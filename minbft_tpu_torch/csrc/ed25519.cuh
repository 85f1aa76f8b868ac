// Twisted-Edwards point arithmetic (a = -1) mod 2^255 - 19 for K7
// (ed25519_verify.cu) and K8 (ed25519_rb.cu), over ed25519_field.cuh's
// group of 4 threads per lane (EdTasks), which shares out each level's
// products.
//
// The reference's formulas in minbft_tpu/ops/ed25519.py (_dbl:
// dbl-2008-hwcd; _add: add-2008-hwcd-3 with k = 2d), each field op exact
// and fully reduced.  What differs from the reference is only where a value
// is computed, never which value:
// - the addend's terms that depend on it alone are stored with it
//   (EdAddend: y - x, y + x, 2d*t and 2z, for add-2008-hwcd-3's
//   (y2 - x2), (y2 + x2), 2d*t2 and the 2*z2 of D = 2*z1*z2);
// - an affine addend (z = 1) has no z product (a mixed add: D = 2*z1);
// - an output no later op reads is not computed (K7's adds feed doublings,
//   which read no T).
// So K8's projective (X, Y, Z) equals the reference's bit for bit (after
// the map to the Montgomery domain), and K7's point is the reference's.
//
// Each formula is written as levels of independent products (muls): a
// doubling is 4 squares then 4 products, an add 3 or 4 products then 3 or
// 4, so on a group of 4 threads a ladder step (double, then add) is 4
// multiplies deep where one thread runs 15 in turn.
#pragma once

#include "ed25519_field.cuh"

struct EdPt {
  Fe x, y, z, t;  // extended (X : Y : Z : T)
};

// An addend of add-2008-hwcd-3 with its own terms computed once.
struct EdAddend {
  Fe ymx, ypx, t2d, z2;  // y - x, y + x, 2d*t, 2z
};

// The addend form of an extended point.
template <class F>
__device__ __forceinline__ EdAddend ed_addend(const F& f, const EdPt& p) {
  return {f.sub(p.y, p.x), f.add(p.y, p.x), f.mul(p.t, ed_constant(kEdD2)),
          f.add(p.z, p.z)};
}

// Dedicated doubling (dbl-2008-hwcd, a = -1): 4 squares, then the 4
// output products.
template <class F>
__device__ __forceinline__ EdPt ed_dbl(const F& f, const Fe& x, const Fe& y,
                                       const Fe& z) {
  Fe in[4] = {x, y, z, f.add(x, y)}, sq[4];
  f.template muls<4, 0xFu>(in, in, sq);
  Fe a = sq[0], b = sq[1];
  Fe c = f.add(sq[2], sq[2]);
  Fe e = f.sub(f.sub(sq[3], a), b);
  Fe g = f.sub(b, a);                      // D + B with D = -A
  Fe ff = f.sub(g, c);
  Fe h = f.sub(f.zero(), f.add(a, b));     // D - B = -(A + B)
  Fe ma[4] = {e, g, ff, e}, mb[4] = {ff, h, g, h}, m[4];
  f.template muls<4, 0x0u>(ma, mb, m);
  return {m[0], m[1], m[2], m[3]};
}

// p + q (add-2008-hwcd-3, complete) for an addend with any z: A, B, C and
// D = z1 * 2z2, then X, Y and Z.  T is not computed: the caller doubles
// next, and a doubling reads no T.
template <class F>
__device__ __forceinline__ void ed_add_xyz(const F& f, const EdPt& p, const EdAddend& q,
                                           Fe* x, Fe* y, Fe* z) {
  Fe ma[4] = {f.sub(p.y, p.x), f.add(p.y, p.x), p.t, p.z};
  Fe mb[4] = {q.ymx, q.ypx, q.t2d, q.z2}, m[4];
  f.template muls<4, 0x0u>(ma, mb, m);
  Fe e = f.sub(m[1], m[0]);
  Fe ff = f.sub(m[3], m[2]);
  Fe g = f.add(m[3], m[2]);
  Fe h = f.add(m[1], m[0]);
  Fe oa[3] = {e, g, ff}, ob[3] = {ff, h, g}, o[3];
  f.template muls<3, 0x0u>(oa, ob, o);
  *x = o[0];
  *y = o[1];
  *z = o[2];
}

// p + q (add-2008-hwcd-3) for an affine addend (z2 = 1, so D = 2*z1, as the
// reference's zz = z1 * 1): A, B and C, then the 4 outputs.  The addend is
// (y2 - x2, y2 + x2, 2d*t2).
template <class F>
__device__ __forceinline__ EdPt ed_madd(const F& f, const EdPt& p, const Fe& ymx,
                                        const Fe& ypx, const Fe& t2d) {
  Fe ma[3] = {f.sub(p.y, p.x), f.add(p.y, p.x), p.t};
  Fe mb[3] = {ymx, ypx, t2d}, m[3];
  f.template muls<3, 0x0u>(ma, mb, m);
  Fe d = f.add(p.z, p.z);
  Fe e = f.sub(m[1], m[0]);
  Fe ff = f.sub(d, m[2]);
  Fe g = f.add(d, m[2]);
  Fe h = f.add(m[1], m[0]);
  Fe oa[4] = {e, g, ff, e}, ob[4] = {ff, h, g, h}, o[4];
  f.template muls<4, 0x0u>(oa, ob, o);
  return {o[0], o[1], o[2], o[3]};
}
