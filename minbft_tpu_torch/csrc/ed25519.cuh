// Twisted-Edwards point arithmetic (a = -1) over the Ed25519 prime, on the
// K1 field library, for K7 (ed25519_verify.cu) and K8 (ed25519_rb.cu).
//
// The reference's formulas in minbft_tpu/ops/ed25519.py (_add, _dbl), op
// for op and in its operand order: every field op returns a fully reduced
// value, so the same sequence of ops gives the reference's projective
// coordinates bit for bit (a different addition law would give other,
// projectively equal, coordinates, and K8 returns them).
#pragma once

#include "field.cuh"

struct EdPt {
  Fe x, y, z, t;  // extended (X : Y : Z : T), Montgomery domain
};

// Montgomery-domain constants: the base point B (x, y, t = xy) and 2d.
static __constant__ uint32_t kEdBxM[8] = {
    0x3f9da287u, 0xe2cabc55u, 0x2396e489u, 0x9ca59856u,
    0xade4b5b7u, 0x9879936bu, 0x7e6077d0u, 0x759e2370u};
static __constant__ uint32_t kEdByM[8] = {
    0x3333334au, 0x33333333u, 0x33333333u, 0x33333333u,
    0x33333333u, 0x33333333u, 0x33333333u, 0x33333333u};
static __constant__ uint32_t kEdBtM[8] = {
    0x994ae86cu, 0x4f0896aau, 0xb612506eu, 0xe3b7ad11u,
    0xf183c492u, 0x46c7a922u, 0xfeb3930du, 0x5e181c59u};
static __constant__ uint32_t kEdD2M[8] = {
    0xbe8fd3f4u, 0x01db17fdu, 0x5f8c52e7u, 0x21430eefu,
    0x78310d20u, 0xcb27240fu, 0xe53f8a4du, 0x590456b4u};

__device__ __forceinline__ EdPt ed_identity() {
  Fe one = fe_load_const(kFieldEd.one);
  return {fe_zero(), one, one, fe_zero()};
}

// ed_add and ed_dbl are calls, not inlined: with both inlined into K7's
// ladder, cicc (CUDA 12.9, -O3, sm_90a) crashed with a segmentation fault.
// As calls, K7 builds with 166 registers and no spills (a 512-byte stack
// frame carries the point arguments; chip_smoke.py prints the report).

// Complete unified addition (add-2008-hwcd-3 with k = 2d): identity and
// doubling inputs need no special case.  9 field multiplies.
__device__ __noinline__ EdPt ed_add(const EdPt& p, const EdPt& q) {
  const FieldConsts& f = kFieldEd;
  Fe a = mont_mul(sub_mod(p.y, p.x, f), sub_mod(q.y, q.x, f), f);
  Fe b = mont_mul(add_mod(p.y, p.x, f), add_mod(q.y, q.x, f), f);
  Fe c = mont_mul(mont_mul(p.t, fe_load_const(kEdD2M), f), q.t, f);
  Fe zz = mont_mul(p.z, q.z, f);
  Fe d = add_mod(zz, zz, f);
  Fe e = sub_mod(b, a, f);
  Fe ff = sub_mod(d, c, f);
  Fe g = add_mod(d, c, f);
  Fe h = add_mod(b, a, f);
  return {mont_mul(e, ff, f), mont_mul(g, h, f), mont_mul(ff, g, f),
          mont_mul(e, h, f)};
}

// Dedicated doubling (dbl-2008-hwcd, a = -1): 4 squarings + 4 multiplies.
__device__ __noinline__ EdPt ed_dbl(const EdPt& p) {
  const FieldConsts& f = kFieldEd;
  Fe a = mont_sqr(p.x, f);
  Fe b = mont_sqr(p.y, f);
  Fe zz = mont_sqr(p.z, f);
  Fe c = add_mod(zz, zz, f);
  Fe e = sub_mod(sub_mod(mont_sqr(add_mod(p.x, p.y, f), f), a, f), b, f);
  Fe g = sub_mod(b, a, f);                        // D + B with D = -A
  Fe ff = sub_mod(g, c, f);
  Fe h = sub_mod(fe_zero(), add_mod(a, b, f), f);  // D - B = -(A + B)
  return {mont_mul(e, ff, f), mont_mul(g, h, f), mont_mul(ff, g, f),
          mont_mul(e, h, f)};
}
