// P-256 field arithmetic specialised at compile time, and the point
// formulas of K2, K3 and K4 over it, at one thread per lane or a group of
// T threads per lane.
//
// Replaces, for the prime p = 2^256 - 2^224 + 2^192 + 2^96 - 1 only: the
// generic ops of field.cuh (mont_mul's CIOS over a __constant__ modulus,
// mont_sqr = mont_mul(a, a), mont_inv's 256 squarings and ~128 multiplies),
// which K2-K4 ran on every multiply.  field.cuh keeps the generic ops for
// the group order n, the carry primitives and the group geometry.
//
// Every op returns the value the generic op returns, bit for bit: R is
// 2^256, a product is (a*b + U*p) / 2^256 with U the unique 256-bit value
// that makes it exact (the same pre-subtract value as any word size's CIOS),
// and the one conditional subtract follows the generic rule (subtract iff
// the value is >= p, i.e. t_hi >= borrow).  Inside the kernels every value
// is below p, so results are the canonical residues.
//
// What the modulus gives (all folded by nvcc, no modulus in memory):
// - -p^-1 = 1 mod 2^96, so the reduction's U is read off the product: u_i
//   is column i mod 2^32, and U*p is U shifted to words 3, 6, 7 (negated)
//   and 8.  The reduction costs adds only (the generic one, 72 products).
// - a square takes 36 products (28 cross products doubled, 8 squares).
// - the inversion is an addition chain for p - 2: 255 squarings and 12
//   multiplies (the generic one: 256 squarings and 128 multiplies).
//
// Bound and design.  A lane is one serial chain of field multiplies, and
// at the deployment bucket every warp has its scheduler to itself, so the
// multiply's latency sets a kernel's time.  Products are column sums in
// 64-bit C (each column a sum of 32-bit halves of independent products,
// one carry pass that also reduces), which nvcc schedules freely: the
// columns, and independent multiplies, overlap.  The same product as PTX
// carry chains (mad.lo.cc / madc.hi.cc rows) measured slower on the H100
// (nvcc 12.8): ptxas moved the carry flag through P2R / LOP3 and every
// multiply became one serial chain (PERF.md section 6).  The short
// add/sub chains stay PTX (add.cc / sub.cc).
//
// Geometries, one interface (class F: mul, sqr, add, sub, muls, ...),
// P256Field<T> for T threads per lane:
// - P256F1: one thread per lane, an element in 8 registers.
// - P256Tasks<4>: 4 threads per lane.  Every thread holds the lane's whole
//   state and runs its adds, subs and selects; the multiplies of one
//   dependency level of a point formula (muls: up to 4 in dbl and 3 in
//   madd) are dealt out, one to a thread, and the products shared by
//   __shfl_sync.  A ladder step (pt_dbl_madd: the doubling's last levels
//   beside the madd's first) puts its 19 multiplies in 7 levels, so the
//   lane's chain is 7 multiplies deep, for 4 times the threads.  Control
//   flow stays uniform inside a group (every branch is on a value the
//   group holds in common), so the shuffles use the group's own lane mask
//   and groups of one warp may diverge.
#pragma once

#include <cstdint>

#include "field.cuh"

// ---------------------------------------------------------------------------
// Constants (little-endian words): p, R mod p (the Montgomery one),
// R^2 mod p (the to-Montgomery factor), G in the Montgomery domain, and 1
// (the from-Montgomery factor).

enum P256Const { kConstP = 0, kConstOne, kConstR2, kConstGx, kConstGy, kConstUnit };

__device__ __forceinline__ Fe p256_constant(P256Const c) {
  const uint32_t w[6][8] = {
      {0xffffffffu, 0xffffffffu, 0xffffffffu, 0x00000000u, 0x00000000u,
       0x00000000u, 0x00000001u, 0xffffffffu},
      {0x00000001u, 0x00000000u, 0x00000000u, 0xffffffffu, 0xffffffffu,
       0xffffffffu, 0xfffffffeu, 0x00000000u},
      {0x00000003u, 0x00000000u, 0xffffffffu, 0xfffffffbu, 0xfffffffeu,
       0xffffffffu, 0xfffffffdu, 0x00000004u},
      {0x18a9143cu, 0x79e730d4u, 0x5fedb601u, 0x75ba95fcu, 0x77622510u,
       0x79fb732bu, 0xa53755c6u, 0x18905f76u},
      {0xce95560au, 0xddf25357u, 0xba19e45cu, 0x8b4ab8e4u, 0xdd21f325u,
       0xd2e88688u, 0x25885d85u, 0x8571ff18u},
      {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}};
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = w[c][j];
  return r;
}

// ---------------------------------------------------------------------------
// Products and the reduction.

// a*b as column sums: column k (k = 0..15) collects the low words of
// a_i*b_{k-i} and the high words of a_i*b_{k-1-i} in 64 bits (< 2^37); no
// column waits on another.
__device__ __forceinline__ void p256_cols_mul(const uint32_t* a, const uint32_t* b,
                                              uint64_t* s) {
#pragma unroll
  for (int k = 0; k < 16; ++k) s[k] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t p = (uint64_t)a[i] * b[j];
      s[i + j] += (uint32_t)p;
      s[i + j + 1] += p >> 32;
    }
  }
}

// a^2 as column sums: the 28 cross products twice, the 8 squares once.
__device__ __forceinline__ void p256_cols_sqr(const uint32_t* a, uint64_t* s) {
#pragma unroll
  for (int k = 0; k < 16; ++k) s[k] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = i + 1; j < 8; ++j) {
      uint64_t p = (uint64_t)a[i] * a[j];
      s[i + j] += (uint64_t)(uint32_t)p << 1;
      s[i + j + 1] += (p >> 32) << 1;
    }
    uint64_t q = (uint64_t)a[i] * a[i];
    s[2 * i] += (uint32_t)q;
    s[2 * i + 1] += q >> 32;
  }
}

// r - p if r (with its 2^256 bit `top`) is >= p, else r: the generic
// cond_sub's rule, subtract iff top >= borrow(r - p).
__device__ __forceinline__ Fe p256_cond_sub(const uint32_t* r, uint32_t top) {
  Fe d;
  d.v[0] = sub_cc(r[0], 0xffffffffu);
  d.v[1] = subc_cc(r[1], 0xffffffffu);
  d.v[2] = subc_cc(r[2], 0xffffffffu);
  d.v[3] = subc_cc(r[3], 0u);
  d.v[4] = subc_cc(r[4], 0u);
  d.v[5] = subc_cc(r[5], 0u);
  d.v[6] = subc_cc(r[6], 1u);
  d.v[7] = subc_cc(r[7], 0xffffffffu);
  uint32_t borrow = subc(0u, 0u) & 1u;
  bool keep = top < borrow;
  Fe out;
#pragma unroll
  for (int j = 0; j < 8; ++j) out.v[j] = keep ? r[j] : d.v[j];
  return out;
}

// (S + U*p) / 2^256 for the column sums S, conditionally reduced: one pass
// normalises the columns and reduces.  Column i < 8 gives u_i (its value
// mod 2^32, as -p^-1 = 1) and collects u_{i-3} + u_{i-6} - u_{i-7}; high
// column 8 + i collects u_{i+5} + u_{i+2} - u_{i+1} + u_i (the terms past
// u_7 absent).  Every carry is exact (x - u_i vanishes mod 2^32) and the
// last is the value's 2^256 bit.
__device__ __forceinline__ Fe p256_redc(const uint64_t* s) {
  uint32_t u[8], r[8];
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t x = (int64_t)s[i] + c;
    if (i >= 3) x += u[i - 3];
    if (i >= 6) x += u[i - 6];
    if (i >= 7) x -= u[i - 7];
    u[i] = (uint32_t)x;
    c = x >> 32;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t x = (int64_t)s[8 + i] + c + u[i];
    if (i + 1 <= 7) x -= u[i + 1];
    if (i + 2 <= 7) x += u[i + 2];
    if (i + 5 <= 7) x += u[i + 5];
    r[i] = (uint32_t)x;
    c = x >> 32;
  }
  return p256_cond_sub(r, (uint32_t)c);
}

// ---------------------------------------------------------------------------
// One thread per lane.

struct P256F1 {
  __device__ __forceinline__ bool leader() const { return true; }
  __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) const {
    uint64_t s[16];
    p256_cols_mul(a.v, b.v, s);
    return p256_redc(s);
  }
  __device__ __forceinline__ Fe sqr(const Fe& a) const {
    uint64_t s[16];
    p256_cols_sqr(a.v, s);
    return p256_redc(s);
  }
  // out[j] = a[j] * b[j] for the K independent multiplies of one level;
  // bit j of SQ marks a square (b[j] == a[j]).  Here in turn, unrolled, so
  // nvcc interleaves them.
  template <int K, unsigned SQ>
  __device__ __forceinline__ void muls(const Fe (&a)[K], const Fe (&b)[K],
                                       Fe (&out)[K]) const {
#pragma unroll
    for (int j = 0; j < K; ++j) out[j] = ((SQ >> j) & 1u) ? sqr(a[j]) : mul(a[j], b[j]);
  }
  __device__ __forceinline__ Fe add(const Fe& a, const Fe& b) const {
    uint32_t s[8];
    s[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) s[j] = addc_cc(a.v[j], b.v[j]);
    uint32_t top = addc(0u, 0u);
    return p256_cond_sub(s, top);
  }
  // a - b, plus p on a borrow: the generic sub_mod's value for a, b < p.
  __device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) const {
    Fe d, e;
    d.v[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) d.v[j] = subc_cc(a.v[j], b.v[j]);
    uint32_t borrow = subc(0u, 0u);
    e.v[0] = add_cc(d.v[0], 0xffffffffu);
    e.v[1] = addc_cc(d.v[1], 0xffffffffu);
    e.v[2] = addc_cc(d.v[2], 0xffffffffu);
    e.v[3] = addc_cc(d.v[3], 0u);
    e.v[4] = addc_cc(d.v[4], 0u);
    e.v[5] = addc_cc(d.v[5], 0u);
    e.v[6] = addc_cc(d.v[6], 1u);
    e.v[7] = addc(d.v[7], 0xffffffffu);
    return fe_select(borrow != 0u, e, d);
  }
  __device__ __forceinline__ Fe one() const { return p256_constant(kConstOne); }
  __device__ __forceinline__ Fe gx() const { return p256_constant(kConstGx); }
  __device__ __forceinline__ Fe gy() const { return p256_constant(kConstGy); }
  __device__ __forceinline__ Fe zero() const { return fe_zero(); }
  __device__ __forceinline__ Fe to_mont(const Fe& a) const {
    return mul(a, p256_constant(kConstR2));
  }
  __device__ __forceinline__ Fe from_mont(const Fe& a) const {
    return mul(a, p256_constant(kConstUnit));
  }
  __device__ __forceinline__ bool is_zero(const Fe& a) const { return fe_is_zero(a); }
  __device__ __forceinline__ bool eq(const Fe& a, const Fe& b) const { return fe_eq(a, b); }
  __device__ __forceinline__ Fe select(bool c, const Fe& a, const Fe& b) const {
    return fe_select(c, a, b);
  }
};

// T threads per lane (field.cuh FieldTasks) over P256F1.
template <int T>
using P256Tasks = FieldTasks<P256F1, T>;
template <int T>
using P256Field = FieldGeometry<P256F1, T>;

// ---------------------------------------------------------------------------
// Over either geometry.

// Fermat inversion x^(p-2) in the Montgomery domain by an addition chain
// (255 squarings, 12 multiplies); the value equals the generic mont_inv's.
// One serial chain: a group runs it in every thread.
template <class F>
__device__ __forceinline__ Fe p256_inv(const F& f, const Fe& x) {
  Fe z = f.mul(x, f.sqr(x));        // x^0b11
  z = f.mul(x, f.sqr(z));           // x^0b111
  Fe t0 = f.mul(z, sqr_n(f, z, 3)); // x^(2^6 - 1)
  t0 = f.mul(t0, sqr_n(f, t0, 6));  // x^(2^12 - 1)
  z = f.mul(z, sqr_n(f, t0, 3));    // x^(2^15 - 1)
  t0 = f.mul(x, f.sqr(z));          // x^(2^16 - 1)
  t0 = f.mul(t0, sqr_n(f, t0, 16)); // x^(2^32 - 1)
  t0 = sqr_n(f, t0, 15);
  z = f.mul(z, t0);                 // x^(2^47 - 1)
  t0 = f.mul(x, sqr_n(f, t0, 17));
  t0 = f.mul(z, sqr_n(f, t0, 143));
  z = f.mul(z, sqr_n(f, t0, 47));
  return f.mul(x, sqr_n(f, z, 2));
}

struct Pt {
  Fe x, y, z;  // Jacobian, Montgomery domain; z == 0 <=> identity
};

// Mixed Jacobian + affine addition (madd-2007-bl, 7M + 4S): the
// reference's ops, its multiplies taken level by level (1, 2, 3, 3, 2).
// *exc is set where the formula is undefined (p == q, both finite);
// identity operands are resolved by the reference's selects, including
// the x/y it leaves in an identity result.
template <class F>
__device__ __forceinline__ Pt pt_madd(const F& f, const Pt& p, const Fe& qx,
                                      const Fe& qy, bool q_inf, bool* exc) {
  Fe z1z1 = f.sqr(p.z);
  Fe a2[2] = {qx, p.z}, b2[2] = {z1z1, z1z1}, m2[2];
  f.template muls<2, 0x0u>(a2, b2, m2);
  Fe u2 = m2[0], z1c = m2[1];
  Fe h = f.sub(u2, p.x);
  // s2 = qy * z1^3, hh = h^2, z3 = z1 * h.
  Fe a3[3] = {qy, h, p.z}, b3[3] = {z1c, h, h}, m3[3];
  f.template muls<3, 0x2u>(a3, b3, m3);
  Fe s2 = m3[0], hh = m3[1], z3 = m3[2];
  Fe r = f.sub(s2, p.y);
  // hhh = h * hh, v = x1 * hh, rr = r^2.
  Fe a4[3] = {h, p.x, r}, b4[3] = {hh, hh, r}, m4[3];
  f.template muls<3, 0x4u>(a4, b4, m4);
  Fe hhh = m4[0], v = m4[1], rr = m4[2];
  Fe x3 = f.sub(f.sub(rr, hhh), f.add(v, v));
  Fe a5[2] = {r, p.y}, b5[2] = {f.sub(v, x3), hhh}, m5[2];
  f.template muls<2, 0x0u>(a5, b5, m5);
  Fe y3 = f.sub(m5[0], m5[1]);

  bool p_inf = f.is_zero(p.z);
  *exc = f.is_zero(h) && f.is_zero(r) && !p_inf && !q_inf;
  Pt out;
  out.x = f.select(p_inf, qx, f.select(q_inf, p.x, x3));
  out.y = f.select(p_inf, qy, f.select(q_inf, p.y, y3));
  out.z = f.select(p_inf, f.select(q_inf, f.zero(), f.one()),
                   f.select(q_inf, p.z, z3));
  return out;
}

// One ladder step: the Jacobian doubling, a = -3 (dbl-2001-b), then
// pt_madd of q, the reference's ops in both, with the madd's first
// multiplies (on the double's z, known after the doubling's second level)
// taken beside the doubling's last two: 7 levels (2, 4, 2, 3, 3, 3, 2)
// in place of 4 + 5.  With q_inf set it returns the double of a finite p
// (the madd's selects keep it).
template <class F>
__device__ __forceinline__ Pt pt_dbl_madd(const F& f, const Pt& p, const Fe& qx,
                                          const Fe& qy, bool q_inf, bool* exc) {
  Fe sq_in[2] = {p.z, p.y}, sq[2];
  f.template muls<2, 0x3u>(sq_in, sq_in, sq);
  Fe delta = sq[0], gamma = sq[1];
  Fe t0 = f.sub(p.x, delta);
  Fe t1 = f.add(p.x, delta);
  Fe a3 = f.add(f.add(t0, t0), t0);
  Fe yz = f.add(p.y, p.z);
  Fe ma[4] = {p.x, a3, yz, gamma}, mb[4] = {gamma, t1, yz, gamma}, m[4];
  f.template muls<4, 0xCu>(ma, mb, m);
  Fe beta = m[0], alpha = m[1], yz2 = m[2], g2 = m[3];
  Fe b2 = f.add(beta, beta);
  Fe beta4 = f.add(b2, b2);
  Fe beta8 = f.add(beta4, beta4);
  Fe dz = f.sub(f.sub(yz2, gamma), delta);  // the double (dx, dy, dz)
  Fe g4 = f.add(g2, g2);
  Fe g8 = f.add(g4, g4);
  g8 = f.add(g8, g8);
  // alpha^2 (the double's x) beside dz^2 (the madd's z1z1).
  Fe a5[2] = {alpha, dz}, m5[2];
  f.template muls<2, 0x3u>(a5, a5, m5);
  Fe dx = f.sub(m5[0], beta8), z1z1 = m5[1];
  // alpha * (beta4 - dx) (the double's y) beside u2 and z1^3.
  Fe a6[3] = {alpha, qx, dz}, b6[3] = {f.sub(beta4, dx), z1z1, z1z1}, m6[3];
  f.template muls<3, 0x0u>(a6, b6, m6);
  Fe dy = f.sub(m6[0], g8);
  Fe u2 = m6[1], z1c = m6[2];
  Fe h = f.sub(u2, dx);
  Fe a7[3] = {qy, h, dz}, b7[3] = {z1c, h, h}, m7[3];
  f.template muls<3, 0x2u>(a7, b7, m7);
  Fe s2 = m7[0], hh = m7[1], z3 = m7[2];
  Fe r = f.sub(s2, dy);
  Fe a8[3] = {h, dx, r}, b8[3] = {hh, hh, r}, m8[3];
  f.template muls<3, 0x4u>(a8, b8, m8);
  Fe hhh = m8[0], v = m8[1], rr = m8[2];
  Fe x3 = f.sub(f.sub(rr, hhh), f.add(v, v));
  Fe a9[2] = {r, dy}, b9[2] = {f.sub(v, x3), hhh}, m9[2];
  f.template muls<2, 0x0u>(a9, b9, m9);
  Fe y3 = f.sub(m9[0], m9[1]);

  bool p_inf = f.is_zero(dz);
  *exc = f.is_zero(h) && f.is_zero(r) && !p_inf && !q_inf;
  Pt out;
  out.x = f.select(p_inf, qx, f.select(q_inf, dx, x3));
  out.y = f.select(p_inf, qy, f.select(q_inf, dy, y3));
  out.z = f.select(p_inf, f.select(q_inf, f.zero(), f.one()),
                   f.select(q_inf, dz, z3));
  return out;
}
