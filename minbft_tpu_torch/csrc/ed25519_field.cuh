// Field arithmetic mod p = 2^255 - 19 specialised at compile time, for K7,
// K7' and K8 (a group of 4 threads per lane) and K1's ops mod 2^255 - 19.
//
// Replaces, for 2^255 - 19: field.cuh's generic Montgomery ops over a
// modulus read from __constant__ memory (CIOS: 64 products for a*b and 64
// for the reduction on every multiply and every square; a square-and-
// multiply inversion of 256 squarings and 254 multiplies), which K7 and K8
// ran until this header.
//
// Representation: plain residues, not the Montgomery domain.  An element is
// its value mod p in 8 little-endian 32-bit words, and every op returns the
// unique fully reduced value (< p).  Why plain: 2^256 = 38 mod p, so a
// product's high half folds into its low half by a multiply by 38, and the
// eight folds are independent of each other; a Montgomery reduction by this
// p (-p^-1 mod 2^32 is not 1) is eight steps that each wait on the last, on
// the chain that bounds the kernels.  The reference's values are the
// Montgomery images x*2^256 mod p of these: since every op is exact and
// fully reduced, the same sequence of ops gives x here where it gives
// x*2^256 mod p there, and one multiply by 38 (to_mont) maps a result to the
// reference's integer (K8's outputs).
//
// What the modulus gives (no modulus in memory):
// - a product is 64 32x32->64 products as 64-bit column sums (a square 36:
//   28 cross products doubled, 8 squares), then column k + 8 times 38
//   folded into column k, one carry pass, bits 255 and up times 19 folded
//   into word 0, and a last subtract of p decided by compares (the value is
//   then below 2^255 + 2^23, so v - p fits in word 0);
// - add and sub follow the generic ops' rule (subtract p once iff the sum,
//   or a + p - b, is >= p), so they give the reference's values for any
//   operands below 2^256 (K1's test kernel checks some >= p); on operands
//   below p that is the canonical residue;
// - the inversion is the standard addition chain for p - 2: 254 squarings
//   and 11 multiplies (the generic one: 256 squarings and 254 multiplies).
//
// Geometries, one interface (class F: mul, sqr, add, sub, muls, ...): EdF1,
// one thread per lane (K1's wrapper), and EdTasks (field.cuh FieldTasks
// over EdF1), a group of 4 threads that deals out the independent
// multiplies of each level of a point formula and shares the products back
// (K7, K7' and K8).  Products are column sums in 64-bit C, not PTX carry
// chains (for the P-256 field the chains measured slower on the H100:
// PERF.md section 6); the add/sub chains are PTX.
#pragma once

#include <cstdint>

#include "field.cuh"

// ---------------------------------------------------------------------------
// Constants (little-endian words), plain values mod p: 2d, 2^-256 (the
// reference's from-Montgomery factor), the base point B (x, y) and B's
// addend form (y - x, y + x, 2d*x*y).

enum EdConst { kEdD2 = 0, kEdRInv, kEdBx, kEdBy, kEdBymx, kEdBypx, kEdBt2d };

__device__ __forceinline__ Fe ed_constant(EdConst c) {
  const uint32_t w[7][8] = {
      {0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au, 0xeef3d130u,
       0x198e80f2u, 0x56dffce7u, 0x2406d9dcu},
      {0x9435e50au, 0x435e50d7u, 0x35e50d79u, 0x5e50d794u, 0xe50d7943u,
       0x50d79435u, 0x0d79435eu, 0x179435e5u},
      {0x8f25d51au, 0xc9562d60u, 0x9525a7b2u, 0x692cc760u, 0xfdd6dc5cu,
       0xc0a4e231u, 0xcd6e53feu, 0x216936d3u},
      {0x66666658u, 0x66666666u, 0x66666666u, 0x66666666u, 0x66666666u,
       0x66666666u, 0x66666666u, 0x66666666u},
      {0xd740913eu, 0x9d103905u, 0xd140beb3u, 0xfd399f05u, 0x688f8a09u,
       0xa5c18434u, 0x98f81267u, 0x44fd2f92u},
      {0xf58c3b85u, 0x2fbc93c6u, 0xfb8c0e19u, 0xcf932dc6u, 0x643d42c2u,
       0x270b4898u, 0x33d4ba65u, 0x07cf9d3au},
      {0x877aaa68u, 0xabc91205u, 0xccaac49eu, 0x26d9e823u, 0xdd43598cu,
       0x5a1b7dcbu, 0x9f0c65a8u, 0x6f117b68u}};
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = w[c][j];
  return r;
}

__device__ __forceinline__ Fe ed_small(uint32_t v) {
  Fe r = fe_zero();
  r.v[0] = v;
  return r;
}

// ---------------------------------------------------------------------------
// Products and the reduction.

// a*b as column sums: column k (k = 0..15) collects the low words of
// a_i*b_{k-i} and the high words of a_i*b_{k-1-i} in 64 bits (< 2^36).
__device__ __forceinline__ void ed_cols_mul(const uint32_t* a, const uint32_t* b,
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
__device__ __forceinline__ void ed_cols_sqr(const uint32_t* a, uint64_t* s) {
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

// The value r + c*2^256 (r 8 words, c < 2^18) reduced mod p: bits 255 and
// up folded into word 0 times 19 (2^255 = 19 mod p), leaving w below
// 2^255 + 2^23; then w - p where w >= p.  There w - p < 2^24, so it is
// w_0 + 19 in word 0 and zeros: the compares decide, no second chain.
__device__ __forceinline__ Fe ed_reduce(uint32_t* r, uint32_t c) {
  uint32_t top = (c << 1) | (r[7] >> 31);
  Fe w;
  w.v[0] = add_cc(r[0], top * 19u);
#pragma unroll
  for (int j = 1; j < 7; ++j) w.v[j] = addc_cc(r[j], 0u);
  w.v[7] = addc(r[7] & 0x7fffffffu, 0u);
  uint32_t ones = w.v[1] & w.v[2] & w.v[3] & w.v[4] & w.v[5] & w.v[6];
  bool ge = (w.v[7] >> 31) != 0u ||
            (w.v[7] == 0x7fffffffu && ones == 0xffffffffu && w.v[0] >= 0xffffffedu);
  Fe low = ed_small(w.v[0] + 19u);
  return fe_select(ge, low, w);
}

// Column sums S (a product) mod p: column k + 8 times 38 (2^256 = 38 mod p)
// into column k, one carry pass (each column < 2^43), then ed_reduce.
__device__ __forceinline__ Fe ed_fold(const uint64_t* s) {
  uint32_t r[8];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += s[k] + 38u * s[k + 8];
    r[k] = (uint32_t)c;
    c >>= 32;
  }
  return ed_reduce(r, (uint32_t)c);
}

// ---------------------------------------------------------------------------
// One thread per lane.

struct EdF1 {
  __device__ __forceinline__ bool leader() const { return true; }
  // a*b mod p, for any a, b below 2^256.
  __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) const {
    uint64_t s[16];
    ed_cols_mul(a.v, b.v, s);
    return ed_fold(s);
  }
  __device__ __forceinline__ Fe sqr(const Fe& a) const {
    uint64_t s[16];
    ed_cols_sqr(a.v, s);
    return ed_fold(s);
  }
  // a*k mod p for a small constant k (< 2^16): 8 products.
  __device__ __forceinline__ Fe mul_small(const Fe& a, uint32_t k) const {
    uint32_t r[8];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a.v[j] * k;
      r[j] = (uint32_t)c;
      c >>= 32;
    }
    return ed_reduce(r, (uint32_t)c);
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
  // a + b less p where that is >= p (the generic add_mod's rule).
  __device__ __forceinline__ Fe add(const Fe& a, const Fe& b) const {
    Fe s, d;
    s.v[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) s.v[j] = addc_cc(a.v[j], b.v[j]);
    uint32_t carry = addc(0u, 0u);
    d.v[0] = sub_cc(s.v[0], 0xffffffedu);
#pragma unroll
    for (int j = 1; j < 7; ++j) d.v[j] = subc_cc(s.v[j], 0xffffffffu);
    d.v[7] = subc_cc(s.v[7], 0x7fffffffu);
    uint32_t borrow = subc(0u, 0u) & 1u;
    return fe_select(carry >= borrow, d, s);
  }
  // a + p - b less p where that is >= p (the generic sub_mod's rule), as
  // d = a - b (mod 2^256) and e = d + p: d unless a < b and e carries out
  // (then a + p - b = e is in [0, 2^256)).
  __device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) const {
    Fe d, e;
    d.v[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) d.v[j] = subc_cc(a.v[j], b.v[j]);
    uint32_t borrow = subc(0u, 0u);
    e.v[0] = add_cc(d.v[0], 0xffffffedu);
#pragma unroll
    for (int j = 1; j < 7; ++j) e.v[j] = addc_cc(d.v[j], 0xffffffffu);
    e.v[7] = addc_cc(d.v[7], 0x7fffffffu);
    uint32_t carry = addc(0u, 0u);
    return fe_select((borrow & carry) != 0u, e, d);
  }
  __device__ __forceinline__ Fe one() const { return ed_small(1u); }
  __device__ __forceinline__ Fe zero() const { return fe_zero(); }
  // x -> x*2^256 mod p (the reference's Montgomery image).
  __device__ __forceinline__ Fe to_mont(const Fe& a) const { return mul_small(a, 38u); }
  __device__ __forceinline__ bool is_zero(const Fe& a) const { return fe_is_zero(a); }
  __device__ __forceinline__ bool eq(const Fe& a, const Fe& b) const { return fe_eq(a, b); }
  __device__ __forceinline__ Fe select(bool c, const Fe& a, const Fe& b) const {
    return fe_select(c, a, b);
  }
};

// 4 threads per lane (field.cuh FieldTasks) over EdF1.
using EdTasks = FieldTasks<EdF1, 4>;

// x^(p-2) by the standard addition chain (254 squarings, 11 multiplies):
// x^-1 mod p, and 0 for 0.  One serial chain: a group runs it in every
// thread.
template <class F>
__device__ __forceinline__ Fe ed_inv(const F& f, const Fe& x) {
  Fe x2 = f.sqr(x);                          // x^2
  Fe x9 = f.mul(x, sqr_n(f, x2, 2));         // x^9
  Fe x11 = f.mul(x2, x9);                    // x^11
  Fe t = f.mul(x9, f.sqr(x11));              // x^(2^5 - 1)
  Fe t10 = f.mul(t, sqr_n(f, t, 5));         // x^(2^10 - 1)
  Fe t20 = f.mul(t10, sqr_n(f, t10, 10));    // x^(2^20 - 1)
  Fe t40 = f.mul(t20, sqr_n(f, t20, 20));    // x^(2^40 - 1)
  Fe t50 = f.mul(t10, sqr_n(f, t40, 10));    // x^(2^50 - 1)
  Fe t100 = f.mul(t50, sqr_n(f, t50, 50));   // x^(2^100 - 1)
  Fe t200 = f.mul(t100, sqr_n(f, t100, 100));  // x^(2^200 - 1)
  Fe t250 = f.mul(t50, sqr_n(f, t200, 50));  // x^(2^250 - 1)
  return f.mul(x11, sqr_n(f, t250, 5));      // x^(2^255 - 21)
}
