// K1: 256-bit Montgomery field arithmetic over a modulus read as data
// (FieldConsts), as a __device__ library: the group order n of P-256
// (K1's timed op) and the Ed25519 prime 2^255 - 19 (inlined into K7 and
// K8).  The P-256 prime p has its own ops, specialised at compile time, in
// p256_field.cuh (K2, K3, K4 and K1's ops mod p).
//
// Replaces: minbft_tpu/ops/limbs.py (mont_mul with its unrolled / block /
// loop lowerings, _mont_finish, _cond_sub, add_mod, sub_mod,
// mont_pow_static, mont_inv), which the TPU program inlined into every
// vmapped kernel as 16 limbs of 16 bits in u32 lanes.
//
// Representation: 8 little-endian 32-bit words per element.  R = 2^256 as
// in the reference, so a Montgomery-domain value here is the same integer
// as the reference's 16x16-bit limbs; every op returns a fully reduced
// value (< m) and the one conditional subtract follows the reference's
// rule (t_hi >= borrow), so results are bit-identical to the reference's.
//
// Bound on the H100: integer multiply-add issue.  A multiply is 64
// 32x32->64 products for a*b plus 64 for u*m (CIOS), each a wide IMAD
// pair; there is no memory traffic inside the ladders at all.  Design:
// word-level CIOS with 64-bit accumulators that nvcc lowers to
// IMAD.WIDE / IMAD.HI chains, everything in registers, fully unrolled.
#pragma once

#include <cstdint>

struct Fe {
  uint32_t v[8];
};

struct FieldConsts {
  uint32_t m[8];   // modulus
  uint32_t one[8]; // R mod m (Montgomery one)
  uint32_t r2[8];  // R^2 mod m (to-Montgomery factor)
  uint32_t e[8];   // m - 2 (Fermat exponent)
  uint32_t mp;     // -m^-1 mod 2^32
};

static __constant__ FieldConsts kOrderN = {
    {0xfc632551u, 0xf3b9cac2u, 0xa7179e84u, 0xbce6faadu, 0xffffffffu,
     0xffffffffu, 0x00000000u, 0xffffffffu},
    {0x039cdaafu, 0x0c46353du, 0x58e8617bu, 0x43190552u, 0x00000000u,
     0x00000000u, 0xffffffffu, 0x00000000u},
    {0xbe79eea2u, 0x83244c95u, 0x49bd6fa6u, 0x4699799cu, 0x2b6bec59u,
     0x2845b239u, 0xf3d95620u, 0x66e12d94u},
    {0xfc63254fu, 0xf3b9cac2u, 0xa7179e84u, 0xbce6faadu, 0xffffffffu,
     0xffffffffu, 0x00000000u, 0xffffffffu},
    0xee00bc4fu};

// The Ed25519 prime 2^255 - 19 (K7, K8): one = 2^256 mod m = 38,
// r2 = 38^2 = 1444.
static __constant__ FieldConsts kFieldEd = {
    {0xffffffedu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
     0xffffffffu, 0xffffffffu, 0x7fffffffu},
    {0x00000026u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000000u},
    {0x000005a4u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000000u},
    {0xffffffebu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
     0xffffffffu, 0xffffffffu, 0x7fffffffu},
    0x286bca1bu};

__device__ __forceinline__ Fe fe_load_const(const uint32_t* c) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = c[j];
  return r;
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = 0u;
  return r;
}

// Widen 16 little-endian u16 limbs (the reference's layout) to 8 words.
__device__ __forceinline__ Fe fe_from_u16(const uint16_t* p) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    r.v[j] = (uint32_t)p[2 * j] | ((uint32_t)p[2 * j + 1] << 16);
  return r;
}

__device__ __forceinline__ void fe_to_u16(const Fe& a, uint16_t* p) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p[2 * j] = (uint16_t)(a.v[j] & 0xffffu);
    p[2 * j + 1] = (uint16_t)(a.v[j] >> 16);
  }
}

// Word w (0 = least significant) of a scalar, by selects: a dynamic index
// into a register array would put the array in local memory.
__device__ __forceinline__ uint32_t fe_word(const Fe& s, int w) {
  uint32_t r = s.v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) r = (w == j) ? s.v[j] : r;
  return r;
}

// Widen 16 little-endian limbs carried in 32-bit lanes (the reference's
// [16] u32 limb arrays, each limb < 2^16) to 8 words.
__device__ __forceinline__ Fe fe_from_u32_limbs(const uint32_t* p) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = p[2 * j] | (p[2 * j + 1] << 16);
  return r;
}

__device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = c ? a.v[j] : b.v[j];
  return r;
}

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
  uint32_t d = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) d |= a.v[j] ^ b.v[j];
  return d == 0;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t d = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) d |= a.v[j];
  return d == 0;
}

// The reference's _cond_sub: t - m (mod 2^256) if t_hi >= borrow(t - m),
// else t.  t_hi is the high part of t, read as uint32.
__device__ __forceinline__ Fe cond_sub(const uint32_t* t, uint32_t t_hi,
                                       const FieldConsts& F) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)t[j] - F.m[j] - borrow;
    d.v[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  bool ge = t_hi >= borrow;
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = ge ? d.v[j] : t[j];
  return r;
}

__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b,
                                      const FieldConsts& F) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)a.v[j] + b.v[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  return cond_sub(s, (uint32_t)c, F);
}

// a + m - b; high part = carry(a + m) - borrow(. - b) as uint32, exactly
// the reference's sub_mod.
__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b,
                                      const FieldConsts& F) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)a.v[j] + F.m[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  uint32_t carry = (uint32_t)c;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)s[j] - b.v[j] - borrow;
    s[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  return cond_sub(s, carry - borrow, F);
}

// Word-level CIOS Montgomery product a*b*2^-256 mod m.  The pre-subtract
// value (a*b + U*m) / 2^256 does not depend on the word size (U is the
// unique value < 2^256 with a*b + U*m = 0 mod 2^256), so it equals the
// reference's 16-bit lazy-carry CIOS value, t_hi included.  The argument
// holds for any odd m, so it covers kFieldEd as well as kOrderN.
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b,
                                       const FieldConsts& F) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a.v[i] * b.v[j] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    uint32_t u = t[0] * F.mp;
    c = ((uint64_t)u * F.m[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)u * F.m[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  return cond_sub(t, t[8], F);
}

__device__ __forceinline__ Fe mont_sqr(const Fe& a, const FieldConsts& F) {
  return mont_mul(a, a, F);
}

__device__ __forceinline__ Fe to_mont(const Fe& a, const FieldConsts& F) {
  return mont_mul(a, fe_load_const(F.r2), F);
}

__device__ __forceinline__ Fe from_mont(const Fe& a, const FieldConsts& F) {
  Fe one = fe_zero();
  one.v[0] = 1u;
  return mont_mul(a, one, F);
}

// Fermat inversion a^(m-2) in the Montgomery domain: square-and-multiply
// from the top bit of the exponent (the reference's mont_pow_static).  The
// exponent is a constant, so every thread takes the same branches.
__device__ __noinline__ Fe mont_inv(const Fe& a, const FieldConsts& F) {
  Fe acc = fe_load_const(F.one);
  for (int w = 7; w >= 0; --w) {
    uint32_t ew = F.e[w];
    for (int i = 31; i >= 0; --i) {
      acc = mont_sqr(acc, F);
      if ((ew >> i) & 1u) acc = mont_mul(acc, a, F);
    }
  }
  return acc;
}
