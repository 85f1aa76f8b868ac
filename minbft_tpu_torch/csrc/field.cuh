// The 8-word field element shared by every field library of the port, its
// helpers, the PTX carry primitives, the group geometry (T threads per
// lane sharing out each level's independent multiplies), and K1's generic
// Montgomery ops over a modulus read as data, for the P-256 group order n
// (K1's timed op).  The primes have their own ops, specialised at compile
// time: p in p256_field.cuh (K2, K3, K4), 2^255 - 19 in ed25519_field.cuh
// (K7, K8).
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
// Bound on the H100 (the generic ops): integer multiply-add issue.  A
// multiply is 64 32x32->64 products for a*b plus 64 for u*m (CIOS), each a
// wide IMAD pair.  Design: word-level CIOS with 64-bit accumulators that
// nvcc lowers to IMAD.WIDE / IMAD.HI chains, everything in registers,
// fully unrolled.
#pragma once

#include <cstdint>
#include <type_traits>

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
// holds for any odd m.
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

// ---------------------------------------------------------------------------
// PTX carry-chain primitives for the add/sub chains.  The carry flag
// (CC.CF) flows from one asm statement to the next; they are volatile so
// they stay in order, and nvcc emits no other flag-setting instruction.
// Compiled for the host with MBT_HOST_TEST, they run on an emulated flag
// (the repository's host tests of the field headers).

#if !defined(__CUDA_ARCH__) && defined(MBT_HOST_TEST)
#define MBT_EMU 1
static thread_local uint32_t mbt_cf;
#endif

#if defined(__CUDA_ARCH__)
#define MBT_PTX3(op, d, a, b) \
  asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b))
#endif

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#if defined(__CUDA_ARCH__)
  MBT_PTX3("add.cc.u32", r, a, b);
#elif defined(MBT_EMU)
  uint64_t s = (uint64_t)a + b;
  mbt_cf = (uint32_t)(s >> 32);
  r = (uint32_t)s;
#endif
  return r;
}

__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#if defined(__CUDA_ARCH__)
  MBT_PTX3("addc.cc.u32", r, a, b);
#elif defined(MBT_EMU)
  uint64_t s = (uint64_t)a + b + mbt_cf;
  mbt_cf = (uint32_t)(s >> 32);
  r = (uint32_t)s;
#endif
  return r;
}

__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#if defined(__CUDA_ARCH__)
  MBT_PTX3("addc.u32", r, a, b);
#elif defined(MBT_EMU)
  r = a + b + mbt_cf;
#endif
  return r;
}

// Subtraction: the flag is the borrow.
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#if defined(__CUDA_ARCH__)
  MBT_PTX3("sub.cc.u32", r, a, b);
#elif defined(MBT_EMU)
  mbt_cf = a < b;
  r = a - b;
#endif
  return r;
}

__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#if defined(__CUDA_ARCH__)
  MBT_PTX3("subc.cc.u32", r, a, b);
#elif defined(MBT_EMU)
  uint64_t d = (uint64_t)a - b - mbt_cf;
  mbt_cf = (uint32_t)(d >> 63);
  r = (uint32_t)d;
#endif
  return r;
}

__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#if defined(__CUDA_ARCH__)
  MBT_PTX3("subc.u32", r, a, b);
#elif defined(MBT_EMU)
  r = a - b - mbt_cf;
#endif
  return r;
}

// ---------------------------------------------------------------------------
// T threads per lane, over a one-thread field class F1 (P256F1, EdF1): the
// one-thread ops, run by every thread of the group on the lane's common
// state, except the multiplies of a level (muls), which the group deals out
// and shares.  Control flow stays uniform inside a group (every branch is
// on a value the group holds in common), so the shuffles use the group's
// own lane mask and groups of one warp may diverge.

template <class F1, int T>
struct FieldTasks : F1 {
  static_assert(T == 4, "the launchers' one group size");

  uint32_t rank;  // 0..T-1
  uint32_t mask;  // the group's lanes in the warp

  __device__ __forceinline__ FieldTasks() {
    uint32_t lane = threadIdx.x & 31u;
    rank = lane & (uint32_t)(T - 1);
    mask = ((1u << T) - 1u) << (lane - rank);
  }
  __device__ __forceinline__ bool leader() const { return rank == 0u; }
  // Rank src's value of v.
  __device__ __forceinline__ Fe from(const Fe& v, uint32_t src) const {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.v[j] = __shfl_sync(mask, v.v[j], (int)src, T);
    return r;
  }
  // Rounds of T multiplies: in round j0, rank r computes multiply j0 + r
  // (a rank past the level's last computes multiply j0 again, unused), a
  // round of squares only by the squaring, then every rank takes each
  // product from the rank that computed it.
  template <int K, unsigned SQ>
  __device__ __forceinline__ void muls(const Fe (&a)[K], const Fe (&b)[K],
                                       Fe (&out)[K]) const {
#pragma unroll
    for (int j0 = 0; j0 < K; j0 += T) {
      Fe x = a[j0], y = b[j0];
#pragma unroll
      for (int j = j0 + 1; j < j0 + T && j < K; ++j) {
        bool mine = rank == (uint32_t)(j - j0);
        x = fe_select(mine, a[j], x);
        y = fe_select(mine, b[j], y);
      }
      unsigned round = (((1u << T) - 1u) << j0) & ((1u << K) - 1u);
      Fe p = (SQ & round) == round ? this->sqr(x) : this->mul(x, y);
#pragma unroll
      for (int j = j0; j < j0 + T && j < K; ++j) out[j] = from(p, (uint32_t)(j - j0));
    }
  }
};

// The field ops of F1 for T (1 or 4) threads per lane.
template <class F1, int T>
using FieldGeometry = std::conditional_t<T == 1, F1, FieldTasks<F1, T>>;

// ---------------------------------------------------------------------------
// Over either geometry.

template <class F>
__device__ __forceinline__ Fe sqr_n(const F& f, Fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = f.sqr(x);
  return x;
}
