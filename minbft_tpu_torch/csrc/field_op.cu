// K1 test kernel: one field op per lane, so the device field libraries
// that K2-K4, K7 and K8 inline can be held against the plain PyTorch ops
// of minbft_tpu_torch/ops/limbs.py (field_op_plain) on the card: mod the
// P-256 prime p through p256_field.cuh's ops specialised to p and mod the
// Ed25519 prime 2^255 - 19 through ed25519_field.cuh's, each at one thread
// per lane or in a group of 4 (the multiplies of 4 lanes dealt out across
// the group and shared back), and mod the group order n through field.cuh's
// generic ops.
//
// The ops are the reference's, in its Montgomery domain (R = 2^256).  The
// ops mod p work in that domain themselves; those mod 2^255 - 19 work on
// plain residues, so here a Montgomery product is their product times
// 2^-256 mod p, to_mont a multiply by 38 and mont_inv their inverse times
// 38^2 (all exact, so the values are the reference's).
//
// Replaces (as a checkable unit): the limb arithmetic of
// minbft_tpu/ops/limbs.py; see field.cuh, p256_field.cuh and
// ed25519_field.cuh for the bound and the design.  This kernel itself is
// bound by launch latency and 96 bytes of traffic per lane; it exists for
// parity, not speed.

#include <cuda_runtime.h>

#include "ed25519_field.cuh"
#include "p256_field.cuh"

namespace {

// Op codes, in the order of limbs.FIELD_OPS.
enum Op {
  kMul = 0, kSqr, kAdd, kSub, kToMont, kFromMont, kInv, kSelect, kEq, kIsZero
};

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    order_op_kernel(int op, const uint16_t* __restrict__ a,
                    const uint16_t* __restrict__ b, uint16_t* __restrict__ out,
                    int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const FieldConsts& f = kOrderN;
  Fe x = fe_from_u16(a + (size_t)lane * 16);
  Fe y = fe_from_u16(b + (size_t)lane * 16);
  Fe r = fe_zero();
  switch (op) {
    case kMul: r = mont_mul(x, y, f); break;
    case kSqr: r = mont_sqr(x, f); break;
    case kAdd: r = add_mod(x, y, f); break;
    case kSub: r = sub_mod(x, y, f); break;
    case kToMont: r = to_mont(x, f); break;
    case kFromMont: r = from_mont(x, f); break;
    case kInv: r = mont_inv(x, f); break;
    case kSelect: r = fe_select((x.v[0] & 1u) != 0u, x, y); break;
    case kEq: r.v[0] = fe_eq(x, y) ? 1u : 0u; break;
    case kIsZero: r.v[0] = fe_is_zero(x) ? 1u : 0u; break;
    default: break;
  }
  fe_to_u16(r, out + (size_t)lane * 16);
}

// The reference's Montgomery-domain ops over a specialised field: the
// multiplying ops as one product x * factor (a square for kSqr), then,
// where kSecond, kMul's and kSqr's product times second(); the inversion.
struct P256Mont {
  static constexpr bool kSecond = false;
  __device__ static Fe factor(int op, const Fe& x, const Fe& y) {
    return op == kMul ? y : op == kSqr ? x
                      : p256_constant(op == kToMont ? kConstR2 : kConstUnit);
  }
  template <class F>
  __device__ static Fe inv(const F& f, const Fe& x) { return p256_inv(f, x); }
};

struct EdMont {
  static constexpr bool kSecond = true;
  __device__ static Fe factor(int op, const Fe& x, const Fe& y) {
    return op == kMul ? y : op == kSqr ? x
                      : op == kToMont ? ed_small(38u) : ed_constant(kEdRInv);
  }
  __device__ static Fe second() { return ed_constant(kEdRInv); }
  // (x / 2^256)^-1 * 2^256 = x^-1 * 38^2.
  template <class F>
  __device__ static Fe inv(const F& f, const Fe& x) {
    return f.mul_small(ed_inv(f, x), 1444u);
  }
};

// Over field class F1 (P256F1 with P256Mont, EdF1 with EdMont), one lane
// per thread.  In a group of T threads (T consecutive lanes) the
// multiplying ops go through the group's muls: every thread gathers the T
// lanes' operands, the group computes the T products (one a thread) and
// shares them, and each thread keeps its own lane's.  The other ops are
// the one-thread ones.  Lanes past n compute lane n - 1's op and store
// nothing, so every group is whole.
template <class F1, class M, int T>
__global__ void __launch_bounds__(kThreads)
    prime_op_kernel(int op, const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                    int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int src = lane < n ? lane : n - 1;
  FieldGeometry<F1, T> f;
  Fe x, y, r = fe_zero();
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    x.v[w] = a[(size_t)src * 8 + w];
    y.v[w] = b[(size_t)src * 8 + w];
  }
  bool multiplies = op == kMul || op == kSqr || op == kToMont || op == kFromMont;
  bool second = op == kMul || op == kSqr;
  if (multiplies) {
    Fe by = M::factor(op, x, y);
    if constexpr (T > 1) {
      Fe xs[T], ys[T], m[T];
#pragma unroll
      for (int j = 0; j < T; ++j) {
        xs[j] = f.from(x, (uint32_t)j);
        ys[j] = f.from(by, (uint32_t)j);
      }
      if (op == kSqr)
        f.template muls<T, (1u << T) - 1u>(xs, xs, m);
      else
        f.template muls<T, 0u>(xs, ys, m);
      if constexpr (M::kSecond) {
        if (second) {
#pragma unroll
          for (int j = 0; j < T; ++j) ys[j] = M::second();
          f.template muls<T, 0u>(m, ys, xs);
#pragma unroll
          for (int j = 0; j < T; ++j) m[j] = xs[j];
        }
      }
#pragma unroll
      for (int j = 0; j < T; ++j) r = fe_select(f.rank == (uint32_t)j, m[j], r);
    } else {
      r = op == kSqr ? f.sqr(x) : f.mul(x, by);
      if constexpr (M::kSecond) {
        if (second) r = f.mul(r, M::second());
      }
    }
  }
  switch (op) {
    case kAdd: r = f.add(x, y); break;
    case kSub: r = f.sub(x, y); break;
    case kInv: r = M::inv(f, x); break;
    case kSelect: r = f.select((x.v[0] & 1u) != 0u, x, y); break;
    case kEq: r.v[0] = f.eq(x, y) ? 1u : 0u; break;
    case kIsZero: r.v[0] = f.is_zero(x) ? 1u : 0u; break;
    default: break;
  }
  if (lane < n) {
#pragma unroll
    for (int w = 0; w < 8; ++w) out[(size_t)lane * 8 + w] = r.v[w];
  }
}

template <class F1, class M>
void launch_prime(int op, int t, const void* a, const void* b, void* out, int n,
                  cudaStream_t s) {
  int blocks = (n + kThreads - 1) / kThreads;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  if (t == 1)
    prime_op_kernel<F1, M, 1><<<blocks, kThreads, 0, s>>>(op, pa, pb, (uint32_t*)out, n);
  else
    prime_op_kernel<F1, M, 4><<<blocks, kThreads, 0, s>>>(op, pa, pb, (uint32_t*)out, n);
}

}  // namespace

extern "C" {

// a, b, out: [n, 16] u16 limb rows on the device (4-byte aligned); field
// 0 = the P-256 prime p, 1 = its group order n, 2 = the Ed25519 prime
// 2^255 - 19; t: threads per group, 1 or 4 for the primes, 1 for n.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int mbt_field_op(int op, int field, int t, const void* a, const void* b,
                 void* out, int n, void* stream) {
  if (op < kMul || op > kIsZero || field < 0 || field > 2)
    return (int)cudaErrorInvalidValue;
  if (!(t == 1 || (field != 1 && t == 4)))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0) {
      launch_prime<P256F1, P256Mont>(op, t, a, b, out, n, s);
    } else if (field == 2) {
      launch_prime<EdF1, EdMont>(op, t, a, b, out, n, s);
    } else {
      int blocks = (n + kThreads - 1) / kThreads;
      order_op_kernel<<<blocks, kThreads, 0, s>>>(op, (const uint16_t*)a,
                                                  (const uint16_t*)b, (uint16_t*)out, n);
    }
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
