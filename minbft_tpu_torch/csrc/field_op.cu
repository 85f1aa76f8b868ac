// K1 test kernel: one field op per lane, so the device field libraries
// that K2-K4, K7 and K8 inline can be held against the plain PyTorch ops
// of minbft_tpu_torch/ops/limbs.py (field_op_plain) on the card: mod the
// P-256 prime p through p256_field.cuh's ops specialised to p, at one
// thread per lane (P256F1) or in a group of 4 (P256Tasks: the multiplies
// of 4 lanes dealt out across the group and shared back), and
// mod the group order n and the Ed25519 prime 2^255 - 19 through
// field.cuh's generic ops.
//
// Replaces (as a checkable unit): the limb arithmetic of
// minbft_tpu/ops/limbs.py; see field.cuh and p256_field.cuh for the bound
// and the design.  This kernel itself is bound by launch latency and 96
// bytes of traffic per lane; it exists for parity, not speed.

#include <cuda_runtime.h>

#include "p256_field.cuh"

namespace {

// Op codes, in the order of limbs.FIELD_OPS.
enum Op {
  kMul = 0, kSqr, kAdd, kSub, kToMont, kFromMont, kInv, kSelect, kEq, kIsZero
};

constexpr int kThreads = 128;

template <int kField>
__global__ void __launch_bounds__(kThreads)
    field_op_kernel(int op, const uint16_t* __restrict__ a,
                    const uint16_t* __restrict__ b, uint16_t* __restrict__ out,
                    int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const FieldConsts& f = kField == 1 ? kOrderN : kFieldEd;
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

// Mod p, one lane per thread.  In a group of T threads (T consecutive
// lanes) the multiplying ops go through the group's muls: every thread
// gathers the T lanes' operands, the group computes the T products (one a
// thread) and shares them, and each thread keeps its own lane's.  The
// other ops are the one-thread ones.  Lanes past n compute lane n - 1's
// op and store nothing, so every group is whole.
template <int T>
__global__ void __launch_bounds__(kThreads)
    p256_op_kernel(int op, const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                   int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int src = lane < n ? lane : n - 1;
  P256Field<T> f;
  Fe x, y, r = fe_zero();
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    x.v[w] = a[(size_t)src * 8 + w];
    y.v[w] = b[(size_t)src * 8 + w];
  }
  bool multiplies = op == kMul || op == kSqr || op == kToMont || op == kFromMont;
  if constexpr (T > 1) {
    if (multiplies) {
      Fe by = op == kMul ? y : op == kSqr ? x
                             : p256_constant(op == kToMont ? kConstR2 : kConstUnit);
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
#pragma unroll
      for (int j = 0; j < T; ++j) r = fe_select(f.rank == (uint32_t)j, m[j], r);
    }
  }
  if (T == 1 || !multiplies) {
    switch (op) {
      case kMul: r = f.mul(x, y); break;
      case kSqr: r = f.sqr(x); break;
      case kAdd: r = f.add(x, y); break;
      case kSub: r = f.sub(x, y); break;
      case kToMont: r = f.to_mont(x); break;
      case kFromMont: r = f.from_mont(x); break;
      case kInv: r = p256_inv(f, x); break;
      case kSelect: r = f.select((x.v[0] & 1u) != 0u, x, y); break;
      case kEq: r.v[0] = f.eq(x, y) ? 1u : 0u; break;
      case kIsZero: r.v[0] = f.is_zero(x) ? 1u : 0u; break;
      default: break;
    }
  }
  if (lane < n) {
#pragma unroll
    for (int w = 0; w < 8; ++w) out[(size_t)lane * 8 + w] = r.v[w];
  }
}

template <int T>
void launch_p256(int op, const void* a, const void* b, void* out, int n,
                 cudaStream_t s) {
  int blocks = (n + kThreads - 1) / kThreads;
  p256_op_kernel<T><<<blocks, kThreads, 0, s>>>(
      op, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
}

}  // namespace

extern "C" {

// a, b, out: [n, 16] u16 limb rows on the device (4-byte aligned); field
// 0 = the P-256 prime p, 1 = its group order n, 2 = the Ed25519 prime
// 2^255 - 19; t: threads per group, 1 or 4 for field 0, 1 otherwise.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int mbt_field_op(int op, int field, int t, const void* a, const void* b,
                 void* out, int n, void* stream) {
  if (op < kMul || op > kIsZero || field < 0 || field > 2)
    return (int)cudaErrorInvalidValue;
  if (!(t == 1 || (field == 0 && t == 4)))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (field == 0) {
      if (t == 1) launch_p256<1>(op, a, b, out, n, s);
      else launch_p256<4>(op, a, b, out, n, s);
    } else {
      int blocks = (n + kThreads - 1) / kThreads;
      const uint16_t* pa = (const uint16_t*)a;
      const uint16_t* pb = (const uint16_t*)b;
      uint16_t* po = (uint16_t*)out;
      if (field == 1)
        field_op_kernel<1><<<blocks, kThreads, 0, s>>>(op, pa, pb, po, n);
      else
        field_op_kernel<2><<<blocks, kThreads, 0, s>>>(op, pa, pb, po, n);
    }
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
