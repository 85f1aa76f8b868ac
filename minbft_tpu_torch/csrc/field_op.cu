// K1 test kernel: one field op of csrc/field.cuh per lane, so the device
// library that K2, K3, K7 and K8 inline can be held against the plain
// PyTorch ops of minbft_tpu_torch/ops/limbs.py (field_op_plain) on the
// card, mod each of its three moduli.
//
// Replaces (as a checkable unit): the limb arithmetic of
// minbft_tpu/ops/limbs.py; see field.cuh for the bound and the design.
// This kernel itself is bound by launch latency and 96 bytes of traffic
// per lane; it exists for parity, not speed.

#include <cuda_runtime.h>

#include "field.cuh"

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
  const FieldConsts& f =
      kField == 0 ? kFieldP : kField == 1 ? kOrderN : kFieldEd;
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

}  // namespace

extern "C" {

// a, b, out: [n, 16] u16 limb rows on the device; field 0 = the P-256
// prime p, 1 = its group order n, 2 = the Ed25519 prime 2^255 - 19.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int mbt_field_op(int op, int field, const void* a, const void* b, void* out,
                 int n, void* stream) {
  if (op < kMul || op > kIsZero || field < 0 || field > 2)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    cudaStream_t s = (cudaStream_t)stream;
    const uint16_t* pa = (const uint16_t*)a;
    const uint16_t* pb = (const uint16_t*)b;
    uint16_t* po = (uint16_t*)out;
    if (field == 0)
      field_op_kernel<0><<<blocks, kThreads, 0, s>>>(op, pa, pb, po, n);
    else if (field == 1)
      field_op_kernel<1><<<blocks, kThreads, 0, s>>>(op, pa, pb, po, n);
    else
      field_op_kernel<2><<<blocks, kThreads, 0, s>>>(op, pa, pb, po, n);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
