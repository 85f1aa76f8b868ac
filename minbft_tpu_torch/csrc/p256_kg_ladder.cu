// K4: batched k*G by the 256-step double-then-add ladder, T threads per
// lane (T = 1 or 4, the launcher's choice by batch).
//
// Replaces: minbft_tpu/ops/p256.py ecdsa_kg_ladder_kernel (_kg_one), a
// jax.vmap of a scalar program over [B, 16] u32 nonce limbs, which the
// reference keeps as the differential reference of the comb K3.  From bit
// 255 down: acc = dbl(acc); acc = madd(acc, G, q_inf = (bit == 0)); the
// exc flags are ORed together and fold to Z = 0 at the end (for a nonce
// below n no partial sum equals G, so it never fires; a hit would send the
// lane to sign_finish's host signer).  The reference's dbl and madd are
// kept op for op (csrc/p256_field.cuh pt_dbl_madd), and the madd runs on
// every bit, its result discarded by the q_inf select for a 0 bit: the work
// does not depend on the nonce's bits and no thread branches on one.  So
// (X, Z), Jacobian in the Montgomery domain, equals the reference's bit for
// bit, not only after normalisation.  Output: [B, 2, 16] u16 limbs, K3's
// layout, so sign_finish takes either kernel's output.
//
// Bound on the H100: integer multiply-add issue.  Per lane: 256 doublings
// and one mixed add per 1-bit, no inversion, against 32 bytes read and 64
// written; chip_smoke.py (k4_imads) counts what the function needs on each
// run's nonces.  A lane is one serial chain of 256 fused steps, 19
// multiplies each.  Design: K2's ladder without the Q half, on the field
// ops specialised to p (p256_field.cuh).  At small batches a lane runs on a
// group of 4 threads that share out each step's multiplies: 7 levels
// (2, 4, 2, 3, 3, 3, 2) in place of 19 in series.  Above p256.GROUP_LIMIT
// lanes the card is full and one thread per lane wins, as for K2 and K3.
// Measured (chip_smoke.py phase 11, NVIDIA H100 80GB HBM3, 700.00 W;
// device time of a CUDA-graph replay): at 512 lanes T = 4 0.818 ms, T = 1
// 1.578 (1.549 before, when one thread per lane was the only form); at
// 16,384 T = 1 1.915 (1.915), T = 4 2.741.  150 registers at T = 4, 128 at
// T = 1, no stack frame or spills.

#include <cuda_runtime.h>

#include "p256_field.cuh"

namespace {

// One lane's k*G from its nonce row (16 u16 limbs, 16-byte aligned): X
// and Z (Z = 0 where a madd hit its undefined case).
template <class F>
__device__ __forceinline__ Pt kg_ladder_lane(const F& f, const uint16_t* k) {
  // The nonce: two 16-byte reads of the 32-byte row.
  const uint4* kp = reinterpret_cast<const uint4*>(k);
  uint4 k0 = kp[0], k1 = kp[1];
  Fe kw = {{k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w}};

  Fe gx = f.gx(), gy = f.gy();
  Pt acc = {f.one(), f.one(), f.zero()};
  bool exc = false;
#pragma unroll 1
  for (int w = 7; w >= 0; --w) {
    uint32_t word = fe_word(kw, w);
#pragma unroll 1
    for (int i = 31; i >= 0; --i) {
      bool e;
      acc = pt_dbl_madd(f, acc, gx, gy, ((word >> i) & 1u) == 0u, &e);
      exc = exc || e;
    }
  }
  acc.z = f.select(exc, f.zero(), acc.z);
  return acc;
}

}  // namespace

// The kernel and its launcher.  The lane code above also compiles for the
// host (tests/test_torch_p256_field.py runs it under g++).
#if defined(__CUDACC__)

namespace {

constexpr int kThreads = 128;

template <int T>
__global__ void __launch_bounds__(kThreads)
    p256_kg_ladder_kernel(const uint16_t* __restrict__ k,
                          uint32_t* __restrict__ out, int n) {
  int lane = (blockIdx.x * blockDim.x + threadIdx.x) / T;
  if (lane >= n) return;  // a whole group
  P256Field<T> f;
  Pt r = kg_ladder_lane(f, k + (size_t)lane * 16);
  // Output [n, 2, 16] u16 limbs = [n, 2, 8] words (little-endian pairs).
  if (f.leader()) {
    uint32_t* o = out + (size_t)lane * 16;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      o[w] = r.x.v[w];
      o[8 + w] = r.z.v[w];
    }
  }
}

template <int T>
void launch(const void* k, void* out, int n, cudaStream_t s) {
  int blocks = (int)(((long long)n * T + kThreads - 1) / kThreads);
  p256_kg_ladder_kernel<T><<<blocks, kThreads, 0, s>>>(
      (const uint16_t*)k, (uint32_t*)out, n);
}

}  // namespace

extern "C" {

// k: [n, 16] u16 nonce limbs (32-byte rows, 16-byte aligned); out:
// [n, 2, 16] u16 (X, Z); t: threads per lane (1 or 4).  Launches on
// `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for another t).
int mbt_p256_kg_ladder(const void* k, void* out, int n, int t, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (t != 1 && t != 4) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (t == 1) launch<1>(k, out, n, s);
    else launch<4>(k, out, n, s);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#endif  // __CUDACC__
