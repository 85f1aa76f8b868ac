// K4: batched k*G by the 256-step double-then-add ladder, one thread per
// lane.
//
// Replaces: minbft_tpu/ops/p256.py ecdsa_kg_ladder_kernel (_kg_one), a
// jax.vmap of a scalar program over [B, 16] u32 nonce limbs, which the
// reference keeps as the differential reference of the comb K3.  From bit
// 255 down: acc = dbl(acc); acc = madd(acc, G, q_inf = (bit == 0)); the
// exc flags are ORed together and fold to Z = 0 at the end (for a nonce
// below n no partial sum equals G, so it never fires; a hit would send the
// lane to sign_finish's host signer).  The reference's dbl and madd are
// kept op for op (csrc/p256_field.cuh pt_dbl_madd), so (X, Z), Jacobian in
// the Montgomery domain, equals the reference's bit for bit, not only after
// normalisation.  Output: [B, 2, 16] u16 limbs, K3's layout, so
// sign_finish takes either kernel's output; the values are the reference's
// u32 limbs (each < 2^16).
//
// Bound on the H100: integer multiply-add issue.  Per lane: 256 doublings
// and one mixed add per 1-bit, no inversion, against 32 bytes read and 64
// written; chip_smoke.py (k4_imads) counts what the function needs on each
// run's nonces.  This kernel does more: it runs the madd for every bit
// (the q_inf select discards it), as the reference does.  Design: as K2's
// ladder without the Q half: G is a compile-time constant, the nonce's
// words are pulled by selects, everything stays in registers, on the
// one-thread field ops specialised to p (P256F1 in p256_field.cuh).

#include <cuda_runtime.h>

#include "p256_field.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    p256_kg_ladder_kernel(const uint16_t* __restrict__ k,
                          uint16_t* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  P256F1 f;
  Fe kw = fe_from_u16(k + (size_t)lane * 16);

  Fe one = f.one();
  Fe gx = f.gx();
  Fe gy = f.gy();
  Pt acc = {one, one, fe_zero()};
  bool exc = false;
  for (int w = 7; w >= 0; --w) {
    uint32_t word = fe_word(kw, w);
    for (int i = 31; i >= 0; --i) {
      bool e;
      acc = pt_dbl_madd(f, acc, gx, gy, ((word >> i) & 1u) == 0u, &e);
      exc = exc || e;
    }
  }
  Fe z = fe_select(exc, fe_zero(), acc.z);
  uint16_t* o = out + (size_t)lane * 32;
  fe_to_u16(acc.x, o);
  fe_to_u16(z, o + 16);
}

}  // namespace

extern "C" {

// k: [n, 16] u16 nonce limbs; out: [n, 2, 16] u16 (X, Z).  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int mbt_p256_kg_ladder(const void* k, void* out, int n, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    p256_kg_ladder_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)k, (uint16_t*)out, n);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
