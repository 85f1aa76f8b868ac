// K3: batched fixed-base k*G by the 64-window comb, one thread per lane.
//
// Replaces: minbft_tpu/ops/p256.py ecdsa_kg_kernel (_kg_comb_one over the
// host-built table _comb_table_np), a jax.vmap with the table closed over
// as a jit constant.  k = sum_j k_j 16^j; T[j][v] = v 16^j G (affine,
// Montgomery domain, the v = 0 rows zero); k*G = sum_j T[j][k_j] by 64
// mixed additions and no doublings.  The reference's madd and selects are
// kept, and exc folds to Z = 0 (the host signer takes such a lane), so the
// (X, Z) bits equal the reference's and the signatures built from them are
// byte-identical to hostcrypto.ecdsa_sign_py.
//
// Bound on the H100: integer multiply-add issue (64 madds of 11 field
// multiplies each, ~700 multiplies per lane) against 32 bytes read, 64
// written and 64 bytes of table per window step.  Design: the 64 KiB table
// ([64][16][2][8] u32 words) stays in global memory, where L1/L2 serve the
// lanes' divergent row reads (constant memory would serialise them); each
// step reads the selected row's 64 bytes as four 16-byte loads.  Staging
// the table in shared memory per block is the next step once the
// multiply side is faster.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kWindows = 64;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    p256_kg_kernel(const uint16_t* __restrict__ k,
                   const uint4* __restrict__ table,
                   uint16_t* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const uint16_t* kl = k + (size_t)lane * 16;
  const FieldConsts& f = kFieldP;

  Fe one = fe_load_const(f.one);
  Pt acc = {one, one, fe_zero()};
  bool exc = false;
  for (int j = 0; j < kWindows; ++j) {
    uint32_t v = ((uint32_t)kl[j >> 2] >> (4 * (j & 3))) & 0xFu;
    // Row T[j][v]: x then y, 8 words each = four uint4.
    const uint4* row = table + ((size_t)j * 16 + v) * 4;
    uint4 x0 = row[0], x1 = row[1], y0 = row[2], y1 = row[3];
    Fe ax = {{x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w}};
    Fe ay = {{y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w}};
    bool e;
    acc = pt_madd(acc, ax, ay, v == 0u, &e);
    exc = exc || e;
  }
  Fe z = fe_select(exc, fe_zero(), acc.z);
  uint16_t* o = out + (size_t)lane * 32;
  fe_to_u16(acc.x, o);
  fe_to_u16(z, o + 16);
}

}  // namespace

extern "C" {

// k: [n, 16] u16 nonce limbs; table: [64, 16, 2, 8] u32 words (64 KiB,
// 16-byte aligned); out: [n, 2, 16] u16 (X, Z).  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int mbt_p256_kg(const void* k, const void* table, void* out, int n,
                void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    p256_kg_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)k, (const uint4*)table, (uint16_t*)out, n);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
