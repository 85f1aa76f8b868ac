// K8: batched fixed-base r*B by the 64-window comb, one thread per lane.
//
// Replaces: minbft_tpu/ops/ed25519.py ed25519_rb_kernel (_rb_comb_one
// over the host-built table _comb_table_np), a jax.vmap with the table
// closed over as a jit constant.  r = sum_j r_j 16^j; T[j][v] = v 16^j B
// as affine (x, y, t = xy), Montgomery domain, the v = 0 rows the
// identity (0, 1, 0); r*B = sum_j T[j][r_j] by 64 complete additions onto
// the identity, no doublings and no flags.  The reference's _add is kept
// op for op, so the projective (X, Y, Z) bits equal the reference's and
// the signatures built from them are byte-identical to
// hostcrypto.ed25519_sign.
//
// Bound on the H100: integer multiply-add issue, against 32 bytes read
// and 96 written per lane and the 96 KiB table read once.  chip_smoke.py
// (k8_imads) counts what the function needs, about 64,600 IMAD issues
// per lane: mixed adds (2d*t stored in the table, Z = 1) of products
// with the reduction special to 2^255 - 19.  This kernel does 64 general
// adds of 9 generic CIOS multiplies (576 x 257 issues).  Design as K3's: the
// table ([64][16][3][8] u32 words) stays in global memory, where L1/L2
// serve the lanes' divergent row reads (constant memory would serialise
// them, and 96 KiB is past its 64 KiB); each step reads the selected
// 96-byte row as six 16-byte loads.

#include <cuda_runtime.h>

#include "ed25519.cuh"

namespace {

constexpr int kWindows = 64;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    ed25519_rb_kernel(const uint16_t* __restrict__ r,
                      const uint4* __restrict__ table,
                      uint16_t* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const uint16_t* rl = r + (size_t)lane * 16;

  Fe one = fe_load_const(kFieldEd.one);
  EdPt acc = ed_identity();
  for (int j = 0; j < kWindows; ++j) {
    uint32_t v = ((uint32_t)rl[j >> 2] >> (4 * (j & 3))) & 0xFu;
    // Row T[j][v]: x, y, t, 8 words each = six uint4.
    const uint4* row = table + ((size_t)j * 16 + v) * 6;
    uint4 x0 = row[0], x1 = row[1], y0 = row[2], y1 = row[3];
    uint4 t0 = row[4], t1 = row[5];
    Fe qx = {{x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w}};
    Fe qy = {{y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w}};
    Fe qt = {{t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w}};
    EdPt q = {qx, qy, one, qt};
    acc = ed_add(acc, q);
  }
  uint16_t* o = out + (size_t)lane * 48;
  fe_to_u16(acc.x, o);
  fe_to_u16(acc.y, o + 16);
  fe_to_u16(acc.z, o + 32);
}

}  // namespace

extern "C" {

// r: [n, 16] u16 nonce limbs; table: [64, 16, 3, 8] u32 words (96 KiB,
// 16-byte aligned); out: [n, 3, 16] u16 (X, Y, Z).  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int mbt_ed25519_rb(const void* r, const void* table, void* out, int n,
                   void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    ed25519_rb_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)r, (const uint4*)table, (uint16_t*)out, n);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
