// K3: batched fixed-base k*G by the 64-window comb, T threads per lane
// (T = 1 or 4, the launcher's choice by batch).
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
// Bound on the H100: integer multiply-add issue (about 63 madds of 11
// field multiplies a lane, chip_smoke.py k3_imads) against 32 bytes read,
// 64 written and 64 bytes of table per window.  As for K2, the one-thread
// design was latency-bound at the deployment bucket (16 warps on the card),
// with each window's table row fetched from global memory on the
// dependent chain.  Design: p256_field.cuh's ops specialised to p; at
// small batches a lane on a group of 4 threads that share out the
// independent multiplies of each madd level (11 multiplies in 5 levels);
// the next window's row loaded one window ahead, while the current madd
// runs.  The 64 KiB table ([64][16][2][8] u32 words) stays in global
// memory, where L1/L2 serve the divergent row reads.

#include <cuda_runtime.h>

#include "p256_field.cuh"

namespace {

constexpr int kWindows = 64;

// Nibble j (0..63) of the nonce words.
__device__ __forceinline__ uint32_t nibble(const Fe& k, int j) {
  return (fe_word(k, j >> 3) >> (4 * (j & 7))) & 0xFu;
}

// Row T[j][v]: x then y, 8 words each, as four 16-byte reads.
__device__ __forceinline__ void load_row(const uint4* __restrict__ table, int j,
                                         uint32_t v, Fe* x, Fe* y) {
  const uint4* row = table + ((size_t)j * 16 + v) * 4;
  uint4 x0 = row[0], x1 = row[1], y0 = row[2], y1 = row[3];
  *x = {{x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w}};
  *y = {{y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w}};
}

// One lane's k*G from its nonce row (16 u16 limbs, 16-byte aligned): X
// and Z (Z = 0 where a madd hit its undefined case).
template <class F>
__device__ __forceinline__ Pt kg_lane(const F& f, const uint16_t* k,
                                      const uint4* __restrict__ table) {
  // The nonce: two 16-byte reads of the 32-byte row.
  const uint4* kp = reinterpret_cast<const uint4*>(k);
  uint4 k0 = kp[0], k1 = kp[1];
  Fe kw = {{k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w}};

  Pt acc = {f.one(), f.one(), f.zero()};
  bool exc = false;
  uint32_t v = nibble(kw, 0);
  Fe ax, ay;
  load_row(table, 0, v, &ax, &ay);
#pragma unroll 1
  for (int j = 0; j < kWindows; ++j) {
    // Window j + 1's row, loaded while window j's madd runs.
    uint32_t v_next = j + 1 < kWindows ? nibble(kw, j + 1) : 0u;
    Fe nx, ny;
    load_row(table, j + 1 < kWindows ? j + 1 : j, v_next, &nx, &ny);
    bool e;
    acc = pt_madd(f, acc, ax, ay, v == 0u, &e);
    exc = exc || e;
    v = v_next;
    ax = nx;
    ay = ny;
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
    p256_kg_kernel(const uint16_t* __restrict__ k,
                   const uint4* __restrict__ table,
                   uint32_t* __restrict__ out, int n) {
  int lane = (blockIdx.x * blockDim.x + threadIdx.x) / T;
  if (lane >= n) return;  // a whole group
  P256Field<T> f;
  Pt r = kg_lane(f, k + (size_t)lane * 16, table);
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
void launch(const void* k, const void* table, void* out, int n, cudaStream_t s) {
  int blocks = (int)(((long long)n * T + kThreads - 1) / kThreads);
  p256_kg_kernel<T><<<blocks, kThreads, 0, s>>>(
      (const uint16_t*)k, (const uint4*)table, (uint32_t*)out, n);
}

}  // namespace

extern "C" {

// k: [n, 16] u16 nonce limbs (32-byte rows, 16-byte aligned); table:
// [64, 16, 2, 8] u32 words (64 KiB, 16-byte aligned); out: [n, 2, 16] u16
// (X, Z); t: threads per lane (1 or 4).  Launches on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for another t).
int mbt_p256_kg(const void* k, const void* table, void* out, int n, int t,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (t != 1 && t != 4) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (t == 1) launch<1>(k, table, out, n, s);
    else launch<4>(k, table, out, n, s);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#endif  // __CUDACC__
