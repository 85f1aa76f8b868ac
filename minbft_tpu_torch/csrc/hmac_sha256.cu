// K6: batched HMAC-SHA256 verify over packed [B, 24] u32 rows, one thread
// per lane.
//
// Replaces: minbft_tpu/ops/hmac_sha256.py hmac_verify_kernel_packed (via
// hmac32_verify and hmac32), a jax.vmap over the batch.  Each row holds
// key (8 words) | msg (8) | mac (8), big-endian.  RFC 2104 with a 64-byte
// block and a 32-byte key and message is exactly four compressions (K5):
//   inner = H((key ^ ipad) || msg || pad), mac' = H((key ^ opad) || inner
//   || pad), with pad the reference's _TAIL (0x80, zeros, bit length 768);
// the lane is true iff mac' equals the row's mac word for word.
//
// Bound on the H100: 32-bit integer issue on the ALU pipe, 4,121 SHF/LOP3
// per lane (four compressions of 1,024, 25 for the pads and the compare;
// see sha256.cuh) against 97 bytes moved (96 read, 1 written).
// Design: the row is read as six 16-byte loads (rows are 96 bytes, so
// every row starts 16-byte aligned); all state stays in registers; the two
// key-pad compressions are recomputed per lane, as the reference does
// (caching them per key is a later optimisation).  At the cluster's batch
// sizes the launch and the round trip dominate, not this arithmetic.

#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kIpad = 0x36363636u;
constexpr uint32_t kOpad = 0x5C5C5C5Cu;

// Second block of both hashes: 8 data words, then 0x80, zeros and the
// bit length of 64 + 32 bytes.
__device__ __forceinline__ void tail_block(uint32_t w[16],
                                           const uint32_t data[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = data[i];
  w[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; ++i) w[i] = 0u;
  w[15] = 768u;
}

__device__ __forceinline__ void pad_block(uint32_t w[16],
                                          const uint32_t key[8],
                                          uint32_t pad) {
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = key[i] ^ pad;
#pragma unroll
  for (int i = 8; i < 16; ++i) w[i] = pad;
}

__global__ void __launch_bounds__(kThreads)
    hmac_verify_kernel(const uint4* __restrict__ rows,
                       bool* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const uint4* r = rows + (size_t)lane * 6;
  uint32_t row[24];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    uint4 v = r[i];
    row[4 * i] = v.x; row[4 * i + 1] = v.y;
    row[4 * i + 2] = v.z; row[4 * i + 3] = v.w;
  }
  const uint32_t* key = row;
  const uint32_t* msg = row + 8;
  const uint32_t* mac = row + 16;

  uint32_t w[16], inner[8], outer[8];
  sha256::init(inner);
  pad_block(w, key, kIpad);
  sha256::compress(inner, w);
  tail_block(w, msg);
  sha256::compress(inner, w);

  sha256::init(outer);
  pad_block(w, key, kOpad);
  sha256::compress(outer, w);
  tail_block(w, inner);
  sha256::compress(outer, w);

  uint32_t diff = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) diff |= outer[i] ^ mac[i];
  out[lane] = diff == 0u;
}

}  // namespace

extern "C" {

// rows: [n, 24] u32 bit patterns (key | msg | mac, big-endian words),
// 16-byte aligned; out: [n] bool.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mbt_hmac_sha256_verify(const void* rows, void* out, int n, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    hmac_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)rows, (bool*)out, n);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
