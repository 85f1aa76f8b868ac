// K6, K6' and K6s: batched HMAC-SHA256 over 32-byte keys and messages, one
// thread per lane.
//
// Replaces: minbft_tpu/ops/hmac_sha256.py hmac_verify_kernel_packed (K6,
// over packed [B, 24] u32 rows of key | msg | mac), hmac_verify_kernel
// (K6', the same verify over three [B, 8] u32 arrays) and hmac_sign_kernel
// (K6s, keys and msgs [B, 8] -> macs [B, 8]), each a jax.vmap of hmac32.
// All words are big-endian.  RFC 2104 with a 64-byte block and a 32-byte
// key and message is exactly four compressions (K5), in hmac32 below,
// which the three launchers share:
//   inner = H((key ^ ipad) || msg || pad), mac' = H((key ^ opad) || inner
//   || pad), with pad the reference's _TAIL (0x80, zeros, bit length 768);
// a verify lane is true iff mac' equals its mac word for word, a sign lane
// writes mac'.
//
// Bound on the H100: 32-bit integer issue on the ALU pipe, 4,121 SHF/LOP3
// per verify lane (four compressions of 1,024, 25 for the pads and the
// compare; see sha256.cuh) against 97 bytes moved (96 read, 1 written;
// K6s: 64 read, 32 written).  Design: each 32-byte operand is read as two
// 16-byte loads (rows and [B, 8] arrays keep every operand 16-byte
// aligned); all state stays in registers; the two key-pad compressions are
// recomputed per lane, as the reference does (caching them per key is a
// later optimisation).  At the cluster's batch sizes the launch and the
// round trip dominate, not this arithmetic.

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

// HMAC-SHA256(key32, msg32) -> out (8 state words).
__device__ __forceinline__ void hmac32(const uint32_t key[8],
                                       const uint32_t msg[8],
                                       uint32_t out[8]) {
  uint32_t w[16], inner[8];
  sha256::init(inner);
  pad_block(w, key, kIpad);
  sha256::compress(inner, w);
  tail_block(w, msg);
  sha256::compress(inner, w);

  sha256::init(out);
  pad_block(w, key, kOpad);
  sha256::compress(out, w);
  tail_block(w, inner);
  sha256::compress(out, w);
}

// 8 words from two 16-byte loads.
__device__ __forceinline__ void load8(const uint4* p, uint32_t out[8]) {
  uint4 a = p[0], b = p[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ bool equal8(const uint32_t a[8],
                                       const uint32_t b[8]) {
  uint32_t diff = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) diff |= a[i] ^ b[i];
  return diff == 0u;
}

__global__ void __launch_bounds__(kThreads)
    hmac_verify_kernel(const uint4* __restrict__ rows,
                       bool* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const uint4* r = rows + (size_t)lane * 6;
  uint32_t key[8], msg[8], mac[8], got[8];
  load8(r, key);
  load8(r + 2, msg);
  load8(r + 4, mac);
  hmac32(key, msg, got);
  out[lane] = equal8(got, mac);
}

__global__ void __launch_bounds__(kThreads)
    hmac_verify_arrays_kernel(const uint4* __restrict__ keys,
                              const uint4* __restrict__ msgs,
                              const uint4* __restrict__ macs,
                              bool* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t key[8], msg[8], mac[8], got[8];
  load8(keys + (size_t)lane * 2, key);
  load8(msgs + (size_t)lane * 2, msg);
  load8(macs + (size_t)lane * 2, mac);
  hmac32(key, msg, got);
  out[lane] = equal8(got, mac);
}

__global__ void __launch_bounds__(kThreads)
    hmac_sign_kernel(const uint4* __restrict__ keys,
                     const uint4* __restrict__ msgs,
                     uint4* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t key[8], msg[8], mac[8];
  load8(keys + (size_t)lane * 2, key);
  load8(msgs + (size_t)lane * 2, msg);
  hmac32(key, msg, mac);
  uint4* o = out + (size_t)lane * 2;
  o[0] = make_uint4(mac[0], mac[1], mac[2], mac[3]);
  o[1] = make_uint4(mac[4], mac[5], mac[6], mac[7]);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// rows: [n, 24] u32 bit patterns (key | msg | mac, big-endian words),
// 16-byte aligned; out: [n] bool.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mbt_hmac_sha256_verify(const void* rows, void* out, int n, void* stream) {
  if (n > 0) {
    hmac_verify_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)rows, (bool*)out, n);
  }
  return (int)cudaGetLastError();
}

// keys, msgs, macs: [n, 8] u32 big-endian words, each 16-byte aligned;
// out: [n] bool.  Launches on `stream` and returns cudaGetLastError().
int mbt_hmac_sha256_verify_arrays(const void* keys, const void* msgs,
                                  const void* macs, void* out, int n,
                                  void* stream) {
  if (n > 0) {
    hmac_verify_arrays_kernel<<<blocks_for(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const uint4*)keys, (const uint4*)msgs, (const uint4*)macs,
        (bool*)out, n);
  }
  return (int)cudaGetLastError();
}

// keys, msgs: [n, 8] u32 big-endian words, 16-byte aligned; out: [n, 8]
// u32 MACs, 16-byte aligned.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mbt_hmac_sha256_sign(const void* keys, const void* msgs, void* out, int n,
                         void* stream) {
  if (n > 0) {
    hmac_sign_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)keys, (const uint4*)msgs, (uint4*)out, n);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
