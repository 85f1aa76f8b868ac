// K6, K6' and K6s: batched HMAC-SHA256 over 32-byte keys and messages.
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
// K6s: 64 read, 32 written).  That bound has all 132 SMs issuing.  The
// paths send 128 to 1,024 lanes (the bench 8,192): a few warps on the
// card, each with its scheduler to itself, so a lane takes its warp's own
// ALU issue, about 2,050 clocks a compression.
//
// Design: the chain is three compressions, not four.  The opad compression
// depends only on the key, and the msg block's schedule only on the
// message, so both run beside the ipad compression:
//   1. the ipad and opad compressions, and the msg block's K[t] + W[t];
//   2. the inner compression's 64 rounds alone;
//   3. the outer compression of inner || pad.
// A lane runs on 2 threads, at every batch: in stage 1 each thread
// compresses one pad block and the two states are swapped by
// __shfl_xor_sync; both threads then run stages 2 and 3 (the same
// instructions, so the warp does not diverge).  A thread issues three
// compressions, not four, and the card gets twice the warps.  What the
// pair costs: stages 2 and 3 run twice, which is free while the card is
// nearly empty and costs issue once it is full.  The paths send at most
// 8,192 lanes (the clusters' buckets at most 1,024, the bench 8,192), where
// the pair won at every batch; one thread per lane, with both pads in one
// instruction stream, was timed beside it and dropped: no faster than the
// four compressions in series at those batches, and ahead only at 16,384
// lanes, which no path sends (PERF.md section 6).  In stage 1 a thread's
// pad words 8-15 are one register (its rank's pad), not immediates; the
// tail blocks' words 8-15 are immediates, so their schedule terms fold.
// SASS (chip_smoke.py phase 1, cuobjdump) per thread of K6: 4,368
// instructions (2,974 SHF/LOP3) and a longest dependency chain of about
// 595.  Measured (chip_smoke.py phases 6 and 12, NVIDIA H100 80GB HBM3,
// 700.00 W; device time of a CUDA-graph replay, over this design's
// smokes): K6 0.0058-0.0070 ms at 512 lanes (0.0081 before), 0.0077-0.0078
// at 8,192 (0.0095), 0.0105-0.0107 at 16,384 (0.0098).
// Each 32-byte operand is read as two 16-byte loads (rows and [B, 8]
// arrays keep every operand 16-byte aligned); all state stays in
// registers; the key-pad compressions are recomputed per lane, as the
// reference does.

#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

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

// HMAC-SHA256(key32, msg32) -> out (8 state words), on the 2 threads of a
// lane (rank: this thread's place in the pair; mask: the pair's lanes in
// the warp).
__device__ __forceinline__ void hmac32(const uint32_t key[8],
                                       const uint32_t msg[8],
                                       uint32_t out[8], uint32_t rank,
                                       uint32_t mask) {
  // Stage 1: rank 0 compresses the ipad block, rank 1 the opad block,
  // beside the msg block's schedule (its K[t] + W[t]).
  uint32_t w[16], kw[64], inner[8], st[8];
  tail_block(w, msg);
  sha256::expand(w, kw);
  sha256::init(st);
  pad_block(w, key, rank ? kOpad : kIpad);
  sha256::compress(st, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t other = __shfl_xor_sync(mask, st[i], 1);
    inner[i] = rank ? other : st[i];
    out[i] = rank ? st[i] : other;
  }
  // Stage 2: the inner compression's rounds.
  sha256::compress_kw(inner, kw);
  // Stage 3: the outer compression of inner || pad.
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

}  // namespace

// The kernels and their launchers.  The lane code above also compiles for
// the host (tests/test_torch_hmac_lane.py runs it under g++).
#if defined(__CUDACC__)

namespace {

constexpr int kThreads = 128;

// This thread's lane, its rank in the lane's pair and the pair's lanes in
// the warp.
struct Lane {
  int lane;
  uint32_t rank, mask;
  __device__ __forceinline__ Lane() {
    lane = (int)((blockIdx.x * blockDim.x + threadIdx.x) / 2);
    rank = threadIdx.x & 1u;
    mask = 3u << ((threadIdx.x & 31u) - rank);
  }
};

__global__ void __launch_bounds__(kThreads)
    hmac_verify_kernel(const uint4* __restrict__ rows,
                       bool* __restrict__ out, int n) {
  Lane l;
  if (l.lane >= n) return;  // a whole pair
  const uint4* r = rows + (size_t)l.lane * 6;
  uint32_t key[8], msg[8], mac[8], got[8];
  load8(r, key);
  load8(r + 2, msg);
  load8(r + 4, mac);
  hmac32(key, msg, got, l.rank, l.mask);
  if (l.rank == 0) out[l.lane] = equal8(got, mac);
}

__global__ void __launch_bounds__(kThreads)
    hmac_verify_arrays_kernel(const uint4* __restrict__ keys,
                              const uint4* __restrict__ msgs,
                              const uint4* __restrict__ macs,
                              bool* __restrict__ out, int n) {
  Lane l;
  if (l.lane >= n) return;
  uint32_t key[8], msg[8], mac[8], got[8];
  load8(keys + (size_t)l.lane * 2, key);
  load8(msgs + (size_t)l.lane * 2, msg);
  load8(macs + (size_t)l.lane * 2, mac);
  hmac32(key, msg, got, l.rank, l.mask);
  if (l.rank == 0) out[l.lane] = equal8(got, mac);
}

__global__ void __launch_bounds__(kThreads)
    hmac_sign_kernel(const uint4* __restrict__ keys,
                     const uint4* __restrict__ msgs,
                     uint4* __restrict__ out, int n) {
  Lane l;
  if (l.lane >= n) return;
  uint32_t key[8], msg[8], mac[8];
  load8(keys + (size_t)l.lane * 2, key);
  load8(msgs + (size_t)l.lane * 2, msg);
  hmac32(key, msg, mac, l.rank, l.mask);
  if (l.rank == 0) {
    uint4* o = out + (size_t)l.lane * 2;
    o[0] = make_uint4(mac[0], mac[1], mac[2], mac[3]);
    o[1] = make_uint4(mac[4], mac[5], mac[6], mac[7]);
  }
}

// Blocks for n lanes on 2 threads each.
int blocks_for(int n) { return (int)(((long long)n * 2 + kThreads - 1) / kThreads); }

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
        (const uint4*)keys, (const uint4*)msgs, (const uint4*)macs, (bool*)out,
        n);
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

#endif  // __CUDACC__
