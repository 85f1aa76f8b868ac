// K5 test kernel: one SHA-256 compression per lane, so the device function
// of sha256.cuh that K6 inlines can be held against the plain PyTorch
// compress of minbft_tpu_torch/ops/sha256.py on the card.
//
// Replaces (as a checkable unit): minbft_tpu/ops/sha256.py compress_batch;
// see sha256.cuh for the bound and the design.  This kernel reads 96 bytes
// and writes 32 per lane; it exists for parity, not speed.

#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    sha256_compress_kernel(const uint32_t* __restrict__ state,
                           const uint32_t* __restrict__ block,
                           uint32_t* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t st[8], w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = state[(size_t)lane * 8 + i];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = block[(size_t)lane * 16 + i];
  sha256::compress(st, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[(size_t)lane * 8 + i] = st[i];
}

}  // namespace

extern "C" {

// state: [n, 8], block: [n, 16] (big-endian words), out: [n, 8]; all u32
// bit patterns on the device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mbt_sha256_compress(const void* state, const void* block, void* out,
                        int n, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    sha256_compress_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)state, (const uint32_t*)block, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
