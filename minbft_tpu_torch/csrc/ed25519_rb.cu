// K8: batched fixed-base r*B by the 64-window comb, a group of 4 threads
// per lane.
//
// Replaces: minbft_tpu/ops/ed25519.py ed25519_rb_kernel (_rb_comb_one
// over the host-built table _comb_table_np), a jax.vmap with the table
// closed over as a jit constant.  r = sum_j r_j 16^j; T[j][v] = v 16^j B
// (affine, the v = 0 rows the identity (0, 1, 0)); r*B = sum_j T[j][r_j]
// by 64 complete additions onto the identity, no doublings and no flags.
// The output is the projective (X, Y, Z) in the Montgomery domain, so the
// reference's _add is kept value for value: every op of ed25519_field.cuh
// is exact and fully reduced, and what differs gives the same integers:
// - the table holds each row's addend terms (y - x, y + x, 2d*t), plain
//   (ed25519.comb_table_words builds them from the reference's table);
// - the adds are mixed (the rows' z is 1, and the reference's z1 * 1 is
//   z1): 3 products, then 4;
// - the first add, onto the identity, is its own values: X = 2e, Y = 2h,
//   Z = 4, T = e*h with e = 2x, h = 2y (one product);
// - the result is mapped to the Montgomery domain by a multiply by 38
//   (2^256 mod p) at the end.
// So (X, Y, Z) equals the reference's bit for bit, every zero nibble's
// add of the identity included (it scales the point by 4Z, and the sign
// path's bits keep it), and the signatures built from it are
// byte-identical to hostcrypto.ed25519_sign.
//
// Bound on the H100: integer multiply-add issue (chip_smoke.py k8_imads:
// 63 mixed adds a lane, cheaper for the identity's rows) against 32 bytes
// read, 96 written and 96 bytes of table per window.  The one-thread
// design ran 64 general adds of 9 generic multiplies on a chain bound by
// latency (at 1,024 lanes 32 warps on the card).  Design, as K3's:
// - ed25519_field.cuh's ops specialised to 2^255 - 19;
// - a lane on a group of 4 threads that share out each add's products (2
//   levels a window); on the H100 the group beat one thread per lane at
//   every batch checked, 1,024 to 32,768 lanes (PERF.md section 6);
// - the next window's row loaded one window ahead, while the current add
//   runs;
// - __launch_bounds__ with 4 blocks an SM: the same occupancy as without
//   it (~120 registers), no spills, and a schedule from ptxas that ran
//   faster at every batch measured (PERF.md section 6);
// - the table ([64][16][3][8] u32 words, 96 KiB) in global memory, where
//   L1/L2 serve the lanes' divergent row reads (constant memory would
//   serialise them, and 96 KiB is past its 64 KiB).

#include <cuda_runtime.h>

#include "ed25519.cuh"

namespace {

constexpr int kWindows = 64;

// Nibble j (0..63) of the nonce words.
__device__ __forceinline__ uint32_t nibble(const Fe& r, int j) {
  return (fe_word(r, j >> 3) >> (4 * (j & 7))) & 0xFu;
}

struct Row {
  Fe ymx, ypx, t2d;
};

// Row T[j][v]: y - x, y + x, 2d*t, 8 words each, as six 16-byte reads.
__device__ __forceinline__ Row load_row(const uint4* __restrict__ table, int j,
                                        uint32_t v) {
  const uint4* p = table + ((size_t)j * 16 + v) * 6;
  uint4 a0 = p[0], a1 = p[1], b0 = p[2], b1 = p[3], c0 = p[4], c1 = p[5];
  return {{{a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w}},
          {{b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w}},
          {{c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w}}};
}

// One lane's r*B from its nonce row (16 u16 limbs, 16-byte aligned):
// (X, Y, Z) in the Montgomery domain.
template <class F>
__device__ __forceinline__ EdPt rb_lane(const F& f, const uint16_t* r,
                                        const uint4* __restrict__ table) {
  // The nonce: two 16-byte reads of the 32-byte row.
  const uint4* rp = reinterpret_cast<const uint4*>(r);
  uint4 r0 = rp[0], r1 = rp[1];
  Fe rw = {{r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w}};

  // Window 0 onto the identity (0 : 1 : 1 : 0): e = 2x, h = 2y, F = G = 2.
  Row q = load_row(table, 0, nibble(rw, 0));
  Fe e = f.sub(q.ypx, q.ymx), h = f.add(q.ypx, q.ymx);
  EdPt acc = {f.add(e, e), f.add(h, h), ed_small(4u), f.mul(e, h)};
  q = load_row(table, 1, nibble(rw, 1));
#pragma unroll 1
  for (int j = 1; j < kWindows; ++j) {
    // Window j + 1's row, loaded while window j's add runs.
    int jn = j + 1 < kWindows ? j + 1 : j;
    Row next = load_row(table, jn, nibble(rw, jn));
    acc = ed_madd(f, acc, q.ymx, q.ypx, q.t2d);
    q = next;
  }
  return {f.to_mont(acc.x), f.to_mont(acc.y), f.to_mont(acc.z), acc.t};
}

}  // namespace

// The kernel and its launcher.  The lane code above also compiles for the
// host (tests/test_torch_ed25519_field.py runs it under g++).
#if defined(__CUDACC__)

namespace {

constexpr int kThreads = 128;

constexpr int kGroup = 4;  // threads per lane

__global__ void __launch_bounds__(kThreads, 4)
    ed25519_rb_kernel(const uint16_t* __restrict__ r,
                      const uint4* __restrict__ table,
                      uint32_t* __restrict__ out, int n) {
  int lane = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (lane >= n) return;  // a whole group
  EdTasks f;
  EdPt p = rb_lane(f, r + (size_t)lane * 16, table);
  // Output [n, 3, 16] u16 limbs = [n, 3, 8] words (little-endian pairs).
  if (f.leader()) {
    uint32_t* o = out + (size_t)lane * 24;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      o[w] = p.x.v[w];
      o[8 + w] = p.y.v[w];
      o[16 + w] = p.z.v[w];
    }
  }
}

}  // namespace

extern "C" {

// r: [n, 16] u16 nonce limbs (32-byte rows, 16-byte aligned); table:
// [64, 16, 3, 8] u32 words (96 KiB, 16-byte aligned: comb_table_words);
// out: [n, 3, 16] u16 (X, Y, Z).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mbt_ed25519_rb(const void* r, const void* table, void* out, int n,
                   void* stream) {
  if (n > 0) {
    int blocks = (int)(((long long)n * kGroup + kThreads - 1) / kThreads);
    ed25519_rb_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)r, (const uint4*)table, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#endif  // __CUDACC__
