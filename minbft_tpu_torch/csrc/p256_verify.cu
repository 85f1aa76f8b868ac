// K2 and K2': batched ECDSA-P256 verification, T threads per lane
// (T = 1 or 4, the launcher's choice by batch).
//
// Replaces: minbft_tpu/ops/p256.py ecdsa_verify_kernel_packed (K2:
// _verify_one_packed -> _verify_one -> _shamir, _dbl, _madd,
// _madd_complete_table), a jax.vmap of a scalar program over [B, 98] u16
// rows, and ecdsa_verify_kernel = _verify_batch (K2': the same _verify_one
// over eight arrays, qx qy u1 u2 r r2 [B, 16] u32 limbs and r2_ok valid
// [B] bool).  One lane function, verify_lane, serves both launchers and
// every group size, as _verify_one serves both reference forms; only the
// reads differ.  Same algorithm, same point formulas and exceptional-case
// handling, and every field op returns the reference's bits, so the
// verdict of every lane (adversarial ones included) equals the
// reference's:
//   accept iff X == r*Z^2 or (r2_ok and X == r2*Z^2), and Z != 0, and no
//   incomplete add hit its undefined case (exc), and the host's range
//   checks passed (valid).
//
// Bound on the H100: integer multiply-add issue, about 427,000 IMAD issues
// per valid lane (chip_smoke.py k2_imads) against 196 bytes read and 1
// written (K2'; 392 + 2 read).  What held the one-thread-per-lane design
// back was latency, not issue: a lane is one serial chain of 256 ladder
// steps, and at the deployment bucket (512) its 16 warps leave every
// scheduler with one warp, so each dependent instruction waits out its
// latency; the generic CIOS reduction, full-cost squarings and the
// square-and-multiply inversion lengthened that chain.  Design:
// - the field ops of p256_field.cuh, specialised to p at compile time
//   (no reduction products, 36-product squarings, a 12-multiply
//   inversion chain, column-sum products nvcc can overlap);
// - a ladder step is one pt_dbl_madd, the doubling's last multiplies
//   beside the madd's first (7 levels of independent multiplies);
// - at small batches a lane runs on a group of 4 threads that share out
//   each level's multiplies (P256Tasks), so the lane's chain is 7
//   multiplies deep a step, not 19; at large batches T = 1, where the
//   card is full and the group's idle and duplicated work would cost
//   issue;
// - the row is read as u32 words of the u16 limbs; a lane with valid = 0
//   returns at once (its verdict is false), so padding costs nothing.

#include <cuda_runtime.h>

#include "p256_field.cuh"

namespace {

constexpr int kCols = 98;  // qx qy u1 u2 r r2 (16 limbs each) | r2_ok valid

// K2's row: [98] u16, 4-byte aligned (196 bytes a row), read as words.
struct PackedRow {
  const uint16_t* row;
  __device__ __forceinline__ uint32_t word(int k, int w) const {
    return reinterpret_cast<const uint32_t*>(row)[8 * k + w];
  }
  __device__ __forceinline__ bool r2_ok() const { return row[96] != 0; }
  __device__ __forceinline__ bool valid() const { return row[97] != 0; }
};

// K2''s eight arrays: a __grid_constant__ kernel parameter, so the lane's
// reads through a reference to it stay in the parameter bank (no copy).
struct Arrays {
  const uint32_t* limbs[6];  // qx qy u1 u2 r r2, [n, 16] u32 limbs each
  const bool* r2_ok;
  const bool* valid;
};

struct ArrayRow {
  const Arrays& a;
  int lane;
  // Word w = limbs 2w, 2w + 1, one 8-byte read.
  __device__ __forceinline__ uint32_t word(int k, int w) const {
    uint2 x = reinterpret_cast<const uint2*>(a.limbs[k] + (size_t)lane * 16)[w];
    return x.x | (x.y << 16);
  }
  __device__ __forceinline__ bool r2_ok() const { return a.r2_ok[lane]; }
  __device__ __forceinline__ bool valid() const { return a.valid[lane]; }
};

// Value k of the row (8 words).
template <class Row>
__device__ __forceinline__ Fe load(const Row& row, int k) {
  Fe e;
#pragma unroll
  for (int w = 0; w < 8; ++w) e.v[w] = row.word(k, w);
  return e;
}

template <class F, class Row>
__device__ __forceinline__ bool verify_lane(const F& f, const Row& row) {
  if (!row.valid()) return false;  // the same in every thread of a group
  Fe qx_m = f.to_mont(load(row, 0));
  Fe qy_m = f.to_mont(load(row, 1));
  Fe u1 = load(row, 2);
  Fe u2 = load(row, 3);
  bool r2_ok = row.r2_ok();

  // Table entry G+Q (affine).  Q == +-G handled exactly: the doubling
  // case as 2G (a ladder step with q_inf set), the negation case as the
  // identity.
  Fe one = f.one();
  Fe gx = f.gx();
  Fe gy = f.gy();
  Pt g = {gx, gy, one};
  bool e0, e1;
  Pt gq = pt_madd(f, g, qx_m, qy_m, false, &e0);
  if (e0) gq = pt_dbl_madd(f, g, gx, gy, true, &e1);
  bool gq_inf = f.is_zero(gq.z);
  Fe zi = p256_inv(f, f.select(gq_inf, one, gq.z));
  Fe zi2 = f.sqr(zi);
  Fe gqx = f.mul(gq.x, zi2);
  Fe gqy = f.mul(gq.y, f.mul(zi, zi2));

  // Interleaved Shamir ladder over {identity, Q, G, G+Q}, top bit first.
  Pt acc = {one, one, f.zero()};
  bool exc = false;
#pragma unroll 1
  for (int w = 7; w >= 0; --w) {
    uint32_t w1 = fe_word(u1, w);
    uint32_t w2 = fe_word(u2, w);
#pragma unroll 1
    for (int i = 31; i >= 0; --i) {
      uint32_t d = (((w1 >> i) & 1u) << 1) | ((w2 >> i) & 1u);
      bool is1 = d == 1u, is2 = d == 2u, is3 = d == 3u;
      Fe ax = f.select(is1, qx_m, f.select(is2, gx, gqx));
      Fe ay = f.select(is1, qy_m, f.select(is2, gy, gqy));
      bool ainf = (d == 0u) ? true : (is3 && gq_inf);
      bool e;
      acc = pt_dbl_madd(f, acc, ax, ay, ainf, &e);
      exc = exc || e;
    }
  }

  bool inf = f.is_zero(acc.z);
  Fe z2 = f.sqr(acc.z);
  Fe c1 = f.mul(f.to_mont(load(row, 4)), z2);
  Fe c2 = f.mul(f.to_mont(load(row, 5)), z2);
  bool ok = f.eq(acc.x, c1) || (r2_ok && f.eq(acc.x, c2));
  return ok && !inf && !exc;
}

}  // namespace

// The kernels and their launchers.  The lane code above also compiles for
// the host (tests/test_torch_p256_field.py runs it under g++).
#if defined(__CUDACC__)

namespace {

constexpr int kThreads = 128;

template <int T>
__global__ void __launch_bounds__(kThreads)
    p256_verify_kernel(const uint16_t* __restrict__ rows,
                       bool* __restrict__ out, int n) {
  int lane = (blockIdx.x * blockDim.x + threadIdx.x) / T;
  if (lane >= n) return;  // a whole group
  P256Field<T> f;
  bool ok = verify_lane(f, PackedRow{rows + (size_t)lane * kCols});
  if (f.leader()) out[lane] = ok;
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    p256_verify_arrays_kernel(const __grid_constant__ Arrays a,
                              bool* __restrict__ out, int n) {
  int lane = (blockIdx.x * blockDim.x + threadIdx.x) / T;
  if (lane >= n) return;
  P256Field<T> f;
  bool ok = verify_lane(f, ArrayRow{a, lane});
  if (f.leader()) out[lane] = ok;
}

template <int T>
void launch_packed(const void* rows, void* out, int n, cudaStream_t s) {
  int blocks = (int)(((long long)n * T + kThreads - 1) / kThreads);
  p256_verify_kernel<T><<<blocks, kThreads, 0, s>>>((const uint16_t*)rows, (bool*)out, n);
}

template <int T>
void launch_arrays(const Arrays& a, void* out, int n, cudaStream_t s) {
  int blocks = (int)(((long long)n * T + kThreads - 1) / kThreads);
  p256_verify_arrays_kernel<T><<<blocks, kThreads, 0, s>>>(a, (bool*)out, n);
}

}  // namespace

extern "C" {

// rows: [n, 98] u16 on the device, 4-byte aligned; out: [n] bool; t:
// threads per lane (1 or 4).  Launches on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for another t).
int mbt_p256_verify(const void* rows, void* out, int n, int t, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (t != 1 && t != 4) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (t == 1) launch_packed<1>(rows, out, n, s);
    else launch_packed<4>(rows, out, n, s);
  }
  return (int)cudaGetLastError();
}

// qx, qy, u1, u2, r, r2: [n, 16] u32 limbs (each < 2^16), 8-byte aligned;
// r2_ok, valid: [n] bool; out: [n] bool; t as for mbt_p256_verify.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int mbt_p256_verify_arrays(const void* qx, const void* qy, const void* u1,
                           const void* u2, const void* r, const void* r2,
                           const void* r2_ok, const void* valid, void* out,
                           int n, int t, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (t != 1 && t != 4) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    Arrays a = {{(const uint32_t*)qx, (const uint32_t*)qy,
                 (const uint32_t*)u1, (const uint32_t*)u2,
                 (const uint32_t*)r, (const uint32_t*)r2},
                (const bool*)r2_ok, (const bool*)valid};
    if (t == 1) launch_arrays<1>(a, out, n, s);
    else launch_arrays<4>(a, out, n, s);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#endif  // __CUDACC__
