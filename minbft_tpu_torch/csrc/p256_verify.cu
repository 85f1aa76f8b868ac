// K2 and K2': batched ECDSA-P256 verification, one thread per lane.
//
// Replaces: minbft_tpu/ops/p256.py ecdsa_verify_kernel_packed (K2:
// _verify_one_packed -> _verify_one -> _shamir, _dbl, _madd,
// _madd_complete_table), a jax.vmap of a scalar program over [B, 98] u16
// rows, and ecdsa_verify_kernel = _verify_batch (K2': the same _verify_one
// over eight arrays, qx qy u1 u2 r r2 [B, 16] u32 limbs and r2_ok valid
// [B] bool).  One lane function, verify_lane, serves both launchers, as
// _verify_one serves both reference forms; only the reads differ.  Same
// arithmetic, same point formulas and exceptional-case handling, so the
// verdict of every lane (adversarial ones included) equals the
// reference's:
//   accept iff X == r*Z^2 or (r2_ok and X == r2*Z^2), and Z != 0, and no
//   incomplete add hit its undefined case (exc), and the host's range
//   checks passed (valid).
//
// Bound on the H100: integer multiply-add issue.  Per lane: 2 to_mont, a
// G+Q table entry (madd + dbl), one Fermat inversion (256 squarings + ~128
// multiplies), then 256 ladder steps of 19 field multiplies each, about
// 5,500 field multiplies, against 196 bytes read and 1 byte written (K2';
// 392 + 2 read).  chip_smoke.py (k2_imads) counts what the function needs
// on each run's rows.  Design: each lane is independent, so one thread runs
// the whole ladder in registers; the row is read once and widened in the
// kernel, and the scalar bits are pulled a 32-bit word at a time.  A batch
// of 512 fills only 4 of the 132 SMs with 128-thread blocks (launch latency
// and per-thread serial work dominate at the deployment bucket); splitting
// a lane's multiply across a warp's threads is the lever for later PRs.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kCols = 98;  // qx qy u1 u2 r r2 (16 limbs each) | r2_ok valid
constexpr int kThreads = 128;

// K2's row: [98] u16.
struct PackedRow {
  const uint16_t* row;
  __device__ __forceinline__ Fe limbs(int k) const {
    return fe_from_u16(row + 16 * k);
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
  __device__ __forceinline__ Fe limbs(int k) const {
    return fe_from_u32_limbs(a.limbs[k] + (size_t)lane * 16);
  }
  __device__ __forceinline__ bool r2_ok() const { return a.r2_ok[lane]; }
  __device__ __forceinline__ bool valid() const { return a.valid[lane]; }
};

template <class Row>
__device__ __forceinline__ bool verify_lane(const Row& row) {
  const FieldConsts& f = kFieldP;
  Fe qx_m = to_mont(row.limbs(0), f);
  Fe qy_m = to_mont(row.limbs(1), f);
  Fe u1 = row.limbs(2);
  Fe u2 = row.limbs(3);
  bool r2_ok = row.r2_ok();
  bool valid = row.valid();

  // Table entry G+Q (affine).  Q == +-G handled exactly: the doubling
  // case through pt_dbl, the negation case as the identity.
  Fe one = fe_load_const(f.one);
  Fe gx = fe_load_const(kGxM);
  Fe gy = fe_load_const(kGyM);
  Pt g = {gx, gy, one};
  bool e0;
  Pt gq = pt_madd(g, qx_m, qy_m, false, &e0);
  if (e0) gq = pt_dbl(g);
  bool gq_inf = fe_is_zero(gq.z);
  Fe zi = mont_inv(fe_select(gq_inf, one, gq.z), f);
  Fe zi2 = mont_sqr(zi, f);
  Fe gqx = mont_mul(gq.x, zi2, f);
  Fe gqy = mont_mul(gq.y, mont_mul(zi, zi2, f), f);

  // Interleaved Shamir ladder over {identity, Q, G, G+Q}, top bit first.
  Pt acc = {one, one, fe_zero()};
  bool exc = false;
  for (int w = 7; w >= 0; --w) {
    uint32_t w1 = fe_word(u1, w);
    uint32_t w2 = fe_word(u2, w);
    for (int i = 31; i >= 0; --i) {
      acc = pt_dbl(acc);
      uint32_t d = (((w1 >> i) & 1u) << 1) | ((w2 >> i) & 1u);
      bool is1 = d == 1u, is2 = d == 2u, is3 = d == 3u;
      Fe ax = fe_select(is1, qx_m, fe_select(is2, gx, gqx));
      Fe ay = fe_select(is1, qy_m, fe_select(is2, gy, gqy));
      bool ainf = (d == 0u) ? true : (is3 && gq_inf);
      bool e;
      acc = pt_madd(acc, ax, ay, ainf, &e);
      exc = exc || e;
    }
  }

  bool inf = fe_is_zero(acc.z);
  Fe z2 = mont_sqr(acc.z, f);
  Fe c1 = mont_mul(to_mont(row.limbs(4), f), z2, f);
  Fe c2 = mont_mul(to_mont(row.limbs(5), f), z2, f);
  bool ok = fe_eq(acc.x, c1) || (r2_ok && fe_eq(acc.x, c2));
  return ok && !inf && !exc && valid;
}

__global__ void __launch_bounds__(kThreads)
    p256_verify_kernel(const uint16_t* __restrict__ rows,
                       bool* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  out[lane] = verify_lane(PackedRow{rows + (size_t)lane * kCols});
}

__global__ void __launch_bounds__(kThreads)
    p256_verify_arrays_kernel(const __grid_constant__ Arrays a,
                              bool* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  out[lane] = verify_lane(ArrayRow{a, lane});
}

}  // namespace

extern "C" {

// rows: [n, 98] u16 on the device; out: [n] bool.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int mbt_p256_verify(const void* rows, void* out, int n, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    p256_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)rows, (bool*)out, n);
  }
  return (int)cudaGetLastError();
}

// qx, qy, u1, u2, r, r2: [n, 16] u32 limbs (each < 2^16); r2_ok, valid:
// [n] bool; out: [n] bool.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mbt_p256_verify_arrays(const void* qx, const void* qy, const void* u1,
                           const void* u2, const void* r, const void* r2,
                           const void* r2_ok, const void* valid, void* out,
                           int n, void* stream) {
  if (n > 0) {
    Arrays a = {{(const uint32_t*)qx, (const uint32_t*)qy,
                 (const uint32_t*)u1, (const uint32_t*)u2,
                 (const uint32_t*)r, (const uint32_t*)r2},
                (const bool*)r2_ok, (const bool*)valid};
    int blocks = (n + kThreads - 1) / kThreads;
    p256_verify_arrays_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        a, (bool*)out, n);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
