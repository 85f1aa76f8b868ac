// K2: batched ECDSA-P256 verification, one thread per lane.
//
// Replaces: minbft_tpu/ops/p256.py ecdsa_verify_kernel_packed
// (_verify_one_packed -> _verify_one -> _shamir, _dbl, _madd,
// _madd_complete_table), a jax.vmap of a scalar program over [B, 98] u16
// rows.  Same arithmetic, same point formulas and exceptional-case
// handling, so the verdict of every lane (adversarial ones included)
// equals the reference's:
//   accept iff X == r*Z^2 or (r2_ok and X == r2*Z^2), and Z != 0, and no
//   incomplete add hit its undefined case (exc), and the host's range
//   checks passed (valid).
//
// Bound on the H100: integer multiply-add issue.  Per lane: 2 to_mont, a
// G+Q table entry (madd + dbl), one Fermat inversion (256 squarings + ~128
// multiplies), then 256 ladder steps of 19 field multiplies each, about
// 5,500 field multiplies of 128 32x32->64 multiply-adds each, against 196
// bytes read and 1 byte written.  Design: each lane is independent, so one
// thread runs the whole ladder in registers; the row is read once and
// widened in the kernel, and the scalar bits are pulled a 32-bit word at a
// time.  A batch of 512 fills only 4 of the 132 SMs with 128-thread blocks
// (launch latency and per-thread serial work dominate at the deployment
// bucket); splitting a lane's multiply across a warp's threads is the
// lever for later PRs.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kCols = 98;  // qx qy u1 u2 r r2 (16 limbs each) | r2_ok valid
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t word_of(const Fe& s, int w) {
  uint32_t r = s.v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) r = (w == j) ? s.v[j] : r;
  return r;
}

__global__ void __launch_bounds__(kThreads)
    p256_verify_kernel(const uint16_t* __restrict__ rows,
                       bool* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const uint16_t* row = rows + (size_t)lane * kCols;
  const FieldConsts& f = kFieldP;

  Fe qx_m = to_mont(fe_from_u16(row + 0), f);
  Fe qy_m = to_mont(fe_from_u16(row + 16), f);
  Fe u1 = fe_from_u16(row + 32);
  Fe u2 = fe_from_u16(row + 48);
  bool r2_ok = row[96] != 0;
  bool valid = row[97] != 0;

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
    uint32_t w1 = word_of(u1, w);
    uint32_t w2 = word_of(u2, w);
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
  Fe c1 = mont_mul(to_mont(fe_from_u16(row + 64), f), z2, f);
  Fe c2 = mont_mul(to_mont(fe_from_u16(row + 80), f), z2, f);
  bool ok = fe_eq(acc.x, c1) || (r2_ok && fe_eq(acc.x, c2));
  out[lane] = ok && !inf && !exc && valid;
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

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
