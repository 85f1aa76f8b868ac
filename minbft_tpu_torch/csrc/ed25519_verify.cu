// K7: batched Ed25519 verification, one thread per lane.
//
// Replaces: minbft_tpu/ops/ed25519.py ed25519_verify_kernel_packed
// (_verify_one_packed -> _verify_one -> _ladder, _add, _dbl), a jax.vmap
// of a scalar program over [B, 82] u16 rows.  Per lane: A' = -A from the
// row's (ax, ay), the table {identity, A', B, B + A'}, 256 steps of
// double-then-add of tab[2 bit(u1) + bit(u2)] from bit 255 down (the add
// is complete, so the identity entry needs no flag), one Fermat inversion
// of Z; accept iff y(P) == ry, parity(x(P)) == rsign and valid is set.
// The verdict of every lane equals the reference's, adversarial ones
// included; all-zero pad rows (valid = 0, A' = (0, 0)) run like any other
// (mont_inv(0) = 0) and are rejected.
//
// Bound on the H100: integer multiply-add issue, against 164 bytes read
// and 1 written per lane.  chip_smoke.py (k7_imads) counts what the
// function needs on each run's rows, about 486,000 IMAD issues per lane:
// products of 64 (square: 36) 32x32->64 terms with the reduction special
// to 2^255 - 19, a doubling and, for a nonzero digit, an add per bit
// below the top one, and an inversion by the 254-square chain.  This
// kernel does more: generic CIOS multiplies (257 issues each, squares
// too), an add for every digit, 2d*t and Z*1 recomputed, and a
// square-and-multiply inversion (4,877 multiplies).  Design as K2's: each lane
// is independent, so one thread runs the whole ladder in registers; the
// addend is picked by selects from registers (lanes disagree on every
// bit, so any branch would diverge), and the scalars are read a 32-bit
// word at a time from the row in global memory, not held in registers.
// The point formulas are calls, not inlined (see ed25519.cuh).
// A row is 164 bytes, 4-byte aligned only: the kernel reads 32-bit words.

#include <cuda_runtime.h>

#include "ed25519.cuh"

namespace {

constexpr int kWords = 41;  // [82] u16: ax ay u1 u2 ry (8 words each) | rsign valid
constexpr int kThreads = 128;

__device__ __forceinline__ Fe fe_from_words(const uint32_t* p) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = p[j];
  return r;
}

__global__ void __launch_bounds__(kThreads)
    ed25519_verify_kernel(const uint32_t* __restrict__ rows,
                          bool* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const uint32_t* row = rows + (size_t)lane * kWords;
  const FieldConsts& f = kFieldEd;

  Fe one = fe_load_const(f.one);
  Fe zero = fe_zero();
  Fe ax = to_mont(fe_from_words(row + 0), f);
  Fe ay = to_mont(fe_from_words(row + 8), f);
  EdPt aq = {ax, ay, one, mont_mul(ax, ay, f)};
  EdPt bp = {fe_load_const(kEdBxM), fe_load_const(kEdByM), one,
             fe_load_const(kEdBtM)};
  EdPt ba = ed_add(bp, aq);  // B + A'

  EdPt acc = ed_identity();
  for (int w = 7; w >= 0; --w) {
    uint32_t w1 = row[16 + w];  // u1 = S
    uint32_t w2 = row[24 + w];  // u2 = k
    for (int i = 31; i >= 0; --i) {
      acc = ed_dbl(acc);
      uint32_t d = (((w1 >> i) & 1u) << 1) | ((w2 >> i) & 1u);
      bool is1 = d == 1u, is2 = d == 2u, is3 = d == 3u;
      EdPt q;
      q.x = fe_select(is1, aq.x, fe_select(is2, fe_load_const(kEdBxM),
                                           fe_select(is3, ba.x, zero)));
      q.y = fe_select(is1, aq.y, fe_select(is2, fe_load_const(kEdByM),
                                           fe_select(is3, ba.y, one)));
      q.z = fe_select(is3, ba.z, one);
      q.t = fe_select(is1, aq.t, fe_select(is2, fe_load_const(kEdBtM),
                                           fe_select(is3, ba.t, zero)));
      acc = ed_add(acc, q);
    }
  }

  Fe zi = mont_inv(acc.z, f);
  Fe xa = from_mont(mont_mul(acc.x, zi, f), f);
  Fe ya = from_mont(mont_mul(acc.y, zi, f), f);
  uint32_t flags = row[40];  // rsign in the low half, valid in the high
  bool ok = fe_eq(ya, fe_from_words(row + 32)) &&
            (xa.v[0] & 1u) == (flags & 0xffffu) && (flags >> 16) != 0u;
  out[lane] = ok;
}

}  // namespace

extern "C" {

// rows: [n, 82] u16 on the device, 4-byte aligned; out: [n] bool.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int mbt_ed25519_verify(const void* rows, void* out, int n, void* stream) {
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    ed25519_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (bool*)out, n);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
