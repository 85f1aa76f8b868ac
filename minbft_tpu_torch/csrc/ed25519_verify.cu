// K7 and K7': batched Ed25519 verification, one thread per lane.
//
// Replaces: minbft_tpu/ops/ed25519.py ed25519_verify_kernel_packed (K7:
// _verify_one_packed -> _verify_one -> _ladder, _add, _dbl), a jax.vmap
// of a scalar program over [B, 82] u16 rows, and ed25519_verify_kernel
// (K7': the same _verify_one over seven arrays, ax ay u1 u2 ry [B, 16] u32
// limbs, rsign [B] u32, valid [B] bool).  One lane function, verify_lane,
// serves both launchers, as _verify_one serves both reference forms; only
// the reads differ.  Per lane: A' = -A from (ax, ay), the table
// {identity, A', B, B + A'}, 256 steps of double-then-add of
// tab[2 bit(u1) + bit(u2)] from bit 255 down (the add is complete, so the
// identity entry needs no flag), one Fermat inversion of Z; accept iff
// y(P) == ry, parity(x(P)) == rsign and valid is set.
// The verdict of every lane equals the reference's, adversarial ones
// included; all-zero pad rows (valid = 0, A' = (0, 0)) run like any other
// (mont_inv(0) = 0) and are rejected.
//
// Bound on the H100: integer multiply-add issue, against 164 bytes read
// and 1 written per lane (K7': 325 read).  chip_smoke.py (k7_imads)
// counts what the function needs on each run's rows, about 486,000 IMAD
// issues per lane: products of 64 (square: 36) 32x32->64 terms with the
// reduction special to 2^255 - 19, a doubling and, for a nonzero digit,
// an add per bit below the top one, and an inversion by the 254-square
// chain.  This kernel does more: generic CIOS multiplies (257 issues each,
// squares too), an add for every digit, 2d*t and Z*1 recomputed, and a
// square-and-multiply inversion (4,877 multiplies).  Design as K2's: each
// lane is independent, so one thread runs the whole ladder in registers;
// the addend is picked by selects from registers (lanes disagree on every
// bit, so any branch would diverge), and the scalars are read a 32-bit
// word at a time from the row in global memory, not held in registers.
// The point formulas are calls, not inlined (see ed25519.cuh); the lane
// function itself is inlined into each launcher, so each kernel keeps the
// call structure that builds.
// A K7 row is 164 bytes, 4-byte aligned only: the kernel reads 32-bit
// words.

#include <cuda_runtime.h>

#include "ed25519.cuh"

namespace {

// [82] u16: ax ay u1 u2 ry (8 words each) | rsign valid
constexpr int kWords = 41;
constexpr int kThreads = 128;

__device__ __forceinline__ Fe fe_from_words(const uint32_t* p) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = p[j];
  return r;
}

// K7's row: [82] u16 read as 41 words.
struct PackedRow {
  const uint32_t* row;
  __device__ __forceinline__ Fe limbs(int k) const {
    return fe_from_words(row + 8 * k);
  }
  // Word w of u1 (k = 2) or u2 (k = 3).
  __device__ __forceinline__ uint32_t word(int k, int w) const {
    return row[8 * k + w];
  }
  // rsign in the low half of word 40, valid in the high half.
  __device__ __forceinline__ uint32_t rsign() const {
    return row[40] & 0xffffu;
  }
  __device__ __forceinline__ bool valid() const {
    return (row[40] >> 16) != 0u;
  }
};

// K7''s seven arrays: a __grid_constant__ kernel parameter, so the lane's
// reads through a reference to it stay in the parameter bank (no copy).
struct Arrays {
  const uint32_t* limbs[5];  // ax ay u1 u2 ry, [n, 16] u32 limbs each
  const uint32_t* rsign;     // [n] u32
  const bool* valid;         // [n] bool
};

struct ArrayRow {
  const Arrays& a;
  int lane;
  __device__ __forceinline__ Fe limbs(int k) const {
    return fe_from_u32_limbs(a.limbs[k] + (size_t)lane * 16);
  }
  __device__ __forceinline__ uint32_t word(int k, int w) const {
    const uint32_t* p = a.limbs[k] + (size_t)lane * 16 + 2 * w;
    return p[0] | (p[1] << 16);
  }
  __device__ __forceinline__ uint32_t rsign() const { return a.rsign[lane]; }
  __device__ __forceinline__ bool valid() const { return a.valid[lane]; }
};

template <class Row>
__device__ __forceinline__ bool verify_lane(const Row& row) {
  const FieldConsts& f = kFieldEd;

  Fe one = fe_load_const(f.one);
  Fe zero = fe_zero();
  Fe ax = to_mont(row.limbs(0), f);
  Fe ay = to_mont(row.limbs(1), f);
  EdPt aq = {ax, ay, one, mont_mul(ax, ay, f)};
  EdPt bp = {fe_load_const(kEdBxM), fe_load_const(kEdByM), one,
             fe_load_const(kEdBtM)};
  EdPt ba = ed_add(bp, aq);  // B + A'

  EdPt acc = ed_identity();
  for (int w = 7; w >= 0; --w) {
    uint32_t w1 = row.word(2, w);  // u1 = S
    uint32_t w2 = row.word(3, w);  // u2 = k
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
  return fe_eq(ya, row.limbs(4)) && (xa.v[0] & 1u) == row.rsign() &&
         row.valid();
}

__global__ void __launch_bounds__(kThreads)
    ed25519_verify_kernel(const uint32_t* __restrict__ rows,
                          bool* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  out[lane] = verify_lane(PackedRow{rows + (size_t)lane * kWords});
}

__global__ void __launch_bounds__(kThreads)
    ed25519_verify_arrays_kernel(const __grid_constant__ Arrays a,
                                 bool* __restrict__ out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  out[lane] = verify_lane(ArrayRow{a, lane});
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

// ax, ay, u1, u2, ry: [n, 16] u32 limbs (each < 2^16); rsign: [n] u32;
// valid: [n] bool; out: [n] bool.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int mbt_ed25519_verify_arrays(const void* ax, const void* ay, const void* u1,
                              const void* u2, const void* ry,
                              const void* rsign, const void* valid, void* out,
                              int n, void* stream) {
  if (n > 0) {
    Arrays a = {{(const uint32_t*)ax, (const uint32_t*)ay,
                 (const uint32_t*)u1, (const uint32_t*)u2,
                 (const uint32_t*)ry},
                (const uint32_t*)rsign, (const bool*)valid};
    int blocks = (n + kThreads - 1) / kThreads;
    ed25519_verify_arrays_kernel<<<blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(a, (bool*)out, n);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
