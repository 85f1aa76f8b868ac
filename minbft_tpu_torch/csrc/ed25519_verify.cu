// K7 and K7': batched Ed25519 verification, a group of 4 threads per lane.
//
// Replaces: minbft_tpu/ops/ed25519.py ed25519_verify_kernel_packed (K7:
// _verify_one_packed -> _verify_one -> _ladder, _add, _dbl), a jax.vmap
// of a scalar program over [B, 82] u16 rows, and ed25519_verify_kernel
// (K7': the same _verify_one over seven arrays, ax ay u1 u2 ry [B, 16] u32
// limbs, rsign [B] u32, valid [B] bool).  One lane function, verify_lane,
// serves both launchers, as _verify_one serves both reference forms; only the reads differ.  The reference: A' = -A from
// (ax, ay), the table {identity, A', B, B + A'}, 256 steps of
// double-then-add of tab[2 bit(u1) + bit(u2)] from bit 255 down, one
// Fermat inversion of Z; accept iff y(P) == ry, parity(x(P)) == rsign and
// valid is set.  Here the same table, ladder order and formulas compute
// the same point P, with work the verdict does not need left out: a lane
// with valid = 0 returns false at once; the ladder starts at the top
// nonzero digit with that entry loaded (the reference's steps above it
// double and add the identity); each entry keeps its addend terms
// (y - x, y + x, 2d*t, 2z; ed25519.cuh); the adds compute no T.  Only the
// verdict leaves the kernel, and it equals the reference's on every lane
// (small-order and non-canonical keys, S >= L, tampered messages and
// zero padding rows included).
//
// Bound on the H100: integer multiply-add issue, against 164 bytes read
// and 1 written per lane (K7': 325 read).  chip_smoke.py (k7_imads)
// counts what the function needs on each run's rows: per valid lane the
// setup's 10 multiplies, from the top nonzero digit down a doubling per
// bit and an add per nonzero digit, the 254-square inversion chain and
// two multiplies.  This kernel adds an entry for every digit (the
// identity's for 0: lanes of a warp disagree on every digit, so a branch
// would not save the add) and the doubling's T where no add follows.
// What held the one-thread-per-lane design back was latency, not issue:
// at cluster C's bucket (1,024 lanes) its 32 warps left every busy
// scheduler with one warp, on a serial chain of ~4,900 generic multiplies.
// Design, as K2's:
// - the field ops of ed25519_field.cuh, specialised to 2^255 - 19 (a
//   product's reduction by independent folds, 36-product squares, an
//   11-multiply inversion chain, column-sum products nvcc can overlap);
// - a ladder step is a doubling (4 squares, then 4 products) and an add
//   (4 products, then 3), all inlined: 4 levels of at most 4 independent
//   multiplies;
// - a lane runs on a group of 4 threads that share out each level's
//   multiplies (EdTasks), so the lane's chain is 4 multiplies deep a step,
//   not 15.  Measured on the H100 (PERF.md section 6), the group beat one
//   thread per lane at every batch checked, 1,024 to 32,768 lanes, even
//   where the card is full, so every batch runs at 4;
// - the row is read as 32-bit words (K7) or 8-byte pairs of u32 limbs
//   (K7''s arrays); each step reads its two scalar words from L1.

#include <cuda_runtime.h>

#include "ed25519.cuh"

namespace {

constexpr int kWords = 41;  // [82] u16: ax ay u1 u2 ry (8 words each) | rsign valid

// K7's row: [82] u16 read as 41 words (164 bytes a row, 4-byte aligned).
struct PackedRow {
  const uint32_t* row;
  __device__ __forceinline__ uint32_t word(int k, int w) const { return row[8 * k + w]; }
  // rsign in the low half of word 40, valid in the high half.
  __device__ __forceinline__ uint32_t rsign() const { return row[40] & 0xffffu; }
  __device__ __forceinline__ bool valid() const { return (row[40] >> 16) != 0u; }
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
  // Word w = limbs 2w, 2w + 1, one 8-byte read.
  __device__ __forceinline__ uint32_t word(int k, int w) const {
    uint2 x = reinterpret_cast<const uint2*>(a.limbs[k] + (size_t)lane * 16)[w];
    return x.x | (x.y << 16);
  }
  __device__ __forceinline__ uint32_t rsign() const { return a.rsign[lane]; }
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

// Ladder digit i: 2 bit_i(u1) + bit_i(u2).
template <class Row>
__device__ __forceinline__ uint32_t digit(const Row& row, int i) {
  uint32_t w1 = row.word(2, i >> 5), w2 = row.word(3, i >> 5);
  return (((w1 >> (i & 31)) & 1u) << 1) | ((w2 >> (i & 31)) & 1u);
}

template <class F, class Row>
__device__ __forceinline__ bool verify_lane(const F& f, const Row& row) {
  if (!row.valid()) return false;  // the same in every thread of a group
  // The top nonzero digit (-1: u1 = u2 = 0, P is the identity).
  int top = -1;
#pragma unroll 1
  for (int w = 7; w >= 0 && top < 0; --w) {
    uint32_t m = row.word(2, w) | row.word(3, w);
    if (m != 0u) top = 32 * w + 31 - __clz(m);
  }

  // The table's entries A' = (ax, ay) and B (affine) and B + A' (the
  // reference's _add(B, A'), A' with t = ax*ay): 10 products in 4 levels.
  Fe ax = load(row, 0), ay = load(row, 1);
  Fe a_ymx = f.sub(ay, ax), a_ypx = f.add(ay, ax);
  Fe m1a[3] = {ax, a_ymx, a_ypx};
  Fe m1b[3] = {ay, ed_constant(kEdBymx), ed_constant(kEdBypx)}, m1[3];
  f.template muls<3, 0x0u>(m1a, m1b, m1);  // t(A'), A, B
  Fe m2a[2] = {m1[0], m1[0]}, m2b[2] = {ed_constant(kEdD2), ed_constant(kEdBt2d)}, m2[2];
  f.template muls<2, 0x0u>(m2a, m2b, m2);  // 2d*t(A'), C
  Fe two = ed_small(2u);
  Fe e = f.sub(m1[2], m1[1]), ff = f.sub(two, m2[1]);
  Fe g = f.add(two, m2[1]), h = f.add(m1[2], m1[1]);
  Fe m3a[4] = {e, g, ff, e}, m3b[4] = {ff, h, g, h}, ba[4];
  f.template muls<4, 0x0u>(m3a, m3b, ba);  // B + A' = (X : Y : Z : T)
  EdAddend q_ba = ed_addend(f, EdPt{ba[0], ba[1], ba[2], ba[3]});
  Fe a_t2d = m2[0];

  // Start at the top digit's entry (its T is not read: a doubling is next).
  Fe one = f.one();
  EdPt acc = {f.zero(), one, one, f.zero()};
  if (top >= 0) {
    uint32_t d = digit(row, top);
    acc.x = f.select(d == 1u, ax, f.select(d == 2u, ed_constant(kEdBx), ba[0]));
    acc.y = f.select(d == 1u, ay, f.select(d == 2u, ed_constant(kEdBy), ba[1]));
    acc.z = f.select(d == 3u, ba[2], one);
  }
#pragma unroll 1
  for (int i = top - 1; i >= 0; --i) {
    uint32_t d = digit(row, i);
    EdPt dbl = ed_dbl(f, acc.x, acc.y, acc.z);
    // tab[d] as an addend: the identity (1, 1, 0, 2), A', B or B + A'.
    bool is1 = d == 1u, is2 = d == 2u, is3 = d == 3u;
    EdAddend q;
    q.ymx = f.select(is1, a_ymx, f.select(is2, ed_constant(kEdBymx),
                                          f.select(is3, q_ba.ymx, one)));
    q.ypx = f.select(is1, a_ypx, f.select(is2, ed_constant(kEdBypx),
                                          f.select(is3, q_ba.ypx, one)));
    q.t2d = f.select(is1, a_t2d, f.select(is2, ed_constant(kEdBt2d),
                                          f.select(is3, q_ba.t2d, f.zero())));
    q.z2 = f.select(is3, q_ba.z2, two);
    ed_add_xyz(f, dbl, q, &acc.x, &acc.y, &acc.z);
  }

  Fe zi = ed_inv(f, acc.z);
  Fe na[2] = {acc.x, acc.y}, nb[2] = {zi, zi}, xy[2];
  f.template muls<2, 0x0u>(na, nb, xy);
  return f.eq(xy[1], load(row, 4)) && (xy[0].v[0] & 1u) == row.rsign();
}

}  // namespace

// The kernels and their launchers.  The lane code above also compiles for
// the host (tests/test_torch_ed25519_field.py runs it under g++).
#if defined(__CUDACC__)

namespace {

constexpr int kThreads = 128;

constexpr int kGroup = 4;  // threads per lane

__global__ void __launch_bounds__(kThreads)
    ed25519_verify_kernel(const uint32_t* __restrict__ rows,
                          bool* __restrict__ out, int n) {
  int lane = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (lane >= n) return;  // a whole group
  EdTasks f;
  bool ok = verify_lane(f, PackedRow{rows + (size_t)lane * kWords});
  if (f.leader()) out[lane] = ok;
}

__global__ void __launch_bounds__(kThreads)
    ed25519_verify_arrays_kernel(const __grid_constant__ Arrays a,
                                 bool* __restrict__ out, int n) {
  int lane = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (lane >= n) return;
  EdTasks f;
  bool ok = verify_lane(f, ArrayRow{a, lane});
  if (f.leader()) out[lane] = ok;
}

int blocks(int n) {
  return (int)(((long long)n * kGroup + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// rows: [n, 82] u16 on the device, 4-byte aligned; out: [n] bool.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int mbt_ed25519_verify(const void* rows, void* out, int n, void* stream) {
  if (n > 0)
    ed25519_verify_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (bool*)out, n);
  return (int)cudaGetLastError();
}

// ax, ay, u1, u2, ry: [n, 16] u32 limbs (each < 2^16), 8-byte aligned;
// rsign: [n] u32; valid: [n] bool; out: [n] bool.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int mbt_ed25519_verify_arrays(const void* ax, const void* ay, const void* u1,
                              const void* u2, const void* ry,
                              const void* rsign, const void* valid, void* out,
                              int n, void* stream) {
  if (n > 0) {
    Arrays a = {{(const uint32_t*)ax, (const uint32_t*)ay,
                 (const uint32_t*)u1, (const uint32_t*)u2,
                 (const uint32_t*)ry},
                (const uint32_t*)rsign, (const bool*)valid};
    ed25519_verify_arrays_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        a, (bool*)out, n);
  }
  return (int)cudaGetLastError();
}

const char* mbt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#endif  // __CUDACC__
