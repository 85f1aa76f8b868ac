// K5: FIPS 180-4 SHA-256 compression as device functions: one block
// (compress), and a block whose schedule is known ahead split in two
// (expand, then compress_kw: the rounds alone).
//
// Replaces: minbft_tpu/ops/sha256.py compress (its _round, the unrolled
// _compress_unrolled and the fori_loop _compress_loop lowerings), a
// scalar u32 program that the reference vmaps over the batch.  It has no
// launch of its own on the main path: K6 (hmac_sha256.cu) inlines it;
// sha256_compress.cu wraps compress in a thin test kernel.
//
// Bound on the H100: 32-bit integer issue on the ALU pipe.  A compression
// needs at least 1,384 instructions: per round 6 SHF, 4 LOP3 and 4 IADD3,
// per schedule word 6 SHF, 2 LOP3 and 2 IADD3, and 8 final adds.  The
// 1,024 SHF and LOP3 issue only on the ALU pipe (64 lanes per SM per
// clock, 16 per scheduler, so a warp's instruction holds it 2 clocks) and
// set the floor; the adds can issue as IMAD on the FMA pipe.  It moves 96
// bytes of state and block in and 32 out.  At the batches the engine sends
// a warp has its scheduler to itself, and its own ALU issue (~2,050 clocks
// a compression) is most of a compression's time: a chain of dependent
// instructions shorter than that gains nothing unless it also issues less.
//
// Design: the 64 rounds are unrolled, so the rolling 16-word schedule
// window is indexed statically and stays in registers; the working
// variables are renamed, not moved (round t reads a..h at v[(0 - t) & 7]
// .. v[(7 - t) & 7] and writes its new e over d and its new a over h);
// rotations are funnel shifts (one SHF each).  The round constants are an
// array local to k_at, which nvcc folds to immediates in the unrolled
// code, so K[t] + W[t] is one immediate where W[t] is a constant (HMAC's
// pad and tail words 8-15), and the schedule terms that read only
// constants fold.  A round keeps e's chain at three dependent instructions
// (the rotates, the three-way XOR, one IADD3 of Sigma1, Ch and d + h +
// K[t] + W[t], that sum formed off the chain), and a's at three too.
// SASS of the test kernel (chip_smoke.py phase 1, cuobjdump): 1,504
// instructions (1,024 SHF/LOP3, 305 IADD3, 120 IMAD) and a longest chain
// of 197 dependent instructions, about three a round; 0.0039 ms for 4,096
// lanes, 0.0042 with the sum on the chain (chip_smoke.py phase 6, NVIDIA
// H100 80GB HBM3, 700.00 W).

#pragma once

#include <stdint.h>

namespace sha256 {

// K[t] for t known at compile time (every caller unrolls its rounds).
__device__ __forceinline__ uint32_t k_at(int t) {
  const uint32_t k[64] = {
      0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
      0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
      0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
      0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
      0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
      0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
      0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
      0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
      0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
      0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
      0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
      0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
      0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
  };
  return k[t];
}

// FIPS 180-4 initial hash value H(0).
__device__ __forceinline__ void init(uint32_t st[8]) {
  st[0] = 0x6A09E667u; st[1] = 0xBB67AE85u; st[2] = 0x3C6EF372u;
  st[3] = 0xA54FF53Au; st[4] = 0x510E527Fu; st[5] = 0x9B05688Cu;
  st[6] = 0x1F83D9ABu; st[7] = 0x5BE0CD19u;
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// W[t], t >= 16, from the rolling window: w[t & 15] holds W[t - 16] on
// entry and W[t] on return.
__device__ __forceinline__ uint32_t schedule(uint32_t w[16], int t) {
  uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
  uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
  uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
  uint32_t wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
  w[t & 15] = wt;
  return wt;
}

// Round t on the working variables v, with kw = K[t] + W[t].
__device__ __forceinline__ void step(uint32_t v[8], int t, uint32_t kw) {
  const uint32_t a = v[(0 - t) & 7], b = v[(1 - t) & 7], c = v[(2 - t) & 7];
  const uint32_t d = v[(3 - t) & 7], e = v[(4 - t) & 7], f = v[(5 - t) & 7];
  const uint32_t g = v[(6 - t) & 7], h = v[(7 - t) & 7];
  const uint32_t hk = h + kw;    // off the chain: h is e of 3 rounds back
  const uint32_t dhk = d + hk;   // d is a of 3 rounds back
  const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  v[(3 - t) & 7] = dhk + s1 + ch;               // e of round t + 1
  v[(7 - t) & 7] = (hk + s1 + ch) + (s0 + maj);  // a of round t + 1
}

__device__ __forceinline__ void load(uint32_t v[8], const uint32_t st[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
}

// After 64 rounds the renaming is back where it started (64 = 0 mod 8).
__device__ __forceinline__ void finish(uint32_t st[8], const uint32_t v[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] += v[i];
}

// st <- compress(st, w): one 64-byte block of 16 big-endian words.  `w` is
// the schedule window and is overwritten (the caller passes a copy).
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t v[8];
  load(v, st);
#pragma unroll
  for (int t = 0; t < 64; ++t)
    step(v, t, k_at(t) + (t < 16 ? w[t] : schedule(w, t)));
  finish(st, v);
}

// kw[t] = K[t] + W[t] for the 64 rounds of block w (overwritten): the
// schedule, which needs only the block, ahead of the rounds.
__device__ __forceinline__ void expand(uint32_t w[16], uint32_t kw[64]) {
#pragma unroll
  for (int t = 0; t < 64; ++t) kw[t] = k_at(t) + (t < 16 ? w[t] : schedule(w, t));
}

// st <- compress(st, w) from expand's kw: the rounds alone.
__device__ __forceinline__ void compress_kw(uint32_t st[8], const uint32_t kw[64]) {
  uint32_t v[8];
  load(v, st);
#pragma unroll
  for (int t = 0; t < 64; ++t) step(v, t, kw[t]);
  finish(st, v);
}

}  // namespace sha256
