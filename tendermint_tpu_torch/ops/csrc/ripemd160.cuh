// RIPEMD-160 for one thread: the compression of hash_blocks.cu (K1, the
// part and tx-leaf hashes) and of merkle_tree.cu (K3, one block an inner
// node).
//
// Every round constant, message-word index and rotate amount is a template
// argument: the 80 steps of each line unroll at compile time, the message
// words stay in registers (a run-time index would put them in local
// memory), and each rotate is one SHF.L.W (__funnelshift_l with both halves
// the same word, or with the add of e in one LEA.HI). A step needs three
// dependent instructions (the round function, a three-input add, the
// rotate-and-add), four where the constant's add stays on the path; the
// two lines are independent, but ptxas lays them out one after the other,
// so one warp's in-order issue waits out both lines' chains.
//
// Words and digests are little-endian: the host packs the padded message
// with '<u4' and reads the five state words back the same way.

#pragma once

#include "hash_block.cuh"

namespace {

// the message word, rotate amount and constant of step j (0..79) of line 0
// (left) or 1 (right), as in crypto/hashing.py's _R1/_R2, _S1/_S2, _K1/_K2
__host__ __device__ constexpr int rmd_word(int line, int j) {
  constexpr uint8_t r[2][80] = {
      {0, 1, 2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 7,  4,  13, 1,
       10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8, 3, 10, 14, 4, 9, 15, 8, 1,
       2, 7, 0, 6, 13, 11, 5, 12, 1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15,
       14, 5, 6, 2, 4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13},
      {5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12, 6, 11, 3, 7,
       0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2, 15, 5, 1, 3, 7, 14, 6, 9,
       11, 8, 12, 2, 10, 0, 4, 13, 8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13,
       9, 7, 10, 14, 12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11}};
  return r[line][j];
}

__host__ __device__ constexpr int rmd_shift(int line, int j) {
  constexpr uint8_t s[2][80] = {
      {11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8, 7, 6, 8, 13,
       11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12, 11, 13, 6, 7, 14, 9, 13, 15,
       14, 8, 13, 6, 5, 12, 7, 5, 11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6,
       8, 6, 5, 12, 9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6},
      {8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6, 9, 13, 15, 7,
       12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11, 9, 7, 15, 11, 8, 6, 6, 14,
       12, 13, 5, 14, 13, 13, 7, 5, 15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9,
       12, 5, 15, 8, 8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11}};
  return s[line][j];
}

__host__ __device__ constexpr uint32_t rmd_k(int line, int round) {
  constexpr uint32_t k[2][5] = {{0x00000000u, 0x5A827999u, 0x6ED9EBA1u, 0x8F1BBCDCu, 0xA953FD4Eu},
                                {0x50A28BE6u, 0x5C4DD124u, 0x6D703EF3u, 0x7A6D76E9u, 0x00000000u}};
  return k[line][round];
}

template <int F>
TM_HASH_DEV uint32_t rmd_f(uint32_t x, uint32_t y, uint32_t z) {
  if constexpr (F == 0) return x ^ y ^ z;
  else if constexpr (F == 1) return (x & y) | (~x & z);
  else if constexpr (F == 2) return (x | ~y) ^ z;
  else if constexpr (F == 3) return (x & z) | (y & ~z);
  else return x ^ (y | ~z);
}

// one step of a line: s = (a, b, c, d, e)
template <int F, int W, int S, uint32_t K>
TM_HASH_DEV void rmd_step(uint32_t (&s)[5], const uint32_t (&x)[16]) {
  const uint32_t t = rotl32(s[0] + rmd_f<F>(s[1], s[2], s[3]) + x[W] + K, S) + s[4];
  s[0] = s[4];
  s[4] = s[3];
  s[3] = rotl32(s[2], 10);
  s[2] = s[1];
  s[1] = t;
}

template <int J>
TM_HASH_DEV void rmd_steps(uint32_t (&l)[5], uint32_t (&r)[5], const uint32_t (&x)[16]) {
  if constexpr (J < 80) {
    constexpr int kRound = J / 16;
    rmd_step<kRound, rmd_word(0, J), rmd_shift(0, J), rmd_k(0, kRound)>(l, x);
    rmd_step<4 - kRound, rmd_word(1, J), rmd_shift(1, J), rmd_k(1, kRound)>(r, x);
    rmd_steps<J + 1>(l, r, x);
  }
}

TM_HASH_DEV void ripemd160_init(uint32_t (&h)[5]) {
  h[0] = 0x67452301u;
  h[1] = 0xEFCDAB89u;
  h[2] = 0x98BADCFEu;
  h[3] = 0x10325476u;
  h[4] = 0xC3D2E1F0u;
}

// h <- compress(h, x), x one 64-byte block as 16 little-endian words
TM_HASH_DEV void ripemd160_compress(uint32_t (&h)[5], const uint32_t (&x)[16]) {
  uint32_t l[5] = {h[0], h[1], h[2], h[3], h[4]};
  uint32_t r[5] = {h[0], h[1], h[2], h[3], h[4]};
  rmd_steps<0>(l, r, x);
  const uint32_t t = h[1] + l[2] + r[3];
  h[1] = h[2] + l[3] + r[4];
  h[2] = h[3] + l[4] + r[0];
  h[3] = h[4] + l[0] + r[1];
  h[4] = h[0] + l[1] + r[2];
  h[0] = t;
}

// The digest of one MD-padded message of `nblocks` blocks (at least one)
// into out[0..4]. The next block's loads are issued before the current
// block's compression, so a block's memory latency hides behind the
// previous one's 80 steps.
TM_HASH_DEV void ripemd160_message(const uint4* blocks, int nblocks, uint32_t* out) {
  uint32_t h[5];
  ripemd160_init(h);
  uint32_t cur[16] = {}, nxt[16] = {};
  if (nblocks > 0) load_block(cur, blocks);
#pragma unroll 1
  for (int b = 0; b < nblocks; ++b) {
    if (b + 1 < nblocks) load_block(nxt, blocks + 4 * (b + 1));
    ripemd160_compress(h, cur);
#pragma unroll
    for (int i = 0; i < 16; ++i) cur[i] = nxt[i];
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) out[i] = h[i];
}

}  // namespace
