// SHA-256 for one thread: the compression of hash_blocks.cu (K2).
//
// As in ripemd160.cuh, every round constant and schedule index is a
// template argument, so the 64 rounds unroll with the message schedule in
// a ring of 16 registers, and each rotate is one SHF.R.W. A round's
// dependent chain runs through e (the rotates of Sigma1 in parallel, their
// xor, the five-term add into t1, the add of d): about five instructions.
//
// Words and digests are big-endian values: the host packs the padded
// message with '>u4' and writes the eight state words back with '>u4'.

#pragma once

#include "hash_block.cuh"

namespace {

__host__ __device__ constexpr uint32_t sha_k(int t) {
  constexpr uint32_t k[64] = {
      0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u, 0x923F82A4u,
      0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu,
      0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu,
      0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u,
      0xC6E00BF3u, 0xD5A79147u, 0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
      0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
      0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u,
      0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu, 0x682E6FF3u,
      0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u, 0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u,
      0xC67178F2u};
  return k[t];
}

// round T on s = (a, b, c, d, e, f, g, h); w holds schedule words T-16..T-1
// in slot (index & 15), and from round 16 on slot T & 15 becomes word T
template <int T>
TM_HASH_DEV void sha_rounds(uint32_t (&s)[8], uint32_t (&w)[16]) {
  if constexpr (T < 64) {
    if constexpr (T >= 16) {
      const uint32_t w15 = w[(T - 15) & 15], w2 = w[(T - 2) & 15];
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      w[T & 15] += s0 + w[(T - 7) & 15] + s1;
    }
    constexpr uint32_t k = sha_k(T);
    const uint32_t e = s[4], a = s[0];
    const uint32_t t1 = s[7] + (rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25)) +
                        ((e & s[5]) ^ (~e & s[6])) + k + w[T & 15];
    const uint32_t t2 = (rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22)) +
                        ((a & s[1]) ^ (a & s[2]) ^ (s[1] & s[2]));
    s[7] = s[6];
    s[6] = s[5];
    s[5] = s[4];
    s[4] = s[3] + t1;
    s[3] = s[2];
    s[2] = s[1];
    s[1] = s[0];
    s[0] = t1 + t2;
    sha_rounds<T + 1>(s, w);
  }
}

TM_HASH_DEV void sha256_init(uint32_t (&h)[8]) {
  h[0] = 0x6A09E667u;
  h[1] = 0xBB67AE85u;
  h[2] = 0x3C6EF372u;
  h[3] = 0xA54FF53Au;
  h[4] = 0x510E527Fu;
  h[5] = 0x9B05688Cu;
  h[6] = 0x1F83D9ABu;
  h[7] = 0x5BE0CD19u;
}

// h <- compress(h, x), x one 64-byte block as 16 big-endian word values
TM_HASH_DEV void sha256_compress(uint32_t (&h)[8], const uint32_t (&x)[16]) {
  uint32_t w[16], s[8];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = x[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = h[i];
  sha_rounds<0>(s, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] += s[i];
}

// The digest of one MD-padded message of `nblocks` blocks into out[0..7],
// the next block's loads issued before the current block's rounds.
TM_HASH_DEV void sha256_message(const uint4* blocks, int nblocks, uint32_t* out) {
  uint32_t h[8];
  sha256_init(h);
  uint32_t cur[16] = {}, nxt[16] = {};
  if (nblocks > 0) load_block(cur, blocks);
#pragma unroll 1
  for (int b = 0; b < nblocks; ++b) {
    if (b + 1 < nblocks) load_block(nxt, blocks + 4 * (b + 1));
    sha256_compress(h, cur);
#pragma unroll
    for (int i = 0; i < 16; ++i) cur[i] = nxt[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = h[i];
}

}  // namespace
