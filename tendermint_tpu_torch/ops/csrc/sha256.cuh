// SHA-256: the compression of hash_blocks.cu (K2), as its two parts:
// sha_schedule, a block's 64 schedule words each with its round constant
// added (W[t] + K[t]), and sha_rounds, the 64 rounds from the chaining
// state on those sums. K2 runs the parts on two warps (the schedule warp
// one block ahead of the compression warp, the sums handed over through
// shared memory); sha256_compress and sha256_message are their composition
// on one thread.
//
// Every round index is a template argument, so the schedule runs in a ring
// of 16 registers and the rounds' state stays in registers; each rotate is
// one SHF.R.W. A round's dependent chain runs through e: Sigma1's rotates
// side by side, their xor, and one three-input add of Sigma1, Ch and
// d + h + (W + K), a sum ready three rounds ahead and so added off the
// chain (d and h at round t are a and e of round t - 3); a' is one more
// three-input add. Ch and Maj are one LOP3 each: about 14 instructions a
// round.
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

// schedule word T + K[T]; w holds words T-16..T-1 in slot (index & 15),
// and from T = 16 on slot T & 15 becomes word T
template <int T>
TM_HASH_DEV uint32_t sha_word_k(uint32_t (&w)[16]) {
  if constexpr (T >= 16) {
    const uint32_t w15 = w[(T - 15) & 15], w2 = w[(T - 2) & 15];
    const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
    const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
    w[T & 15] += s0 + w[(T - 7) & 15] + s1;
  }
  constexpr uint32_t k = sha_k(T);
  return w[T & 15] + k;
}

// The schedule of one block (w: its 16 words, overwritten) as W[t] + K[t],
// four rounds a uint4: wk[q * stride] holds rounds 4q..4q+3.
template <int Q = 0>
TM_HASH_DEV void sha_schedule(uint32_t (&w)[16], uint4* wk, int stride) {
  if constexpr (Q < 16) {
    uint4 v;
    v.x = sha_word_k<4 * Q>(w);
    v.y = sha_word_k<4 * Q + 1>(w);
    v.z = sha_word_k<4 * Q + 2>(w);
    v.w = sha_word_k<4 * Q + 3>(w);
    wk[Q * stride] = v;
    sha_schedule<Q + 1>(w, wk, stride);
  }
}

// x + y + z as one IADD3 in that grouping: the compiler otherwise
// reassociates a round's sums and puts four or five adds in sequence on
// the chain through e (on the host, a plain sum)
TM_HASH_DEV uint32_t add3(uint32_t x, uint32_t y, uint32_t z) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("{\n\t.reg .u32 t;\n\tadd.u32 t, %1, %2;\n\tadd.u32 %0, t, %3;\n\t}"
      : "=r"(r) : "r"(x), "r"(y), "r"(z));
  return r;
#else
  return x + y + z;
#endif
}

// round T on s = (a, b, c, d, e, f, g, h) with wk = W[T] + K[T]:
// e' = Sigma1 + Ch + (d + h + wk) and a' = e' + Sigma0 + (Maj - d), so
// that each new word is one IADD3 after its Sigma's LOP3, with d + h + wk
// summed off the chain (d and h are a and e of three rounds back)
template <int T>
TM_HASH_DEV void sha_round(uint32_t (&s)[8], uint32_t wk) {
  const uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
  const uint32_t sig1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t sig0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  const uint32_t e1 = add3(sig1, ch, d + h + wk);
  s[7] = g;
  s[6] = f;
  s[5] = e;
  s[4] = e1;
  s[3] = c;
  s[2] = b;
  s[1] = a;
  s[0] = add3(e1, sig0, maj - d);
}

// The 64 rounds on s from the sums sha_schedule wrote (wk[q * stride],
// four rounds each).
template <int Q = 0>
TM_HASH_DEV void sha_rounds(uint32_t (&s)[8], const uint4* wk, int stride) {
  if constexpr (Q < 16) {
    const uint4 v = wk[Q * stride];
    sha_round<4 * Q>(s, v.x);
    sha_round<4 * Q + 1>(s, v.y);
    sha_round<4 * Q + 2>(s, v.z);
    sha_round<4 * Q + 3>(s, v.w);
    sha_rounds<Q + 1>(s, wk, stride);
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
  uint4 wk[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = x[i];
  sha_schedule(w, wk, 1);
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = h[i];
  sha_rounds(s, wk, 1);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] += s[i];
}

// The digest of one MD-padded message of `nblocks` blocks into out[0..7],
// on one thread.
TM_HASH_DEV void sha256_message(const uint4* blocks, int nblocks, uint32_t* out) {
  uint32_t h[8], x[16];
  sha256_init(h);
#pragma unroll 1
  for (int b = 0; b < nblocks; ++b) {
    load_block(x, blocks + 4 * b);
    sha256_compress(h, x);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = h[i];
}

}  // namespace
