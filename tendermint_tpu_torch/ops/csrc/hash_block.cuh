// What the hash kernels share (ripemd160.cuh, sha256.cuh): the rotates
// and the load of one 64-byte message block.
//
// A message is MD-padded on the host and its blocks lie end to end in one
// buffer of 16-word rows; the kernels walk a message's own blocks
// (ops/hashing.py packs them: '<u4' words for RIPEMD-160, '>u4' for
// SHA-256, so a word here is already the value the compression takes).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define TM_HASH_DEV __device__ __forceinline__

namespace {

// one SHF.L.W / SHF.R.W: a funnel shift with both halves the same word
TM_HASH_DEV uint32_t rotl32(uint32_t x, int n) { return __funnelshift_l(x, x, n); }
TM_HASH_DEV uint32_t rotr32(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

// the 16 words of a 64-byte block, in four 16-byte loads
TM_HASH_DEV void load_block(uint32_t (&x)[16], const uint4* blk) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = blk[q];
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

}  // namespace
