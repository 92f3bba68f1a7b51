// K1 and K2: batched RIPEMD-160 and SHA-256, one thread a message.
//
// Replaces the JAX package's XLA hash kernels (B6),
// tendermint_tpu/ops/hashing.py:133 ripemd160_words (body _ripemd160_block
// :99) and :232 sha256_words (body _sha256_block :196). Those scan every
// message over the batch's longest block count in a dense [B, max_blocks,
// 16] tensor, freezing finished lanes; here the messages' padded blocks
// lie end to end (uint32[total_blocks, 16]) with a first block and a block
// count a message, so a batch of one 10,240-byte transaction among 10,000
// small ones moves the sum of its padded lengths, not 10,000 x 161 blocks.
//
// What bounds it on this card: a message's blocks are a serial chain (each
// compression needs the last one's state), so a batch is bound by the
// larger of its longest message's chain (blocks x about 320 dependent
// instructions of RIPEMD-160, a block each) and the whole batch's integer
// instructions over the card's ALU rate. A 64 KB part is 1,025 blocks in
// sequence whatever the part count. The design does two things about it:
// the state and the block stay in registers (all indices are compile-time,
// ripemd160.cuh), and the next block's loads issue before the current
// block's compression, so only the chain is left on the path. A thread
// that finishes early idles its lane: parts are equal-length, and tx
// lengths differ by at most 161 blocks.
//
// tm_hash_blocks writes `out` row by row (5 words a message for RIPEMD-160,
// 8 for SHA-256): the tree path points it at rows 0..n-1 of K3's node
// buffer, so leaf digests never leave the card.

#include "ripemd160.cuh"
#include "sha256.cuh"

namespace {

constexpr int kThreads = 128;

template <int ALGO>
__global__ void __launch_bounds__(kThreads)
    hash_blocks_kernel(const uint4* __restrict__ words, const int32_t* __restrict__ first,
                       const int32_t* __restrict__ nblocks, uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4* blocks = words + 4 * static_cast<int64_t>(first[i]);
  if constexpr (ALGO == 0) {
    ripemd160_message(blocks, nblocks[i], out + 5 * static_cast<int64_t>(i));
  } else {
    sha256_message(blocks, nblocks[i], out + 8 * static_cast<int64_t>(i));
  }
}

}  // namespace

// algo 0: RIPEMD-160 (K1), 1: SHA-256 (K2). words: uint32[total_blocks, 16];
// first, nblocks: int32[n]; out: uint32[n, 5] or [n, 8]. Launches on
// `stream` without synchronising; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for another algo.
extern "C" int tm_hash_blocks(int algo, const void* words, const int32_t* first,
                              const int32_t* nblocks, uint32_t* out, int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n + kThreads - 1) / kThreads;
  const uint4* w = static_cast<const uint4*>(words);
  if (algo == 0) {
    hash_blocks_kernel<0><<<grid, kThreads, 0, s>>>(w, first, nblocks, out, n);
  } else if (algo == 1) {
    hash_blocks_kernel<1><<<grid, kThreads, 0, s>>>(w, first, nblocks, out, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
