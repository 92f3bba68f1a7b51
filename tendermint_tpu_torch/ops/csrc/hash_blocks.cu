// K1 and K2: batched RIPEMD-160 and SHA-256.
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
// larger of its longest message's chain (blocks x the compression's
// dependent instructions) and the whole batch's integer instructions over
// the card's ALU rate. A 64 KB part is 1,025 blocks in sequence whatever
// the part count. The state and the block stay in registers (all indices
// are compile-time, ripemd160.cuh), and the next blocks' loads are in
// flight during the current block's compression, so only the chain is
// left on the path.
//
// K1 gives a message two threads: a block of two warps takes 32 messages,
// lane t of warp 0 running message t's left line and lane t of warp 1 its
// right line, so the two 80-step chains of a compression run side by side
// on two warps (one thread running both waits them out one after the
// other: ptxas lays the lines out in sequence and a warp runs in order).
// Both threads hold the chaining state; after each block's line they swap
// their line's five words through shared memory (double-buffered, so one
// __syncthreads a block is the pair's only barrier) and both apply the
// join. Each warp's code is uniform: its line depends on the warp index
// only. Both warps walk to the largest block count of their 32 messages,
// so they meet the same barriers; a lane whose message has ended keeps its
// state and idles, and lanes past n walk too and write nothing.
//
// A line of a block is shorter than the load of the next block from
// device memory, and ptxas sinks a register prefetch to the end of the
// loop, so each thread copies its blocks kAhead ahead into a ring of its
// own in shared memory (cp.async, one commit group a block) and reads the
// current one from there. K2 keeps one thread a message.
//
// tm_hash_blocks writes `out` row by row (5 words a message for RIPEMD-160,
// 8 for SHA-256): the tree path points it at rows 0..n-1 of K3's node
// buffer, so leaf digests never leave the card.

#include <cuda_pipeline.h>

#include "ripemd160.cuh"
#include "sha256.cuh"

namespace {

constexpr int kAhead = 4;  // blocks a thread has in flight beyond the one it compresses
constexpr int kSlots = kAhead + 1;

// A K1 block's shared memory: each thread's ring of blocks, [slot]
// [quarter][thread] so that a quarter's 16-byte reads are conflict-free,
// and the lines' exchange, [buffer][line][word][lane].
struct PairShared {
  uint4 ring[kSlots][4][2 * kPairLanes];
  uint32_t xchg[2][2][5][kPairLanes];
};

// block b of a message (if it has one) into ring slot `slot` of thread t,
// one commit group either way, so every thread counts the same groups
TM_HASH_DEV void fetch_block(PairShared& sh, const uint4* blocks, int b, int nb, int slot, int t) {
  if (b < nb) {
#pragma unroll
    for (int q = 0; q < 4; ++q) __pipeline_memcpy_async(&sh.ring[slot][q][t], blocks + 4 * b + q, 16);
  }
  __pipeline_commit();
}

// One K1 block's walk for the thread running line LINE of message m0 +
// lane (a lane of warp LINE).
template <int LINE>
TM_HASH_DEV void ripemd160_pair(PairShared& sh, const uint4* words, const int32_t* first,
                                const int32_t* nblocks, uint32_t* out, int n, int m0, int lane) {
  const int t = LINE * kPairLanes + lane;
  const int i = m0 + lane;
  const bool live = i < n;
  const int nb = live ? nblocks[i] : 0;
  const int most = __reduce_max_sync(0xFFFFFFFFu, nb);  // the same in both warps
  const uint4* blocks = words + 4 * static_cast<int64_t>(live ? first[i] : 0);
  uint32_t h[5];
  ripemd160_init(h);
#pragma unroll
  for (int d = 0; d < kAhead; ++d) fetch_block(sh, blocks, d, nb, d, t);
  int slot = 0;  // block b's slot: b mod kSlots
#pragma unroll 1
  for (int b = 0; b < most; ++b) {
    __pipeline_wait_prior(kAhead - 1);  // block b's group has landed
    uint32_t x[16], mine[5], other[5];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = sh.ring[slot][q][t];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
    // block b + kAhead into the slot read one block ago
    fetch_block(sh, blocks, b + kAhead, nb, slot == 0 ? kSlots - 1 : slot - 1, t);
    slot = slot == kSlots - 1 ? 0 : slot + 1;
    rmd_line<LINE>(h, x, mine);
#pragma unroll
    for (int k = 0; k < 5; ++k) sh.xchg[b & 1][LINE][k][lane] = mine[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 5; ++k) other[k] = sh.xchg[b & 1][1 - LINE][k][lane];
    if (b < nb) {
      if constexpr (LINE == 0) {
        rmd_join(h, mine, other);
      } else {
        rmd_join(h, other, mine);
      }
    }
  }
  __pipeline_wait_prior(0);
  if (LINE == 0 && live) {
#pragma unroll
    for (int k = 0; k < 5; ++k) out[5 * static_cast<int64_t>(i) + k] = h[k];
  }
}

constexpr int kThreads = 128;  // K2's block, one thread a message
constexpr int kPairThreads = 2 * kPairLanes;  // K1's block

template <int ALGO>
__global__ void __launch_bounds__(kThreads)
    hash_blocks_kernel(const uint4* __restrict__ words, const int32_t* __restrict__ first,
                       const int32_t* __restrict__ nblocks, uint32_t* __restrict__ out, int n) {
  if constexpr (ALGO == 0) {
    __shared__ PairShared sh;
    const int m0 = blockIdx.x * kPairLanes;
    const int lane = threadIdx.x % kPairLanes;
    if (threadIdx.x < kPairLanes) {
      ripemd160_pair<0>(sh, words, first, nblocks, out, n, m0, lane);
    } else {
      ripemd160_pair<1>(sh, words, first, nblocks, out, n, m0, lane);
    }
  } else {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    sha256_message(words + 4 * static_cast<int64_t>(first[i]), nblocks[i],
                   out + 8 * static_cast<int64_t>(i));
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
  const uint4* w = static_cast<const uint4*>(words);
  if (algo == 0) {
    const int grid = (n + kPairLanes - 1) / kPairLanes;
    hash_blocks_kernel<0><<<grid, kPairThreads, 0, s>>>(w, first, nblocks, out, n);
  } else if (algo == 1) {
    const int grid = (n + kThreads - 1) / kThreads;
    hash_blocks_kernel<1><<<grid, kThreads, 0, s>>>(w, first, nblocks, out, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
