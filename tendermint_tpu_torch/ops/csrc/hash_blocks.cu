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
// are compile-time, ripemd160.cuh, sha256.cuh), and the next blocks' loads
// are in flight during the current block's compression, so only the chain
// and issuing the compression's own instructions are left on the path.
//
// Both kernels give a message two threads: a block of two warps takes 32
// messages, lane t of each warp working on message t. Each warp's code is
// uniform: its part depends on the warp index only. Both warps walk to the
// largest block count of their 32 messages (__reduce_max_sync), so they
// meet the same barriers; a lane whose message has ended keeps its state
// and idles, and lanes past n walk too and write nothing.
//
// K1 runs message t's left line on lane t of warp 0 and its right line on
// lane t of warp 1, so the two 80-step chains of a compression run side by
// side on two warps (one thread running both waits them out one after the
// other: ptxas lays the lines out in sequence and a warp runs in order).
// Both threads hold the chaining state; after each block's line they swap
// their line's five words through shared memory (double-buffered, so one
// __syncthreads a block is the pair's only barrier) and both apply the
// join.
//
// K2 splits a compression into its schedule and its rounds. Warp 1, the
// schedule warp, expands each block's 64 schedule words and writes W + K
// for every round into shared memory (double-buffered, four rounds a
// 16-byte word), one block ahead of warp 0, the compression warp, which
// runs the 64 rounds with the state in registers and one shared load every
// four rounds: no schedule work and no device-memory load is left on the
// thread that carries the chain. One __syncthreads a block hands a buffer
// over.
//
// A block's compression is shorter than the load of the next block from
// device memory, and ptxas sinks a register prefetch to the end of the
// loop, so each thread that reads blocks (both of K1's, K2's schedule
// warp) copies them kAhead ahead into a ring of its own in shared memory
// (cp.async, one commit group a block) and reads the current one from
// there.
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

// A K2 block's shared memory: the schedule warp's ring of blocks, [slot]
// [quarter][lane] as K1's, and the sums W + K it hands the compression
// warp, [buffer][four rounds][lane], so that both warps' 16-byte accesses
// are conflict-free.
struct ShaShared {
  uint4 ring[kSlots][4][kPairLanes];
  uint4 wk[2][16][kPairLanes];
};

// block b of a message (if it has one) into ring slot `slot` of the
// schedule warp's lane, one commit group either way
TM_HASH_DEV void fetch_sha_block(ShaShared& sh, const uint4* blocks, int b, int nb, int slot, int lane) {
  if (b < nb) {
#pragma unroll
    for (int q = 0; q < 4; ++q) __pipeline_memcpy_async(&sh.ring[slot][q][lane], blocks + 4 * b + q, 16);
  }
  __pipeline_commit();
}

// One K2 block's walk for lane `lane` (message m0 + lane) of warp ROLE:
// 0 the compression warp, 1 the schedule warp. Each meets `most`
// barriers: the schedule warp's b-th follows its write of block b's sums,
// the compression warp's b-th precedes its read of them, so the schedule
// warp writes block b + 1 while the rounds of block b run, into the
// buffer the rounds of block b - 1 have left.
template <int ROLE>
TM_HASH_DEV void sha256_pair(ShaShared& sh, const uint4* words, const int32_t* first,
                             const int32_t* nblocks, uint32_t* out, int n, int m0, int lane) {
  const int i = m0 + lane;
  const bool live = i < n;
  const int nb = live ? nblocks[i] : 0;
  const int most = __reduce_max_sync(0xFFFFFFFFu, nb);  // the same in both warps
  if constexpr (ROLE == 1) {
    const uint4* blocks = words + 4 * static_cast<int64_t>(live ? first[i] : 0);
#pragma unroll
    for (int d = 0; d < kAhead; ++d) fetch_sha_block(sh, blocks, d, nb, d, lane);
    int slot = 0;  // block b's slot: b mod kSlots
#pragma unroll 1
    for (int b = 0; b < most; ++b) {
      __pipeline_wait_prior(kAhead - 1);  // block b's group has landed
      uint32_t w[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = sh.ring[slot][q][lane];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
      // block b + kAhead into the slot read one block ago
      fetch_sha_block(sh, blocks, b + kAhead, nb, slot == 0 ? kSlots - 1 : slot - 1, lane);
      slot = slot == kSlots - 1 ? 0 : slot + 1;
      sha_schedule(w, &sh.wk[b & 1][0][lane], kPairLanes);
      __syncthreads();
    }
    __pipeline_wait_prior(0);
  } else {
    uint32_t h[8];
    sha256_init(h);
#pragma unroll 1
    for (int b = 0; b < most; ++b) {
      __syncthreads();  // block b's sums are in buffer b & 1
      uint32_t s[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] = h[k];
      sha_rounds(s, &sh.wk[b & 1][0][lane], kPairLanes);
      if (b < nb) {
#pragma unroll
        for (int k = 0; k < 8; ++k) h[k] += s[k];
      }
    }
    if (live) {
#pragma unroll
      for (int k = 0; k < 8; ++k) out[8 * static_cast<int64_t>(i) + k] = h[k];
    }
  }
}

constexpr int kThreads = 2 * kPairLanes;  // a block of either kernel: 32 messages on two warps

// The launch bound stays at 128 threads, the bound K1 was tuned under: at
// 64, ptxas gives K1 two more registers and a schedule 2-5% slower.
template <int ALGO>
__global__ void __launch_bounds__(2 * kThreads)
    hash_blocks_kernel(const uint4* __restrict__ words, const int32_t* __restrict__ first,
                       const int32_t* __restrict__ nblocks, uint32_t* __restrict__ out, int n) {
  const int m0 = blockIdx.x * kPairLanes;
  const int lane = threadIdx.x % kPairLanes;
  if constexpr (ALGO == 0) {
    __shared__ PairShared sh;
    if (threadIdx.x < kPairLanes) {
      ripemd160_pair<0>(sh, words, first, nblocks, out, n, m0, lane);
    } else {
      ripemd160_pair<1>(sh, words, first, nblocks, out, n, m0, lane);
    }
  } else {
    __shared__ ShaShared sh;
    if (threadIdx.x < kPairLanes) {
      sha256_pair<0>(sh, words, first, nblocks, out, n, m0, lane);
    } else {
      sha256_pair<1>(sh, words, first, nblocks, out, n, m0, lane);
    }
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
  const int grid = (n + kPairLanes - 1) / kPairLanes;
  if (algo == 0) {
    hash_blocks_kernel<0><<<grid, kThreads, 0, s>>>(w, first, nblocks, out, n);
  } else if (algo == 1) {
    hash_blocks_kernel<1><<<grid, kThreads, 0, s>>>(w, first, nblocks, out, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
