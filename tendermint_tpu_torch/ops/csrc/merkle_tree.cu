// K3: a simple-Merkle tree's inner nodes, one launch a tree.
//
// Replaces the JAX package's XLA tree kernel (B6),
// tendermint_tpu/ops/merkle.py:126 _run_tree, whose fori_loop runs one
// batched inner hash a round (_inner_hash_batch :118, the preimage of
// _inner_preimage_words :98) over a dense [rounds, max_width] schedule.
// Here the kernel walks the same rounds (ops/merkle.py _dense_schedule,
// from merkle/simple.py _flat_shape) and hashes only a round's real width,
// not the schedule's padding. The node buffer (uint32[2n, 5], leaves in
// rows 0..n-1, FlatTree's postorder after them, a scratch row last) is
// read and written in place: a node is written in one round and read in a
// later one, after a grid or block barrier, so it is read with plain
// loads, not through the read-only cache.
//
// What bounds it: each round is one RIPEMD-160 compression deep, so a tree
// of n leaves is ceil(log2 n) compressions in sequence (14 at 10,000
// leaves); the n - 1 compressions' instructions over the card's ALU rate
// are far below that chain. The design does two things about it:
// - A node's two lines run on a pair of warps, as in K1 (hash_blocks.cu):
//   lane t of the pair's first warp runs the left line of the pair's node
//   t, lane t of its second warp the right line; the right line's five
//   words pass to the first warp through shared memory (double-buffered:
//   one __syncthreads a sweep), which joins and writes the node, so a
//   round costs one line's chain, not two.
// - While a round is wider than one block takes in one sweep (a pair of
//   warps a 32 nodes), its nodes spread over a cooperative grid of blocks,
//   a grid barrier after each such round; the narrow rounds left run in
//   block 0 alone, __syncthreads between them. A block's pairs take the
//   grid's 32-node groups pair-major across the blocks (pair q of block b
//   is the grid's pair q * blocks + b), so a wide round's groups land on
//   every SM before any SM takes a second.
// Every pair of the grid (or of block 0) sweeps a round the same number of
// times, so every thread of a block meets the same barriers; a pair with
// no node in a sweep skips its lines, so the idle warps of a block leave
// the SM's instruction slots to the busy ones. The widths sit in shared memory,
// and in block 0 a pair loads its next round's schedule entries during the
// current round's lines, so a round's path holds one load from memory (its
// children), not three in sequence.
//
// The preimage is 0x01 0x14 | left | 0x01 0x14 | right (encode_bytes of
// two 20-byte digests, merkle.simple.inner_hash), 0x80 at byte 44 and the
// bit length 352 at bytes 56-57: the left digest's words land 16 bits off
// their alignment, the right digest's on it.

#include <cooperative_groups.h>

#include "ripemd160.cuh"

namespace {

constexpr int kMaxPairs = 16;   // pairs of a block of 1,024 threads
constexpr int kMaxRounds = 64;  // a tree's rounds (ceil(log2 n) for n leaves)

// one padded block of an inner node's preimage from its children's
// little-endian digest words
TM_HASH_DEV void inner_preimage(uint32_t (&x)[16], const uint32_t (&l)[5], const uint32_t (&r)[5]) {
  x[0] = 0x1401u | (l[0] << 16);
#pragma unroll
  for (int i = 1; i < 5; ++i) x[i] = __funnelshift_r(l[i - 1], l[i], 16);
  x[5] = (l[4] >> 16) | 0x14010000u;
#pragma unroll
  for (int i = 0; i < 5; ++i) x[6 + i] = r[i];
  x[11] = 0x80u;
  x[12] = 0;
  x[13] = 0;
  x[14] = 352;  // 44 bytes in bits
  x[15] = 0;
}

// A K3 block's shared memory: the right lines' words for the left lines'
// threads, [buffer][pair][word][lane], and every round's width.
struct TreeShared {
  uint32_t xchg[2][kMaxPairs][5][kPairLanes];
  int32_t widths[kMaxRounds];
};

// One sweep of a pair of warps: node `o` = inner_hash(nodes[ls],
// nodes[rs]) for the thread running line `line` of lane `lane` of pair
// `slot`, if `live`; a pair with no live lane (`active` false) only meets
// the barrier. `it` counts the sweeps, choosing the exchange buffer.
TM_HASH_DEV void pair_node(TreeShared& sh, uint32_t* nodes, bool active, bool live, int ls, int rs,
                           int o, int slot, int line, int lane, int& it) {
  uint32_t mine[5];
  if (active) {  // the same for both warps of the pair
    uint32_t l[5] = {}, r[5] = {}, x[16], h[5];
    if (live) {
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        l[i] = nodes[5 * ls + i];
        r[i] = nodes[5 * rs + i];
      }
    }
    inner_preimage(x, l, r);
    ripemd160_init(h);
    if (line == 0) {
      rmd_line<0>(h, x, mine);
    } else {
      rmd_line<1>(h, x, mine);
#pragma unroll
      for (int i = 0; i < 5; ++i) sh.xchg[it & 1][slot][i][lane] = mine[i];
    }
  }
  __syncthreads();
  if (line == 0 && live) {
    uint32_t h[5], other[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) other[i] = sh.xchg[it & 1][slot][i][lane];
    ripemd160_init(h);
    rmd_join(h, mine, other);
#pragma unroll
    for (int i = 0; i < 5; ++i) nodes[5 * o + i] = h[i];
  }
  ++it;
}

// Every internal node of `nodes`, for the calling thread of a block of
// blockDim.x threads (pairs of warps) in a grid of gridDim.x blocks. The
// rounds' widths are read once into shared memory. Rounds wider than the
// block's pairs x 32 nodes run over the grid, a grid_sync() after each:
// 32-node group g of a round goes to the grid's pair g mod (its pairs),
// every pair sweeping as often as the most loaded one. The rest run in
// block 0, pair q taking nodes 32q..32q+31 of each round in one sweep, its
// next round's schedule loaded during this one's lines.
template <class Sync>
TM_HASH_DEV void merkle_walk(TreeShared& sh, uint32_t* nodes, const int32_t* left,
                             const int32_t* right, const int32_t* out, const int32_t* widths,
                             int rounds, int stride, Sync grid_sync) {
  const int warp = threadIdx.x / kPairLanes, lane = threadIdx.x % kPairLanes;
  const int slot = warp / 2, line = warp % 2;
  const int pairs = blockDim.x / (2 * kPairLanes);
  const int cut = pairs * kPairLanes;  // nodes one block takes in one sweep
  for (int rd = threadIdx.x; rd < rounds; rd += blockDim.x) sh.widths[rd] = widths[rd];
  __syncthreads();
  int it = 0, rd = 0;
  for (; rd < rounds && sh.widths[rd] > cut; ++rd) {
    const int width = sh.widths[rd], groups = (width + kPairLanes - 1) / kPairLanes;
    const int total = pairs * gridDim.x, p = slot * gridDim.x + blockIdx.x;
    for (int g = p; g - p < groups; g += total) {
      const int k = g * kPairLanes + lane, at = rd * stride + k;
      const bool live = k < width;
      pair_node(sh, nodes, g < groups, live, live ? left[at] : 0, live ? right[at] : 0,
                live ? out[at] : 0, slot, line, lane, it);
    }
    grid_sync();
  }
  if (blockIdx.x != 0) return;
  const int k = slot * kPairLanes + lane;
  int ls = 0, rs = 0, o = 0;
  if (rd < rounds && k < sh.widths[rd]) {
    ls = left[rd * stride + k];
    rs = right[rd * stride + k];
    o = out[rd * stride + k];
  }
  for (; rd < rounds; ++rd) {
    int next_ls = 0, next_rs = 0, next_o = 0;
    if (rd + 1 < rounds && k < sh.widths[rd + 1]) {
      next_ls = left[(rd + 1) * stride + k];
      next_rs = right[(rd + 1) * stride + k];
      next_o = out[(rd + 1) * stride + k];
    }
    pair_node(sh, nodes, slot * kPairLanes < sh.widths[rd], k < sh.widths[rd], ls, rs, o, slot, line,
              lane, it);
    __syncthreads();
    ls = next_ls;
    rs = next_rs;
    o = next_o;
  }
}

constexpr int kThreads = kMaxPairs * 2 * kPairLanes;

struct GridSync {
  __device__ void operator()() const { cooperative_groups::this_grid().sync(); }
};

// rounds x stride schedule (left, right, out: node slots); widths[r] nodes
// of round r are real, the rest padding
__global__ void __launch_bounds__(kThreads)
    merkle_tree_kernel(uint32_t* nodes, const int32_t* __restrict__ left,
                       const int32_t* __restrict__ right, const int32_t* __restrict__ out,
                       const int32_t* __restrict__ widths, int rounds, int stride) {
  __shared__ TreeShared sh;
  merkle_walk(sh, nodes, left, right, out, widths, rounds, stride, GridSync{});
}

}  // namespace

// Fills every internal node of `nodes` round by round with blocks of
// `threads` (a multiple of 64, at most 1024; at most kMaxRounds rounds):
// one block when the widest round (`stride`) fits one sweep of it
// (threads / 2 nodes), else a cooperative grid of as many blocks as are
// resident at once, at most one a 32-node group of the widest round. Launches on `stream` without
// synchronising; returns cudaGetLastError() or the cooperative launch's
// error (0 on success): a grid the card cannot hold at once is refused.
extern "C" int tm_merkle_tree(uint32_t* nodes, const int32_t* left, const int32_t* right,
                              const int32_t* out, const int32_t* widths, int rounds, int stride,
                              int threads, void* stream) {
  if (threads <= 0 || threads > kThreads || threads % (2 * kPairLanes) != 0 || rounds > kMaxRounds) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride <= threads / 2) {
    merkle_tree_kernel<<<1, threads, 0, s>>>(nodes, left, right, out, widths, rounds, stride);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, merkle_tree_kernel, threads, 0);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int groups = (stride + kPairLanes - 1) / kPairLanes;
  const int grid = per_sm * sms < groups ? per_sm * sms : groups;
  if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&nodes, &left, &right, &out, &widths, &rounds, &stride};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(merkle_tree_kernel),
                                                      dim3(grid), dim3(threads), args, 0, s));
}
