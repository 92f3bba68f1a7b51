// K3: a simple-Merkle tree's inner nodes, one launch a tree.
//
// Replaces the JAX package's XLA tree kernel (B6),
// tendermint_tpu/ops/merkle.py:126 _run_tree, whose fori_loop runs one
// batched inner hash a round (_inner_hash_batch :118, the preimage of
// _inner_preimage_words :98) over a dense [rounds, max_width] schedule.
// Here one block walks the same rounds (ops/merkle.py _dense_schedule, from
// merkle/simple.py _flat_shape), __syncthreads between them, its threads
// taking a round's nodes in turn; only a round's real width is hashed, not
// the schedule's padding. The node buffer (uint32[2n, 5], leaves in rows
// 0..n-1, FlatTree's postorder after them, a scratch row last) is read
// and written in place: a node is written in one round and read in a later
// one, after the barrier, so it is read with plain loads, not through the
// read-only cache.
//
// What bounds it: each round is one RIPEMD-160 compression deep, so a tree
// of n leaves is ceil(log2 n) compressions in sequence (14 at 10,000
// leaves) while a round wider than the block repeats; the n - 1
// compressions' instructions over one SM's issue rate bound the widest
// trees. At the part sets' 16-336 leaves the chain governs.
//
// The preimage is 0x01 0x14 | left | 0x01 0x14 | right (encode_bytes of
// two 20-byte digests, merkle.simple.inner_hash), 0x80 at byte 44 and the
// bit length 352 at bytes 56-57: the left digest's words land 16 bits off
// their alignment, the right digest's on it.

#include "ripemd160.cuh"

namespace {

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

// nodes[o] = inner_hash(nodes[ls], nodes[rs])
TM_HASH_DEV void inner_node(uint32_t* nodes, int o, int ls, int rs) {
  uint32_t l[5], r[5], x[16], h[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    l[i] = nodes[5 * ls + i];
    r[i] = nodes[5 * rs + i];
  }
  inner_preimage(x, l, r);
  ripemd160_init(h);
  ripemd160_compress(h, x);
#pragma unroll
  for (int i = 0; i < 5; ++i) nodes[5 * o + i] = h[i];
}

constexpr int kThreads = 1024;

// rounds x stride schedule (left, right, out: node slots); widths[r] nodes
// of round r are real, the rest padding
__global__ void __launch_bounds__(kThreads)
    merkle_tree_kernel(uint32_t* nodes, const int32_t* __restrict__ left,
                       const int32_t* __restrict__ right, const int32_t* __restrict__ out,
                       const int32_t* __restrict__ widths, int rounds, int stride) {
  for (int rd = 0; rd < rounds; ++rd) {
    const int w = widths[rd];
    const int base = rd * stride;
    for (int k = threadIdx.x; k < w; k += blockDim.x) {
      inner_node(nodes, out[base + k], left[base + k], right[base + k]);
    }
    __syncthreads();
  }
}

}  // namespace

// One block of `threads` (a multiple of 32, at most 1024) fills every
// internal node of `nodes` round by round. Launches on `stream` without
// synchronising; returns cudaGetLastError() (0 on success).
extern "C" int tm_merkle_tree(uint32_t* nodes, const int32_t* left, const int32_t* right,
                              const int32_t* out, const int32_t* widths, int rounds, int stride,
                              int threads, void* stream) {
  if (threads <= 0 || threads > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  merkle_tree_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nodes, left, right, out, widths, rounds, stride);
  return static_cast<int>(cudaGetLastError());
}
