// Strict cofactorless Ed25519 verification by 253 single-bit Straus steps,
// four threads per signature, for Hopper (sm_90a).
//
// Replaces the TPU kernel tendermint_tpu/ops/ed25519_pallas.py::_verify_kernel
// (ed25519_pallas.py:186, launched by `_make_verify.call`, :261). It
// computes the same function as B1 (ed25519_verify.cu): accept iff
// compress([s]B + [h](-A)) == R, where the host has already rejected
// s >= L, R.y >= p, bad points and bad lengths (prepare_batch8) and masks
// those lanes afterwards. The plain PyTorch version it is held against is
// tendermint_tpu_torch/ops/ed25519_pallas.py::verify_plain.
//
// It keeps the algorithm that makes B2 a contender distinct from B1: the
// 4-entry joint table {0, B, -A, B-A}, indexed by (bit k of s) + 2 (bit k
// of h), and 253 steps MSB first, each one doubling with T and one cached
// addition, the addition never skipped (B1: a 16-entry table and 127
// two-bit steps).
//
// Work per lane, summed over its four threads and counted from the code
// below and fe25519x4.cuh: 3,062 field multiplications and 1,266 squarings
// (table: -A's and B's T 2, their cached forms 2, B-A 8, its cached form
// 1: 13; ladder 253 x (doubling 4 + 4 squarings, addition 8); inversion
// 11 + 254; affine x and y 2): 3,062 x 100 + 1,266 x 55 = 375,830
// 32x32->64-bit limb products (1.38x B1). A lane moves 168 bytes (five
// 32-byte inputs, one int32 sign, one int32 verdict).
// ed25519_pallas.MULS_PER_LANE / SQS_PER_LANE carry the same counts for
// the bound that chip_smoke.py reports.
//
// Critical path, in field operations on one thread: table 7 (-A 1, its
// cached form 1, B 1, its cached form 1, B-A 2, its cached form 1), ladder
// 253 x 4 = 1,012, inversion 265, affine 1: 1,285, against 14 + 253 x 16 +
// 265 + 2 = 4,329 with one thread per lane. A step exchanges 10 Fe values
// inside the group (5 a point operation). The serial inversion is a fifth
// of the path (20.6%).
//
// What bounds it on this card: latency. Up to 4,096 lanes each scheduler
// holds at most one warp, each warp one dependent chain of serial carries
// and shuffle round trips, and the time is that chain (about 0.53 ms on an
// H100 80GB HBM3 at 700 W, PERF.md); at 16,384 lanes (four warps a
// scheduler) the kernel issues its limb products at about 52% of the
// measured IMAD.WIDE rate. The bound chip_smoke.py reports is the limb
// products over that rate. The design is B1's:
// - Four threads carry one lane (fe25519x4.cuh): thread t of a group holds
//   coordinate t of the extended point and of each cached table entry, and
//   each point operation is two stages of one field operation per thread
//   with warp shuffles between them. A warp carries 8 lanes, a 128-thread
//   block 32.
// - The first warp of each block inverts the block's 32 Z values, one a
//   thread (block_invert).
// - Native integer limbs instead of the TPU's 17 x 15 bits: 10 signed
//   limbs of radix 2^25.5, one IMAD.WIDE a limb product.
// - Each thread keeps its coordinate of the four cached entries in
//   registers and picks one by the bit pair with selects (fe_pick), 1.5-3%
//   faster than B1's way, an array indexed in local memory (PERF.md);
//   all four threads read the lane's s and h words, so the pair selects the
//   same entry on each.
// - The kernel extracts bit k from the scalar bytes itself (not the TPU
//   path's 2 x 253 int32 bit rows, 2 KB a lane), takes n lanes with no
//   padding, and masks the ragged edge by clamping, never by an early
//   return (the shuffles need every thread).

#include "fe25519x4.cuh"

namespace {

// One lane on four threads (t = rank in the group) of a block of LANES
// lanes: on thread 0, 1 if compress([s]B + [h](-A)) == R, else 0;
// unspecified on the others. zs is block_invert's.
template <int LANES>
TM_DEV int32_t verify_lane_b2(int t, const uint32_t axw[8], const uint32_t ayw[8],
                              const uint32_t ryw[8], int32_t rsign, const uint32_t sw[8],
                              const uint32_t hw[8], Fe* zs) {
  const Fe d2 = fe_const(0);
  const Fe neg_a = ge4_affine(t, fe_sub(fe_small(0), fe_from_words(axw)), fe_from_words(ayw));
  const Fe b = ge4_affine(t, fe_const(1), fe_const(2));
  const Fe neg_a_c = ge4_cached(t, neg_a, d2);
  // table[sbit + 2 hbit], this thread's coordinate of each cached entry
  const Fe table[4] = {ge4_cached_identity(t), ge4_cached(t, b, d2), neg_a_c,
                       ge4_cached(t, ge4_add(t, b, neg_a_c), d2)};
  const Fe acc = ge4_ladder_bits(t, table, sw, hw);

  const Fe w = ge4_to_affine<LANES>(t, acc, zs);  // thread 0: x, thread 1: y
  const Fe y = fe_shfl(w, 1);
  const Fe ry = fe_from_words(ryw);  // R.y < p (host-checked): already canonical
  bool eq = (w.v[0] & 1) == rsign;
#pragma unroll
  for (int i = 0; i < 10; ++i) eq = eq && (y.v[i] == ry.v[i]);
  return eq ? 1 : 0;
}

constexpr int kThreads = 128;  // 32 lanes a block
constexpr int kLanes = kThreads / 4;
constexpr int kMinBlocks = 512 / kThreads;  // 512 threads an SM: at most 128 registers each

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ed25519_verify_b2_kernel(const uint8_t* __restrict__ ax, const uint8_t* __restrict__ ay,
                             const uint8_t* __restrict__ ry, const int32_t* __restrict__ rsign,
                             const uint8_t* __restrict__ s8, const uint8_t* __restrict__ h8,
                             int32_t* __restrict__ out, int n) {
  const int t = threadIdx.x & 3;
  const int group = blockIdx.x * kLanes + (threadIdx.x >> 2);
  const int lane = group < n ? group : n - 1;  // a group past the end recomputes the last lane
  uint32_t axw[8], ayw[8], ryw[8], sw[8], hw[8];
  load_words(ax, n, lane, axw);
  load_words(ay, n, lane, ayw);
  load_words(ry, n, lane, ryw);
  load_words(s8, n, lane, sw);
  load_words(h8, n, lane, hw);
  __shared__ Fe zs[kLanes];
  const int32_t ok = verify_lane_b2<kLanes>(t, axw, ayw, ryw, rsign[lane], sw, hw, zs);
  if (group < n && t == 0) out[lane] = ok;
}

}  // namespace

// ax, ay, ry, s8, h8: (32, n) uint8, limb-major; rsign, out: (n,) int32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tm_ed25519_verify_b2(const uint8_t* ax, const uint8_t* ay, const uint8_t* ry,
                                    const int32_t* rsign, const uint8_t* s8, const uint8_t* h8,
                                    int32_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kLanes - 1) / kLanes;
  ed25519_verify_b2_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ax, ay, ry, rsign, s8, h8, out, n);
  return static_cast<int>(cudaGetLastError());
}
