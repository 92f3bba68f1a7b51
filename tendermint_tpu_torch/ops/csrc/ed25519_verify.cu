// Strict cofactorless Ed25519 verification, four threads per signature, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel tendermint_tpu/ops/ed25519_f32p.py::_verify_kernel
// (body `_ladder`). It computes the same function: accept iff
// compress([s]B + [h](-A)) == R, where the host has already rejected
// s >= L, R.y >= p, bad points and bad lengths (prepare_batch8) and masks
// those lanes afterwards. The plain PyTorch version it is held against is
// tendermint_tpu_torch/ops/ed25519_f32.py::verify_plain.
//
// Work per lane, summed over its four threads and counted from the code
// below and fe25519x4.cuh: 2,021 field multiplications and 1,274 squarings
// (table: -A's T and cached form 2, 2(-A) 4 + 4 squarings, 3(-A) 8, their
// cached forms 2, B, 2B and 3B's T 3, their cached forms 3, nine mixed
// entries 9 x (8 + 1): 103 + 4; ladder 127 x (doubling without T 3 + 4,
// doubling 4 + 4, addition 8); inversion 11 + 254; affine x and y 2):
// 2,021 x 100 + 1,274 x 55 = 272,170 32x32->64-bit limb products. A lane
// moves 168 bytes (five 32-byte inputs, one int32 sign, one int32 verdict).
// ed25519_f32p.MULS_PER_LANE / SQS_PER_LANE carry the same counts for the
// bound that chip_smoke.py reports.
//
// Critical path, in field operations on one thread: table 41 (-A 1,
// cached 1, doubling 2, addition 2, two cached 2, B's row 3 + 3 cached,
// nine mixed entries 9 x 3), ladder 127 x 6 = 762, inversion 265, affine
// 1: 1,069, against 107 + 127 x 23 + 265 + 2 = 3,295 with one thread per
// lane. The serial inversion is a quarter of it (24.8%).
//
// What bounds it on this card: latency. Up to 4,096 lanes each scheduler
// holds at most one warp, and 16,384 lanes fill only four a scheduler
// (2,048 warps on 528 schedulers), each warp one dependent chain: the
// serial carries of every field operation and the shuffles' round trips
// leave the multiply pipes idle most of the time (IMAD.WIDE runs at about
// 45% of its measured 8.35 T/s rate at 16,384 lanes, PERF.md). The bound
// chip_smoke.py reports is the limb products over that rate. The design:
// - Four threads carry one lane (fe25519x4.cuh): thread t of a group holds
//   coordinate t of the extended point, and each point operation is two
//   stages of one field operation per thread with warp shuffles between
//   them. A warp carries 8 lanes; 4,096 lanes are 128 blocks, one per SM.
// - The sums between the stages take one parallel carry pass, three
//   instructions deep, instead of a ten-step chain (fe25519x4.cuh).
// - The first warp of each block inverts the block's 32 Z values, one a
//   thread (block_invert), so the 265-operation inversion is issued once a
//   warp for 32 lanes; inside each group it would be issued for 8.
// - Native integer limbs instead of the TPU's fp32 radix 2^8: 10 signed
//   limbs of radix 2^25.5, 64-bit products from 32-bit operands (one
//   IMAD.WIDE each), 100 products a multiply and 55 a square.
// - Each thread keeps its own coordinate of the 16-entry cached joint table
//   {i*B + j*(-A)} in local memory (16 x 40 bytes) and reads it by the
//   digit pair directly; verification handles no secret. All four threads
//   read the lane's s and h words, so the digit pair selects the same entry
//   on each.
// - The kernel extracts the 127 2-bit digits from the scalar bytes itself,
//   takes n lanes with no padding, and masks the ragged edge by clamping,
//   never by an early return (the shuffles need every thread).
// Not yet: wgmma, TMA, a shorter carry for fe_mul (two interleaved chains
// measured slower, PERF.md), a batched (Montgomery) inversion.

#include "fe25519x4.cuh"

namespace {

// One lane on four threads (t = rank in the group) of a block of LANES
// lanes: on thread 0, 1 if compress([s]B + [h](-A)) == R, else 0;
// unspecified on the others. zs is block_invert's.
template <int LANES>
TM_DEV int32_t verify_lane(int t, const uint32_t axw[8], const uint32_t ayw[8],
                           const uint32_t ryw[8], int32_t rsign, const uint32_t sw[8],
                           const uint32_t hw[8], Fe* zs) {
  const Fe d2 = fe_const(0);
  const Fe neg_a = ge4_affine(t, fe_sub(fe_small(0), fe_from_words(axw)), fe_from_words(ayw));
  const Fe neg_a_c = ge4_cached(t, neg_a, d2);
  const Fe na2 = ge4_dbl<true>(t, neg_a);
  const Fe na3 = ge4_add(t, na2, neg_a_c);
  const Fe a_row_c[4] = {ge4_cached_identity(t), neg_a_c, ge4_cached(t, na2, d2),
                         ge4_cached(t, na3, d2)};
  Fe b_row[4], b_row_c[4];
  b_row[0] = ge4_identity(t);
  b_row_c[0] = a_row_c[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    b_row[i] = ge4_affine(t, fe_const(2 * i - 1), fe_const(2 * i));
    b_row_c[i] = ge4_cached(t, b_row[i], d2);
  }

  Fe table[16];  // table[i + 4j] = i*B + j*(-A), this thread's coordinate
  ge4_joint_table(t, b_row, b_row_c, a_row_c, d2, table);
  const Fe acc = ge4_ladder(t, table, sw, hw);

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
    ed25519_verify_kernel(const uint8_t* __restrict__ ax, const uint8_t* __restrict__ ay,
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
  const int32_t ok = verify_lane<kLanes>(t, axw, ayw, ryw, rsign[lane], sw, hw, zs);
  if (group < n && t == 0) out[lane] = ok;
}

}  // namespace

// ax, ay, ry, s8, h8: (32, n) uint8, limb-major; rsign, out: (n,) int32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tm_ed25519_verify(const uint8_t* ax, const uint8_t* ay, const uint8_t* ry,
                                 const int32_t* rsign, const uint8_t* s8, const uint8_t* h8,
                                 int32_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kLanes - 1) / kLanes;
  ed25519_verify_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ax, ay, ry, rsign, s8, h8, out, n);
  return static_cast<int>(cudaGetLastError());
}
