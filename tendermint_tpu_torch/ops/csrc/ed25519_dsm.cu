// Batched dual scalar multiplication [a]P + [b]Q for variable points, four
// threads per lane, for Hopper (sm_90a): the device work of an aggregate
// commit's verify (crypto/ed25519_agg.aggregate_terms makes n + 1 such
// lanes, the last one (s_agg, B, 0, identity)).
//
// Replaces the XLA kernel tendermint_tpu/ops/ed25519.py::_dsm_impl (:542,
// behind dsm_batch, :594). It computes the same function: the canonical
// affine (x, y) of [a]P + [b]Q per lane, for affine on-curve P and Q and
// scalars a, b < L. The plain PyTorch version it is held against is
// tendermint_tpu_torch/ops/ed25519.py::dsm_plain.
//
// Its walk is B1's (ed25519_verify.cu), on the same four-threads-per-lane
// point layer (fe25519x4.cuh): a 16-entry joint table {i*P + j*Q}, i, j in
// 0..3, then 127 two-bit steps MSB first, each two doublings and one
// complete addition indexed by the digit pair. Two changes: the table is
// built per lane from the lane's own P and Q (both rows need a doubling and
// an addition), and the lane ends with canonical affine coordinates written
// back as bytes (x by thread 0, y by thread 1), not a comparison with R.
// The complete formulas make the lanes with Q = identity, a = 0, b = 0,
// P == Q and P == -Q need no special case.
//
// Work per lane, summed over its four threads and counted from the code
// below and fe25519x4.cuh:
// - table: P's and Q's T (2), their cached forms (2), 2P and 2Q (8 muls, 8
//   squarings), 3P and 3Q (16), the cached 2P, 3P, 2Q, 3Q (4), nine mixed
//   entries (9 x (8 + 1)): 113 muls and 8 squarings;
// - ladder: 127 x (doubling without T 3 muls + 4 squarings, doubling with
//   T 4 muls + 4 squarings, addition 8 muls);
// - inversion 11 muls + 254 squarings, affine 2 muls;
// = 2,031 field multiplications and 1,278 squarings, 2,031 x 100 +
// 1,278 x 55 = 273,390 32x32->64-bit limb products, and 256 bytes moved
// (six 32-byte rows in, two out). ed25519.MULS_PER_LANE / SQS_PER_LANE
// carry the same counts for the bound that chip_smoke.py reports.
//
// Critical path, in field operations on one thread: table 43 (P's and Q's
// T 2, cached 2, doublings 4, additions 4, cached 4, nine mixed entries
// 9 x 3), ladder 127 x 6 = 762, inversion 265, affine 1: 1,071, against
// 3,310 with one thread per lane (every operation in series). What bounds
// it is B1's, latency (a quarter of the chain is the serial inversion),
// and so is the design: one-pass carries between the stages, and the first
// warp of each block inverting the block's 32 Z values (block_invert).

#include "fe25519x4.cuh"

namespace {

// One lane on four threads (t = rank in the group) of a block of LANES
// lanes: thread 0 returns the canonical affine x of [a]P + [b]Q, thread 1
// its y; the others an unspecified value. zs is block_invert's.
template <int LANES>
TM_DEV Fe dsm_lane(int t, const uint32_t pxw[8], const uint32_t pyw[8], const uint32_t qxw[8],
                   const uint32_t qyw[8], const uint32_t aw[8], const uint32_t bw[8], Fe* zs) {
  const Fe d2 = fe_const(0);
  Fe p_row[4], q_row[4], p_row_c[4], q_row_c[4];
  p_row[0] = q_row[0] = ge4_identity(t);
  p_row_c[0] = q_row_c[0] = ge4_cached_identity(t);
  p_row[1] = ge4_affine(t, fe_from_words(pxw), fe_from_words(pyw));
  q_row[1] = ge4_affine(t, fe_from_words(qxw), fe_from_words(qyw));
  p_row_c[1] = ge4_cached(t, p_row[1], d2);
  q_row_c[1] = ge4_cached(t, q_row[1], d2);
  p_row[2] = ge4_dbl<true>(t, p_row[1]);
  q_row[2] = ge4_dbl<true>(t, q_row[1]);
  p_row[3] = ge4_add(t, p_row[2], p_row_c[1]);
  q_row[3] = ge4_add(t, q_row[2], q_row_c[1]);
#pragma unroll
  for (int i = 2; i < 4; ++i) {
    p_row_c[i] = ge4_cached(t, p_row[i], d2);
    q_row_c[i] = ge4_cached(t, q_row[i], d2);
  }

  Fe table[16];  // table[i + 4j] = i*P + j*Q, this thread's coordinate
  ge4_joint_table(t, p_row, p_row_c, q_row_c, d2, table);
  return ge4_to_affine<LANES>(t, ge4_ladder(t, table, aw, bw), zs);
}

constexpr int kThreads = 128;  // 32 lanes a block
constexpr int kLanes = kThreads / 4;
constexpr int kMinBlocks = 512 / kThreads;  // 512 threads an SM: at most 128 registers each

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ed25519_dsm_kernel(const uint8_t* __restrict__ px, const uint8_t* __restrict__ py,
                       const uint8_t* __restrict__ qx, const uint8_t* __restrict__ qy,
                       const uint8_t* __restrict__ a8, const uint8_t* __restrict__ b8,
                       uint8_t* __restrict__ x8, uint8_t* __restrict__ y8, int n) {
  const int t = threadIdx.x & 3;
  const int group = blockIdx.x * kLanes + (threadIdx.x >> 2);
  const int lane = group < n ? group : n - 1;  // a group past the end recomputes the last lane
  uint32_t pxw[8], pyw[8], qxw[8], qyw[8], aw[8], bw[8], w[8];
  load_words(px, n, lane, pxw);
  load_words(py, n, lane, pyw);
  load_words(qx, n, lane, qxw);
  load_words(qy, n, lane, qyw);
  load_words(a8, n, lane, aw);
  load_words(b8, n, lane, bw);
  __shared__ Fe zs[kLanes];
  const Fe r = dsm_lane<kLanes>(t, pxw, pyw, qxw, qyw, aw, bw, zs);
  if (group < n && t < 2) {
    fe_to_words(r, w);
    store_words(t == 0 ? x8 : y8, n, lane, w);
  }
}

}  // namespace

// px, py, qx, qy, a8, b8, x8, y8: (32, n) uint8, limb-major (little-endian
// bytes of each value down the column). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int tm_ed25519_dsm(const uint8_t* px, const uint8_t* py, const uint8_t* qx,
                              const uint8_t* qy, const uint8_t* a8, const uint8_t* b8,
                              uint8_t* x8, uint8_t* y8, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kLanes - 1) / kLanes;
  ed25519_dsm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      px, py, qx, qy, a8, b8, x8, y8, n);
  return static_cast<int>(cudaGetLastError());
}
