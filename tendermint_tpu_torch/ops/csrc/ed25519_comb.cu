// Doubling-free Ed25519 verification against per-validator comb tables,
// four threads per signature, for Hopper (sm_90a).
//
// Replaces the comb verify of the JAX package,
// tendermint_tpu/ops/ed25519_comb.py::_verify_comb_impl (XLA there). It
// computes the same function: accept iff compress(W) == R for
//   W = sum_p T_A[slot][p][h_p] + sum_p T_B[p][s_p]  ( = [s]B + [h](-A) )
// over the 64 4-bit digits of h and of s, where T_A[slot] is the key's
// table of -A in a pool slot and T_B the table of B (comb.cuh's layout).
// The host has already rejected s >= L, R.y >= p, bad points and bad
// lengths and masks those lanes afterwards; they read slot 0, whose zero
// rows give an unspecified verdict. The plain PyTorch version it is held
// against is tendermint_tpu_torch/ops/ed25519_comb.py::verify_comb_plain.
//
// Work per lane, summed over its four threads (fe25519x4.cuh): 128 mixed
// additions from the identity, 7 multiplications each (ge4_add<true>: no
// Z*1 on thread 2), the inversion (11 multiplications, 254 squarings), affine
// x and y (2): 909 multiplications and 254 squarings, 104,870 32x32->64-bit
// limb products. It gathers 128 rows of 96 bytes: 12,288 bytes a lane
// (fewer distinct ones where lanes share a key, a digit and a position).
// The function needs 6 multiplications fewer (the first entry, added to
// the identity, needs only its T): ed25519_comb.MULS_PER_LANE /
// SQS_PER_LANE carry that count for the bound chip_smoke.py reports.
//
// Critical path, in field operations on one thread: 128 x 2 = 256 for the
// sum, 265 for the inversion, 1 for affine: 522, against B1's 1,069. The
// design:
// - The four-thread point layer of B1 (fe25519x4.cuh): thread t of a group
//   holds coordinate t of W and loads coordinate t of each table entry
//   (thread 3 the entry's 2dxy, thread 2 nothing), so an addition is two
//   stages of one field multiplication per thread.
// - Each entry is decoded from its canonical bytes into radix-2^25.5 limbs
//   in registers; the B table is gathered by digit exactly like the pool
//   (the JAX kernel's one-hot matmul picks the same rows).
// - The next step's entry is loaded before this step's addition, so a
//   gather's latency hides behind two field operations.
// - The first warp of each block inverts the block's 32 Z values
//   (block_invert), as in B1.
// What bounds it: the multiplications' latency, as B1 (PERF.md), with half
// of B1's critical path; the gathers are a tenth of its bound in bytes.

#include "comb.cuh"
#include "fe25519x4.cuh"

namespace {

// One lane on four threads (t = rank in the group) of a block of LANES
// lanes: on thread 0, 1 if compress(W) == R, else 0; unspecified on the
// others. a_tab is the lane's slot of the pool, b_tab the B table; zs is
// block_invert's.
template <int LANES>
TM_DEV int32_t comb_verify_lane(int t, const uint8_t* __restrict__ a_tab,
                                const uint8_t* __restrict__ b_tab, const uint32_t ryw[8],
                                int32_t rsign, const uint32_t sw[8], const uint32_t hw[8],
                                Fe* zs) {
  // thread t reads coordinate t of an entry: 0 y-x, 1 y+x, 3 2dxy
  const int coord = t == 3 ? 2 : t;
  uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (t != 2) load_coord_words(a_tab + comb_digit(hw, 0) * kRowBytes, coord, w);
  Fe acc = ge4_identity(t);
#pragma unroll 1
  for (int k = 0; k < 2 * kCombPositions; ++k) {
    const Fe entry = fe_from_words(w);
    const int j = k + 1;  // the next step: positions of h in the pool, then of s in the B table
    if (t != 2 && j < 2 * kCombPositions) {
      const int p = j & (kCombPositions - 1);
      const uint8_t* tab = j < kCombPositions ? a_tab : b_tab;
      const int digit = comb_digit(j < kCombPositions ? hw : sw, p);
      load_coord_words(tab + (p * kCombEntries + digit) * kRowBytes, coord, w);
    }
    acc = ge4_add<true>(t, acc, entry);
  }

  const Fe aff = ge4_to_affine<LANES>(t, acc, zs);  // thread 0: x, thread 1: y
  const Fe y = fe_shfl(aff, 1);
  const Fe ry = fe_from_words(ryw);  // R.y < p (host-checked): already canonical
  bool eq = (aff.v[0] & 1) == rsign;
#pragma unroll
  for (int i = 0; i < 10; ++i) eq = eq && (y.v[i] == ry.v[i]);
  return eq ? 1 : 0;
}

constexpr int kThreads = 128;  // 32 lanes a block
constexpr int kLanes = kThreads / 4;
constexpr int kMinBlocks = 512 / kThreads;  // at most 128 registers a thread

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ed25519_comb_kernel(const uint8_t* __restrict__ pool, const uint8_t* __restrict__ btab,
                        const int32_t* __restrict__ slots, const uint8_t* __restrict__ ry,
                        const int32_t* __restrict__ rsign, const uint8_t* __restrict__ s8,
                        const uint8_t* __restrict__ h8, int32_t* __restrict__ out, int n,
                        int pool_slots) {
  const int t = threadIdx.x & 3;
  const int group = blockIdx.x * kLanes + (threadIdx.x >> 2);
  const int lane = group < n ? group : n - 1;  // a group past the end recomputes the last lane
  uint32_t ryw[8], sw[8], hw[8];
  load_words(ry, n, lane, ryw);
  load_words(s8, n, lane, sw);
  load_words(h8, n, lane, hw);
  int slot = slots[lane];
  if (slot < 0 || slot >= pool_slots) slot = 0;  // never read outside the pool
  const uint8_t* a_tab = pool + static_cast<size_t>(slot) * kSlotRows * kRowBytes;
  __shared__ Fe zs[kLanes];
  const int32_t ok = comb_verify_lane<kLanes>(t, a_tab, btab, ryw, rsign[lane], sw, hw, zs);
  if (group < n && t == 0) out[lane] = ok;
}

}  // namespace

// pool: (pool_slots * 1024, 96) uint8 niels rows; btab: (1024, 96) uint8;
// slots, rsign, out: (n,) int32; ry, s8, h8: (32, n) uint8, limb-major.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tm_ed25519_comb(const uint8_t* pool, const uint8_t* btab, const int32_t* slots,
                               const uint8_t* ry, const int32_t* rsign, const uint8_t* s8,
                               const uint8_t* h8, int32_t* out, int n, int pool_slots,
                               void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kLanes - 1) / kLanes;
  ed25519_comb_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pool, btab, slots, ry, rsign, s8, h8, out, n, pool_slots);
  return static_cast<int>(cudaGetLastError());
}
