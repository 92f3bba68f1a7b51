// Doubling-free Ed25519 verification against per-validator comb tables,
// for Hopper (sm_90a): eight threads sum a signature's 128 table entries as
// two partial sums, and a ninth decodes R beside them.
//
// Replaces the comb verify of the JAX package,
// tendermint_tpu/ops/ed25519_comb.py::_verify_comb_impl (XLA there). It
// computes the same function: accept iff compress(W) == R for
//   W = sum_p T_A[slot][p][h_p] + sum_p T_B[p][s_p]  ( = [s]B + [h](-A) )
// over the 64 4-bit digits of h and of s, where T_A[slot] is the key's
// table of -A in a pool slot and T_B the table of B (comb.cuh's layout).
// The host has already rejected s >= L, R.y >= p, bad points and bad
// lengths and masks those lanes afterwards; they read slot 0. The plain
// PyTorch version it is held against is
// tendermint_tpu_torch/ops/ed25519_comb.py::verify_comb_plain.
//
// The design, a block of 16 lanes (144 threads):
// - The sum, threads 8j..8j+7 for lane j, on the four-thread point layer
//   of fe25519x4.cuh: the first group of four adds the 64 pool entries of
//   h, the second the 64 B-table entries of s, each a chain of mixed
//   additions from the identity (ge4_add<true>: thread t holds coordinate
//   t; thread t loads coordinate t of each entry, thread 3 the entry's
//   2dxy, thread 2 nothing; the next entry is loaded before this step's
//   addition). The additions commute, so the two chains are independent;
//   each group then forms its partial sum's cached form (ge4_cached), the
//   groups swap them (fe_shfl_xor) and both add: W on each.
// - The decoding, thread 128 + j for lane j (a fifth warp, half of it
//   idle): RFC 8032's decoding of R (5.1.3), x = u v^3 (u v^7)^((p-5)/8)
//   for u = y^2 - 1, v = d y^2 + 1, the root test, its sqrt(-1) fix and
//   the sign, into shared memory. It depends on R alone, so it runs while
//   the sum does.
// - The compare, projective, with no inversion: X_W == x_R Z_W and Y_W ==
//   y_R Z_W. For W a curve point this is compress(W) == R exactly: R.y < p
//   (else no canonical y equals it), the two roots of a y differ in parity
//   when x != 0, a y with no root is no point's, and x = 0 with the sign
//   bit set is no point's encoding. The zero rows of slot 0 (and of a slot
//   not built) make W = (0 : 0 : Z : 0), not a curve point, whose affine
//   form is (0, 0): where X and Y (or Z) vanish, the lane accepts iff R's
//   bytes are y = 0 with the sign bit clear. So every raw verdict is the
//   affine compare's with R.y unreduced: R.y >= p rejects (it equals no
//   canonical y), where the plain version reduces it.
//
// Work per lane: 128 mixed additions (7 multiplications each, 896), the
// join (the two cached forms, 2, and two full additions, 16), the
// decoding (18 multiplications, 255 squarings), the compare (2): 934
// multiplications and 255 squarings, 107,425 32x32->64-bit limb products.
// It gathers 128 rows of 96 bytes: 12,288 bytes a lane (fewer distinct
// ones where lanes share a key, a digit and a position). The function
// needs 903 multiplications and 254 squarings (one chain, one inversion:
// ed25519_comb.MULS_PER_LANE / SQS_PER_LANE), the count behind the bound
// chip_smoke.py reports.
//
// Critical path, in field operations on one thread: the decoding's 271
// (its exponentiation 262) and the compare's 1, against the sum's 64 x 2
// + 3 = 131 beside it: about 272, where one chain and the block's
// inversion would take 128 x 2 + 265 + 1 = 522. What bounds it:
// the multiplications' latency, as B1 (PERF.md), and at full load their
// rate; the gathers are a tenth of its bound in bytes.

#include "comb.cuh"
#include "fe25519x4.cuh"

namespace {

// R's x from its y (eight LE words, bit 255 clear) and sign bit, by RFC
// 8032's decoding; `flags` bit 0 is set when R decodes (y < p, a root
// exists, and not x = 0 with the sign bit set), bit 1 when y is 0 and the
// sign bit clear (the one R whose affine compare the point (0 : 0 : Z : 0)
// passes). x is canonical and meaningful only with bit 0.
TM_DEV Fe comb_decode_r(const uint32_t ryw[8], int32_t sign, int32_t& flags) {
  const Fe y = fe_from_words(ryw);
  const Fe yc = fe_canon(y);
  bool canonical = true, y_zero = true;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    canonical = canonical && yc.v[i] == y.v[i];
    y_zero = y_zero && y.v[i] == 0;
  }
  const Fe y2 = fe_sq(y);
  const Fe u = fe_sub(y2, fe_small(1));
  const Fe v = fe_add(fe_mul(y2, fe_const(7)), fe_small(1));  // d y^2 + 1
  const Fe v2 = fe_sq(v);
  const Fe v3 = fe_mul(v2, v);
  const Fe uv3 = fe_mul(u, v3);
  const Fe uv7 = fe_mul(uv3, fe_sq(v2));
  const Fe beta = fe_mul(uv3, fe_pow22523(uv7));
  const Fe check = fe_canon(fe_mul(v, fe_sq(beta)));  // v beta^2: u, -u, or no root
  const Fe cu = fe_canon(u), cnu = fe_canon(fe_sub(fe_small(0), u));
  bool root = true, root_i = true;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    root = root && check.v[i] == cu.v[i];
    root_i = root_i && check.v[i] == cnu.v[i];
  }
  const Fe bi = fe_mul(beta, fe_const(8));  // beta sqrt(-1)
  Fe x = fe_canon(root ? beta : bi);
  bool x_zero = true;
#pragma unroll
  for (int i = 0; i < 10; ++i) x_zero = x_zero && x.v[i] == 0;
  if ((x.v[0] & 1) != sign) x = fe_canon(fe_sub(fe_small(0), x));
  flags = ((canonical && (root || root_i) && !(x_zero && sign)) ? 1 : 0) | ((y_zero && !sign) ? 2 : 0);
  return x;
}

// Thread x of block `block` of LANES lanes (9 x LANES threads: the sum on
// the first 8 x LANES, the decoding on the rest): writes out[lane] = 1 if
// compress(W) == R, else 0, for the block's lanes below n. rx, rflags:
// LANES shared entries each. A lane past the end computes on the
// last lane and stores nothing.
template <int LANES>
TM_DEV void comb_verify_block(int block, const uint8_t* __restrict__ pool,
                              const uint8_t* __restrict__ btab, const int32_t* __restrict__ slots,
                              const uint8_t* __restrict__ ry, const int32_t* __restrict__ rsign,
                              const uint8_t* __restrict__ s8, const uint8_t* __restrict__ h8,
                              int32_t* __restrict__ out, int n, int pool_slots, Fe* rx,
                              int32_t* rflags) {
  const int x = threadIdx.x;
  const bool sum = x < 8 * LANES;
  const int j = sum ? x >> 3 : x - 8 * LANES;
  const int lane0 = block * LANES + j;
  const int lane = lane0 < n ? lane0 : n - 1;
  const int half = (x >> 2) & 1, t = x & 3;  // sum threads: h (0) or s (1), rank
  Fe acc;
  if (sum) {
    uint32_t dw[8];
    load_words(half ? s8 : h8, n, lane, dw);
    int slot = slots[lane];
    if (slot < 0 || slot >= pool_slots) slot = 0;  // never read outside the pool
    const uint8_t* tab = half ? btab : pool + static_cast<size_t>(slot) * kSlotRows * kRowBytes;
    const int coord = t == 3 ? 2 : t;  // thread t reads coordinate t: 0 y-x, 1 y+x, 3 2dxy
    uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (t != 2) load_coord_words(tab + comb_digit(dw, 0) * kRowBytes, coord, w);
    acc = ge4_identity(t);
#pragma unroll 1
    for (int p = 0; p < kCombPositions; ++p) {
      const Fe entry = fe_from_words(w);
      if (t != 2 && p + 1 < kCombPositions)
        load_coord_words(tab + ((p + 1) * kCombEntries + comb_digit(dw, p + 1)) * kRowBytes, coord, w);
      acc = ge4_add<true>(t, acc, entry);
    }
    const Fe c = ge4_cached(t, acc, fe_const(0));
    acc = ge4_add(t, acc, fe_shfl_xor(c, 4));  // W = the h half + the s half
  } else {
    uint32_t ryw[8];
    load_words(ry, n, lane, ryw);
    int32_t flags;
    rx[j] = comb_decode_r(ryw, rsign[lane], flags);
    rflags[j] = flags;
  }
  __syncthreads();
  if (!sum) return;

  const Fe z = fe_shfl(acc, 2);
  Fe bits = fe_small(0);  // threads 0 and 1 of the h group: 1 equal, 2 zero, 4 Z zero
  if (half == 0 && t < 2) {
    Fe r = rx[j];
    if (t == 1) {
      uint32_t ryw[8];
      load_words(ry, n, lane, ryw);
      r = fe_from_words(ryw);
    }
    const Fe want = fe_canon(fe_mul(r, z));
    const Fe have = fe_canon(acc);
    const Fe zc = fe_canon(z);
    bool eq = true, zero = true, z_zero = true;
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      eq = eq && have.v[i] == want.v[i];
      zero = zero && have.v[i] == 0;
      z_zero = z_zero && zc.v[i] == 0;
    }
    bits = fe_small((eq ? 1 : 0) | (zero ? 2 : 0) | (z_zero ? 4 : 0));
  }
  const Fe other = fe_shfl(bits, 1);
  if (half == 0 && t == 0 && lane0 < n) {
    const int both = bits.v[0] & other.v[0];
    const int32_t flags = rflags[j];
    const bool degenerate = (both & 2) || (bits.v[0] & 4);  // affine (0, 0) before
    out[lane] = degenerate ? (flags >> 1) & 1 : (flags & 1) & both;
  }
}

constexpr int kThreads = 144;  // 16 lanes a block: 128 summing, 16 decoding
constexpr int kLanes = 16;
// Three five-warp blocks an SM: ptxas fits a thread in 128 registers with
// 52 bytes of spills. Two blocks (142 registers, no spills) measured 9-13%
// slower from 10,000 lanes on (PERF.md).
constexpr int kMinBlocks = 3;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ed25519_comb_kernel(const uint8_t* __restrict__ pool, const uint8_t* __restrict__ btab,
                        const int32_t* __restrict__ slots, const uint8_t* __restrict__ ry,
                        const int32_t* __restrict__ rsign, const uint8_t* __restrict__ s8,
                        const uint8_t* __restrict__ h8, int32_t* __restrict__ out, int n,
                        int pool_slots) {
  __shared__ Fe rx[kLanes];  // the decodings' x
  __shared__ int32_t rflags[kLanes];
  comb_verify_block<kLanes>(blockIdx.x, pool, btab, slots, ry, rsign, s8, h8, out, n, pool_slots,
                            rx, rflags);
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
