// Strict cofactorless Ed25519 verification by 253 single-bit Straus steps,
// one signature per thread, for Hopper (sm_90a).
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
// addition (B1: a 16-entry table and 127 two-bit steps). The addition is
// never skipped, also when both bits are 0: a warp's 32 lanes almost never
// agree on skipping, so a skip would only diverge.
//
// What bounds it on this card: integer multiply throughput. A lane moves
// 168 bytes (five 32-byte rows and the sign in, the verdict out) and does,
// counted from the code below:
// - table: -A's T (1), B's T (1), B-A (8), four cached 2d*T (4): 14 muls;
// - ladder: 253 x (doubling 4 muls + 4 squarings, addition 8 muls);
// - inversion 11 muls + 254 squarings, affine 2 muls;
// = 3,063 field multiplications and 1,266 squarings, 3,063 x 100 +
// 1,266 x 55 = 375,930 32x32->64-bit limb products (1.38x B1).
// ed25519_pallas.MULS_PER_LANE / SQS_PER_LANE carry the same counts for
// the bound that chip_smoke.py reports.
//
// What the design does about that bound: the limbs are fe25519.cuh's
// radix 2^25.5 (not the TPU's 17 x 15 bits), the four cached entries stay
// in registers or local memory, the kernel reads the scalars as bytes and
// extracts bit k itself (not the TPU path's 2 x 253 int32 bit rows, 2 KB a
// lane), and it takes n lanes with no padding. The small table is the
// register-pressure contrast with B1's sixteen entries.

#include "fe25519.cuh"

namespace {

// One lane: 1 if compress([s]B + [h](-A)) == R, else 0.
TM_DEV int32_t verify_lane_b2(const uint32_t axw[8], const uint32_t ayw[8],
                              const uint32_t ryw[8], int32_t rsign, const uint32_t sw[8],
                              const uint32_t hw[8]) {
  const Fe d2 = fe_const(0);
  const Fe zero = fe_small(0);
  const Fe one = fe_small(1);
  const Ge ident{zero, one, one, zero};

  const Fe nax = fe_sub(zero, fe_from_words(axw));
  const Ge neg_a = ge_affine(nax, fe_from_words(ayw));
  const Ge b = ge_affine(fe_const(1), fe_const(2));
  const Cached neg_a_c = to_cached(neg_a, d2);
  // table[sbit + 2 hbit]
  const Cached table[4] = {to_cached(ident, d2), to_cached(b, d2), neg_a_c,
                           to_cached(ge_add(b, neg_a_c), d2)};

  Ge acc = ident;
#pragma unroll 1
  for (int k = 252; k >= 0; --k) {  // bits of s and h, MSB first
    acc = ge_dbl<true>(acc);
    const uint32_t sel = ((sw[k >> 5] >> (k & 31)) & 1u) | (((hw[k >> 5] >> (k & 31)) & 1u) << 1);
    acc = ge_add(acc, table[sel]);
  }

  const Fe zinv = fe_invert(acc.Z);
  const Fe x = fe_canon(fe_mul(acc.X, zinv));
  const Fe y = fe_canon(fe_mul(acc.Y, zinv));
  const Fe ry = fe_from_words(ryw);  // R.y < p (host-checked): already canonical
  bool eq = (x.v[0] & 1) == rsign;
#pragma unroll
  for (int i = 0; i < 10; ++i) eq = eq && (y.v[i] == ry.v[i]);
  return eq ? 1 : 0;
}

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    ed25519_verify_b2_kernel(const uint8_t* __restrict__ ax, const uint8_t* __restrict__ ay,
                             const uint8_t* __restrict__ ry, const int32_t* __restrict__ rsign,
                             const uint8_t* __restrict__ s8, const uint8_t* __restrict__ h8,
                             int32_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  uint32_t axw[8], ayw[8], ryw[8], sw[8], hw[8];
  load_words(ax, n, lane, axw);
  load_words(ay, n, lane, ayw);
  load_words(ry, n, lane, ryw);
  load_words(s8, n, lane, sw);
  load_words(h8, n, lane, hw);
  out[lane] = verify_lane_b2(axw, ayw, ryw, rsign[lane], sw, hw);
}

}  // namespace

// ax, ay, ry, s8, h8: (32, n) uint8, limb-major; rsign, out: (n,) int32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tm_ed25519_verify_b2(const uint8_t* ax, const uint8_t* ay, const uint8_t* ry,
                                    const int32_t* rsign, const uint8_t* s8, const uint8_t* h8,
                                    int32_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  ed25519_verify_b2_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ax, ay, ry, rsign, s8, h8, out, n);
  return static_cast<int>(cudaGetLastError());
}
