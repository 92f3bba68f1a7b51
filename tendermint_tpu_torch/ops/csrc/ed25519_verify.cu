// Strict cofactorless Ed25519 verification, one signature per thread, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel tendermint_tpu/ops/ed25519_f32p.py::_verify_kernel
// (body `_ladder`). It computes the same function: accept iff
// compress([s]B + [h](-A)) == R, where the host has already rejected
// s >= L, R.y >= p, bad points and bad lengths (prepare_batch8) and masks
// those lanes afterwards. The plain PyTorch version it is held against is
// tendermint_tpu_torch/ops/ed25519_f32.py::verify_plain.
//
// What bounds it on this card: integer multiply throughput. Each lane runs
// a long dependent chain of field arithmetic and moves only 168 bytes
// (five 32-byte inputs, one int32 sign, one int32 verdict). Counted from
// the code below, a lane does 2,021 field multiplications and 1,274 field
// squarings (table 103 + 4, ladder 127 x (15 + 8), inversion 11 + 254,
// affine 2): 2,021 x 100 + 1,274 x 55 = 272,170 32x32->64-bit limb
// products. ed25519_f32p.MULS_PER_LANE / SQS_PER_LANE carry the same
// counts for the bound that chip_smoke.py reports.
//
// What the design does about that bound:
// - Native integer limbs instead of the TPU's fp32 radix 2^8: 10 signed
//   limbs of radix 2^25.5 (26/25 bits alternating), 64-bit products from
//   32-bit operands (one IMAD.WIDE each), 100 products a multiply and 55 a
//   square, against 1,024 FMAs a multiply in radix 2^8. The 2x of odd x odd
//   limb products and the 19x of the 2^255 fold are folded into 32-bit
//   operands before the product, so no 64-bit multiply is ever emitted.
// - The 16-entry joint table {i*B + j*(-A)} sits in per-thread local
//   memory in "cached" form (Y+X, Y-X, Z, 2d*T) and is read by the digit
//   pair directly. The TPU's masked 16-way select existed only because a
//   TPU lane cannot gather; verification handles no secret, so an indexed
//   load is fine. The cached form saves one multiply per addition, and the
//   first doubling of each step skips the T coordinate nobody reads.
// - The kernel reads the scalar bytes and extracts the 127 2-bit digits
//   itself (replacing the TPU path's _expand_digits pass), takes n lanes
//   with no padding, and masks the ragged edge.
// - Inputs are limb-major (32, n) bytes, so thread i reads column i and a
//   warp's loads of one byte row are coalesced.
// Not yet: wgmma, TMA, shared-memory tiling or a multi-lane field multiply.
//
// The field and point code is fe25519.cuh, shared with the B2 and dsm
// kernels.

#include "fe25519.cuh"

namespace {

// One lane: 1 if compress([s]B + [h](-A)) == R, else 0.
TM_DEV int32_t verify_lane(const uint32_t axw[8], const uint32_t ayw[8], const uint32_t ryw[8],
                           int32_t rsign, const uint32_t sw[8], const uint32_t hw[8]) {
  const Fe d2 = fe_const(0);
  const Fe zero = fe_small(0);
  const Fe one = fe_small(1);
  const Ge ident{zero, one, one, zero};

  const Fe nax = fe_sub(zero, fe_from_words(axw));
  const Ge neg_a = ge_affine(nax, fe_from_words(ayw));
  const Cached neg_a_c = to_cached(neg_a, d2);
  const Ge na2 = ge_dbl<true>(neg_a);
  const Ge na3 = ge_add(na2, neg_a_c);
  const Cached a_row[4] = {to_cached(ident, d2), neg_a_c, to_cached(na2, d2),
                           to_cached(na3, d2)};
  const Ge b_row[4] = {ident, ge_affine(fe_const(1), fe_const(2)),
                       ge_affine(fe_const(3), fe_const(4)),
                       ge_affine(fe_const(5), fe_const(6))};

  Cached table[16];  // table[i + 4j] = i*B + j*(-A)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i == 0)
        table[4 * j] = a_row[j];
      else if (j == 0)
        table[i] = to_cached(b_row[i], d2);
      else
        table[i + 4 * j] = to_cached(ge_add(b_row[i], a_row[j]), d2);
    }
  }

  Ge acc = ident;
#pragma unroll 1
  for (int k = 126; k >= 0; --k) {  // 2-bit digits of s and h, MSB first
    acc = ge_dbl<false>(acc);
    acc = ge_dbl<true>(acc);
    const int sh = 2 * (k & 15);
    const uint32_t sel = ((sw[k >> 4] >> sh) & 3u) | (((hw[k >> 4] >> sh) & 3u) << 2);
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
    ed25519_verify_kernel(const uint8_t* __restrict__ ax, const uint8_t* __restrict__ ay,
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
  out[lane] = verify_lane(axw, ayw, ryw, rsign[lane], sw, hw);
}

}  // namespace

// ax, ay, ry, s8, h8: (32, n) uint8, limb-major; rsign, out: (n,) int32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tm_ed25519_verify(const uint8_t* ax, const uint8_t* ay, const uint8_t* ry,
                                 const int32_t* rsign, const uint8_t* s8, const uint8_t* h8,
                                 int32_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  ed25519_verify_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ax, ay, ry, rsign, s8, h8, out, n);
  return static_cast<int>(cudaGetLastError());
}
