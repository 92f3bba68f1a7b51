// Batched dual scalar multiplication [a]P + [b]Q for variable points, one
// lane per thread, for Hopper (sm_90a): the device work of an aggregate
// commit's verify (crypto/ed25519_agg.aggregate_terms makes n + 1 such
// lanes, the last one (s_agg, B, 0, identity)).
//
// Replaces the XLA kernel tendermint_tpu/ops/ed25519.py::_dsm_impl (:542,
// behind dsm_batch, :594). It computes the same function: the canonical
// affine (x, y) of [a]P + [b]Q per lane, for affine on-curve P and Q and
// scalars a, b < L. The plain PyTorch version it is held against is
// tendermint_tpu_torch/ops/ed25519.py::dsm_plain.
//
// Its walk is B1's (ed25519_verify.cu): a 16-entry joint table
// {i*P + j*Q}, i, j in 0..3, in cached form in per-thread local memory,
// then 127 two-bit steps MSB first, each two doublings and one complete
// addition indexed by the digit pair. Two changes: the table is built per
// lane from the lane's own P and Q (both rows need a doubling and an
// addition), and the lane ends with canonical affine coordinates written
// back as bytes, not a comparison with R. The complete formulas make the
// lanes with Q = identity, a = 0, b = 0, P == Q and P == -Q need no
// special case.
//
// What bounds it on this card: integer multiply throughput. A lane moves
// 256 bytes (six 32-byte rows in, two out) and does, counted from the
// code below:
// - table: P's and Q's T (2), 2P and 2Q (8 muls, 8 squarings), 3P and 3Q
//   (16), seven cached 2d*T (7), nine mixed entries (9 x (8 + 1)):
//   114 muls and 8 squarings;
// - ladder: 127 x (doubling without T 3 muls + 4 squarings, doubling with
//   T 4 muls + 4 squarings, addition 8 muls);
// - inversion 11 muls + 254 squarings, affine 2 muls;
// = 2,032 field multiplications and 1,278 squarings, 2,032 x 100 +
// 1,278 x 55 = 273,490 32x32->64-bit limb products.
// ed25519.MULS_PER_LANE / SQS_PER_LANE carry the same counts for the bound
// that chip_smoke.py reports.
//
// What the design does about that bound: fe25519.cuh's radix-2^25.5
// integer limbs instead of the XLA kernel's 17 x 15-bit int32 limbs, one
// launch for the whole ladder instead of an XLA scan, the digits extracted
// from the scalar bytes in the kernel, n lanes with no padding.

#include "fe25519.cuh"

namespace {

TM_DEV void dsm_lane(const uint32_t pxw[8], const uint32_t pyw[8], const uint32_t qxw[8],
                     const uint32_t qyw[8], const uint32_t aw[8], const uint32_t bw[8],
                     uint32_t xw[8], uint32_t yw[8]) {
  const Fe d2 = fe_const(0);
  const Fe zero = fe_small(0);
  const Fe one = fe_small(1);
  const Ge ident{zero, one, one, zero};

  Ge pr[4], qr[4];
  Cached pc[4], qc[4];
  pr[0] = qr[0] = ident;
  pc[0] = qc[0] = to_cached(ident, d2);
  pr[1] = ge_affine(fe_from_words(pxw), fe_from_words(pyw));
  qr[1] = ge_affine(fe_from_words(qxw), fe_from_words(qyw));
  pc[1] = to_cached(pr[1], d2);
  qc[1] = to_cached(qr[1], d2);
  pr[2] = ge_dbl<true>(pr[1]);
  qr[2] = ge_dbl<true>(qr[1]);
  pr[3] = ge_add(pr[2], pc[1]);
  qr[3] = ge_add(qr[2], qc[1]);
#pragma unroll
  for (int i = 2; i < 4; ++i) {
    pc[i] = to_cached(pr[i], d2);
    qc[i] = to_cached(qr[i], d2);
  }

  Cached table[16];  // table[i + 4j] = i*P + j*Q
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i == 0)
        table[4 * j] = qc[j];
      else if (j == 0)
        table[i] = pc[i];
      else
        table[i + 4 * j] = to_cached(ge_add(pr[i], qc[j]), d2);
    }
  }

  Ge acc = ident;
#pragma unroll 1
  for (int k = 126; k >= 0; --k) {  // 2-bit digits of a and b, MSB first
    acc = ge_dbl<false>(acc);
    acc = ge_dbl<true>(acc);
    const int sh = 2 * (k & 15);
    const uint32_t sel = ((aw[k >> 4] >> sh) & 3u) | (((bw[k >> 4] >> sh) & 3u) << 2);
    acc = ge_add(acc, table[sel]);
  }

  const Fe zinv = fe_invert(acc.Z);
  fe_to_words(fe_canon(fe_mul(acc.X, zinv)), xw);
  fe_to_words(fe_canon(fe_mul(acc.Y, zinv)), yw);
}

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    ed25519_dsm_kernel(const uint8_t* __restrict__ px, const uint8_t* __restrict__ py,
                       const uint8_t* __restrict__ qx, const uint8_t* __restrict__ qy,
                       const uint8_t* __restrict__ a8, const uint8_t* __restrict__ b8,
                       uint8_t* __restrict__ x8, uint8_t* __restrict__ y8, int n) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  uint32_t pxw[8], pyw[8], qxw[8], qyw[8], aw[8], bw[8], xw[8], yw[8];
  load_words(px, n, lane, pxw);
  load_words(py, n, lane, pyw);
  load_words(qx, n, lane, qxw);
  load_words(qy, n, lane, qyw);
  load_words(a8, n, lane, aw);
  load_words(b8, n, lane, bw);
  dsm_lane(pxw, pyw, qxw, qyw, aw, bw, xw, yw);
  store_words(x8, n, lane, xw);
  store_words(y8, n, lane, yw);
}

}  // namespace

// px, py, qx, qy, a8, b8, x8, y8: (32, n) uint8, limb-major (little-endian
// bytes of each value down the column). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int tm_ed25519_dsm(const uint8_t* px, const uint8_t* py, const uint8_t* qx,
                              const uint8_t* qy, const uint8_t* a8, const uint8_t* b8,
                              uint8_t* x8, uint8_t* y8, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  ed25519_dsm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      px, py, qx, qy, a8, b8, x8, y8, n);
  return static_cast<int>(cudaGetLastError());
}
