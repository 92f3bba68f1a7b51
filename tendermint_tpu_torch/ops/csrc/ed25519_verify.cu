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

#include <cstdint>
#include <cuda_runtime.h>

#define TM_DEV __device__ __forceinline__

namespace {

struct Fe {
  int32_t v[10];  // limb i has weight 2^ceil(25.5 i); even limbs 26 bits, odd 25
};

// Every Fe that leaves a function below is "carried": all limbs are
// non-negative, limb i < 2^26 (even i) or 2^25 (odd i), except limb 1,
// which may reach 2^25 + 2^15 after the 2^255 fold. Products of carried
// limbs with the 2x/19x factors stay below 2^57, and ten of them below
// 2^61: no int64 accumulator overflows.

TM_DEV int limb_bits(int i) { return (i & 1) ? 25 : 26; }

TM_DEV Fe fe_carry64(int64_t h[10]) {
  Fe out;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int s = limb_bits(i);
    const int64_t c = h[i] >> s;  // arithmetic shift: floor division
    h[i + 1] += c;
    out.v[i] = (int32_t)(h[i] & ((1LL << s) - 1));
  }
  const int64_t c9 = h[9] >> 25;  // 2^255 == 19 mod p
  out.v[9] = (int32_t)(h[9] & ((1LL << 25) - 1));
  const int64_t t0 = (int64_t)out.v[0] + 19 * c9;
  out.v[0] = (int32_t)(t0 & ((1LL << 26) - 1));
  out.v[1] += (int32_t)(t0 >> 26);
  return out;
}

TM_DEV Fe fe_carry32(int32_t h[10]) {
  Fe out;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int s = limb_bits(i);
    const int32_t c = h[i] >> s;
    h[i + 1] += c;
    out.v[i] = h[i] & ((1 << s) - 1);
  }
  const int32_t c9 = h[9] >> 25;
  out.v[9] = h[9] & ((1 << 25) - 1);
  const int32_t t0 = out.v[0] + 19 * c9;
  out.v[0] = t0 & ((1 << 26) - 1);
  out.v[1] += t0 >> 26;
  return out;
}

// 2p in limbs: adding it before a subtraction keeps every limb
// non-negative for any carried subtrahend.
__constant__ int32_t k2P[10] = {
    2 * ((1 << 26) - 19), 2 * ((1 << 25) - 1), 2 * ((1 << 26) - 1), 2 * ((1 << 25) - 1),
    2 * ((1 << 26) - 1),  2 * ((1 << 25) - 1), 2 * ((1 << 26) - 1), 2 * ((1 << 25) - 1),
    2 * ((1 << 26) - 1),  2 * ((1 << 25) - 1)};

TM_DEV Fe fe_add(const Fe& a, const Fe& b) {
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = a.v[i] + b.v[i];
  return fe_carry32(h);
}

TM_DEV Fe fe_sub(const Fe& a, const Fe& b) {
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = a.v[i] + k2P[i] - b.v[i];
  return fe_carry32(h);
}

TM_DEV Fe fe_mul(const Fe& f, const Fe& g) {
  // f_i g_j has weight 2^(off_i + off_j) = 2^off_(i+j) times 2 when both
  // i and j are odd; for i + j >= 10 the weight wraps past 2^255 (x19).
  int32_t f2[10], g19[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
    g19[i] = 19 * g.v[i];
  }
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const int32_t a = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      if (i + j < 10)
        h[i + j] += (int64_t)a * g.v[j];
      else
        h[i + j - 10] += (int64_t)a * g19[j];
    }
  }
  return fe_carry64(h);
}

TM_DEV Fe fe_sq(const Fe& f) {
  // the same row sums as fe_mul(f, f), each cross term counted once, doubled
  int64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = i; j < 10; ++j) {
      const int32_t ca = (i == j ? 1 : 2) * (((i & 1) && (j & 1)) ? 2 : 1);
      const int32_t cb = (i + j < 10) ? 1 : 19;
      h[(i + j) % 10] += (int64_t)(ca * f.v[i]) * (int64_t)(cb * f.v[j]);
    }
  }
  return fe_carry64(h);
}

TM_DEV Fe fe_sq_n(Fe f, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) f = fe_sq(f);
  return f;
}

TM_DEV Fe fe_invert(const Fe& z) {
  // z^(p-2): the standard 254-squaring, 11-multiplication chain
  const Fe z2 = fe_sq(z);
  const Fe z9 = fe_mul(fe_sq_n(z2, 2), z);
  const Fe z11 = fe_mul(z9, z2);
  const Fe z_5_0 = fe_mul(fe_sq(z11), z9);
  const Fe z_10_0 = fe_mul(fe_sq_n(z_5_0, 5), z_5_0);
  const Fe z_20_0 = fe_mul(fe_sq_n(z_10_0, 10), z_10_0);
  const Fe z_40_0 = fe_mul(fe_sq_n(z_20_0, 20), z_20_0);
  const Fe z_50_0 = fe_mul(fe_sq_n(z_40_0, 10), z_10_0);
  const Fe z_100_0 = fe_mul(fe_sq_n(z_50_0, 50), z_50_0);
  const Fe z_200_0 = fe_mul(fe_sq_n(z_100_0, 100), z_100_0);
  const Fe z_250_0 = fe_mul(fe_sq_n(z_200_0, 50), z_50_0);
  return fe_mul(fe_sq_n(z_250_0, 5), z11);
}

// Canonical limbs of the value mod p. Three carry passes leave every limb
// inside its width and the value below 2^255 < 2p; then v >= p exactly
// when v + 19 carries out of bit 255, and (v + 19) mod 2^255 is v - p.
TM_DEV Fe fe_canon(const Fe& f) {
  int32_t h[10];
  Fe r = f;
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
    for (int i = 0; i < 10; ++i) h[i] = r.v[i];
    r = fe_carry32(h);
  }
  int32_t t[10];
  int32_t c = 19;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int s = limb_bits(i);
    const int32_t v = r.v[i] + c;
    c = v >> s;
    t[i] = v & ((1 << s) - 1);
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = c ? t[i] : r.v[i];
  return r;
}

// Limbs of a 256-bit little-endian value held as eight 32-bit words; bit
// 255 is dropped (every value read this way is below p).
TM_DEV Fe fe_from_words(const uint32_t w[8]) {
  Fe f;
  int off = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int s = limb_bits(i);
    const int lo = off >> 5, sh = off & 31;
    uint32_t x = w[lo] >> sh;
    if (sh + s > 32) x |= w[lo + 1] << (32 - sh);
    f.v[i] = (int32_t)(x & ((1u << s) - 1));
    off += s;
  }
  return f;
}

// Column `lane` of a (32, n) limb-major byte array, as eight LE words.
TM_DEV void load_words(const uint8_t* __restrict__ p, int n, int lane, uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k] = (uint32_t)p[(4 * k) * n + lane] | ((uint32_t)p[(4 * k + 1) * n + lane] << 8) |
           ((uint32_t)p[(4 * k + 2) * n + lane] << 16) |
           ((uint32_t)p[(4 * k + 3) * n + lane] << 24);
  }
}

// 2d, and the affine coordinates of B, 2B and 3B, as limbs.
__constant__ int32_t kConst[7][10] = {
    {45281625, 27714825, 36363642, 13898781, 229458, 15978800, 54557047, 27058993, 29715967, 9444199},
    {52811034, 25909283, 16144682, 17082669, 27570973, 30858332, 40966398, 8378388, 20764389, 8758491},
    {40265304, 26843545, 13421772, 20132659, 26843545, 6710886, 53687091, 13421772, 40265318, 26843545},
    {4443662, 23614346, 9171064, 2666173, 2111033, 3401644, 35503756, 9275296, 13235616, 14331105},
    {49849289, 30518170, 36356555, 9118146, 39642173, 27402070, 19887204, 20464564, 53514802, 9012023},
    {66642524, 9574388, 17880460, 13372178, 26021472, 14338106, 39270943, 32056318, 10627368, 27179633},
    {16102612, 14291486, 6324312, 12269856, 41704368, 2531063, 55625520, 20280356, 18317030, 4824775},
};

TM_DEV Fe fe_const(int row) {
  Fe f;
#pragma unroll
  for (int i = 0; i < 10; ++i) f.v[i] = kConst[row][i];
  return f;
}

TM_DEV Fe fe_small(int32_t x) {
  Fe f;
#pragma unroll
  for (int i = 0; i < 10; ++i) f.v[i] = 0;
  f.v[0] = x;
  return f;
}

struct Ge {  // extended coordinates: x = X/Z, y = Y/Z, T = XY/Z
  Fe X, Y, Z, T;
};

struct Cached {  // an addend, pre-transformed for ge_add
  Fe YpX, YmX, Z, T2d;
};

TM_DEV Cached to_cached(const Ge& p, const Fe& d2) {
  return Cached{fe_add(p.Y, p.X), fe_sub(p.Y, p.X), p.Z, fe_mul(p.T, d2)};
}

// dbl-2008-hwcd for a = -1, in the sign convention of the JAX kernel's
// point_double; WITH_T = false skips the T that the next doubling ignores.
template <bool WITH_T>
TM_DEV Ge ge_dbl(const Ge& p) {
  const Fe a = fe_sq(p.X);
  const Fe b = fe_sq(p.Y);
  const Fe zz = fe_sq(p.Z);
  const Fe c = fe_add(zz, zz);
  const Fe h = fe_add(a, b);
  const Fe e = fe_sub(h, fe_sq(fe_add(p.X, p.Y)));
  const Fe g = fe_sub(a, b);
  const Fe f = fe_add(c, g);
  Ge r;
  r.X = fe_mul(e, f);
  r.Y = fe_mul(g, h);
  r.Z = fe_mul(f, g);
  if (WITH_T) r.T = fe_mul(e, h);
  return r;
}

// add-2008-hwcd-3 (complete) against a cached addend.
TM_DEV Ge ge_add(const Ge& p, const Cached& q) {
  const Fe a = fe_mul(fe_sub(p.Y, p.X), q.YmX);
  const Fe b = fe_mul(fe_add(p.Y, p.X), q.YpX);
  const Fe c = fe_mul(p.T, q.T2d);
  const Fe zz = fe_mul(p.Z, q.Z);
  const Fe d = fe_add(zz, zz);
  const Fe e = fe_sub(b, a);
  const Fe f = fe_sub(d, c);
  const Fe g = fe_add(d, c);
  const Fe h = fe_add(b, a);
  return Ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

TM_DEV Ge ge_affine(const Fe& x, const Fe& y) {
  return Ge{x, y, fe_small(1), fe_mul(x, y)};
}

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
