// GF(2^255 - 19) and Edwards-curve point arithmetic for the port's
// one-thread-per-lane Ed25519 kernels (ed25519_verify.cu, B1;
// ed25519_verify_b2.cu, B2; ed25519_dsm.cu, the dual scalar multiply).
//
// Field elements are 10 signed 32-bit limbs of radix 2^25.5 (26/25 bits
// alternating); a limb product is one 32x32->64-bit IMAD.WIDE, a multiply
// 100 of them and a square 55. Points are extended coordinates; additions
// take the addend in "cached" form (Y+X, Y-X, Z, 2d*T).
//
// Each kernel source includes this header into its own translation unit
// and shared library, so everything here has internal linkage.

#pragma once

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

// The inverse of fe_from_words for a canonical Fe: eight LE words, bit 255
// clear.
TM_DEV void fe_to_words(const Fe& f, uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = 0;
  int off = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int lo = off >> 5, sh = off & 31;
    const uint32_t x = (uint32_t)f.v[i];
    w[lo] |= x << sh;
    if (sh + limb_bits(i) > 32) w[lo + 1] |= x >> (32 - sh);
    off += limb_bits(i);
  }
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

// The inverse of load_words: eight LE words into column `lane`.
TM_DEV void store_words(uint8_t* __restrict__ p, int n, int lane, const uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int b = 0; b < 4; ++b) p[(4 * k + b) * n + lane] = (uint8_t)(w[k] >> (8 * b));
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

// dbl-2008-hwcd for a = -1, in the sign convention of the JAX kernels'
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

}  // namespace
