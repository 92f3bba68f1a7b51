// The comb table layout shared by the comb verify kernel (ed25519_comb.cu)
// and the table-build kernel (ed25519_comb_tables.cu).
//
// A table is 64 window positions x 16 entries; entry v of position p is the
// affine point v * 16^p * Q in niels form, one row of 96 bytes: the
// canonical little-endian bytes of (y - x, y + x, 2d*x*y), 32 each. Entry 0
// is the identity (1, 1, 0). A pool slot holds one key's table (1024 rows,
// 98,304 bytes); slot 0 stays zero. The B table is one such table of the
// base point. The JAX package stores the same values as bf16 rows; these
// are its bytes.

#pragma once

#include "fe25519.cuh"

namespace {

constexpr int kCombPositions = 64;
constexpr int kCombEntries = 16;
constexpr int kRowBytes = 96;
constexpr int kSlotRows = kCombPositions * kCombEntries;

// Four bits of a scalar held as eight LE words: the digit of position p
// (weight 16^p).
TM_DEV int comb_digit(const uint32_t w[8], int p) { return (w[p >> 3] >> ((p & 7) << 2)) & 15; }

// A row's coordinate `c` (0: y-x, 1: y+x, 2: 2dxy) as eight LE words: two
// 16-byte loads on the card (rows lie on 16-byte boundaries: the wrappers
// check the tables' base addresses).
TM_DEV void load_coord_words(const uint8_t* __restrict__ row, int c, uint32_t w[8]) {
#ifdef __CUDA_ARCH__
  const uint4* q = reinterpret_cast<const uint4*>(row + 32 * c);
  const uint4 a = __ldg(q), b = __ldg(q + 1);
  w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
#else
  const uint32_t* p = reinterpret_cast<const uint32_t*>(row + 32 * c);
  for (int k = 0; k < 8; ++k) w[k] = p[k];
#endif
}

// The three canonical coordinates of a niels row into `row`: six 16-byte
// stores on the card (rows lie on 16-byte boundaries: the wrappers check
// the pool's base address).
TM_DEV void store_row(uint8_t* __restrict__ row, const Fe& my, const Fe& py, const Fe& t2) {
  uint32_t w[24];
  fe_to_words(my, w);
  fe_to_words(py, w + 8);
  fe_to_words(t2, w + 16);
#ifdef __CUDA_ARCH__
  uint4* out = reinterpret_cast<uint4*>(row);
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
#else
  uint32_t* out = reinterpret_cast<uint32_t*>(row);
  for (int k = 0; k < 24; ++k) out[k] = w[k];
#endif
}

}  // namespace
