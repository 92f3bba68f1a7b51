// Edwards-curve point arithmetic with four threads per point, for the
// port's B1 (ed25519_verify.cu), B2 (ed25519_verify_b2.cu), dsm
// (ed25519_dsm.cu) and comb (ed25519_comb.cu, ed25519_comb_tables.cu)
// kernels.
//
// A group of four consecutive threads of a warp carries one lane. Thread t
// of the group (t = threadIdx.x & 3) holds coordinate t of the lane's
// extended point (X, Y, Z, T) as one radix-2^25.5 Fe of fe25519.cuh, and
// coordinate t of each cached addend (Y-X, Y+X, Z, 2d*T). A point operation
// is two stages of one field multiplication or squaring per thread,
// separated by exchanges of whole Fe values inside the group:
//
//   doubling (dbl-2008-hwcd, in the sign convention of the JAX row code's
//   point_double, tendermint_tpu/ops/ed25519.py:245)
//     stage 1: threads 0-3 square X+Y, Y, Z, X (one exchange first:
//              thread 0 fetches Y, thread 3 fetches X)
//     stage 2: each thread gathers (X+Y)^2, Y^2, Z^2, X^2 (four
//              exchanges), forms e, f, g, h and computes its own new
//              coordinate: e*f, g*h, f*g, e*h. The doubling without T
//              leaves thread 3 idle in stage 2.
//   addition (add-2008-hwcd-3, complete, against a cached addend)
//     stage 1: threads 0-3 compute (Y-X)*(Y-X)', (Y+X)*(Y+X)', Z*Z',
//              T*(2dT)' (one exchange first: threads 0 and 1 swap X and Y)
//     stage 2: as in the doubling.
//
// So a two-bit ladder step (two doublings and one addition, B1 and dsm)
// is 6 field operations deep on each thread instead of 23, at the price of
// 15 exchanges of ten limbs, and a single-bit step (one doubling and one
// addition, B2) 4 instead of 16, at 10 exchanges. The sums and differences between the stages take one parallel
// carry pass instead of a chain (fe_carry_light). All 32 threads of the
// warp take part in every exchange, so no thread may leave the kernel
// early: a group past the last lane computes on a clamped lane and skips
// its store.
//
// fe_shfl and fe_shfl_xor are the only exchanges, and block_invert,
// block_product_tree and block_tree_unwind the only code that sees the
// block (threadIdx.x,
// __syncthreads). Defining TM_HOST_EXCHANGE before this header (with
// fe25519.cuh, an fe_shfl and an fe_shfl_xor of the same signatures, a
// threadIdx and a __syncthreads declared first) compiles the point layer
// as host C++, one std::thread standing in for each thread of a block;
// tests/test_torch_fe25519x4.py does that.

#pragma once

#include "fe25519.cuh"

namespace {

#ifndef TM_HOST_EXCHANGE
// Thread `src` (0..3) of the caller's group's f: ten width-4 shuffles.
TM_DEV Fe fe_shfl(const Fe& f, int src) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = __shfl_sync(0xffffffffu, f.v[i], src, 4);
  return r;
}

// The f of the thread whose index in the warp is the caller's XOR `mask`
// (4: the same rank in the neighbouring group, the comb verify's join).
TM_DEV Fe fe_shfl_xor(const Fe& f, int mask) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = __shfl_xor_sync(0xffffffffu, f.v[i], mask);
  return r;
}
#endif

// f0, f1, f2 or f3 by k (0..3; the group rank, or B2's bit pair), limb by
// limb (selects, no branch).
TM_DEV Fe fe_pick(int k, const Fe& f0, const Fe& f1, const Fe& f2, const Fe& f3) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 10; ++i)
    r.v[i] = k == 0 ? f0.v[i] : (k == 1 ? f1.v[i] : (k == 2 ? f2.v[i] : f3.v[i]));
  return r;
}

// Sums and differences between the stages, with one parallel carry pass:
// every limb's overflow moves up one place at once (limb 9's, times 19,
// into limb 0), three instructions deep where fe_carry32's chain is ten
// steps. Every input here is "carried" (an fe_mul or fe_sq output, or read
// from bytes) or "lightly carried" (an output of these helpers); every limb
// sum they form is in [0, 2^29), so each result's limb i lies in
// [0, 2^w_i + 2^9), w_i its width. That is a hair above "carried": fe_mul's
// and fe_sq's products still stay below 2^58 and their column sums below
// 2^62, and each limb stays below 2p's, so it may be subtracted.
TM_DEV Fe fe_carry_light(const int32_t h[10]) {
  int32_t c[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) c[i] = h[i] >> limb_bits(i);
  Fe out;
  out.v[0] = (h[0] & ((1 << 26) - 1)) + 19 * c[9];
#pragma unroll
  for (int i = 1; i < 10; ++i) out.v[i] = (h[i] & ((1 << limb_bits(i)) - 1)) + c[i - 1];
  return out;
}

TM_DEV Fe fe_add_l(const Fe& a, const Fe& b) {  // a + b
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = a.v[i] + b.v[i];
  return fe_carry_light(h);
}

TM_DEV Fe fe_sub_l(const Fe& a, const Fe& b) {  // a - b
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = a.v[i] + k2P[i] - b.v[i];
  return fe_carry_light(h);
}

TM_DEV Fe fe_add_sub_l(const Fe& a, const Fe& b, const Fe& c) {  // a + b - c
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = a.v[i] + b.v[i] + k2P[i] - c.v[i];
  return fe_carry_light(h);
}

TM_DEV Fe fe_add3_sub_l(const Fe& a, const Fe& b, const Fe& c, const Fe& d) {  // a + b + c - d
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = a.v[i] + b.v[i] + c.v[i] + k2P[i] - d.v[i];
  return fe_carry_light(h);
}

TM_DEV Fe fe_add3_l(const Fe& a, const Fe& b, const Fe& c) {  // a + b + c
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = a.v[i] + b.v[i] + c.v[i];
  return fe_carry_light(h);
}

// The identity (0, 1, 1, 0), and its cached form (1, 1, 1, 0).
TM_DEV Fe ge4_identity(int t) { return fe_small(t == 1 || t == 2 ? 1 : 0); }
TM_DEV Fe ge4_cached_identity(int t) { return fe_small(t == 3 ? 0 : 1); }

// The extended point (x, y, 1, xy) of an affine point every thread holds:
// one multiplication, on thread 3.
TM_DEV Fe ge4_affine(int t, const Fe& x, const Fe& y) {
  Fe xy = x;
  if (t == 3) xy = fe_mul(x, y);
  return fe_pick(t, x, y, fe_small(1), xy);
}

// This thread's coordinate of the cached form (Y-X, Y+X, Z, 2d*T) of the
// point p: one exchange (threads 0 and 1 swap X and Y), one
// multiplication on thread 3.
TM_DEV Fe ge4_cached(int t, const Fe& p, const Fe& d2) {
  const Fe o = fe_shfl(p, t ^ 1);
  Fe t2d = p;
  if (t == 3) t2d = fe_mul(p, d2);
  return fe_pick(t, fe_sub_l(o, p), fe_add_l(p, o), p, t2d);
}

// Stage 2 of both operations: gather the four stage-1 results q (thread
// order), form e, f, g, h with `combine` (each straight from the q values,
// one carry pass deep), and compute this thread's new coordinate (e*f,
// g*h, f*g, e*h). Thread 3 skips its product when with_t is false.
template <typename Combine>
TM_DEV Fe ge4_stage2(int t, const Fe& q, bool with_t, Combine combine) {
  const Fe q0 = fe_shfl(q, 0);
  const Fe q1 = fe_shfl(q, 1);
  const Fe q2 = fe_shfl(q, 2);
  const Fe q3 = fe_shfl(q, 3);
  Fe e, f, g, h;
  combine(q0, q1, q2, q3, e, f, g, h);
  Fe r = e;
  if (with_t || t != 3) r = fe_mul(fe_pick(t, e, g, f, e), fe_pick(t, f, h, g, h));
  return r;
}

// 2p: stage 1 squares X+Y, Y, Z, X on threads 0-3.
template <bool WITH_T>
TM_DEV Fe ge4_dbl(int t, const Fe& p) {
  const Fe o = fe_shfl(p, t == 0 ? 1 : (t == 3 ? 0 : t));  // 0 <- Y, 3 <- X
  const Fe u = fe_pick(t, fe_add_l(p, o), o, o, o);
  const Fe q = fe_sq(u);
  return ge4_stage2(t, q, WITH_T,
                    [](const Fe& s, const Fe& b, const Fe& zz, const Fe& a, Fe& e, Fe& f, Fe& g,
                       Fe& h) {
                      h = fe_add_l(a, b);            // a + b
                      e = fe_add_sub_l(a, b, s);     // h - (X+Y)^2
                      g = fe_sub_l(a, b);            // a - b
                      f = fe_add3_sub_l(zz, zz, a, b);  // 2zz + g
                    });
}

// p + q for q cached (this thread holds coordinate t of q's cached form):
// stage 1 computes (Y-X)*q0, (Y+X)*q1, Z*q2, T*q3 on threads 0-3. With
// NIELS, q is an affine point in niels form (y-x, y+x, 2dxy; Z = 1, the
// comb kernel's table entries): thread 2's coordinate is not read and its
// stage-1 product Z*1 is left out (a mixed addition, 7 multiplications).
template <bool NIELS = false>
TM_DEV Fe ge4_add(int t, const Fe& p, const Fe& qc) {
  const Fe o = fe_shfl(p, t ^ 1);  // 0 <- Y, 1 <- X
  const Fe u = fe_pick(t, fe_sub_l(o, p), fe_add_l(p, o), p, p);
  Fe q = u;
  if (!NIELS || t != 2) q = fe_mul(u, qc);
  return ge4_stage2(t, q, true,
                    [](const Fe& a, const Fe& b, const Fe& zz, const Fe& c, Fe& e, Fe& f, Fe& g,
                       Fe& h) {
                      e = fe_sub_l(b, a);
                      f = fe_add_sub_l(zz, zz, c);  // 2zz - c
                      g = fe_add3_l(zz, zz, c);     // 2zz + c
                      h = fe_add_l(b, a);
                    });
}

// The 16-entry joint table {i*P + j*Q}, i, j in 0..3, at index i + 4j, in
// cached form, this thread's coordinate of each: p_row holds the points
// 1P..3P (index 0 unused), p_row_c and q_row_c the cached 0P..3P and
// 0Q..3Q. The nine mixed entries cost one addition and one cached
// conversion each.
TM_DEV void ge4_joint_table(int t, const Fe p_row[4], const Fe p_row_c[4], const Fe q_row_c[4],
                            const Fe& d2, Fe table[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) table[4 * j] = q_row_c[j];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    table[i] = p_row_c[i];
#pragma unroll
    for (int j = 1; j < 4; ++j) table[i + 4 * j] = ge4_cached(t, ge4_add(t, p_row[i], q_row_c[j]), d2);
  }
}

// [s]P + [h]Q, MSB first over the 127 two-bit digits of the scalars s and h
// (eight LE words each, below 2^254), walking the joint table: two
// doublings and one addition a step.
TM_DEV Fe ge4_ladder(int t, const Fe table[16], const uint32_t sw[8], const uint32_t hw[8]) {
  Fe acc = ge4_identity(t);
#pragma unroll 1
  for (int k = 126; k >= 0; --k) {
    acc = ge4_dbl<false>(t, acc);
    acc = ge4_dbl<true>(t, acc);
    const int sh = 2 * (k & 15);
    const uint32_t sel = ((sw[k >> 4] >> sh) & 3u) | (((hw[k >> 4] >> sh) & 3u) << 2);
    acc = ge4_add(t, acc, table[sel]);
  }
  return acc;
}

// [s]P + [h]Q, MSB first over the 253 bits of the scalars s and h (eight
// LE words each, below 2^253), walking the cached table {0, P, Q, P+Q} at
// index (bit of s) + 2 (bit of h): one doubling and one addition a step.
// The addition is never skipped, also when both bits are 0: a warp's eight
// lanes would almost never agree on skipping it. All four threads read the
// lane's words, so the bit pair selects the same entry on each. The entries
// stay in registers and are picked with selects: faster than an indexed
// read from local memory (PERF.md).
TM_DEV Fe ge4_ladder_bits(int t, const Fe table[4], const uint32_t sw[8], const uint32_t hw[8]) {
  Fe acc = ge4_identity(t);
#pragma unroll 1
  for (int k = 252; k >= 0; --k) {
    acc = ge4_dbl<true>(t, acc);
    const int sel = ((sw[k >> 5] >> (k & 31)) & 1u) | (((hw[k >> 5] >> (k & 31)) & 1u) << 1);
    acc = ge4_add(t, acc, fe_pick(sel, table[0], table[1], table[2], table[3]));
  }
  return acc;
}

// Z^-1 of the point p for every lane of a block of LANES lanes (4 x LANES
// threads), on every thread of the lane's group: thread 2 of each group
// puts its Z in zs (LANES entries, shared by the block), the block's first
// LANES threads invert one each, and each group reads its own back. The
// inversion is a chain of 265 field operations; inverting inside each
// group would issue it once a warp for 8 lanes, here once a warp for 32,
// while the block's other warps wait at the barrier.
template <int LANES>
TM_DEV Fe block_invert(int t, const Fe& p, Fe* zs) {
  const int x = threadIdx.x;
  if (t == 2) zs[x >> 2] = p;
  __syncthreads();
  if (x < LANES) zs[x] = fe_invert(zs[x]);
  __syncthreads();
  return zs[x >> 2];
}

// This thread's affine coordinate of the point p, canonical, on threads 0
// (x) and 1 (y); threads 2 and 3 return an unspecified value. zs is
// block_invert's.
template <int LANES>
TM_DEV Fe ge4_to_affine(int t, const Fe& p, Fe* zs) {
  const Fe zinv = block_invert<LANES>(t, p, zs);
  Fe r = p;
  if (t < 2) r = fe_canon(fe_mul(p, zinv));
  return r;
}

// Montgomery's batch inversion of one value a thread across a block of
// THREADS threads (a power of two), in two halves around the inversion of
// their product, so that the inversion can run elsewhere: the table build
// inverts every block's product in a launch of its own, 32 a warp, where
// inside the block it would leave the block's other threads idle through
// its 265 operations. The values are the leaves of a binary product tree
// in `tree` (2 * THREADS - 1 shared Fe, heap order: node m's children are
// 2m + 1 and 2m + 2).
//
// block_product_tree multiplies the tree up: on return (after a barrier)
// tree[0] is the product of every thread's `leaf`. The caller replaces
// tree[0] by its inverse and passes a barrier; block_tree_unwind then
// multiplies each node's inverse by its sibling's product for a child's
// inverse down the tree and returns 1 / leaf to each thread. Work: 3
// multiplications a value beside the one inversion, as a chain-long
// Montgomery batch; depth: 2 log2(THREADS) multiplications, where one chain
// would take 2 THREADS. Zero has no inverse: a zero leaf turns every
// result to zero (curve points' Z never is).
template <int THREADS>
TM_DEV void block_product_tree(const Fe& leaf, Fe* tree) {
  const int i = threadIdx.x;
  tree[THREADS - 1 + i] = leaf;
  __syncthreads();
#pragma unroll 1
  for (int width = THREADS / 2; width >= 1; width >>= 1) {
    if (i < width) {
      const int m = width - 1 + i;
      tree[m] = fe_mul(tree[2 * m + 1], tree[2 * m + 2]);
    }
    __syncthreads();
  }
}

template <int THREADS>
TM_DEV Fe block_tree_unwind(Fe* tree) {
  const int i = threadIdx.x;
#pragma unroll 1
  for (int width = 1; width < THREADS; width <<= 1) {
    if (i < width) {
      const int m = width - 1 + i;
      const Fe inv = tree[m], l = tree[2 * m + 1], r = tree[2 * m + 2];
      tree[2 * m + 1] = fe_mul(inv, r);
      tree[2 * m + 2] = fe_mul(inv, l);
    }
    __syncthreads();
  }
  return tree[THREADS - 1 + i];
}

}  // namespace
