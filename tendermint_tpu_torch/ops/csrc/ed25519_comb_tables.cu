// The comb tables of new validator keys, written straight into their pool
// slots, for Hopper (sm_90a).
//
// Replaces the table build of the JAX package,
// tendermint_tpu/ops/ed25519_comb.py::_build_tables_impl and its scatter
// `_scatter_tables` (XLA there). For each key Q = -A (canonical affine
// bytes) and each of the 64 window positions p, the 16 entries v * 16^p * Q
// (v = 0..15) as canonical niels rows (comb.cuh's layout). Every entry is
// canonical, so the rows are byte for byte the JAX package's whatever the
// order of the work. The plain PyTorch version it is held against is
// tendermint_tpu_torch/ops/ed25519_comb.py::build_tables_plain.
//
// Two passes, one launch each:
// 1. Bases, four threads a key on the point layer of fe25519x4.cuh: Q's
//    extended point, then 63 x four doublings, each 16^p * Q (thread t's
//    coordinate) written to a scratch buffer the wrapper allocates. Work a
//    key: one multiplication (T of Q), 63 x (three doublings without T, 4
//    squarings and 3 multiplications; one with T, 4 and 4): 820
//    multiplications, 1,008 squarings.
// 2. Positions, one thread a (key, position): the 15 extended multiples of
//    16^p * Q (14 additions, 8 multiplications each, against Q's cached
//    form, one multiplication), one Montgomery batch inversion of their 15
//    Z values (14 prefix products, the inversion's 11 + 254 squarings, 28
//    to unwind), and each entry's affine x, y, x*y and 2d*x*y (60). Work a
//    position: 226 multiplications, 254 squarings.
// A key: 15,284 multiplications and 17,264 squarings, 2,477,920 limb
// products (ed25519_comb.KERNEL_PRODUCTS_PER_KEY), and 98,304 bytes written
// (BYTES_PER_KEY). The function needs 1,547,410 products a key
// (ed25519_comb.MULS_PER_KEY / SQS_PER_KEY: one Montgomery batch over a
// key's 960 Z values, as the JAX package, instead of 64), and that count
// gives the bound chip_smoke.py reports: the kernel's 64 inversions a key
// are 38% of its products (not yet cut). What bounds it: the limb
// products; 98,304 bytes a key at the memory rate take a sixth of their
// time.

#include "comb.cuh"
#include "fe25519x4.cuh"

namespace {

// Thread t (rank in a key's group of four) of pass 1: coordinate t of
// 16^p * Q for p = 0..63 into bases[4p + t] when `store`.
TM_DEV void comb_bases_lane(int t, const uint32_t qxw[8], const uint32_t qyw[8], Fe* bases,
                            bool store) {
  Fe q = ge4_affine(t, fe_from_words(qxw), fe_from_words(qyw));
  if (store) bases[t] = q;
#pragma unroll 1
  for (int p = 1; p < kCombPositions; ++p) {
    q = ge4_dbl<false>(t, q);
    q = ge4_dbl<false>(t, q);
    q = ge4_dbl<false>(t, q);
    q = ge4_dbl<true>(t, q);
    if (store) bases[4 * p + t] = q;
  }
}

// Pass 2 for one (key, position): from the extended point (X, Y, Z, T) of
// 16^p * Q in `base`, the position's 16 niels rows into `rows`.
TM_DEV void comb_position(const Fe base[4], uint8_t* __restrict__ rows) {
  const Fe d2 = fe_const(0);
  // Q's cached form (Y-X, Y+X, 2Z, 2d*T)
  const Fe qm = fe_sub(base[1], base[0]);
  const Fe qp = fe_add(base[1], base[0]);
  const Fe qz2 = fe_add(base[2], base[2]);
  const Fe qt2d = fe_mul(base[3], d2);
  // the multiples v*Q for v = 1..15 (index v - 1), and the prefix
  // products of their Z values
  Fe ex[kCombEntries - 1], ey[kCombEntries - 1], ez[kCombEntries - 1], pre[kCombEntries - 1];
  Fe x = base[0], y = base[1], z = base[2], tt = base[3];
#pragma unroll 1
  for (int v = 0; v < kCombEntries - 1; ++v) {
    ex[v] = x;
    ey[v] = y;
    ez[v] = z;
    pre[v] = v == 0 ? z : fe_mul(pre[v - 1], z);
    if (v + 1 < kCombEntries - 1) {  // the next multiple: + Q (add-2008-hwcd-3)
      const Fe a = fe_mul(fe_sub(y, x), qm);
      const Fe b = fe_mul(fe_add(y, x), qp);
      const Fe c = fe_mul(tt, qt2d);
      const Fe d = fe_mul(z, qz2);
      const Fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
      x = fe_mul(e, f);
      y = fe_mul(g, h);
      z = fe_mul(f, g);
      tt = fe_mul(e, h);
    }
  }
  store_row(rows, fe_small(1), fe_small(1), fe_small(0));  // entry 0: the identity
  Fe inv = fe_invert(pre[kCombEntries - 2]);  // 1 / (Z_1 ... Z_15)
#pragma unroll 1
  for (int v = kCombEntries - 2; v >= 0; --v) {
    Fe zinv = inv;
    if (v > 0) {
      zinv = fe_mul(inv, pre[v - 1]);
      inv = fe_mul(inv, ez[v]);
    }
    const Fe ax = fe_mul(ex[v], zinv);
    const Fe ay = fe_mul(ey[v], zinv);
    const Fe t2 = fe_mul(fe_mul(ax, ay), d2);
    store_row(rows + (v + 1) * kRowBytes, fe_canon(fe_sub(ay, ax)), fe_canon(fe_add(ay, ax)),
              fe_canon(t2));
  }
}

constexpr int kThreads = 128;  // pass 1: 32 keys a block; pass 2: 128 (key, position) pairs
constexpr int kKeys = kThreads / 4;

__global__ void __launch_bounds__(kThreads)
    comb_bases_kernel(const uint8_t* __restrict__ qx, const uint8_t* __restrict__ qy,
                      Fe* __restrict__ bases, int k) {
  const int t = threadIdx.x & 3;
  const int group = blockIdx.x * kKeys + (threadIdx.x >> 2);
  const int key = group < k ? group : k - 1;  // a group past the end recomputes the last key
  uint32_t xw[8], yw[8];
  load_words(qx, k, key, xw);
  load_words(qy, k, key, yw);
  comb_bases_lane(t, xw, yw, bases + static_cast<size_t>(key) * kCombPositions * 4, group < k);
}

__global__ void __launch_bounds__(kThreads)
    comb_tables_kernel(const Fe* __restrict__ bases, const int32_t* __restrict__ slots,
                       uint8_t* __restrict__ pool, int k, int pool_slots) {
  const int i = blockIdx.x * kThreads + threadIdx.x;  // key i / 64, position i % 64
  if (i >= k * kCombPositions) return;  // no exchange in this pass
  const int slot = slots[i / kCombPositions];
  if (slot <= 0 || slot >= pool_slots) return;  // slot 0 stays zero; never write outside
  Fe base[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) base[c] = bases[static_cast<size_t>(i) * 4 + c];
  const int p = i % kCombPositions;
  comb_position(base, pool + (static_cast<size_t>(slot) * kSlotRows + p * kCombEntries) * kRowBytes);
}

}  // namespace

// qx, qy: (32, k) uint8 canonical affine bytes of Q = -A, limb-major;
// slots: (k,) int32 in [1, pool_slots); pool: (pool_slots * 1024, 96)
// uint8; scratch: k * 64 * 4 Fe (k * 10,240 bytes). Launches both passes
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tm_ed25519_comb_tables(const uint8_t* qx, const uint8_t* qy, const int32_t* slots,
                                      uint8_t* pool, void* scratch, int k, int pool_slots,
                                      void* stream) {
  if (k <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Fe* bases = static_cast<Fe*>(scratch);
  comb_bases_kernel<<<(k + kKeys - 1) / kKeys, kThreads, 0, s>>>(qx, qy, bases, k);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = k * kCombPositions;
  comb_tables_kernel<<<(pairs + kThreads - 1) / kThreads, kThreads, 0, s>>>(bases, slots, pool,
                                                                            k, pool_slots);
  return static_cast<int>(cudaGetLastError());
}
