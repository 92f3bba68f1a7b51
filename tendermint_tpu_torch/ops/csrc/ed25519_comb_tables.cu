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
// Four passes, one launch each:
// 1. Bases, four threads a key on the point layer of fe25519x4.cuh: Q's
//    extended point, then 63 x four doublings, each 16^p * Q (thread t's
//    coordinate) written to a scratch buffer the wrapper allocates. Work a
//    key: one multiplication (T of Q), 63 x (three doublings without T, 4
//    squarings and 3 multiplications; one with T, 4 and 4): 820
//    multiplications, 1,008 squarings. Critical path: 504 field operations.
// 2. Entries, one thread a (key, position), 128 a block (two keys): the
//    base's cached form (one multiplication), the 15 extended multiples v *
//    16^p * Q by 14 additions (8 multiplications each), and the prefix
//    products P_v = Z_1 ... Z_v. Each entry's X_v P_(v-1), Y_v P_(v-1) and
//    Z_v go to the scratch, limb-major across the launch's pairs (each
//    store a warp's 128 consecutive bytes), so no thread keeps an array of
//    entries and no Montgomery prefix is stored apart: with 1 / P_v, pass 4
//    gets x_v = X_v P_(v-1) / P_v and 1 / P_(v-1) = Z_v / P_v from them
//    alone. The block multiplies its 128 products P_15 into one
//    (block_product_tree in shared memory). Work a pair: 1 + 112 + 28 + 14
//    = 155 multiplications; a block: 127 more. Critical path: 155 + 7.
// 3. Inversions, one thread a block's product (one for two keys), 32 a
//    warp: 11 multiplications and 254 squarings, 265 deep. Inside the block
//    the inversion would leave its other 127 threads idle for 265
//    operations and spend a warp's issue slots on one lane; here every lane
//    inverts.
// 4. Rows, the same blocks: the tree again, unwound from pass 3's inverse
//    to each thread's 1 / P_15 (block_tree_unwind); then for v = 15 down to
//    1, x_v, y_v and 1 / P_(v-1) from the scratch, and the canonical niels
//    row of (x_v, y_v, 2d x_v y_v) stored in six 16-byte stores; row 0, the
//    identity. Work a pair: 60 + 14 = 74 multiplications; a block: 127 +
//    254 more. Critical path: 7 + 7 + 74.
// Two keys: 31,471 multiplications and 2,270 squarings, 3,271,950 limb
// products (ed25519_comb.KERNEL_PRODUCTS_PER_KEY is half), with one
// inversion where one a (key, position) would make 128. The function
// needs 1,532,340 a key (ed25519_comb.MULS_PER_KEY / SQS_PER_KEY: the JAX
// package's one batch a key, with its inversion shared as here, so counted
// as none), the count behind the bound chip_smoke.py reports. Critical
// path: 504 + 162 + 265 + 88 = 1,019 operations. Bytes a key: 98,304 of
// niels rows written (BYTES_PER_KEY), 115,200 of entry values written and
// read back, 12,840 of bases and products. What bounds it: the limb
// products; those bytes at the memory rate take about a fifth of their
// time. Passes 2 and 4 take one thread a pair, not four: the build is
// throughput-bound at the key counts that matter, and the four-thread
// layer's exchanges and repeated stage arithmetic cost about 2.4 times an
// addition's instructions; and the entry values go limb-major to a scratch
// buffer, not to their own pool rows, where each thread's 4-byte stores
// land on rows 1,536 bytes apart (both measured slower, PERF.md). Pass 2
// reads its base's cached form from shared memory at each use instead of
// holding it in 40 registers, so it runs without spills at three blocks an
// SM. Shared memory: the 255-node tree, 10,200 bytes a block, and in pass
// 2 the cached forms, 20,480 more.

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

// A block of THREADS (key, position) pairs in passes 2 and 4, one a
// thread: pair = key * 64 + position, thread i of block b has pair b *
// THREADS + i. A pair past the last, or whose key's slot is 0 or past the
// pool, stores nothing and counts 1 in the batch.
template <int THREADS>
struct TableBlock {
  int block, pairs, pool_slots;
  const int32_t* slots;
  uint8_t* pool;
  // the entries' scratch: limb l of value j = 3 (v - 1) + c of pair p at
  // ent[(10 j + l) pairs + p]
  int32_t* ent;

  // value j of thread i's pair in the scratch, limb by limb: consecutive
  // threads touch consecutive words
  TM_DEV void put(int i, int j, const Fe& f) const {
    int32_t* at = ent + static_cast<size_t>(10 * j) * pairs + block * THREADS + i;
#pragma unroll
    for (int l = 0; l < 10; ++l) at[static_cast<size_t>(l) * pairs] = f.v[l];
  }
  TM_DEV Fe get(int i, int j) const {
    const int32_t* at = ent + static_cast<size_t>(10 * j) * pairs + block * THREADS + i;
    Fe f;
#pragma unroll
    for (int l = 0; l < 10; ++l) f.v[l] = at[static_cast<size_t>(l) * pairs];
    return f;
  }

  // the 16 rows of thread i's pair, or nullptr
  TM_DEV uint8_t* rows(int i) const {
    const int pr = block * THREADS + i;
    if (pr >= pairs) return nullptr;
    const int slot = slots[pr / kCombPositions];
    if (slot <= 0 || slot >= pool_slots) return nullptr;  // slot 0 stays zero
    return pool + (static_cast<size_t>(slot) * kSlotRows + (pr % kCombPositions) * kCombEntries) * kRowBytes;
  }
};

// Pass 2 for one block: each thread's 15 extended multiples (X, Y, Z, T)
// of v * 16^p * Q (v = 1..15) from its base (bases[4 pair .. 4 pair + 3]),
// by 14 additions of the base's cached form (add-2008-hwcd-3), and the
// prefix products P_v = Z_1 ... Z_v. The scratch holds, until pass 4, X_v
// P_(v-1), Y_v P_(v-1) and Z_v: with 1 / P_v, pass 4 gets x_v = X_v P_(v-1)
// / P_v and 1 / P_(v-1) = Z_v / P_v from them alone. P_15 goes to
// leaves[pair], and the product of the block's P_15 into *root
// (block_product_tree over THREADS leaves; tree: 2 x THREADS - 1 shared Fe;
// cached: 40 x THREADS shared int32, the bases' cached forms).
template <int THREADS>
TM_DEV void comb_entries_block(const TableBlock<THREADS>& tb, const Fe* __restrict__ bases,
                               Fe* __restrict__ leaves, Fe* tree, int32_t* cached, Fe* root) {
  const int i = threadIdx.x;
  const int pair0 = tb.block * THREADS + i;
  const int pair = pair0 < tb.pairs ? pair0 : tb.pairs - 1;  // past the end: the last pair again
  uint8_t* const rows = tb.rows(i);
  const Fe d2 = fe_const(0);
  const Fe* base = bases + static_cast<size_t>(pair) * 4;
  Fe x = base[0], y = base[1], z = base[2], t = base[3];
  // the base's cached form (Y-X, Y+X, 2Z, 2d*T), limb-major in shared
  // memory and read at each use, so the loop keeps only the multiple and
  // the prefix in registers
  volatile int32_t* const cq = cached + i;
  const auto put_q = [&](int c, const Fe& f) {
#pragma unroll
    for (int l = 0; l < 10; ++l) cq[(10 * c + l) * THREADS] = f.v[l];
  };
  const auto q = [&](int c) {
    Fe f;
#pragma unroll
    for (int l = 0; l < 10; ++l) f.v[l] = cq[(10 * c + l) * THREADS];
    return f;
  };
  put_q(0, fe_sub(y, x));
  put_q(1, fe_add(y, x));
  put_q(2, fe_add(z, z));
  put_q(3, fe_mul(t, d2));
  Fe pre = z;  // P_v after step v - 1
#pragma unroll 1
  for (int v = 1; v < kCombEntries; ++v) {
    if (rows != nullptr) {
      tb.put(i, 3 * (v - 1), v == 1 ? x : fe_mul(x, pre));
      tb.put(i, 3 * (v - 1) + 1, v == 1 ? y : fe_mul(y, pre));
      tb.put(i, 3 * (v - 1) + 2, z);
    }
    if (v > 1) pre = fe_mul(pre, z);
    if (v + 1 < kCombEntries) {  // the next multiple: + the base
      const Fe a = fe_mul(fe_sub(y, x), q(0));
      const Fe b = fe_mul(fe_add(y, x), q(1));
      const Fe c = fe_mul(t, q(3));
      const Fe d = fe_mul(z, q(2));
      const Fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
      x = fe_mul(e, f);
      y = fe_mul(g, h);
      z = fe_mul(f, g);
      t = fe_mul(e, h);
    }
  }
  const Fe leaf = rows != nullptr ? pre : fe_small(1);
  if (pair0 < tb.pairs) leaves[pair0] = leaf;
  block_product_tree<THREADS>(leaf, tree);
  if (i == 0) *root = tree[0];
}

// Pass 4 for one block: with the inverse of pass 2's product (inv_root),
// each thread's 1 / P_15 by the same tree (block_tree_unwind), then its
// pair's rows from 15 down to 1: x_v, y_v from the scratch and 1 / P_v,
// 1 / P_(v-1) = Z_v / P_v, and the canonical niels row of (x_v, y_v); row
// 0, the identity. tree: 2 x THREADS - 1 shared Fe.
template <int THREADS>
TM_DEV void comb_rows_block(const TableBlock<THREADS>& tb, const Fe* __restrict__ leaves,
                            const Fe& inv_root, Fe* tree) {
  const int i = threadIdx.x;
  const int pair0 = tb.block * THREADS + i;
  uint8_t* const rows = tb.rows(i);
  block_product_tree<THREADS>(rows != nullptr ? leaves[pair0] : fe_small(1), tree);
  if (i == 0) tree[0] = inv_root;
  __syncthreads();
  Fe inv = block_tree_unwind<THREADS>(tree);  // 1 / P_v, from v = 15
  if (rows == nullptr) return;
  const Fe d2 = fe_const(0);
#pragma unroll 1
  for (int v = kCombEntries - 1; v >= 1; --v) {
    const Fe ax = fe_mul(tb.get(i, 3 * (v - 1)), inv);
    const Fe ay = fe_mul(tb.get(i, 3 * (v - 1) + 1), inv);
    if (v > 1) inv = fe_mul(inv, tb.get(i, 3 * (v - 1) + 2));
    const Fe t2 = fe_mul(fe_mul(ax, ay), d2);
    store_row(rows + v * kRowBytes, fe_canon(fe_sub(ay, ax)), fe_canon(fe_add(ay, ax)), fe_canon(t2));
  }
  store_row(rows, fe_small(1), fe_small(1), fe_small(0));
}

constexpr int kThreads = 128;  // pass 1: 32 keys a block; passes 2 and 4: 128 pairs (two keys)
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

__global__ void __launch_bounds__(kThreads, 3)
    comb_entries_kernel(const Fe* __restrict__ bases, const int32_t* __restrict__ slots,
                        uint8_t* pool, int32_t* ent, Fe* __restrict__ leaves, Fe* __restrict__ roots,
                        int k, int pool_slots) {
  __shared__ Fe tree[2 * kThreads - 1];
  __shared__ int32_t cached[4 * 10 * kThreads];
  const TableBlock<kThreads> tb{static_cast<int>(blockIdx.x), k * kCombPositions, pool_slots, slots,
                                pool, ent};
  comb_entries_block<kThreads>(tb, bases, leaves, tree, cached, roots + blockIdx.x);
}

__global__ void __launch_bounds__(kThreads)
    comb_invert_kernel(Fe* __restrict__ roots, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) roots[i] = fe_invert(roots[i]);  // no exchange in this pass
}

__global__ void __launch_bounds__(kThreads, 3)
    comb_rows_kernel(const int32_t* __restrict__ slots, uint8_t* pool, int32_t* ent,
                     const Fe* __restrict__ leaves, const Fe* __restrict__ roots, int k, int pool_slots) {
  __shared__ Fe tree[2 * kThreads - 1];
  const TableBlock<kThreads> tb{static_cast<int>(blockIdx.x), k * kCombPositions, pool_slots, slots,
                                pool, ent};
  comb_rows_block<kThreads>(tb, leaves, roots[blockIdx.x], tree);
}

}  // namespace

// qx, qy: (32, k) uint8 canonical affine bytes of Q = -A, limb-major;
// slots: (k,) int32, distinct, in [1, pool_slots) (a key outside is
// skipped); pool: (pool_slots * 1024, 96) uint8, 16-byte aligned; scratch:
// k * 3,201 Fe (k * 128,040 bytes: 64 x 4 bases, 64 products P_15 and 64 x
// 45 entry values a key, and room for a product a block of two keys;
// ed25519_comb.TABLE_SCRATCH_FE_PER_KEY). Launches the four passes on
// `stream` and returns the first cudaGetLastError() that is not 0 (0 on
// success).
extern "C" int tm_ed25519_comb_tables(const uint8_t* qx, const uint8_t* qy, const int32_t* slots,
                                      uint8_t* pool, void* scratch, int k, int pool_slots,
                                      void* stream) {
  if (k <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pairs = k * kCombPositions;
  Fe* bases = static_cast<Fe*>(scratch);
  Fe* leaves = bases + static_cast<size_t>(pairs) * 4;
  int32_t* ent = reinterpret_cast<int32_t*>(leaves + pairs);
  Fe* roots = leaves + pairs + static_cast<size_t>(pairs) * 3 * (kCombEntries - 1);
  const int blocks = (pairs + kThreads - 1) / kThreads;  // an odd key count leaves half a block
  comb_bases_kernel<<<(k + kKeys - 1) / kKeys, kThreads, 0, s>>>(qx, qy, bases, k);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    comb_entries_kernel<<<blocks, kThreads, 0, s>>>(bases, slots, pool, ent, leaves, roots, k,
                                                    pool_slots);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    comb_invert_kernel<<<(blocks + kThreads - 1) / kThreads, kThreads, 0, s>>>(roots, blocks);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    comb_rows_kernel<<<blocks, kThreads, 0, s>>>(slots, pool, ent, leaves, roots, k, pool_slots);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
