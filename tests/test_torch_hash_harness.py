"""The hash kernels' device code (`csrc/hash_block.cuh`, `ripemd160.cuh`,
`sha256.cuh`, `hash_blocks.cu`'s K1 and K2 pair walks and `merkle_tree.cu`'s
K3 walk), compiled as host C++ with g++ and run on the CPU.

The headers compile as written: a stub `cuda_runtime.h` defines the CUDA
qualifiers away and gives `uint4` and the funnel shifts their documented
meaning (hi:lo shifted, the high or the low word kept), and
`hash_blocks.cu` and `merkle_tree.cu` are cut before `constexpr int
kThreads` (the kernels and their launches need a card). g++ builds with
UBSan, so an out-of-range shift fails the run.

The walks that run on many threads run here as the card runs them: one
`std::thread` for each CUDA thread, with a thread-local `threadIdx`,
`blockIdx`, `blockDim` and `gridDim`, `__syncthreads` a barrier over the
thread's block, `__reduce_max_sync` an exchange over its warp, and K3's
grid barrier one over every thread of the grid. Every barrier waits at
most a few seconds: a walk whose threads meet unequal numbers of barriers
(which deadlocks on the card) returns an error instead of hanging the test.

Held against hashlib, `crypto.hashing.ripemd160` of both packages, the
JAX package's `ops.hashing.sha256_batch`, `merkle.simple.inner_hash` and
FlatTree of both packages, exactly:
- the one-thread walks (`ripemd160_message`, `sha256_message`) on the
  padding edge lengths, and `rmd_line` / `rmd_join` against
  `ripemd160_compress`;
- K1's pair walk (two warps a block, 32 messages, both lines side by side)
  at 1, 31, 33 and 65 messages and on a pair of 32 messages of 1 to 1,025
  blocks;
- K2's pair walk (two warps a block, 32 messages, the rounds on one warp
  and the schedule one block ahead on the other) at 1, 31, 33 and 65
  messages and on a pair of 32 messages of 1 to 161 and of 1 to 1,025
  blocks, and a K2 block whose warps meet unequal numbers of barriers;
- K3's one-thread node over ops/merkle.py's device schedule, and its walk
  over a grid of blocks then block 0, at small blocks and at the card's
  block of 1,024 threads, on trees of 2 to 10,000 leaves and on the leaf
  counts whose widest round is the block's cut and one more.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest

from tendermint_tpu.crypto.hashing import ripemd160 as jax_ripemd160
from tendermint_tpu.merkle.simple import FlatTree as JaxFlatTree
from tendermint_tpu.merkle.simple import inner_hash as jax_inner_hash
from tendermint_tpu.ops.hashing import sha256_batch as jax_sha256_batch
from tendermint_tpu_torch.crypto.hashing import ripemd160
from tendermint_tpu_torch.merkle.simple import FlatTree, inner_hash, leaf_hash
from tendermint_tpu_torch.ops import hashing as th
from tendermint_tpu_torch.ops import merkle as tm

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tendermint_tpu_torch", "ops", "csrc")
CUT = "constexpr int kThreads"

# the lengths where the block count changes (55/56, 119/120) and their
# neighbours, the empty message and one of many blocks
EDGE_LENGTHS = (0, 1, 55, 56, 57, 63, 64, 65, 119, 120, 121, 1000)
PAIR_LANES = 32  # messages a K1 block, nodes a K3 pair (ripemd160.cuh kPairLanes)
CARD_THREADS = tm.MAX_THREADS  # K3's block on the card
SMALL_THREADS = 128  # a K3 block of two pairs: a cut of 64 nodes
RESIDENT_BLOCKS = 3  # the grid a cooperative K3 launch gets here

STUB_CUDA_RUNTIME = """#pragma once
#include <cstdint>
#define __device__
#define __host__
#define __forceinline__ inline
struct uint4 {
  uint32_t x, y, z, w;
};
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t shift) {
  const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<uint32_t>((v << (shift & 31)) >> 32);
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t shift) {
  const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<uint32_t>(v >> (shift & 31));
}
// the harness's threads: indices and barriers (defined in harness.cpp)
struct HostDim {
  unsigned x;
};
extern thread_local HostDim threadIdx, blockIdx, blockDim, gridDim;
void __syncthreads();
int __reduce_max_sync(unsigned mask, int value);
"""

# cp.async as a copy done at once: a thread's wait for its groups is then
# always satisfied
STUB_CUDA_PIPELINE = """#pragma once
#include <cstddef>
#include <cstring>
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) { std::memcpy(dst, src, n); }
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
"""

HARNESS = r"""
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

@HASH_BLOCKS@
}  // namespace
@MERKLE@
}  // namespace

namespace {

// A barrier of n threads that gives up after g_wait_ms: a walk whose
// threads meet unequal numbers of barriers sets g_hung and runs on
// without them, and the entry point returns -1.
std::atomic<bool> g_hung{false};
std::atomic<int> g_wait_ms{30000};

class HostBarrier {
 public:
  explicit HostBarrier(int n) : n_(n) {}
  void arrive_and_wait() {
    std::unique_lock<std::mutex> lk(m_);
    if (g_hung) return;
    const long gen = gen_;
    if (++count_ == n_) {
      count_ = 0;
      ++gen_;
      cv_.notify_all();
      return;
    }
    if (!cv_.wait_for(lk, std::chrono::milliseconds(g_wait_ms.load()), [&] { return gen_ != gen; })) {
      g_hung = true;
    }
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  const int n_;
  int count_ = 0;
  long gen_ = 0;
};

struct HostWarp {
  HostBarrier bar{32};
  int slot[32] = {};
};

thread_local HostBarrier* t_block = nullptr;
thread_local HostBarrier* t_grid = nullptr;
thread_local HostWarp* t_warp = nullptr;

// blocks x threads host threads, all at once; body(block) runs on each.
// Returns 0, or -1 if a barrier gave up.
template <typename Body>
int run_grid(int blocks, int threads, Body body) {
  g_hung = false;
  HostBarrier grid(blocks * threads);
  std::vector<std::unique_ptr<HostBarrier>> block_bars;
  std::vector<std::unique_ptr<HostWarp>> warps;
  for (int b = 0; b < blocks; ++b) block_bars.push_back(std::make_unique<HostBarrier>(threads));
  for (int w = 0; w < blocks * threads / 32; ++w) warps.push_back(std::make_unique<HostWarp>());
  std::vector<std::thread> pool;
  for (int b = 0; b < blocks; ++b) {
    for (int x = 0; x < threads; ++x) {
      pool.emplace_back([&, b, x] {
        threadIdx.x = x;
        blockIdx.x = b;
        blockDim.x = threads;
        gridDim.x = blocks;
        t_block = block_bars[b].get();
        t_grid = &grid;
        t_warp = warps[(b * threads + x) / 32].get();
        body(b);
      });
    }
  }
  for (auto& t : pool) t.join();
  return g_hung ? -1 : 0;
}

struct HostGridSync {
  void operator()() const { t_grid->arrive_and_wait(); }
};

// nodes[o] = inner_hash(nodes[ls], nodes[rs]) in one thread, from K3's
// preimage and the one-thread compression
void inner_node(uint32_t* nodes, int o, int ls, int rs) {
  uint32_t l[5], r[5], x[16], h[5];
  for (int i = 0; i < 5; ++i) {
    l[i] = nodes[5 * ls + i];
    r[i] = nodes[5 * rs + i];
  }
  inner_preimage(x, l, r);
  ripemd160_init(h);
  ripemd160_compress(h, x);
  for (int i = 0; i < 5; ++i) nodes[5 * o + i] = h[i];
}

}  // namespace

thread_local HostDim threadIdx = {0}, blockIdx = {0}, blockDim = {1}, gridDim = {1};

void __syncthreads() { t_block->arrive_and_wait(); }

int __reduce_max_sync(unsigned, int value) {
  t_warp->slot[threadIdx.x % 32] = value;
  t_warp->bar.arrive_and_wait();
  int m = t_warp->slot[0];
  for (int i = 1; i < 32; ++i) m = t_warp->slot[i] > m ? t_warp->slot[i] : m;
  t_warp->bar.arrive_and_wait();
  return m;
}

extern "C" {

void host_set_wait_ms(int ms) { g_wait_ms = ms; }

void host_hash_messages(int algo, const uint32_t* words, const int32_t* first,
                        const int32_t* nblocks, uint32_t* out, int n) {
  const uint4* blocks = reinterpret_cast<const uint4*>(words);
  for (int i = 0; i < n; ++i) {
    if (algo == 0) {
      ripemd160_message(blocks + 4 * first[i], nblocks[i], out + 5 * i);
    } else {
      sha256_message(blocks + 4 * first[i], nblocks[i], out + 8 * i);
    }
  }
}

// h <- compress(h, x) both ways: through the one-thread compression into
// whole, and through rmd_line<0>, rmd_line<1> and rmd_join into parts
void host_rmd_parts(const uint32_t* h, const uint32_t* x, uint32_t* whole, uint32_t* parts) {
  uint32_t a[5], b[5], l[5], r[5], w[16];
  for (int i = 0; i < 5; ++i) a[i] = b[i] = h[i];
  for (int i = 0; i < 16; ++i) w[i] = x[i];
  ripemd160_compress(a, w);
  rmd_line<0>(b, w, l);
  rmd_line<1>(b, w, r);
  rmd_join(b, l, r);
  for (int i = 0; i < 5; ++i) {
    whole[i] = a[i];
    parts[i] = b[i];
  }
}

// K1 as the card runs it: blocks of two warps over 32 messages each, one
// block at a time (blocks share nothing). Returns 0, or -1 if a block hung.
int host_pair_messages(const uint32_t* words, const int32_t* first, const int32_t* nblocks,
                       uint32_t* out, int n) {
  const uint4* w = reinterpret_cast<const uint4*>(words);
  for (int m0 = 0; m0 < n; m0 += kPairLanes) {
    auto sh = std::make_unique<PairShared>();
    const int rc = run_grid(1, 2 * kPairLanes, [&](int) {
      const int lane = threadIdx.x % kPairLanes;
      if (threadIdx.x < kPairLanes) {
        ripemd160_pair<0>(*sh, w, first, nblocks, out, n, m0, lane);
      } else {
        ripemd160_pair<1>(*sh, w, first, nblocks, out, n, m0, lane);
      }
    });
    if (rc != 0) return rc;
  }
  return 0;
}

// K2 as the card runs it: blocks of two warps over 32 messages each, warp
// 0 the rounds and warp 1 the schedule, one block at a time. Returns 0,
// or -1 if a block hung.
int host_sha_pair_messages(const uint32_t* words, const int32_t* first, const int32_t* nblocks,
                           uint32_t* out, int n) {
  const uint4* w = reinterpret_cast<const uint4*>(words);
  for (int m0 = 0; m0 < n; m0 += kPairLanes) {
    auto sh = std::make_unique<ShaShared>();
    const int rc = run_grid(1, 2 * kPairLanes, [&](int) {
      const int lane = threadIdx.x % kPairLanes;
      if (threadIdx.x < kPairLanes) {
        sha256_pair<0>(*sh, w, first, nblocks, out, n, m0, lane);
      } else {
        sha256_pair<1>(*sh, w, first, nblocks, out, n, m0, lane);
      }
    });
    if (rc != 0) return rc;
  }
  return 0;
}

// a K2 block whose schedule warp sees no message (n = 0) while its
// compression warp sees the first 32: the warps walk to different block
// counts, the deadlock the barriers must report, not hang on
int host_sha_unequal_barriers(const uint32_t* words, const int32_t* first, const int32_t* nblocks,
                              uint32_t* out, int n) {
  const uint4* w = reinterpret_cast<const uint4*>(words);
  auto sh = std::make_unique<ShaShared>();
  return run_grid(1, 2 * kPairLanes, [&](int) {
    const int lane = threadIdx.x % kPairLanes;
    if (threadIdx.x < kPairLanes) {
      sha256_pair<0>(*sh, w, first, nblocks, out, n, 0, lane);
    } else {
      sha256_pair<1>(*sh, w, first, nblocks, out, 0, 0, lane);
    }
  });
}

// the one-thread K3 round walk, a round's nodes in turn
void host_tree(uint32_t* nodes, const int32_t* left, const int32_t* right, const int32_t* out,
               const int32_t* widths, int rounds, int stride) {
  for (int rd = 0; rd < rounds; ++rd) {
    for (int k = 0; k < widths[rd]; ++k) {
      inner_node(nodes, out[rd * stride + k], left[rd * stride + k], right[rd * stride + k]);
    }
  }
}

// K3 as the card runs it: merkle_walk on blocks x threads, every block at
// once. Returns 0, or -1 if a barrier hung.
int host_merkle_walk(uint32_t* nodes, const int32_t* left, const int32_t* right, const int32_t* out,
                     const int32_t* widths, int rounds, int stride, int threads, int blocks) {
  std::unique_ptr<TreeShared[]> sh(new TreeShared[blocks]);
  return run_grid(blocks, threads, [&](int b) {
    merkle_walk(sh[b], nodes, left, right, out, widths, rounds, stride, HostGridSync{});
  });
}

// a block of two warps in which only warp 0 reaches a __syncthreads: the
// deadlock the barriers must report, not hang on
int host_unequal_barriers() {
  return run_grid(1, 64, [](int) {
    if (threadIdx.x < 32) __syncthreads();
  });
}

}
"""


def _cut(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        src = f.read()
    assert CUT in src, f"{name} has no '{CUT}' to cut at"
    return src[: src.index(CUT)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The harness built with g++ into a temp dir and loaded with ctypes;
    skips where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' device code as host C++")
    d = tmp_path_factory.mktemp("hash_kernels")
    (d / "cuda_runtime.h").write_text(STUB_CUDA_RUNTIME)
    (d / "cooperative_groups.h").write_text("#pragma once\n")
    (d / "cuda_pipeline.h").write_text(STUB_CUDA_PIPELINE)
    (d / "harness.cpp").write_text(HARNESS.replace("@HASH_BLOCKS@", _cut("hash_blocks.cu"))
                                   .replace("@MERKLE@", _cut("merkle_tree.cu")))
    so = d / "libharness.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fsanitize=undefined", "-fno-sanitize-recover=all",
         "-shared", "-fPIC", "-pthread", "-I", str(d), "-I", CSRC, "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    u32 = ctypes.POINTER(ctypes.c_uint32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.host_set_wait_ms.argtypes = [ctypes.c_int]
    lib.host_set_wait_ms.restype = None
    lib.host_hash_messages.argtypes = [ctypes.c_int, u32, i32, i32, u32, ctypes.c_int]
    lib.host_hash_messages.restype = None
    lib.host_rmd_parts.argtypes = [u32] * 4
    lib.host_rmd_parts.restype = None
    lib.host_pair_messages.argtypes = [u32, i32, i32, u32, ctypes.c_int]
    lib.host_pair_messages.restype = ctypes.c_int
    for fn in (lib.host_sha_pair_messages, lib.host_sha_unequal_barriers):
        fn.argtypes = [u32, i32, i32, u32, ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.host_tree.argtypes = [u32, i32, i32, i32, i32, ctypes.c_int, ctypes.c_int]
    lib.host_tree.restype = None
    lib.host_merkle_walk.argtypes = [u32, i32, i32, i32, i32] + [ctypes.c_int] * 4
    lib.host_merkle_walk.restype = ctypes.c_int
    lib.host_unequal_barriers.argtypes = []
    lib.host_unequal_barriers.restype = ctypes.c_int
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _host_digests(lib, msgs: list[bytes], algo: int) -> list[bytes]:
    words, first, nblocks = th.pack_ragged(msgs, little_endian=algo == 0)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    width = 5 if algo == 0 else 8
    out = np.zeros((len(msgs), width), dtype=np.uint32)
    lib.host_hash_messages(algo, _ptr(words, ctypes.c_uint32), _ptr(first, ctypes.c_int32),
                           _ptr(nblocks, ctypes.c_int32), _ptr(out, ctypes.c_uint32), len(msgs))
    return th.digests_to_bytes_le(out) if algo == 0 else th.digests_to_bytes_be(out)


def _messages(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    lengths = list(EDGE_LENGTHS) + [int(x) for x in rng.integers(0, 700, size=12)]
    return [rng.bytes(n) for n in lengths] + [b"\x00" * 64, b"\xff" * 120, b"abc"]


@pytest.mark.parametrize("seed", [0, 1])
def test_ripemd160_message_matches_both_packages(lib, seed):
    msgs = _messages(seed)
    got = _host_digests(lib, msgs, 0)
    assert got == [ripemd160(m) for m in msgs]
    assert got == [jax_ripemd160(m) for m in msgs]


@pytest.mark.parametrize("seed", [0, 1])
def test_sha256_message_matches_hashlib(lib, seed):
    msgs = _messages(seed)
    assert _host_digests(lib, msgs, 1) == [hashlib.sha256(m).digest() for m in msgs]


def test_rmd_line_and_join_match_compress(lib):
    """rmd_line<0>, rmd_line<1> and rmd_join give ripemd160_compress's
    state on random states and blocks, and on all-zero and all-one ones."""
    rng = np.random.default_rng(3)
    cases = [(rng.integers(0, 2**32, 5, dtype=np.uint32), rng.integers(0, 2**32, 16, dtype=np.uint32))
             for _ in range(64)]
    cases += [(np.full(5, v, np.uint32), np.full(16, u, np.uint32))
              for v in (0, 0xFFFFFFFF) for u in (0, 0xFFFFFFFF)]
    for h, x in cases:
        whole, parts = np.zeros(5, np.uint32), np.zeros(5, np.uint32)
        lib.host_rmd_parts(_ptr(h, ctypes.c_uint32), _ptr(x, ctypes.c_uint32),
                           _ptr(whole, ctypes.c_uint32), _ptr(parts, ctypes.c_uint32))
        assert np.array_equal(whole, parts)
    # and the compression itself: one block of "abc" from the initial state
    whole, parts = np.zeros(5, np.uint32), np.zeros(5, np.uint32)
    words, _, _ = th.pack_ragged([b"abc"], little_endian=True)
    block = np.ascontiguousarray(words[0], dtype=np.uint32)
    init = np.array(th.INIT_RIPEMD, dtype=np.uint32)
    lib.host_rmd_parts(_ptr(init, ctypes.c_uint32), _ptr(block, ctypes.c_uint32),
                       _ptr(whole, ctypes.c_uint32), _ptr(parts, ctypes.c_uint32))
    assert whole.astype("<u4").tobytes() == parts.astype("<u4").tobytes() == hashlib.new("ripemd160", b"abc").digest()


def _pair_digests(lib, msgs: list[bytes]) -> list[bytes]:
    words, first, nblocks = th.pack_ragged(msgs, little_endian=True)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    out = np.zeros((len(msgs), 5), dtype=np.uint32)
    rc = lib.host_pair_messages(_ptr(words, ctypes.c_uint32), _ptr(first, ctypes.c_int32),
                                _ptr(nblocks, ctypes.c_int32), _ptr(out, ctypes.c_uint32), len(msgs))
    assert rc == 0, "a K1 block hung: its warps met unequal numbers of barriers"
    return th.digests_to_bytes_le(out)


def _hold_rmd(got: list[bytes], msgs: list[bytes]) -> None:
    assert got == [hashlib.new("ripemd160", m).digest() for m in msgs]
    assert got == [ripemd160(m) for m in msgs]
    assert got == [jax_ripemd160(m) for m in msgs]


@pytest.mark.parametrize("count", [1, 31, 33, 65])
def test_pair_walk_matches_both_packages(lib, count):
    """K1's pair walk at message counts around a block's 32: a partial
    block, one block and a partial second, two and a partial third."""
    rng = np.random.default_rng(count)
    lengths = (list(EDGE_LENGTHS) + [int(x) for x in rng.integers(0, 1200, size=count)])[:count]
    msgs = [rng.bytes(n) for n in lengths]
    _hold_rmd(_pair_digests(lib, msgs), msgs)


def test_pair_walk_ragged_pair_of_1_to_1025_blocks(lib):
    """One pair of warps over 32 messages of 1 to 1,025 blocks (a 64 KB
    part), in a buffer where they start at scattered blocks: lanes whose
    messages end early keep their state while both warps walk on."""
    blocks = [1, 2, 3, 4, 5, 7, 9, 12, 16, 17, 25, 32, 33, 48, 64, 65, 100, 127, 128, 129,
              200, 255, 256, 257, 400, 511, 512, 513, 700, 1000, 1024, 1025]
    assert len(blocks) == PAIR_LANES
    rng = np.random.default_rng(5)
    order = rng.permutation(PAIR_LANES)
    # 64 (k - 1) bytes pad to k blocks; one lane the empty message
    msgs = [rng.bytes(64 * (blocks[i] - 1)) for i in order]
    got = _pair_digests(lib, msgs)
    assert [th.pack_ragged([m], True)[2][0] for m in msgs] == [blocks[i] for i in order]
    _hold_rmd(got, msgs)
    # and behind other messages: the 32 start mid-buffer, in a second block
    tail = [rng.bytes(int(n)) for n in rng.integers(0, 300, size=7)]
    _hold_rmd(_pair_digests(lib, tail + msgs), tail + msgs)


def test_unequal_barriers_are_reported_not_hung(lib):
    """The harness's own check: a block whose warps meet unequal numbers
    of barriers returns -1 within the barrier's wait."""
    lib.host_set_wait_ms(300)
    try:
        assert lib.host_unequal_barriers() == -1
    finally:
        lib.host_set_wait_ms(30000)


def _sha_pair_digests(lib, msgs: list[bytes]) -> list[bytes]:
    words, first, nblocks = th.pack_ragged(msgs, little_endian=False)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    out = np.zeros((len(msgs), 8), dtype=np.uint32)
    rc = lib.host_sha_pair_messages(_ptr(words, ctypes.c_uint32), _ptr(first, ctypes.c_int32),
                                    _ptr(nblocks, ctypes.c_int32), _ptr(out, ctypes.c_uint32), len(msgs))
    assert rc == 0, "a K2 block hung: its warps met unequal numbers of barriers"
    return th.digests_to_bytes_be(out)


def _hold_sha(got: list[bytes], msgs: list[bytes]) -> None:
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    assert got == jax_sha256_batch(msgs)


@pytest.mark.parametrize("count", [1, 31, 33, 65])
def test_sha_pair_walk_matches_hashlib_and_jax(lib, count):
    """K2's walk (the rounds on warp 0, the schedule on warp 1) at message
    counts around a block's 32, on the padding edge lengths first."""
    rng = np.random.default_rng(100 + count)
    lengths = (list(EDGE_LENGTHS) + [int(x) for x in rng.integers(0, 1200, size=count)])[:count]
    msgs = [rng.bytes(n) for n in lengths]
    _hold_sha(_sha_pair_digests(lib, msgs), msgs)


@pytest.mark.parametrize("most", [161, 1025])
def test_sha_pair_walk_ragged_pair(lib, most):
    """One K2 block over 32 messages of 1 to `most` blocks (block_cap's
    10,240-byte transaction, a 64 KB part), scattered in the buffer: the
    schedule warp's ring and both buffers of sums turn over many times
    while lanes whose messages have ended keep their state."""
    blocks = sorted({int(round(x)) for x in np.geomspace(1, most, PAIR_LANES)})
    blocks += [b for b in range(2, most) if b not in blocks][: PAIR_LANES - len(blocks)]
    assert len(set(blocks)) == PAIR_LANES and min(blocks) == 1 and max(blocks) == most
    rng = np.random.default_rng(most)
    order = rng.permutation(PAIR_LANES)
    msgs = [rng.bytes(64 * (blocks[i] - 1)) for i in order]
    assert [th.pack_ragged([m], False)[2][0] for m in msgs] == [blocks[i] for i in order]
    _hold_sha(_sha_pair_digests(lib, msgs), msgs)
    # and behind other messages: the 32 start mid-buffer, in a second block
    tail = [rng.bytes(int(n)) for n in rng.integers(0, 300, size=7)]
    _hold_sha(_sha_pair_digests(lib, tail + msgs), tail + msgs)


def test_sha_unequal_barriers_are_reported_not_hung(lib):
    """A K2 block whose schedule warp walks no block while its compression
    warp walks its messages' returns -1 within the barrier's wait."""
    msgs = [b"x" * 100] * PAIR_LANES
    words, first, nblocks = th.pack_ragged(msgs, little_endian=False)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    out = np.zeros((len(msgs), 8), dtype=np.uint32)
    lib.host_set_wait_ms(300)
    try:
        assert lib.host_sha_unequal_barriers(_ptr(words, ctypes.c_uint32), _ptr(first, ctypes.c_int32),
                                             _ptr(nblocks, ctypes.c_int32), _ptr(out, ctypes.c_uint32),
                                             len(msgs)) == -1
    finally:
        lib.host_set_wait_ms(30000)


def _schedule(n: int):
    left, right, out, _, _, _, _ = tm._dense_schedule(n)
    widths = np.array([len(level) for level in tm._flat_shape(n)[2]], dtype=np.int32)
    return left, right, out, widths


def _leaf_nodes(digests: list[bytes]) -> np.ndarray:
    n = len(digests)
    nodes = np.zeros((2 * n, 5), dtype=np.uint32)
    nodes[:n] = np.frombuffer(b"".join(digests), dtype="<u4").reshape(n, 5)
    return nodes


def _host_nodes(lib, digests: list[bytes]) -> list[bytes]:
    """K3's one-thread round walk over the device schedule of len(digests)
    leaves."""
    n = len(digests)
    left, right, out, widths = _schedule(n)
    nodes = _leaf_nodes(digests)
    lib.host_tree(_ptr(nodes, ctypes.c_uint32), _ptr(left, ctypes.c_int32), _ptr(right, ctypes.c_int32),
                  _ptr(out, ctypes.c_int32), _ptr(widths, ctypes.c_int32), left.shape[0], left.shape[1])
    return th.digests_to_bytes_le(nodes[: 2 * n - 1])


def test_inner_node_matches_inner_hash(lib):
    """The 44-byte preimage: random digests and crafted ones whose 16-bit
    halves are all zero or all one, in both positions."""
    rng = np.random.default_rng(7)
    pairs = [(rng.bytes(20), rng.bytes(20)) for _ in range(24)]
    crafted = [b"\x00" * 20, b"\xff" * 20, b"\x00\xff" * 10, b"\xff\x00" * 10, bytes(range(20))]
    pairs += [(a, b) for a in crafted for b in crafted]
    for a, b in pairs:
        nodes = _host_nodes(lib, [a, b])
        assert nodes[2] == inner_hash(a, b) == jax_inner_hash(a, b)


@pytest.mark.parametrize("n", [2, 3, 5, 7, 16, 33, 100, 336])
def test_tree_walk_matches_flat_tree(lib, n):
    digests = [leaf_hash(b"leaf-%d" % i) for i in range(n)]
    assert _host_nodes(lib, digests) == FlatTree.from_leaf_digests(digests).nodes


def _walk_nodes(lib, digests: list[bytes], threads: int) -> list[bytes]:
    """K3's walk as tm_merkle_tree launches it with blocks of `threads`:
    one block when the widest round fits one sweep (threads / 2 nodes),
    else a grid of RESIDENT_BLOCKS blocks, at most one a 32-node group."""
    n = len(digests)
    left, right, out, widths = _schedule(n)
    stride = left.shape[1]
    blocks = 1 if stride <= threads // 2 else min(RESIDENT_BLOCKS, -(-stride // PAIR_LANES))
    nodes = _leaf_nodes(digests)
    rc = lib.host_merkle_walk(_ptr(nodes, ctypes.c_uint32), _ptr(left, ctypes.c_int32),
                              _ptr(right, ctypes.c_int32), _ptr(out, ctypes.c_int32),
                              _ptr(widths, ctypes.c_int32), left.shape[0], stride, threads, blocks)
    assert rc == 0, "the K3 walk hung: its threads met unequal numbers of barriers"
    return th.digests_to_bytes_le(nodes[: 2 * n - 1])


def _cut_edges(threads: int) -> tuple[int, int]:
    """The largest leaf count whose widest round is exactly a block's cut
    (threads / 2 nodes: the last tree in one block) and the next, the
    first whose widest round is one more (the first on a grid)."""
    cut = threads // 2
    widest = lambda n: max(len(level) for level in tm._flat_shape(n)[2])  # noqa: E731
    at = max(n for n in range(2, 4 * cut) if widest(n) == cut)
    assert widest(at + 1) == cut + 1
    return at, at + 1


@pytest.mark.parametrize("threads,n", [
    (SMALL_THREADS, 2), (SMALL_THREADS, 3), (SMALL_THREADS, 33), (SMALL_THREADS, 10_000),
    (SMALL_THREADS, "cut"), (SMALL_THREADS, "cut+1"),
    (CARD_THREADS, 2), (CARD_THREADS, 336), (CARD_THREADS, "cut"), (CARD_THREADS, "cut+1"),
    (CARD_THREADS, 10_000),
])
def test_pair_tree_walk_matches_flat_tree(lib, threads, n):
    """K3's walk, both lines of a node on a pair of warps, the wide rounds
    over a grid of blocks and the narrow ones in block 0, against FlatTree
    of both packages, slot for slot."""
    if isinstance(n, str):
        n = _cut_edges(threads)[n == "cut+1"]
    rng = np.random.default_rng(n)
    digests = [rng.bytes(20) for _ in range(n)]
    got = _walk_nodes(lib, digests, threads)
    assert got == FlatTree.from_leaf_digests(digests).nodes
    assert got == JaxFlatTree.from_leaf_digests(digests).nodes
