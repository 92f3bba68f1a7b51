"""The hash kernels' device code (`csrc/hash_block.cuh`, `ripemd160.cuh`,
`sha256.cuh`, and `merkle_tree.cu`'s preimage assembly and node hash),
compiled as host C++ with g++ and run on the CPU.

The headers compile as written: a stub `cuda_runtime.h` defines the CUDA
qualifiers away and gives `uint4` and the funnel shifts their documented
meaning (hi:lo shifted, the high or the low word kept), and
`merkle_tree.cu` is cut before `constexpr int kThreads` (the kernel and its
launch need a card). g++ builds with UBSan, so an out-of-range shift fails
the run. The per-message walk (`ripemd160_message`, `sha256_message`, the
next block's loads ahead of the current block's rounds) is held against
hashlib and `crypto.hashing.ripemd160` of both packages on the padding
edge lengths; the inner-node hash against `merkle.simple.inner_hash` on
random and crafted 44-byte preimages; and K3's round walk, over
ops/merkle.py's device schedule with each round's width, against
FlatTree's node buffer, slot for slot. Every comparison is exact.
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
from tendermint_tpu.merkle.simple import inner_hash as jax_inner_hash
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
"""

HARNESS = r"""
#include "ripemd160.cuh"
#include "sha256.cuh"
@MERKLE@
}  // namespace

extern "C" {

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

// the K3 round walk of one block, its threads in turn
void host_tree(uint32_t* nodes, const int32_t* left, const int32_t* right, const int32_t* out,
               const int32_t* widths, int rounds, int stride) {
  for (int rd = 0; rd < rounds; ++rd) {
    for (int k = 0; k < widths[rd]; ++k) {
      inner_node(nodes, out[rd * stride + k], left[rd * stride + k], right[rd * stride + k]);
    }
  }
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
    (d / "harness.cpp").write_text(HARNESS.replace("@MERKLE@", _cut("merkle_tree.cu")))
    so = d / "libharness.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fsanitize=undefined", "-fno-sanitize-recover=all",
         "-shared", "-fPIC", "-I", str(d), "-I", CSRC, "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    u32 = ctypes.POINTER(ctypes.c_uint32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.host_hash_messages.argtypes = [ctypes.c_int, u32, i32, i32, u32, ctypes.c_int]
    lib.host_hash_messages.restype = None
    lib.host_tree.argtypes = [u32, i32, i32, i32, i32, ctypes.c_int, ctypes.c_int]
    lib.host_tree.restype = None
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


def _host_nodes(lib, digests: list[bytes]) -> list[bytes]:
    """K3's round walk over the device schedule of len(digests) leaves."""
    n = len(digests)
    left, right, out, _, _, _, _ = tm._dense_schedule(n)
    widths = np.array([len(level) for level in tm._flat_shape(n)[2]], dtype=np.int32)
    nodes = np.zeros((2 * n, 5), dtype=np.uint32)
    nodes[:n] = np.frombuffer(b"".join(digests), dtype="<u4").reshape(n, 5)
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
