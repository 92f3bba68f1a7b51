"""The four-threads-per-lane point layer of the B1, B2 and dsm kernels
(`csrc/fe25519x4.cuh`, `ed25519_verify.cu`, `ed25519_verify_b2.cu`,
`ed25519_dsm.cu`), compiled as host C++ with g++ and run on the CPU,
exchange for exchange.

The device code is compiled as written: a stub `cuda_runtime.h` defines
the CUDA qualifiers away, each `.cu` is cut before `constexpr int
kThreads` (the kernel and its launch need a card), and `fe_shfl`, the one
exchange, is replaced by a host version. Four `std::thread`s stand in for
a block of one group of four threads: the stub exchange writes the
caller's value to a shared slot, waits on a 4-party barrier, reads the
source's slot and waits again, and `__syncthreads` is the same barrier, so
the kernels' own Z inversion (`block_invert`, one lane a block here) runs
as written. g++ builds with UBSan, so a signed overflow in the limb
arithmetic fails the run.

`verify_lane` (B1) and `verify_lane_b2` (B2) are each held against their
own plain version (`ed25519_f32.verify_plain`, `ed25519_pallas.verify_plain`;
raw verdicts lane for lane) and against `crypto.ed25519.verify` of both
packages (masked verdicts) on the RFC 8032 vectors and the tampered,
malformed and identical-key families of tests/test_ops_f32.py
`TestVerifyF32`; `dsm_lane` against `dsm_plain` and the pure-Python group
law on the edge lanes (Q = identity, a = 0, b = 0, P == Q, P == -Q) and on
random lanes. Every comparison is exact equality.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.ops import ed25519 as ted32
from tendermint_tpu_torch.ops import ed25519_f32p as tf32p
from tendermint_tpu_torch.ops import ed25519_pallas as tb2

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tendermint_tpu_torch", "ops", "csrc")
CUT = "constexpr int kThreads"

STUB_CUDA_RUNTIME = """#pragma once
#define __device__
#define __forceinline__ inline
#define __constant__
"""

HARNESS = r"""
#include <barrier>
#include <cstdint>
#include <thread>

#include "fe25519.cuh"

namespace {

// A block of one group of four host threads: thread index, shared slots,
// barrier.
struct HostThreadIdx {
  int x;
};
thread_local HostThreadIdx threadIdx = {0};
Fe g_slot[4];
std::barrier<>* g_barrier = nullptr;

void __syncthreads() { g_barrier->arrive_and_wait(); }

Fe fe_shfl(const Fe& f, int src) {
  g_slot[threadIdx.x] = f;
  g_barrier->arrive_and_wait();
  const Fe r = g_slot[src];
  g_barrier->arrive_and_wait();
  return r;
}

template <typename Body>
void run_group(Body body) {
  std::barrier<> barrier(4);
  g_barrier = &barrier;
  std::thread threads[4];
  for (int t = 0; t < 4; ++t) threads[t] = std::thread([&body, t] { threadIdx.x = t; body(t); });
  for (auto& th : threads) th.join();
}

}  // namespace

#define TM_HOST_EXCHANGE
#include "fe25519x4.cuh"

@VERIFY@
}  // namespace

@VERIFY_B2@
}  // namespace

@DSM@
}  // namespace

extern "C" int host_verify_lane(const uint32_t* axw, const uint32_t* ayw, const uint32_t* ryw,
                                int rsign, const uint32_t* sw, const uint32_t* hw) {
  int32_t out[4];
  Fe zs[1];
  run_group([&](int t) { out[t] = verify_lane<1>(t, axw, ayw, ryw, rsign, sw, hw, zs); });
  return out[0];
}

extern "C" int host_verify_lane_b2(const uint32_t* axw, const uint32_t* ayw, const uint32_t* ryw,
                                   int rsign, const uint32_t* sw, const uint32_t* hw) {
  int32_t out[4];
  Fe zs[1];
  run_group([&](int t) { out[t] = verify_lane_b2<1>(t, axw, ayw, ryw, rsign, sw, hw, zs); });
  return out[0];
}

// One of fe25519x4.cuh's field helpers on raw limbs: 0 fe_add_l(a, b),
// 1 fe_sub_l(a, b), 2 fe_add_sub_l(a, b, c), 3 fe_add3_sub_l(a, b, c, d),
// 4 fe_add3_l(a, b, c), 5 fe_mul(a, b), 6 fe_sq(a).
extern "C" void host_field_op(int op, const int32_t* a, const int32_t* b, const int32_t* c,
                              const int32_t* d, int32_t* out) {
  Fe fa, fb, fc, fd, r;
  for (int i = 0; i < 10; ++i) {
    fa.v[i] = a[i];
    fb.v[i] = b[i];
    fc.v[i] = c[i];
    fd.v[i] = d[i];
  }
  switch (op) {
    case 0: r = fe_add_l(fa, fb); break;
    case 1: r = fe_sub_l(fa, fb); break;
    case 2: r = fe_add_sub_l(fa, fb, fc); break;
    case 3: r = fe_add3_sub_l(fa, fb, fc, fd); break;
    case 4: r = fe_add3_l(fa, fb, fc); break;
    case 5: r = fe_mul(fa, fb); break;
    default: r = fe_sq(fa); break;
  }
  for (int i = 0; i < 10; ++i) out[i] = r.v[i];
}

extern "C" void host_dsm_lane(const uint32_t* pxw, const uint32_t* pyw, const uint32_t* qxw,
                              const uint32_t* qyw, const uint32_t* aw, const uint32_t* bw,
                              uint32_t* xw, uint32_t* yw) {
  Fe out[4], zs[1];
  run_group([&](int t) { out[t] = dsm_lane<1>(t, pxw, pyw, qxw, qyw, aw, bw, zs); });
  fe_to_words(out[0], xw);
  fe_to_words(out[1], yw);
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
    d = tmp_path_factory.mktemp("fe25519x4")
    (d / "cuda_runtime.h").write_text(STUB_CUDA_RUNTIME)
    src = (HARNESS.replace("@VERIFY@", _cut("ed25519_verify.cu"))
           .replace("@VERIFY_B2@", _cut("ed25519_verify_b2.cu"))
           .replace("@DSM@", _cut("ed25519_dsm.cu")))
    (d / "harness.cpp").write_text(src)
    so = d / "libharness.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fsanitize=undefined", "-fno-sanitize-recover=all",
         "-shared", "-fPIC", "-pthread", "-I", str(d), "-I", CSRC, "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    words = ctypes.POINTER(ctypes.c_uint32)
    lib.host_verify_lane.argtypes = [words] * 3 + [ctypes.c_int] + [words] * 2
    lib.host_verify_lane.restype = ctypes.c_int
    lib.host_verify_lane_b2.argtypes = lib.host_verify_lane.argtypes
    lib.host_verify_lane_b2.restype = ctypes.c_int
    lib.host_dsm_lane.argtypes = [words] * 8
    lib.host_dsm_lane.restype = None
    limbs = ctypes.POINTER(ctypes.c_int32)
    lib.host_field_op.argtypes = [ctypes.c_int] + [limbs] * 5
    lib.host_field_op.restype = None
    return lib


@pytest.mark.parametrize("name", ["ed25519_verify.cu", "ed25519_dsm.cu", "ed25519_verify_b2.cu"])
def test_block_geometry_matches_the_wrappers(name):
    """Each kernel's block is 128 threads, four a lane: the 32 lanes that
    ed25519_f32p.BLOCK_LANES (and so lane_quantum) assumes."""
    import re

    with open(os.path.join(CSRC, name)) as f:
        threads = int(re.search(r"constexpr int kThreads = (\d+);", f.read()).group(1))
    assert threads == 4 * tf32p.BLOCK_LANES


def _words(col: np.ndarray):
    """A (32,) uint8 column as eight little-endian words, for ctypes."""
    w = np.ascontiguousarray(col, dtype=np.uint8).view("<u4").copy()
    return w, w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _host_verdicts(lane, items) -> np.ndarray:
    """Raw per-lane verdicts of a host-compiled lane function (verify_lane
    or verify_lane_b2) on the kernel's own inputs (host_planes), before the
    host's mask."""
    planes, rs, _ = tf32p.host_planes(items, len(items))
    out = []
    for i in range(len(items)):
        keep = [_words(planes[k, :, i]) for k in range(5)]  # ax, ay, ry, s8, h8
        ax, ay, ry, s8, h8 = (p for _, p in keep)
        out.append(lane(ax, ay, ry, int(rs[i]), s8, h8))
    return np.array(out, dtype=np.int32)


def _verify_families():
    from tests.test_torch_verify import FAMILIES

    return FAMILIES


@pytest.mark.parametrize("family", ["identical_keys", "odd", "rfc8032", "tampered"])
def test_verify_lane_matches_plain_and_reference(lib, family):
    from tendermint_tpu.crypto import ed25519 as jed

    items = _verify_families()[family]()
    got = _host_verdicts(lib.host_verify_lane, items)
    args, valid, n = tf32p.marshal_device_args(items, "cpu")
    plain = tf32p.verify_lanes(*args).numpy()
    assert np.array_equal(got, plain)
    verdicts = tf32p.materialize_verdicts(got, valid, n)
    assert list(verdicts) == [ted.verify(*it) for it in items]
    assert list(verdicts) == [jed.verify(*it) for it in items]


@pytest.mark.parametrize("family", ["identical_keys", "odd", "rfc8032", "tampered"])
def test_verify_lane_b2_matches_plain_and_reference(lib, family):
    """B2's single-bit walk (ge4_ladder_bits) on four threads: raw verdicts
    equal to B2's plain version (the JAX kernel's row arithmetic), masked
    verdicts equal to both packages' crypto.ed25519.verify."""
    from tendermint_tpu.crypto import ed25519 as jed

    items = _verify_families()[family]()
    got = _host_verdicts(lib.host_verify_lane_b2, items)
    args, valid, n = tf32p.marshal_device_args(items, "cpu")
    plain = tb2.verify_lanes(*args).numpy()
    assert np.array_equal(got, plain)
    verdicts = tf32p.materialize_verdicts(got, valid, n)
    assert list(verdicts) == [ted.verify(*it) for it in items]
    assert list(verdicts) == [jed.verify(*it) for it in items]


def test_verify_lane_accepts_and_rejects():
    """The families hold both verdicts, so the comparisons above mean
    something: the tampered family's expected pattern."""
    items = _verify_families()["tampered"]()
    assert [ted.verify(*it) for it in items] == [True] + [False] * 8 + [True]


def _dsm_terms(n, seed):
    from tests.test_torch_int32 import _dsm_terms as terms

    return terms(n, seed)


def _host_dsm(lib, terms):
    rows = [r.numpy() for r in ted32.marshal_dsm_args(terms, "cpu")]
    got = []
    for i in range(len(terms)):
        keep = [_words(r[:, i]) for r in rows]  # px, py, qx, qy, a8, b8
        xw, yw = np.zeros(8, dtype=np.uint32), np.zeros(8, dtype=np.uint32)
        lib.host_dsm_lane(*(p for _, p in keep),
                          xw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                          yw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        got.append(tuple(int.from_bytes(w.astype("<u4").tobytes(), "little") for w in (xw, yw)))
    return got, rows


@pytest.mark.parametrize("seed", [3, 17])
def test_dsm_lane_matches_plain_and_group_law(lib, seed):
    """Eight lanes a seed: random points and scalars with the edge lanes
    (kinds 1-7 of _dsm_terms: Q = identity, a = 0, b = 0, P == Q,
    P == -Q, a = b = 0, a = b = L - 1) and the (s, B, 0, identity) lane."""
    from tests.test_torch_int32 import _dsm_reference

    terms = _dsm_terms(8, seed)
    got, rows = _host_dsm(lib, terms)
    px, py = ted32.dsm_plain(*(ted32.limbs_from_bytes(torch.from_numpy(r)) for r in rows))
    plain = [(ted32.limbs_to_int(px.numpy()[:, i]), ted32.limbs_to_int(py.numpy()[:, i]))
             for i in range(len(terms))]
    assert got == plain
    assert got == _dsm_reference(terms)


P25519 = 2**255 - 19
WIDTHS = [26, 25] * 5
OFFSETS = [sum(WIDTHS[:i]) for i in range(10)]


def _limb_value(v) -> int:
    return sum(int(x) << o for x, o in zip(v, OFFSETS))


# The extremes the helpers may see: "carried" (an fe_mul / fe_sq output,
# every limb inside its width but limb 1, which the 2^255 fold may push
# past it; 2^16 over bounds it with room) and "lightly carried" (a
# helper's output, every limb below 2^w + 2^9), at their largest, and zero.
CARRIED_MAX = [(1 << w) - 1 for w in WIDTHS]
CARRIED_MAX[1] = (1 << 25) + (1 << 16) - 1
LIGHT_MAX = [(1 << w) + (1 << 9) - 1 for w in WIDTHS]
ZERO = [0] * 10


def _field_op(lib, op, *args):
    arrs = [np.array(a if a is not None else ZERO, dtype=np.int32) for a in args]
    arrs += [np.zeros(10, dtype=np.int32)] * (4 - len(arrs))
    out = np.zeros(10, dtype=np.int32)
    ptr = ctypes.POINTER(ctypes.c_int32)
    lib.host_field_op(op, *(a.ctypes.data_as(ptr) for a in arrs), out.ctypes.data_as(ptr))
    return [int(x) for x in out]


@pytest.mark.parametrize("seed", [0, 1])
def test_field_helpers_hold_their_bounds_at_the_extremes(lib, seed):
    """The one-pass carries between the stages, and fe_mul / fe_sq on their
    outputs, at the largest limbs their callers can hand them:
    the values are right mod p, the results lie inside the bounds the next
    operation assumes, and (UBSan) nothing overflows."""
    rng = np.random.default_rng(seed)

    def rand(top):
        return [int(rng.integers(0, t + 1)) for t in top]

    light = [LIGHT_MAX, ZERO, rand(LIGHT_MAX)]
    carried = [CARRIED_MAX, ZERO, rand(CARRIED_MAX)]
    light_bound = [(1 << w) + (1 << 9) for w in WIDTHS]
    cases = []
    for x in light:
        for y in light:
            cases.append((0, [x, y], lambda a, b: a + b))
            cases.append((5, [x, y], lambda a, b: a * b))
        cases.append((6, [x], lambda a: a * a))
        for m in carried:
            cases.append((1, [x, m], lambda a, b: a - b))
            cases.append((2, [x, x, m], lambda a, b, c: a + b - c))
            cases.append((3, [x, x, x, m], lambda a, b, c, d: a + b + c - d))
            cases.append((4, [x, x, m], lambda a, b, c: a + b + c))
    for op, args, fn in cases:
        got = _field_op(lib, op, *args)
        assert _limb_value(got) % P25519 == fn(*(_limb_value(a) for a in args)) % P25519
        assert all(v >= 0 for v in got)
        bound = CARRIED_MAX if op >= 5 else [b - 1 for b in light_bound]
        assert all(v <= b for v, b in zip(got, bound)), (op, got)
