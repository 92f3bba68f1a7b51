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

`verify_lane` (B1), `verify_lane_b2` (B2) and `comb_verify_lane` (comb)
are each held against their own plain version (`ed25519_f32.verify_plain`, `ed25519_pallas.verify_plain`,
`ed25519_comb.verify_comb_plain`; raw verdicts lane for lane) and against `crypto.ed25519.verify` of both
packages (masked verdicts) on the RFC 8032 vectors and the tampered,
malformed and identical-key families of tests/test_ops_f32.py
`TestVerifyF32`; `dsm_lane` against `dsm_plain` and the pure-Python group
law on the edge lanes (Q = identity, a = 0, b = 0, P == Q, P == -Q) and on
random lanes; one comb step (`ge4_add<true>` on a loaded niels row)
against `ed25519_comb._niels_add`, and the comb table build
(`comb_bases_lane`, `comb_position`) against `build_tables_plain`, byte for
byte. Every comparison is exact equality.
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

@COMB@
}  // namespace

@COMB_TABLES@
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

// The comb kernel's lane on one slot's table and the B table.
extern "C" int host_comb_lane(const uint8_t* a_tab, const uint8_t* b_tab, const uint32_t* ryw,
                              int rsign, const uint32_t* sw, const uint32_t* hw) {
  int32_t out[4];
  Fe zs[1];
  run_group([&](int t) { out[t] = comb_verify_lane<1>(t, a_tab, b_tab, ryw, rsign, sw, hw, zs); });
  return out[0];
}

// One comb step: the extended point acc (X, Y, Z, T; 4 x 10 limbs) plus the
// niels row `row`, each thread loading its coordinate as the kernel does.
extern "C" void host_comb_step(const int32_t* acc, const uint8_t* row, int32_t* out) {
  Fe res[4];
  run_group([&](int t) {
    Fe p;
    for (int i = 0; i < 10; ++i) p.v[i] = acc[10 * t + i];
    uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (t != 2) load_coord_words(row, t == 3 ? 2 : t, w);
    res[t] = ge4_add<true>(t, p, fe_from_words(w));
  });
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 10; ++i) out[10 * t + i] = res[t].v[i];
}

// The table build of one key: pass 1 on four threads, then pass 2 for each
// of the 64 positions, into 1024 rows of 96 bytes.
extern "C" void host_comb_table(const uint32_t* qxw, const uint32_t* qyw, uint8_t* rows) {
  static Fe bases[4 * kCombPositions];
  run_group([&](int t) { comb_bases_lane(t, qxw, qyw, bases, true); });
  for (int p = 0; p < kCombPositions; ++p)
    comb_position(bases + 4 * p, rows + p * kCombEntries * kRowBytes);
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
           .replace("@DSM@", _cut("ed25519_dsm.cu"))
           .replace("@COMB@", _cut("ed25519_comb.cu"))
           .replace("@COMB_TABLES@", _cut("ed25519_comb_tables.cu")))
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
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.host_comb_lane.argtypes = [u8, u8, words, ctypes.c_int, words, words]
    lib.host_comb_lane.restype = ctypes.c_int
    lib.host_comb_step.argtypes = [ctypes.POINTER(ctypes.c_int32), u8, ctypes.POINTER(ctypes.c_int32)]
    lib.host_comb_step.restype = None
    lib.host_comb_table.argtypes = [words, words, u8]
    lib.host_comb_table.restype = None
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


# -- the comb kernels ---------------------------------------------------------


def _fe_limbs(v: int) -> list[int]:
    """A value below p as carried radix-2^25.5 limbs."""
    return [(v >> o) & ((1 << w) - 1) for o, w in zip(OFFSETS, WIDTHS)]


def _f32_int(limbs) -> int:
    """The value of (32,) radix-2^8 limbs, loose or not."""
    return sum(int(x) << (8 * k) for k, x in enumerate(limbs))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_comb_step_matches_niels_add(lib, seed):
    """One comb step on four threads, each loading its coordinate of a
    niels row of the B table: the same X, Y, Z, T mod p as the plain
    version's `_niels_add` on the same point and row."""
    from tendermint_tpu_torch.ops import ed25519_comb as tcomb

    rng = np.random.default_rng(seed)
    tab = tcomb.b_table().astype(np.uint8)
    for p, v in ((0, 0), (int(rng.integers(64)), int(rng.integers(1, 16))), (63, 15)):
        row = np.ascontiguousarray(tab[p, v])
        acc = [int.from_bytes(rng.bytes(32), "little") % P25519 for _ in range(4)]
        acc_limbs = np.array([_fe_limbs(c) for c in acc], dtype=np.int32)
        out = np.zeros((4, 10), dtype=np.int32)
        ptr = ctypes.POINTER(ctypes.c_int32)
        lib.host_comb_step(acc_limbs.ctypes.data_as(ptr),
                           row.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.ctypes.data_as(ptr))
        got = [_limb_value(out[c]) % P25519 for c in range(4)]
        cols = [torch.from_numpy(np.frombuffer(c.to_bytes(32, "little"), dtype=np.uint8)
                                 .astype(np.float32))[:, None] for c in acc]
        rowf = torch.from_numpy(row.astype(np.float32))[:, None]
        want = tcomb._niels_add(tuple(cols), rowf[:32], rowf[32:64], rowf[64:])
        assert got == [_f32_int(w[:, 0].numpy()) % P25519 for w in want]


def _comb_pool(items):
    """The lanes' keys built into a pool by the plain version: (pool rows
    (C*1024, 96) uint8, slot per lane (0 where the host rejected the
    lane), host planes, rsign, valid)."""
    from tendermint_tpu_torch.ops import ed25519_comb as tcomb

    planes, rs, valid = tf32p.host_planes(items, len(items))
    keys = {}
    slots = np.zeros(len(items), dtype=np.int32)
    for i, (pub, _, _) in enumerate(items):
        if valid[i]:
            slots[i] = keys.setdefault(pub, (len(keys) + 1, i))[0]
    firsts = [i for _, i in keys.values()]
    qx = np.stack([np.frombuffer(tcomb._neg_x_bytes(planes[0, :, i].tobytes()), dtype=np.uint8)
                   for i in firsts], axis=1)
    qy = planes[1][:, firsts]
    tables = tcomb.build_tables_plain(torch.from_numpy(qx.astype(np.float32)),
                                      torch.from_numpy(qy.astype(np.float32)))
    pool = np.zeros((len(keys) + 1, tcomb.ROWS_PER_SLOT, tcomb.COORD_ROWS), dtype=np.uint8)
    pool[1:] = tables.numpy().astype(np.uint8)
    return pool.reshape(-1, tcomb.COORD_ROWS), slots, planes, rs, valid


@pytest.mark.parametrize("family", ["identical_keys", "odd", "rfc8032", "tampered"])
def test_comb_lane_matches_plain_and_reference(lib, family):
    """The comb kernel's lane (`comb_verify_lane`) on four threads, its
    tables built by the plain version: raw verdicts equal to
    `verify_comb_plain`'s on the same pool, masked verdicts equal to both
    packages' crypto.ed25519.verify."""
    from tendermint_tpu.crypto import ed25519 as jed
    from tendermint_tpu_torch.ops import ed25519_comb as tcomb

    items = _verify_families()[family]()
    pool, slots, planes, rs, valid = _comb_pool(items)
    btab = np.ascontiguousarray(tcomb.b_table().astype(np.uint8))
    u8 = ctypes.POINTER(ctypes.c_uint8)
    got = []
    for i in range(len(items)):
        slot_rows = np.ascontiguousarray(pool.reshape(-1, tcomb.ROWS_PER_SLOT, 96)[slots[i]])
        keep = [_words(planes[k, :, i]) for k in (2, 3, 4)]  # ry, s8, h8
        ry, s8, h8 = (p for _, p in keep)
        got.append(lib.host_comb_lane(slot_rows.ctypes.data_as(u8), btab.ctypes.data_as(u8),
                                      ry, int(rs[i]), s8, h8))
    got = np.array(got, dtype=np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (pool, btab.reshape(-1, 96), slots,
                                                                 planes[2], rs, planes[3], planes[4])]
    assert np.array_equal(got, tcomb.comb_lanes(*args).numpy())
    verdicts = tf32p.materialize_verdicts(got, valid, len(items))
    assert list(verdicts) == [ted.verify(*it) for it in items]
    assert list(verdicts) == [jed.verify(*it) for it in items]


def test_comb_table_build_matches_plain(lib):
    """Both passes of the table-build kernel for three keys and the
    small-order identity key: every row byte for byte the plain version's."""
    from tendermint_tpu_torch.ops import ed25519_comb as tcomb

    pubs = [ted.public_key(bytes([i + 5]) * 32) for i in range(3)] + [(1).to_bytes(32, "little")]
    cols = []
    for pub in pubs:  # Q = -A, affine
        pt = ted.point_decompress(pub)
        zi = pow(pt[2], P25519 - 2, P25519)
        x, y = pt[0] * zi % P25519, pt[1] * zi % P25519
        cols.append([np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8) for v in ((-x) % P25519, y)])
    qx = np.stack([c[0] for c in cols], axis=1)
    qy = np.stack([c[1] for c in cols], axis=1)
    want = tcomb.build_tables_plain(torch.from_numpy(qx.astype(np.float32)),
                                    torch.from_numpy(qy.astype(np.float32))).numpy().astype(np.uint8)
    for j in range(len(pubs)):
        rows = np.zeros((tcomb.ROWS_PER_SLOT, tcomb.COORD_ROWS), dtype=np.uint8)
        _, xw = _words(qx[:, j])
        _, yw = _words(qy[:, j])
        lib.host_comb_table(xw, yw, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        assert np.array_equal(rows, want[j]), j
