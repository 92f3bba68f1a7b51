"""The port's int32 radix-2^15 family against the JAX package's, on the CPU:
the field and point ops of `ops.ed25519` and the row ops of
`ops.ed25519_pallas` (eager JAX on the same numpy inputs), the host
marshal and limb codecs, B2's plain version and the dual scalar multiply.

Every quantity is an integer, a byte or a bool, so every comparison is
exact equality. Inputs are tests/test_ops.py's random field elements and
loose-limb extremes, and the verify families of tests/test_torch_verify.py.
JAX's `_finv_rows` (12 s eagerly) and `dsm_batch` (a 58 s first compile)
are not run: inversion is held against Python's pow, and the dual scalar
multiply against the JAX package's pure-Python group law.

The JAX package is imported inside the tests that compare with it, so on a
machine with a card and no JAX the `cuda` cases run alone:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_int32.py -m cuda`.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from test_torch_verify import FAMILIES
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.ops import ed25519 as ted32
from tendermint_tpu_torch.ops import ed25519_f32p as tf32p
from tendermint_tpu_torch.ops import ed25519_pallas as tb2
from tendermint_tpu_torch.ops.gateway import Verifier

P = ted.P
LANES = 8


def _field_inputs():
    """(a, b) int32 (17, LANES) limb arrays: random canonical values (the
    tests/test_ops.py draw), the loose maxima of the parallel carry
    (2^15 + 57), limbs of a carried value (limb 1 at 2^15), and random
    loose limbs."""
    rnd = random.Random(11)
    a = ted32.int_to_limbs_np([rnd.randrange(P) for _ in range(LANES)])
    b = ted32.int_to_limbs_np([rnd.randrange(P) for _ in range(LANES)])
    loose = np.full((17, LANES), (1 << 15) + 57, dtype=np.int32)
    carried = np.full((17, LANES), (1 << 15) - 1, dtype=np.int32)
    carried[1] = 1 << 15
    rng = np.random.default_rng(3)
    rand = rng.integers(0, (1 << 15) + 58, size=(17, LANES)).astype(np.int32)
    return {"random": (a, b), "loose_max": (loose, rand), "carried_max": (carried, a),
            "random_loose": (rand, carried)}


CASES = sorted(_field_inputs())


def _same(torch_out, jax_out):
    assert np.array_equal(torch_out.numpy(), np.asarray(jax_out))


@pytest.mark.parametrize("op", ["fmul", "fadd", "fsub"])
@pytest.mark.parametrize("case", CASES)
def test_binary_field_op_matches_jax(op, case):
    import jax.numpy as jnp

    from tendermint_tpu.ops import ed25519 as jed32

    a, b = _field_inputs()[case]
    _same(getattr(ted32, op)(torch.from_numpy(a), torch.from_numpy(b)),
          getattr(jed32, op)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("op", ["fsq", "fcanon", "_carry", "_digits2_from_limbs"])
@pytest.mark.parametrize("case", CASES)
def test_unary_field_op_matches_jax(op, case):
    import jax.numpy as jnp

    from tendermint_tpu.ops import ed25519 as jed32

    a, _ = _field_inputs()[case]
    _same(getattr(ted32, op)(torch.from_numpy(a)), getattr(jed32, op)(jnp.asarray(a)))


def _rows(arr):
    import jax.numpy as jnp

    return [jnp.asarray(arr[k]) for k in range(17)]


def _unrows(rows):
    return np.stack([np.asarray(r) for r in rows])


@pytest.mark.parametrize("op", ["_fmul_rows", "_fadd_rows", "_fsub_rows"])
@pytest.mark.parametrize("case", CASES)
def test_binary_row_op_matches_jax(op, case):
    from tendermint_tpu.ops import ed25519_pallas as jb2

    a, b = _field_inputs()[case]
    got = getattr(tb2, op)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(got, _unrows(getattr(jb2, op)(_rows(a), _rows(b))))


@pytest.mark.parametrize("op", ["_fsq_rows", "_carry_rows", "_fcanon_rows"])
@pytest.mark.parametrize("case", CASES)
def test_unary_row_op_matches_jax(op, case):
    from tendermint_tpu.ops import ed25519_pallas as jb2

    a, _ = _field_inputs()[case]
    got = getattr(tb2, op)(torch.from_numpy(a)).numpy()
    assert np.array_equal(got, _unrows(getattr(jb2, op)(_rows(a))))


def test_row_ops_wrap_like_jax():
    """Limbs large enough that `2 * (a[i] * a[j])` and the carry's sums
    overflow int32: the port wraps and shifts exactly as JAX does."""
    from tendermint_tpu.ops import ed25519_pallas as jb2

    x = np.full((17, LANES), 40000, dtype=np.int32)
    x[:, 1] = 1 << 16
    x[0, 2] = (1 << 31) - 1
    for op in ("_fsq_rows", "_carry_rows"):
        got = getattr(tb2, op)(torch.from_numpy(x)).numpy()
        assert np.array_equal(got, _unrows(getattr(jb2, op)(_rows(x)))), op


def _points(seed):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 1 << 15, size=(17, LANES)).astype(np.int32) for _ in range(4))
            for _ in range(2)]


def test_point_ops_match_jax():
    import jax.numpy as jnp

    from tendermint_tpu.ops import ed25519 as jed32
    from tendermint_tpu.ops import ed25519_pallas as jb2

    p1, p2 = _points(9)
    tp1, tp2 = (tuple(map(torch.from_numpy, p)) for p in (p1, p2))
    for t, j in zip(ted32.point_add(tp1, tp2),
                    jed32.point_add(tuple(map(jnp.asarray, p1)), tuple(map(jnp.asarray, p2)))):
        _same(t, j)
    for t, j in zip(ted32.point_double(tp1), jed32.point_double(tuple(map(jnp.asarray, p1)))):
        _same(t, j)
    d2 = np.broadcast_to(jed32._D2[:, None], (17, LANES)).astype(np.int32)
    t_add = tb2._point_add_rows(tp1, tp2, torch.from_numpy(d2))
    j_add = jb2._point_add_rows(tuple(map(_rows, p1)), tuple(map(_rows, p2)), _rows(d2))
    for t, j in zip(t_add, j_add):
        assert np.array_equal(t.numpy(), _unrows(j))
    for t, j in zip(tb2._point_double_rows(tp1), jb2._point_double_rows(tuple(map(_rows, p1)))):
        assert np.array_equal(t.numpy(), _unrows(j))


def test_finv_and_finv_rows_invert():
    rnd = random.Random(5)
    z = [rnd.randrange(1, P) for _ in range(4)] + [1, P - 1]
    limbs = torch.from_numpy(ted32.int_to_limbs_np(z))
    by_family = ted32.fcanon(ted32.finv(limbs)).numpy()
    by_rows = tb2._fcanon_rows(tb2._finv_rows(limbs)).numpy()
    for i, v in enumerate(z):
        assert ted32.limbs_to_int(by_family[:, i]) == pow(v, P - 2, P)
        assert ted32.limbs_to_int(by_rows[:, i]) == pow(v, P - 2, P)


def test_constants_and_codecs_match_jax():
    from tendermint_tpu.ops import ed25519 as jed32

    for name in ("_D2", "_P_LIMBS", "_PX2", "_BX", "_BY", "_BT"):
        assert np.array_equal(getattr(ted32, name), getattr(jed32, name)), name
    assert (ted32.NLIMB, ted32.M15) == (jed32.NLIMB, jed32.M15)
    rnd = random.Random(2)
    vals = [0, 1, P - 1, (1 << 256) - 1] + [rnd.randrange(1 << 256) for _ in range(6)]
    assert np.array_equal(ted32.int_to_limbs_np(vals), jed32.int_to_limbs_np(vals))
    assert np.array_equal(ted32.scalar_bits_np(vals), jed32.scalar_bits_np(vals))
    limbs = jed32.int_to_limbs_np(vals)
    assert [ted32.limbs_to_int(limbs[:, i]) for i in range(len(vals))] == [
        jed32.limbs_to_int(limbs[:, i]) for i in range(len(vals))]


def test_byte_row_helpers_equal_the_numpy_codecs():
    """The helpers that feed B2's and dsm's plain versions from the
    kernels' byte rows give int_to_limbs_np's limbs and scalar_bits_np's
    bits, and bytes_from_limbs inverts them (loose limbs included)."""
    rnd = random.Random(4)
    vals = [0, 1, P - 1, (1 << 255) - 1, (1 << 256) - 1] + [rnd.randrange(1 << 256) for _ in range(5)]
    rows = torch.from_numpy(np.ascontiguousarray(ted32._le_rows(vals).T))
    assert np.array_equal(ted32.limbs_from_bytes(rows).numpy(), ted32.int_to_limbs_np(vals))
    assert np.array_equal(ted32.bits_from_bytes(rows).numpy(), ted32.scalar_bits_np(vals))
    below = [v % P for v in vals]
    back = ted32.bytes_from_limbs(torch.from_numpy(ted32.int_to_limbs_np(below))).numpy()
    assert np.array_equal(back, ted32._le_rows(below).T)
    loose = np.full((17, 1), (1 << 15) + 57, dtype=np.int32)
    loose[16] = 0  # a value below 2^255 written with loose limbs
    want = ted32.limbs_to_int(loose[:, 0])
    got = ted32.bytes_from_limbs(torch.from_numpy(loose)).numpy()[:, 0]
    assert int.from_bytes(got.tobytes(), "little") == want


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prepare_batch_identical_to_jax(family):
    from tendermint_tpu.ops import ed25519 as jed32

    items = FAMILIES[family]()
    for bucket in (len(items), 16):
        for name in ("prepare_batch", "prepare_batch_limbs"):
            ted32._pubkey_cache.clear()
            got = getattr(ted32, name)(items, bucket)
            want = getattr(jed32, name)(items, bucket)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b), name


def _all_families():
    return [it for name in sorted(FAMILIES) for it in FAMILIES[name]()]


def test_b2_plain_version_matches_reference_and_jax_marshal():
    """One batch of every family through B2's plain version: verdicts
    equal crypto.ed25519.verify (the JAX package's), and the byte rows it
    reads unpack to exactly JAX's prepare_batch limbs and bits."""
    from tendermint_tpu.crypto import ed25519 as jed
    from tendermint_tpu.ops import ed25519 as jed32

    items = _all_families()
    args, valid, n = tf32p.marshal_device_args(items, "cpu")
    jax_arrays = jed32.prepare_batch(items, n)
    for row, want in zip((args[0], args[1], args[2]), jax_arrays[:3]):
        assert np.array_equal(ted32.limbs_from_bytes(row).numpy(), want)
    assert np.array_equal(ted32.bits_from_bytes(args[4]).numpy(), jax_arrays[4])
    assert np.array_equal(ted32.bits_from_bytes(args[5]).numpy(), jax_arrays[5])
    before = tb2.launches
    got = tf32p.materialize_verdicts(tb2.verify_lanes(*args), valid, n)
    assert tb2.launches == before  # the plain version is not a launch
    assert list(got) == [jed.verify(*it) for it in items]
    assert got.any() and not got.all()


def test_verifier_under_pallas_kernel(monkeypatch):
    from tendermint_tpu.crypto import ed25519 as jed

    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", "pallas")
    v = Verifier(min_tpu_batch=1, device="cpu")
    items = FAMILIES["tampered"]()
    b1_before, b2_before = tf32p.launches, tb2.launches
    assert v.verify_batch(items) == [jed.verify(*it) for it in items]
    assert v.stats()["tpu_batches"] == 1 and v.stats()["tpu_sigs"] == 8
    assert v.stats()["cpu_sigs"] == 2  # short pub, long sig
    assert (tf32p.launches, tb2.launches) == (b1_before, b2_before)
    assert list(tb2.verify_batch([], device="cpu")) == []


def _affine(pt):
    zinv = pow(pt[2], P - 2, P)
    return (pt[0] * zinv % P, pt[1] * zinv % P)


def _dsm_terms(n, seed):
    """n lanes of random points and scalars < L, with the edge lanes the
    aggregate path produces or could: Q = identity, a = 0, b = 0, both
    zero, P == Q, P == -Q, scalars L - 1, and (s, B, 0, identity)."""
    rnd = random.Random(seed)

    def point():
        return _affine(ted.scalar_mult(rnd.randrange(1, ted.L), ted.B))

    terms = []
    for i in range(n):
        p, q = point(), point()
        a, b = rnd.randrange(ted.L), rnd.randrange(ted.L)
        kind = i % 8
        if kind == 1:
            q = (0, 1)
        elif kind == 2:
            a = 0
        elif kind == 3:
            b = 0
        elif kind == 4:
            q = p
        elif kind == 5:
            q = ((-p[0]) % P, p[1])
        elif kind == 6:
            a = b = 0
        elif kind == 7:
            a = b = ted.L - 1
        terms.append((a, p, b, q))
    terms.append((rnd.randrange(ted.L), _affine(ted.B), 0, (0, 1)))
    return terms


def _dsm_reference(terms):
    from tendermint_tpu.crypto import ed25519 as jed

    def ext(pt):
        return (pt[0], pt[1], 1, pt[0] * pt[1] % P)

    return [_affine(jed.point_add(jed.scalar_mult(a, ext(p)), jed.scalar_mult(b, ext(q))))
            for a, p, b, q in terms]


def test_dsm_batch_matches_pure_python_group_law():
    terms = _dsm_terms(8, seed=21)
    before = ted32.launches
    assert ted32.dsm_batch(terms, device="cpu") == _dsm_reference(terms)
    assert ted32.launches == before
    assert ted32.dsm_batch([], device="cpu") == []


def test_dsm_plain_limbs_carry_the_values():
    """dsm_plain on limbs (the JAX layout) gives the values dsm_batch
    returns, read back through limbs_to_int."""
    terms = _dsm_terms(3, seed=8)
    cols = [[t[1][0] for t in terms], [t[1][1] for t in terms], [t[3][0] for t in terms],
            [t[3][1] for t in terms], [t[0] for t in terms], [t[2] for t in terms]]
    x, y = ted32.dsm_plain(*(torch.from_numpy(ted32.int_to_limbs_np(c)) for c in cols))
    got = [(ted32.limbs_to_int(x.numpy()[:, i]), ted32.limbs_to_int(y.numpy()[:, i]))
           for i in range(len(terms))]
    assert got == _dsm_reference(terms)


def test_dsm_wrapper_checks_arguments():
    rows = ted32.marshal_dsm_args(_dsm_terms(1, seed=1), "cpu")
    with pytest.raises(ValueError, match="uint8"):
        ted32.dsm_lanes(rows[0].int(), *rows[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ted32.dsm_lanes(*rows[:5], torch.zeros((2, 32), dtype=torch.uint8).t())


@pytest.mark.cuda
def test_b2_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    items = _all_families() * 5  # several blocks and a ragged last block
    args, valid, n = tf32p.marshal_device_args(items, "cuda")
    before = tb2.launches
    got = tb2.verify_lanes(*args)
    torch.cuda.synchronize()
    assert tb2.launches == before + 1
    assert torch.equal(got, tb2.verify_plain(*args).to(torch.int32))
    verdicts = tf32p.materialize_verdicts(got.cpu(), valid, n)
    assert list(verdicts) == [ted.verify(*it) for it in items]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 9, 33, 100, 1025])
def test_b2_kernel_matches_plain_on_ragged_lane_counts(n):
    """B2 runs four threads a lane, 32 lanes a block: a partial last warp
    and a partial last block give verdicts equal to verify_plain's and
    B1's on every lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    base = _all_families()
    items = (base * (n // len(base) + 1))[:n]
    args, valid, _ = tf32p.marshal_device_args(items, "cuda")
    got = tb2.verify_lanes(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, tb2.verify_plain(*args).to(torch.int32))
    assert torch.equal(got, tf32p.verify_lanes(*args))
    assert list(tf32p.materialize_verdicts(got.cpu(), valid, n)) == [ted.verify(*it) for it in items]


@pytest.mark.cuda
def test_dsm_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    terms = _dsm_terms(300, seed=5)
    rows = ted32.marshal_dsm_args(terms, "cuda")
    before = ted32.launches
    x8, y8 = ted32.dsm_lanes(*rows)
    torch.cuda.synchronize()
    assert ted32.launches == before + 1
    px, py = ted32.dsm_plain(*(ted32.limbs_from_bytes(r) for r in rows))
    assert torch.equal(x8, ted32.bytes_from_limbs(px))
    assert torch.equal(y8, ted32.bytes_from_limbs(py))
    ext = [(x, y, 1, x * y % P) for x, y in ((t[1][0], t[1][1]) for t in terms[:16])]
    want = [_affine(ted.scalar_mult(t[0], e)) for t, e in zip(terms[:16], ext)]
    got = ted32.dsm_batch([(t[0], t[1], 0, (0, 1)) for t in terms[:16]])
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 9, 33, 100, 1025])
def test_dsm_kernel_matches_plain_on_ragged_lane_counts(n):
    """A partial last warp (8 lanes) and a partial last 32-lane block:
    bytes equal dsm_plain's on every lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    base = _dsm_terms(63, seed=n)  # 64 terms, the edge lanes among them
    terms = (base * (n // len(base) + 1))[:n]
    rows = ted32.marshal_dsm_args(terms, "cuda")
    x8, y8 = ted32.dsm_lanes(*rows)
    torch.cuda.synchronize()
    px, py = ted32.dsm_plain(*(ted32.limbs_from_bytes(r) for r in rows))
    assert torch.equal(x8, ted32.bytes_from_limbs(px))
    assert torch.equal(y8, ted32.bytes_from_limbs(py))
