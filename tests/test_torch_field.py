"""The port's fp32 radix-2^8 field and point ops
(tendermint_tpu_torch.ops.ed25519_f32) against the JAX package's
(tendermint_tpu.ops.ed25519_f32), run eagerly on the same numpy inputs.

Every value is an integer below 2^24 in fp32, so the two must agree bit
for bit: the tolerance is exact equality. Inputs are the loose-bound
extremes (limb 0 <= 749 or 825, others <= 268) and random loose limbs of
tests/test_ops_f32.py::TestFieldArithmetic.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import ed25519_f32 as jf32
from tendermint_tpu_torch.ops import ed25519_f32 as tf32

P = jf32.P
LANES = 8


def _loose_pairs():
    """(a, b) limb arrays (32, LANES) float32: extremes, then random."""
    rng = np.random.default_rng(11)
    a = np.full((32, LANES), 268.0)
    a[0, :] = 749.0
    b = np.full((32, LANES), 268.0)
    b[0, :] = 825.0
    rand_a = rng.integers(0, 750, size=(32, LANES)).astype(np.float64)
    rand_b = rng.integers(0, 826, size=(32, LANES)).astype(np.float64)
    rand_c = rng.integers(0, 269, size=(32, LANES)).astype(np.float64)
    return [
        (a.astype(np.float32), b.astype(np.float32)),
        (rand_a.astype(np.float32), rand_b.astype(np.float32)),
        (rand_c.astype(np.float32), rand_a.astype(np.float32)),
    ]


def _same(torch_out, jax_out):
    assert np.array_equal(torch_out.numpy(), np.asarray(jax_out))


BINARY = ["fmul", "fadd", "fsub"]
UNARY = ["fsq", "fcanon", "_carry1", "_carry3", "_seq_carry"]


@pytest.mark.parametrize("op", BINARY)
@pytest.mark.parametrize("case", range(3))
def test_binary_field_op_matches_jax(op, case):
    a, b = _loose_pairs()[case]
    _same(
        getattr(tf32, op)(torch.from_numpy(a), torch.from_numpy(b)),
        getattr(jf32, op)(jnp.asarray(a), jnp.asarray(b)),
    )


@pytest.mark.parametrize("op", UNARY)
@pytest.mark.parametrize("case", range(3))
def test_unary_field_op_matches_jax(op, case):
    a, _ = _loose_pairs()[case]
    _same(getattr(tf32, op)(torch.from_numpy(a)), getattr(jf32, op)(jnp.asarray(a)))


def test_fcanon_exact_values_and_extremes():
    """p, 2p, p-1, p+1, 2p-1 and the loose maxima reduce to canonical
    digits equal to JAX's and to the Python-int value mod p."""
    cols = []
    for v in (0, P, 2 * P, P - 1, P + 1, 2 * P - 1):
        cols.append(np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8).astype(np.float32))
    cols.append(np.full(32, 825.0, dtype=np.float32))
    x = np.stack(cols, axis=1)
    out = tf32.fcanon(torch.from_numpy(x))
    _same(out, jf32.fcanon(jnp.asarray(x)))
    got = out.numpy()
    for lane in range(x.shape[1]):
        want = sum(int(x[k, lane]) << (8 * k) for k in range(32)) % P
        assert sum(int(got[k, lane]) << (8 * k) for k in range(32)) == want


def test_finv_matches_jax_and_inverts():
    rng = np.random.default_rng(5)
    z = rng.integers(0, 256, size=(32, 4)).astype(np.float32)
    out = tf32.finv(torch.from_numpy(z))
    _same(out, jf32.finv(jnp.asarray(z)))
    canon = tf32.fcanon(tf32.fmul(out, torch.from_numpy(z))).numpy()
    for lane in range(4):
        assert sum(int(canon[k, lane]) << (8 * k) for k in range(32)) == 1


def _point(rng):
    return tuple(rng.integers(0, 269, size=(32, LANES)).astype(np.float32) for _ in range(4))


def test_point_add_and_double_match_jax():
    rng = np.random.default_rng(9)
    p1, p2 = _point(rng), _point(rng)
    d2 = np.broadcast_to(jf32._D2[:, None], (32, LANES)).astype(np.float32)
    t_add = tf32.point_add(
        tuple(map(torch.from_numpy, p1)), tuple(map(torch.from_numpy, p2)), torch.from_numpy(d2)
    )
    j_add = jf32.point_add(tuple(map(jnp.asarray, p1)), tuple(map(jnp.asarray, p2)), jnp.asarray(d2))
    for t, j in zip(t_add, j_add):
        _same(t, j)
    for t, j in zip(
        tf32.point_double(tuple(map(torch.from_numpy, p1))),
        jf32.point_double(tuple(map(jnp.asarray, p1))),
    ):
        _same(t, j)


def test_digits2_matches_jax():
    rng = np.random.default_rng(2)
    limbs = rng.integers(0, 256, size=(32, LANES)).astype(np.int32)
    limbs[31] &= 0x1F  # scalars < 2^253
    _same(tf32._digits2(torch.from_numpy(limbs)), jf32._digits2(jnp.asarray(limbs)))


def test_constants_match_jax():
    for mine, theirs in [
        ("pad", jf32._PAD), ("d2", jf32._D2), ("p", jf32._P_LIMBS), ("bx", jf32._BX),
        ("by", jf32._BY), ("b2x", jf32._B2X), ("b2y", jf32._B2Y), ("b3x", jf32._B3X),
        ("b3y", jf32._B3Y),
    ]:
        assert np.array_equal(tf32._CONSTS[mine], theirs), mine
