"""The port's batched hashes (ops/hashing.py) against the JAX package's
(tendermint_tpu/ops/hashing.py) on the same messages: the dense packing
byte for byte, the ragged layout from it, and the plain versions of K1
and K2 (`ripemd160_words`, `sha256_words`) against JAX's
`ripemd160_words` / `sha256_words` digest words exactly, on the families
of tests/test_ops.py `TestHashKernels` and the padding-edge lengths (55/56
and 119/120 bytes change the block count; an empty message is one block).

The `cuda` cases hold K1 and K2 against their plain versions on the card;
they skip here. The JAX package is imported inside the tests that compare
with it, so on a machine with a card and no JAX:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hashing.py -m cuda`.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto.hashing import ripemd160
from tendermint_tpu_torch.ops import hashing as th

EDGE_LENGTHS = (0, 55, 56, 63, 64, 119, 120)

# tests/test_ops.py TestHashKernels' messages, the padding edges, and a
# seeded random mix
FAMILIES = {
    "ops_ripemd": lambda: [b"", b"a", b"abc", b"x" * 200, bytes(range(256)) * 3, b"q" * 64],
    "ops_sha": lambda: [b"", b"abc", b"z" * 1000],
    "edges": lambda: [bytes([i]) * n for i, n in enumerate(EDGE_LENGTHS)],
    "random": lambda: [
        np.random.default_rng(3).bytes(int(n))
        for n in np.random.default_rng(4).integers(0, 300, size=9)
    ],
}


@pytest.fixture(scope="module")
def jh():
    from tendermint_tpu.ops import hashing

    return hashing


@pytest.mark.parametrize("little_endian", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pack_messages_matches_jax_and_ragged(jh, family, little_endian):
    msgs = FAMILIES[family]()
    words, nblocks = th.pack_messages(msgs, little_endian)
    jwords, jnblocks = jh.pack_messages(msgs, little_endian)
    np.testing.assert_array_equal(words, jwords)
    np.testing.assert_array_equal(nblocks, jnblocks)
    for got, want in zip(th.pack_ragged(msgs, little_endian), th.dense_to_ragged(jwords, jnblocks)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ripemd160_words_matches_jax(jh, family):
    import jax.numpy as jnp

    msgs = FAMILIES[family]()
    words, nblocks = jh.pack_messages(msgs, little_endian=True)
    want = np.asarray(jh.ripemd160_words(jnp.asarray(words), jnp.asarray(nblocks)))
    ragged = (torch.from_numpy(a.astype(np.int64)) for a in th.dense_to_ragged(words, nblocks))
    got = th.ripemd160_words(*ragged).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert th.digests_to_bytes_le(got) == [ripemd160(m) for m in msgs]
    assert th.digests_to_bytes_le(got) == jh.digests_to_bytes_le(want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sha256_words_matches_jax(jh, family):
    import jax.numpy as jnp

    msgs = FAMILIES[family]()
    words, nblocks = jh.pack_messages(msgs, little_endian=False)
    want = np.asarray(jh.sha256_words(jnp.asarray(words), jnp.asarray(nblocks)))
    ragged = (torch.from_numpy(a.astype(np.int64)) for a in th.dense_to_ragged(words, nblocks))
    got = th.sha256_words(*ragged).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert th.digests_to_bytes_be(got) == [hashlib.sha256(m).digest() for m in msgs]


def test_batch_entry_points_on_the_cpu(jh):
    from tendermint_tpu.crypto.hashing import ripemd160 as jax_ripemd160

    msgs = FAMILIES["edges"]() + FAMILIES["random"]()
    assert th.ripemd160_batch(msgs, device="cpu") == [jax_ripemd160(m) for m in msgs]
    assert th.ripemd160_batch(msgs, device="cpu") == jh.ripemd160_batch(msgs)
    assert th.sha256_batch(msgs, device="cpu") == jh.sha256_batch(msgs)
    assert th.ripemd160_batch([], device="cpu") == [] and th.sha256_batch([], device="cpu") == []


def test_lanes_write_into_the_rows_given():
    msgs = FAMILIES["ops_ripemd"]()
    words, first, nblocks = th.to_device(*th.pack_ragged(msgs, True), torch.device("cpu"))
    buf = torch.full((2 * len(msgs), 5), -1, dtype=torch.int32)
    got = th.ripemd160_lanes(words, first, nblocks, out=buf[: len(msgs)])
    assert got.data_ptr() == buf.data_ptr()
    assert th.digests_to_bytes_le(buf[: len(msgs)]) == [ripemd160(m) for m in msgs]
    assert (buf[len(msgs):] == -1).all()


def test_wrappers_refuse_bad_shapes():
    words, first, nblocks = th.to_device(*th.pack_ragged([b"abc"], True), torch.device("cpu"))
    with pytest.raises(ValueError, match="words must be"):
        th.ripemd160_lanes(words.reshape(-1), first, nblocks)
    with pytest.raises(ValueError, match="first and nblocks"):
        th.sha256_lanes(words, first, nblocks[:0])


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        th.ripemd160_batch([b"abc"])
    assert th.ripemd160_batch([], device=None) == []


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["ripemd160", "sha256"])
def test_kernel_matches_plain_on_the_card(algo):
    dev = _card()
    rng = np.random.default_rng(11)
    lengths = list(EDGE_LENGTHS) + [10_240, 4096] + [int(x) for x in rng.integers(0, 2000, size=121)]
    msgs = [rng.bytes(n) for n in lengths]
    le = algo == "ripemd160"
    args = th.to_device(*th.pack_ragged(msgs, le), dev)
    before = th.ripemd160_launches if le else th.sha256_launches
    lanes = th.ripemd160_lanes if le else th.sha256_lanes
    plain = th.ripemd160_words if le else th.sha256_words
    got = lanes(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.long() & 0xFFFFFFFF, want)
    to_bytes = th.digests_to_bytes_le if le else th.digests_to_bytes_be
    ref = [ripemd160(m) for m in msgs] if le else [hashlib.sha256(m).digest() for m in msgs]
    assert to_bytes(got) == ref
    assert (th.ripemd160_launches if le else th.sha256_launches) == before + 1
