"""The port's verify path against the JAX package's, on the CPU:
the host marshal (prepare_batch8), the plain version of the kernel
(verify_plain, through ops.ed25519_f32p) and the gateway's Verifier with
device="cpu".

Verdicts are booleans and the marshal's arrays integers, so every
comparison is exact equality. Inputs are the RFC 8032 vectors and the
tampered/malformed/identical-key families of tests/test_ops_f32.py.
Calls into the JAX kernel stay at <= 16 lanes (buckets 8 and 16).

The JAX package is imported inside the tests that compare with it, so on
a machine with a card and no JAX the `cuda` case runs alone:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_verify.py -m cuda`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tendermint_tpu_torch import native as t_native
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.ops import ed25519_f32 as tf32
from tendermint_tpu_torch.ops import ed25519_f32p as tf32p
from tendermint_tpu_torch.ops.gateway import Verifier

RFC8032_VECTORS = [
    (
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
    (
        "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
        "af82",
        "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
        "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a",
    ),
]


def _rfc_items():
    return [(bytes.fromhex(pk), bytes.fromhex(m), bytes.fromhex(s)) for pk, m, s in RFC8032_VECTORS]


def _tampered_items():
    """valid, tampered sig, tampered msg, wrong pub, s >= L, R.y >= p,
    short pub, long sig, invalid point, valid again."""
    seeds = [bytes([i + 1]) * 32 for i in range(8)]
    pubs = [ted.public_key(s) for s in seeds]
    msg = b"vote:height=7,round=0"
    sigs = [ted.sign(s, msg) for s in seeds]
    high_s = sigs[4][:32] + (int.from_bytes(sigs[4][32:], "little") + ted.L).to_bytes(32, "little")
    noncanon_r = (ted.P + 1).to_bytes(32, "little") + sigs[5][32:]
    return [
        (pubs[0], msg, sigs[0]),
        (pubs[1], msg, sigs[1][:10] + b"\x00" + sigs[1][11:]),
        (pubs[2], msg + b"!", sigs[2]),
        (pubs[0], msg, sigs[3]),
        (pubs[4], msg, high_s),
        (pubs[5], msg, noncanon_r),
        (pubs[6][:31], msg, sigs[6]),
        (pubs[7], msg, sigs[7] + b"\x00"),
        (b"\x01" * 32, msg, sigs[0]),
        (pubs[3], msg, sigs[3]),
    ]


def _identical_key_items():
    seed = b"\x42" * 32
    pub = ted.public_key(seed)
    items = [(pub, b"height=%d" % i, ted.sign(seed, b"height=%d" % i)) for i in range(16)]
    items[7] = (pub, items[7][1], items[3][2])  # sig for the wrong message
    return items


def _odd_items():
    seeds = [bytes([i + 10]) * 32 for i in range(5)]
    items = [(ted.public_key(s), b"m%d" % i, ted.sign(s, b"m%d" % i)) for i, s in enumerate(seeds)]
    items[2] = (items[2][0], items[2][1], items[2][2][:63] + b"\x00")
    return items


FAMILIES = {
    "rfc8032": _rfc_items,
    "tampered": _tampered_items,
    "identical_keys": _identical_key_items,
    "odd": _odd_items,
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prepare_batch8_identical_to_jax(family):
    from tendermint_tpu.ops import ed25519_f32 as jf32

    items = FAMILIES[family]()
    for bucket in (len(items), 16):
        tf32._pubkey_cache.clear()
        cold = tf32.prepare_batch8(items, bucket)
        warm = tf32.prepare_batch8(items, bucket)
        ref = jf32.prepare_batch8(items, bucket)
        for a, b, c in zip(cold, warm, ref):
            assert a.dtype == c.dtype and np.array_equal(a, c)
            assert np.array_equal(b, c)


def test_prepare_batch8_pure_python_path_identical(monkeypatch):
    """The marshal's pure-Python digests and decompression (no native
    library) give the same arrays as the native path."""
    if not t_native.available():
        pytest.fail("native library did not build (make -C native)")
    items = _tampered_items()
    tf32._pubkey_cache.clear()
    nat = tf32.prepare_batch8(items, 16)
    tf32._pubkey_cache.clear()
    monkeypatch.setattr(t_native, "available", lambda: False)
    pure = tf32.prepare_batch8(items, 16)
    tf32._pubkey_cache.clear()
    for a, b in zip(nat, pure):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_verify_matches_jax_and_reference(family):
    from tendermint_tpu.crypto import ed25519 as jed
    from tendermint_tpu.ops import ed25519_f32 as jf32

    items = FAMILIES[family]()
    before = tf32p.launches
    got = list(tf32p.verify_batch(items, device="cpu"))
    assert tf32p.launches == before  # the plain version is not a launch
    assert got == list(jf32.verify_batch(items))
    assert got == [jed.verify(*it) for it in items]


def test_expected_verdicts_of_families():
    """The families exercise what they claim: accept and reject lanes."""
    assert list(tf32p.verify_batch(_tampered_items(), device="cpu")) == [
        True, False, False, False, False, False, False, False, False, True,
    ]
    assert list(tf32p.verify_batch([], device="cpu")) == []


def test_verifier_cpu_device_matches_jax_verifier():
    from tendermint_tpu.ops.gateway import Verifier as JaxVerifier

    items = _tampered_items()
    v = Verifier(min_tpu_batch=1, device="cpu")
    got = v.verify_batch(items)
    assert got == JaxVerifier(min_tpu_batch=10**9, use_tpu=False).verify_batch(items)
    # 2 malformed lanes (short pub, long sig) verify on the CPU, 8 on the device route
    assert v.stats()["tpu_batches"] == 1 and v.stats()["tpu_sigs"] == 8
    assert v.stats()["cpu_sigs"] == 2


def test_verifier_gate_keeps_small_batches_on_cpu():
    items = _odd_items()
    before = tf32p.launches
    v = Verifier(min_tpu_batch=64, device="cpu")
    assert v.verify_batch(items) == [ted.verify(*it) for it in items]
    assert v.verify_batch_async(items[:1])() == [True]
    s = v.stats()
    assert s["cpu_sigs"] == len(items) + 1 and s["tpu_batches"] == 0 and s["tpu_sigs"] == 0
    assert tf32p.launches == before


def test_verifier_gate_reads_env(monkeypatch):
    monkeypatch.setenv("TENDERMINT_TPU_MIN_BATCH", "7")
    assert Verifier(device="cpu").min_tpu_batch == 7
    monkeypatch.setenv("TENDERMINT_TPU_MIN_BATCH", "seven")
    assert Verifier(device="cpu").min_tpu_batch == 32
    monkeypatch.delenv("TENDERMINT_TPU_MIN_BATCH")
    assert Verifier(device="cpu").min_tpu_batch == 32


def test_verifier_async_keeps_order_across_batches():
    v = Verifier(min_tpu_batch=4, device="cpu")
    batches = []
    for salt in range(2):
        seeds = [bytes([salt * 8 + i + 1]) * 32 for i in range(6)]
        b = [
            (ted.public_key(s), b"a%d-%d" % (salt, i), ted.sign(s, b"a%d-%d" % (salt, i)))
            for i, s in enumerate(seeds)
        ]
        b[salt] = (b[salt][0], b[salt][1], b"\x00" * 64)
        batches.append(b)
    resolvers = [v.verify_batch_async(b) for b in batches]
    results = [r() for r in reversed(resolvers)][::-1]
    for salt, res in enumerate(results):
        assert res == [i != salt for i in range(6)]
    assert v.stats()["tpu_batches"] == 2 and v.stats()["cpu_sigs"] == 0


def test_prime_cache_then_verify_one():
    items = _identical_key_items()[:4]
    v = Verifier(min_tpu_batch=4, device="cpu")
    v.prime_cache(items)
    assert [v.verify_one(*it) for it in items] == [True] * 4
    assert v.stats()["cpu_sigs"] == 0 and v.stats()["tpu_sigs"] == 4
    assert v.pop_primed(items[0]) is None  # single-use
    assert v.vote_verifier()(*items[0]) is True  # not primed: the CPU
    assert v.stats()["cpu_sigs"] == 1
    assert v.commit_batch_verifier() == v.verify_batch


def test_wrapper_checks_arguments():
    args, _, _ = tf32p.marshal_device_args(_odd_items(), "cpu")
    bad = (args[0].int(),) + args[1:]
    with pytest.raises(ValueError, match="uint8"):
        tf32p.verify_lanes(*bad)
    with pytest.raises(ValueError, match="rsign"):
        tf32p.verify_lanes(*args[:3], args[3].long(), *args[4:])
    with pytest.raises(ValueError, match="contiguous"):
        tf32p.verify_lanes(args[0].t().contiguous().t(), *args[1:])


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    items = _tampered_items() + _identical_key_items() + _odd_items() + _rfc_items()
    items = items * 20  # several blocks and a ragged last block
    args, valid, n = tf32p.marshal_device_args(items, "cuda")
    before = tf32p.launches
    got = tf32p.verify_lanes(*args)
    torch.cuda.synchronize()
    assert tf32p.launches == before + 1
    want = tf32.verify_plain(args[0].float(), args[1].float(), args[2].float(), args[3],
                             args[4].int(), args[5].int()).to(torch.int32)
    assert torch.equal(got, want)
    verdicts = tf32p.materialize_verdicts(got.cpu(), valid, n)
    assert list(verdicts) == [ted.verify(*it) for it in items]
    assert list(tf32p.verify_batch(items)) == list(verdicts)
