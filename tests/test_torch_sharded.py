"""The port's sharded verify path (B1' and ShardedVerifier) against the
JAX package's ShardedVerifier on the 8-device CPU mesh of
tests/conftest.py, under TENDERMINT_TPU_KERNEL=f32p.

The port's CPU mesh is a list of "cpu" shards, each running the
kernel's plain version; verdicts and stats must equal JAX's exactly.
A plain call is bound by torch's per-op overhead (about 2.5 s a 128-lane
shard on one thread, slower with several), so the module runs torch on
one thread and most cases use 2 shards; one case mirrors JAX's 8.

The `cuda` case runs on a machine with a card and no JAX:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sharded.py -m cuda`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.ops import ed25519_f32p as tf32p
from tendermint_tpu_torch.ops.gateway import ShardedVerifier


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def f32p_knob(monkeypatch):
    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", "f32p")


def _mk_items(n, corrupt=()):
    from tests.test_ops import _mk_items as jax_items

    return jax_items(n, corrupt)


def _jax_sharded():
    import jax
    from jax.sharding import Mesh

    from tendermint_tpu.ops import gateway

    return gateway.ShardedVerifier(Mesh(np.array(jax.devices()), ("batch",)), min_tpu_batch=1)


def _check_layout(layout, mesh, n):
    assert [d for d, _ in layout] == mesh
    lanes = {sz for _, sz in layout}
    assert len(lanes) == 1
    q = tf32p.lane_quantum(len(mesh))
    assert n <= lanes.pop() * len(mesh) < n + q


# the items of tests/test_ops.py's TestShardedVerifier cases
CASES = {
    "mesh_sharded_batch": (dict(n=16, corrupt=[(5, "sig")]), 8, "sync"),
    "mesh_sharded_f32p_parity": (dict(n=16, corrupt=[(3, "sig"), (11, "msg")]), 2, "sync"),
    "sharded_async_uses_the_sharded_path": (dict(n=16, corrupt=[(9, "msg")]), 2, "async"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_verdicts_and_stats_equal_jax(case, f32p_knob):
    kw, shards, route = CASES[case]
    items = _mk_items(**kw)
    jv = _jax_sharded()
    mesh = ["cpu"] * shards
    tv = ShardedVerifier(mesh, min_tpu_batch=1)
    before = tf32p.launches
    if route == "async":
        want, got = jv.verify_batch_async(items)(), tv.verify_batch_async(items)()
    else:
        want, got = jv.verify_batch(items), tv.verify_batch(items)
    assert got == want
    assert got == [ted.verify(*it) for it in items]
    assert tv.stats() == jv.stats()
    assert tv.stats()["tpu_batches"] == 1 and tv.stats()["tpu_sigs"] == 16
    assert tf32p.launches == before  # CPU shards run the plain version
    _check_layout(tv.last_shard_layout, mesh, len(items))


def test_shards_split_contiguous_in_mesh_order(monkeypatch):
    """Each shard hands the kernel contiguous rows of its own lanes, in
    mesh order, and the gather puts each shard's verdicts back in place."""
    seen = []

    def fake_lanes(ax, ay, ry, rsign, s8, h8):
        tf32p.check_args(ax, ay, ry, rsign, s8, h8)  # contiguous, one device
        seen.append((ax.clone(), s8.clone()))
        return ax[0].to(torch.int32)  # a lane's first pubkey x byte

    monkeypatch.setattr(tf32p, "verify_lanes", fake_lanes)
    items = _mk_items(300)
    sharded = tf32p.ShardedVerify(["cpu"] * 3)
    res, valid, n = tf32p.sharded_verify_arrays(items, sharded)
    planes, _, _ = tf32p.host_planes(items, 384)
    assert n == 300 and valid[:300].all() and not valid[300:].any()
    assert [(ax.shape, s8.shape) for ax, s8 in seen] == [((32, 128), (32, 128))] * 3
    for k, (ax, s8) in enumerate(seen):
        assert np.array_equal(ax.numpy(), planes[0, :, 128 * k : 128 * (k + 1)])
        assert np.array_equal(s8.numpy(), planes[3, :, 128 * k : 128 * (k + 1)])
    assert np.array_equal(res.wait().numpy(), planes[0, 0].astype(np.int32))
    assert res.shards == [("cpu", 128)] * 3
    assert tf32p.lane_quantum(3) == 96  # 384 is the next multiple above 300
    want = planes[0, 0, :300] != 0
    assert np.array_equal(tf32p.materialize_verdicts(res.wait(), valid, n), want)
    assert tf32p.sharded_verify_arrays([], sharded)[0] is None
    with pytest.raises(ValueError, match="equal shards"):
        sharded.dispatch(planes[..., :100], np.zeros(100, dtype=np.int32))


@pytest.mark.parametrize("name", ["pallas", "int32", "comb", "f32", "devd", "typo"])
def test_sharded_refuses_other_kernels(monkeypatch, name):
    from jax.sharding import Mesh
    import jax

    from tendermint_tpu.ops import gateway

    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", name)
    with pytest.raises(ValueError, match="shards the f32/f32p") as mine:
        ShardedVerifier(["cpu"] * 2)
    if name == "f32":
        assert "not ported" in str(mine.value)
        return
    # the JAX package refuses the same names, with the same words except a
    # name it does not know, which its base class refuses first
    with pytest.raises(ValueError, match="shards the f32/f32p" if name != "typo" else "expected one of"):
        gateway.ShardedVerifier(Mesh(np.array(jax.devices()), ("batch",)))


def test_sharded_fast_sync_group_equal_to_jax(f32p_knob):
    """tests/test_ops.py::test_sharded_fast_sync_commit through the port:
    three 8-validator commits in one grouped dispatch, height 2 tampered;
    only its finisher raises, with JAX's message."""
    from tendermint_tpu.crypto.keys import SignatureEd25519 as JSig
    from tendermint_tpu.types.validator_set import CommitError as JCommitError
    from tendermint_tpu.types.vote import VOTE_TYPE_PRECOMMIT
    from tendermint_tpu.types.vote_set import VoteSet as JVoteSet
    from tests.test_torch_vote_set import carry_vote_set
    from tests.test_types import BLOCK_ID, make_val_set, signed_vote
    from tendermint_tpu_torch.crypto.keys import SignatureEd25519
    from tendermint_tpu_torch.types.block_id import BlockID
    from tendermint_tpu_torch.types.validator_set import CommitError, ValidatorSet

    vs, privs = make_val_set(8, power=1)
    j_entries, t_entries = [], []
    for height in (1, 2, 3):
        jset = JVoteSet("test-chain", height, 0, VOTE_TYPE_PRECOMMIT, vs)
        for p in privs:
            jset.add_vote(signed_vote(p, vs, height, 0, VOTE_TYPE_PRECOMMIT, BLOCK_ID))
        tset = carry_vote_set(jset)
        j_entries.append((BLOCK_ID, height, jset.make_commit()))
        t_entries.append((BlockID.from_json(BLOCK_ID.to_json()), height, tset.make_commit()))
        assert t_entries[-1][2].to_bytes() == j_entries[-1][2].to_bytes()
    for entries, sig_type in ((j_entries, JSig), (t_entries, SignatureEd25519)):
        bad = entries[1][2]
        bad.precommits[0] = bad.precommits[0].with_signature(sig_type(b"\x07" * 64))
    tvs = ValidatorSet.from_json(vs.to_json())

    jv, tv = _jax_sharded(), ShardedVerifier(["cpu"] * 2, min_tpu_batch=1)
    j_fin = vs.verify_commits_async("test-chain", j_entries, jv.verify_batch_async)
    t_fin = tvs.verify_commits_async("test-chain", t_entries, tv.verify_batch_async)

    def outcome(fn, err):
        try:
            fn()
        except err as exc:
            return str(exc)
        return None

    want = [outcome(f, JCommitError) for f in j_fin]
    got = [outcome(f, CommitError) for f in t_fin]
    assert got == want
    assert [g is None for g in got] == [True, False, True]
    assert tv.stats() == jv.stats()
    assert tv.stats()["tpu_batches"] == 1 and tv.stats()["tpu_sigs"] == 24
    _check_layout(tv.last_shard_layout, ["cpu"] * 2, 24)


def test_mixed_key_batch_through_the_sharded_path(f32p_knob):
    """ed25519 lanes ride the shards, secp256k1 lanes verify on the CPU,
    and the verdicts come back in the caller's order, as in JAX."""
    from tests.test_torch_secp256k1 import mixed_batch

    items, expect = mixed_batch()
    jv = _jax_sharded()
    tv = ShardedVerifier(["cpu"] * 2, min_tpu_batch=1)
    got = tv.verify_batch(items)
    assert got == jv.verify_batch(items) == expect
    assert tv.stats() == jv.stats()
    assert tv.stats()["tpu_batches"] == 1 and tv.stats()["cpu_sigs"] == 3
    assert tv.stats()["tpu_sigs"] == 6


def test_small_batches_stay_on_the_cpu_floor(monkeypatch, f32p_knob):
    def no_kernel(*args):
        raise AssertionError("the kernel ran below the size gate")

    monkeypatch.setattr(tf32p, "verify_lanes", no_kernel)
    items = _mk_items(5, corrupt=[(2, "pub")])
    tv = ShardedVerifier(["cpu"] * 2, min_tpu_batch=8)
    assert tv.verify_batch(items) == [i != 2 for i in range(5)]
    assert tv.verify_batch_async(items)() == [i != 2 for i in range(5)]
    assert tv.stats()["cpu_sigs"] == 10 and tv.stats()["tpu_batches"] == 0
    assert tv.last_shard_layout is None


def test_prime_cache_async_then_verify_one_through_the_shards(f32p_knob):
    """The live vote path: a primed batch rides the shards, and each
    verify_one pops its verdict without verifying again."""
    items = _mk_items(6, corrupt=[(4, "sig")])
    tv = ShardedVerifier(["cpu"] * 2, min_tpu_batch=4)
    tv.prime_cache_async(items)
    assert [tv.verify_one(*it) for it in items] == [i != 4 for i in range(6)]
    assert tv.stats()["tpu_batches"] == 1 and tv.stats()["cpu_sigs"] == 0
    assert tv.last_shard_layout == [("cpu", 32), ("cpu", 32)]


def test_no_fallback_a_failing_shard_raises_everywhere(monkeypatch, f32p_knob):
    """A shard that fails raises out of verify_batch, the resolver and a
    primed verify_one; no stat moves and nothing is latched: the next
    batch runs sharded."""
    items = _mk_items(4)

    def broken(*args):
        raise RuntimeError("ed25519_verify kernel launch failed: cudaError 700")

    tv = ShardedVerifier(["cpu"] * 2, min_tpu_batch=1)
    real_wait = tf32p.ShardedVerdicts.wait
    monkeypatch.setattr(tf32p, "verify_lanes", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        tv.verify_batch(items)
    with pytest.raises(RuntimeError, match="launch failed"):
        tv.verify_batch_async(items)()
    assert tv.stats()["tpu_batches"] == tv.stats()["tpu_sigs"] == tv.stats()["cpu_sigs"] == 0

    # a fault that surfaces when the shards are waited on (the lanes
    # themselves are stubbed: only the wait matters here)
    monkeypatch.setattr(tf32p, "verify_lanes", lambda ax, *rest: torch.ones(ax.shape[-1], dtype=torch.int32))

    def failed_wait(self):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tf32p.ShardedVerdicts, "wait", failed_wait)
    resolve = tv.verify_batch_async(items)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        resolve()
    tv.prime_cache_async(items)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tv.verify_one(*items[0])
    assert tv.stats()["tpu_batches"] == tv.stats()["tpu_sigs"] == tv.stats()["cpu_sigs"] == 0

    monkeypatch.setattr(tf32p.ShardedVerdicts, "wait", real_wait)
    assert tv.verify_batch(items) == [True] * 4
    assert tv.stats()["tpu_batches"] == 1 and tv.stats()["cpu_sigs"] == 0


def test_mesh_of_a_missing_card_raises(monkeypatch):
    from tendermint_tpu_torch import multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedVerifier(["cuda:0"] * 4)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices, have 0"):
        multichip.dryrun_multichip(2)
    with pytest.raises(ValueError, match="at least one device"):
        ShardedVerifier([])


def test_dryrun_multichip_on_two_cpu_shards(capsys):
    from tendermint_tpu_torch.multichip import dryrun_multichip

    dryrun_multichip(2, device="cpu")
    assert "4099 sigs over 2 cpu shards" in capsys.readouterr().out


@pytest.mark.cuda
def test_four_shards_on_one_card_equal_unsharded_b1():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    items = [it for k in range(200) for it in _torch_items(k)]  # seven blocks a shard
    sharded = tf32p.ShardedVerify(["cuda:0"] * 4)
    before = tf32p.launches
    res, valid, n = tf32p.sharded_verify_arrays(items, sharded)
    got = res.wait().clone()
    assert tf32p.launches == before + 4
    assert res.shards == [("cuda:0", 224)] * 4
    args, _, _ = tf32p.marshal_device_args(items, "cuda")
    whole = tf32p.verify_lanes(*args)
    assert torch.equal(got[:n], whole.cpu())
    assert list(tf32p.materialize_verdicts(got, valid, n)) == [ted.verify(*it) for it in items]


def _torch_items(k):
    """Valid, tampered and malformed lanes from the port's own crypto (the
    card's machine has no JAX)."""
    seed = bytes([k + 1]) * 32
    pub, msg = ted.public_key(seed), b"shard-%d" % k
    sig = ted.sign(seed, msg)
    return [(pub, msg, sig), (pub, msg + b"!", sig), (pub[:31], msg, sig),
            (pub, msg, sig[:63] + bytes([sig[63] ^ 0x40]))]
