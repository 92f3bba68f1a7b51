"""The port's hash plane end to end against the JAX package's: a whole
`Block.make_block`, wired as consensus wires it (the gateway Hasher's
`part_leaf_hashes`, `part_set_tree` and `submit_part_set_tree`, and
`tx_merkle_root` through `types.tx.set_batch_tx_root`), on the port's
`Hasher(device="cpu", min_tpu_batch=1)` (the kernels' plain versions)
against JAX's `Hasher(min_tpu_batch=1, use_tpu=True)` on its in-process
route: the same block bytes, header, data and part-set hashes, and every
part's proof JSON. The commit and the evidence are made and signed with
the JAX package and carried into the port through their JSON forms.

Then the Hasher itself: the size gate and the operator's knobs
(TENDERMINT_TPU_HASHES, TENDERMINT_TPU_DISABLE,
TENDERMINT_TPU_HASH_MIN_BATCH), the tx-root LRU (tests/test_merkle_flat.py
`TestTxRootCache`), the submit worker's in-flight join, the stats keys
(JAX's, stream gauges included), and the failure contract: a failed tree
submission raises out of `PartSet.from_data`, where JAX falls back to the
CPU. The `cuda` case builds a block on the card; the JAX package is
imported inside the tests that compare with it, so
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hasher.py -m cuda`
runs on a machine with a card and no JAX.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.merkle.simple import simple_hash_from_byteslices
from tendermint_tpu_torch.ops import gateway
from tendermint_tpu_torch.ops.gateway import Hasher
from tendermint_tpu_torch.types import block as pblock
from tendermint_tpu_torch.types import tx as ptx
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.evidence import EvidenceData
from tendermint_tpu_torch.types.part_set import InvalidProofError, Part, PartSet
from tendermint_tpu_torch.types.params import ConsensusParams

CHAIN = "hash-chain"
PART_SIZE = 1024
TIME_NS = 1_700_000_000_123_456_789


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules these tests compare with."""
    from tendermint_tpu.crypto.keys import gen_priv_key_ed25519
    from tendermint_tpu.ops import gateway as jgw
    from tendermint_tpu.types import BlockID, Commit, PartSetHeader, Vote, VOTE_TYPE_PRECOMMIT
    from tendermint_tpu.types import block, tx
    from tendermint_tpu.types.evidence import DuplicateVoteEvidence
    from tendermint_tpu.types.params import ConsensusParams as Params
    from tendermint_tpu.types.part_set import Part as JPart
    from tendermint_tpu.types.part_set import PartSet as JPartSet

    return SimpleNamespace(
        gen_priv_key_ed25519=gen_priv_key_ed25519, gateway=jgw, BlockID=BlockID, Commit=Commit,
        PartSetHeader=PartSetHeader, Vote=Vote, PRECOMMIT=VOTE_TYPE_PRECOMMIT, block=block, tx=tx,
        Evidence=DuplicateVoteEvidence, Params=Params, Part=JPart, PartSet=JPartSet,
        prev=BlockID(b"\x11" * 20, PartSetHeader(3, b"\x22" * 20)),
    )


@pytest.fixture(scope="module")
def jax_parts(jx):
    """A 4-validator commit for the previous block and one double-sign
    piece, made and signed by the JAX package."""

    def signed(key, idx, height, block_id):
        v = jx.Vote(key.pub_key().address(), idx, height, 0, jx.PRECOMMIT, block_id)
        return v.with_signature(key.sign(v.sign_bytes(CHAIN)))

    keys = sorted((jx.gen_priv_key_ed25519(b"hv-%d" % i) for i in range(4)),
                  key=lambda k: k.pub_key().address())
    commit = jx.Commit(jx.prev, [signed(k, i, 1, jx.prev) for i, k in enumerate(keys)])
    other = jx.BlockID(b"\x33" * 20, jx.PartSetHeader(3, b"\x44" * 20))
    ev = jx.Evidence.new(keys[0].pub_key(), signed(keys[0], 0, 1, jx.prev),
                         signed(keys[0], 0, 1, other))
    return commit, [ev], jx.prev


def _txs(n: int, seed: int = 8) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(1, 120))) for _ in range(n)]


@pytest.fixture
def batch_roots():
    """Install a batch tx-root hook in the port (and, given one, in the JAX
    package); restore the host path after."""
    jax_tx = []

    def install(port_fn, jax_fn=None):
        ptx.set_batch_tx_root(port_fn)
        if jax_fn is not None:
            from tendermint_tpu.types import tx

            tx.set_batch_tx_root(jax_fn)
            jax_tx.append(tx)

    yield install
    ptx.set_batch_tx_root(None)
    for tx in jax_tx:
        tx.set_batch_tx_root(None)


def _make(module, hasher, txs, commit, evidence, prev, part_size=PART_SIZE):
    return module.Block.make_block(
        2, CHAIN, txs, commit, prev, b"\x55" * 20, b"\x66" * 20, part_size, time_ns=TIME_NS,
        part_hasher=hasher.part_leaf_hashes if hasher else None,
        part_tree_hasher=hasher.part_set_tree if hasher else None,
        part_tree_submitter=hasher.submit_part_set_tree if hasher else None,
        evidence=evidence,
    )


def _port_args(jax_parts):
    commit, evs, prev = jax_parts
    return (pblock.Commit.from_json(commit.to_json()),
            EvidenceData.from_json({"evidence": [e.to_json() for e in evs]}),
            BlockID.from_json(prev.to_json()))


def _assert_same_block(pb, pps, jb, jps):
    assert pb.to_bytes() == jb.to_bytes()
    assert pb.hash() == jb.hash() and pb.hash()
    assert pb.header.data_hash == jb.header.data_hash
    assert pb.header.evidence_hash == jb.header.evidence_hash != b""
    assert pb.header.last_commit_hash == jb.header.last_commit_hash
    assert pps.header().hash == jps.header().hash and pps.total == jps.total
    for i in range(pps.total):
        assert pps.get_part(i).to_json() == jps.get_part(i).to_json()


def test_make_block_matches_jax(jx, jax_parts, batch_roots):
    txs = _txs(50)
    h = Hasher(device="cpu", min_tpu_batch=1)
    jh = jx.gateway.Hasher(min_tpu_batch=1, use_tpu=True)
    jh._route = "local"
    batch_roots(h.tx_merkle_root, jh.tx_merkle_root)
    commit, evidence, prev = _port_args(jax_parts)
    pb, pps = _make(pblock, h, txs, commit, evidence, prev)
    jb, jps = _make(jx.block, jh, txs, *jax_parts)
    assert pps.total > 1
    _assert_same_block(pb, pps, jb, jps)
    stats = h.stats()
    assert (stats["tpu_part_batches"], stats["tpu_tx_roots"], stats["cpu_leaves"],
            stats["submitted_jobs"], stats["tpu_leaves"]) == (1, 1, 0, 1, pps.total + len(txs))
    assert jh.stats()["tpu_part_batches"] == 1


def test_make_block_on_the_host_floor_matches_jax(jx, jax_parts, batch_roots, monkeypatch):
    """TENDERMINT_TPU_HASHES=0: the native library and FlatTree, no device."""
    monkeypatch.setenv("TENDERMINT_TPU_HASHES", "0")
    h = Hasher()
    assert h.device is None
    jh = jx.gateway.Hasher(use_tpu=False)
    batch_roots(h.tx_merkle_root, jh.tx_merkle_root)
    txs = _txs(40, seed=9)
    commit, evidence, prev = _port_args(jax_parts)
    pb, pps = _make(pblock, h, txs, commit, evidence, prev)
    jb, jps = _make(jx.block, jh, txs, *jax_parts)
    _assert_same_block(pb, pps, jb, jps)
    stats = h.stats()
    assert stats["tpu_part_batches"] == stats["tpu_tx_roots"] == 0
    assert stats["cpu_leaves"] == pps.total + len(txs)


def test_block_roundtrips_and_validates(jx, jax_parts, batch_roots):
    h = Hasher(device="cpu", min_tpu_batch=1)
    batch_roots(h.tx_merkle_root)
    commit, evidence, prev = _port_args(jax_parts)
    txs = _txs(30, seed=10)
    b, ps = _make(pblock, h, txs, commit, evidence, prev)
    again = pblock.Block.from_bytes(b.to_bytes())
    assert again.hash() == b.hash() and again.to_bytes() == b.to_bytes()
    assert pblock.Block.from_json(b.to_json()).hash() == b.hash()
    assert b.validate_basic(CHAIN, 1, prev, b"\x66" * 20) is None
    assert b.block_id(ps) == BlockID(b.hash(), ps.header())
    jb = jx.block.Block.from_bytes(b.to_bytes())
    assert jb.hash() == b.hash()
    with pytest.raises(ValueError, match="trailing bytes"):
        pblock.Block.from_bytes(b.to_bytes() + b"\x00")
    again.header.data_hash = b"\x00" * 20
    assert again.validate_basic(CHAIN, 1, prev, b"\x66" * 20) == "wrong data_hash"
    assert b.validate_basic(CHAIN, 1, prev, b"\x00").startswith("wrong app_hash")


def test_parts_verify_and_a_flipped_byte_is_refused(jx, jax_parts, batch_roots):
    h = Hasher(device="cpu", min_tpu_batch=1)
    batch_roots(h.tx_merkle_root)
    commit, evidence, prev = _port_args(jax_parts)
    b, ps = _make(pblock, h, _txs(30, seed=11), commit, evidence, prev)
    fresh = PartSet.from_header(ps.header())
    jfresh = jx.PartSet.from_header(jx.PartSetHeader(ps.total, ps.hash()))
    for i in range(ps.total):
        part = ps.get_part(i)
        assert fresh.add_part(Part.from_json(part.to_json()))
        assert jfresh.add_part(jx.Part.from_json(part.to_json()))
    assert fresh.is_complete() and fresh.get_data() == b.to_bytes()
    assert not fresh.add_part(ps.get_part(0))  # a duplicate
    part = ps.get_part(1)
    flipped = bytearray(part.bytes_)
    flipped[7] ^= 1
    with pytest.raises(InvalidProofError):
        PartSet.from_header(ps.header()).add_part(Part(1, bytes(flipped), part.proof))


def test_empty_block_is_one_empty_part(jx):
    ps = PartSet.from_data(b"", PART_SIZE, tree_hasher=Hasher(device="cpu", min_tpu_batch=1).part_set_tree)
    assert ps.total == 1 and ps.get_part(0).bytes_ == b""
    assert ps.header() == PartSet.from_data(b"", PART_SIZE).header()
    assert ps.hash() == jx.PartSet.from_data(b"", PART_SIZE).hash()


def test_params_match_jax(jx):
    JParams = jx.Params
    p = ConsensusParams()
    assert p.to_json() == JParams().to_json()
    assert (p.block_size.max_bytes, p.block_size.max_txs, p.tx_size.max_bytes,
            p.block_gossip.block_part_size_bytes) == (22_020_096, 10_000, 10_240, 65_536)
    p.block_gossip.block_part_size_bytes = 1 << 19
    assert p.validate() == JParams.from_json(p.to_json()).validate() is not None
    assert ConsensusParams.from_json(p.to_json()) == p


# -- the Hasher's policy -----------------------------------------------------


def test_size_gate_routes_narrow_batches_to_the_host():
    h = Hasher(device="cpu", min_tpu_batch=8)
    chunks = [b"c%d" % i * 50 for i in range(7)]
    assert h.part_set_tree(chunks) is None
    from tendermint_tpu_torch.crypto.hashing import ripemd160

    assert h.part_leaf_hashes(chunks) == [ripemd160(c) for c in chunks]
    assert h.stats()["cpu_leaves"] == 7 and h.stats()["tpu_part_batches"] == 0
    wide = chunks + [b"more"]
    digests, tree = h.part_set_tree(wide)
    assert digests == [ripemd160(c) for c in wide] and tree.n == 8
    assert h.stats()["tpu_part_batches"] == 1 and h.stats()["tpu_leaves"] == 8


def test_hasher_fallback_parity():
    """tests/test_ops.py test_hasher_fallback_parity: the device route and
    the host route agree."""
    h_dev = Hasher(device="cpu", min_tpu_batch=1)
    h_cpu = Hasher(device="cpu", min_tpu_batch=10**9)
    chunks = [b"c%d" % i * 50 for i in range(8)]
    assert h_dev.part_leaf_hashes(chunks) == h_cpu.part_leaf_hashes(chunks)
    txs = [b"tx%d" % i for i in range(8)]
    assert h_dev.tx_merkle_root(txs) == h_cpu.tx_merkle_root(txs)
    assert h_cpu.tx_merkle_root(txs) == simple_hash_from_byteslices(txs)
    assert h_dev.tx_merkle_root([]) == h_cpu.tx_merkle_root([]) == b""


@pytest.mark.parametrize("env,offload", [
    ({}, True), ({"TENDERMINT_TPU_HASHES": "0"}, False), ({"TENDERMINT_TPU_HASHES": "1"}, True),
    ({"TENDERMINT_TPU_DISABLE": "1"}, False),
    ({"TENDERMINT_TPU_DISABLE": "1", "TENDERMINT_TPU_HASHES": "1"}, False),
])
def test_operator_knobs(monkeypatch, env, offload):
    for k in ("TENDERMINT_TPU_HASHES", "TENDERMINT_TPU_DISABLE", "TENDERMINT_TPU_HASH_MIN_BATCH"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    h = Hasher(device="cpu")
    assert (h.device is not None) is offload
    assert h.min_tpu_batch == 16


@pytest.mark.parametrize("raw,want", [("7", 7), ("", 16), ("many", 16)])
def test_min_batch_knob(monkeypatch, raw, want):
    monkeypatch.setenv("TENDERMINT_TPU_HASH_MIN_BATCH", raw)
    assert Hasher(device="cpu").min_tpu_batch == want
    assert Hasher(device="cpu", min_tpu_batch=3).min_tpu_batch == 3


def test_default_hasher_needs_a_card(monkeypatch):
    monkeypatch.delenv("TENDERMINT_TPU_HASHES", raising=False)
    monkeypatch.delenv("TENDERMINT_TPU_DISABLE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Hasher()
    monkeypatch.setenv("TENDERMINT_TPU_HASHES", "0")
    assert Hasher().device is None  # the operator asked for host hashing


def test_stats_keys_match_jax(jx):
    assert list(Hasher(device="cpu").stats()) == list(jx.gateway.Hasher(use_tpu=False).stats())


# -- tx-root cache and the submit worker -----------------------------------------


class TestTxRootCache:
    def test_cache_hits_skip_rehash(self, monkeypatch):
        h = Hasher(device="cpu")
        txs = [b"tx-%d" % i for i in range(20)]
        root = h.tx_merkle_root(txs)
        assert h.stats()["tx_root_cache_hits"] == 0
        calls = []
        monkeypatch.setattr(h, "_tx_merkle_root_uncached", lambda t: calls.append(1) or b"\x00" * 20)
        assert h.tx_merkle_root(list(txs)) == root
        assert calls == [] and h.stats()["tx_root_cache_hits"] == 1

    def test_distinct_sets_distinct_roots(self):
        h = Hasher(device="cpu")
        a = [b"a-%d" % i for i in range(17)]
        b = [b"b-%d" % i for i in range(17)]
        assert h.tx_merkle_root(a) == simple_hash_from_byteslices(a)
        assert h.tx_merkle_root(b) == simple_hash_from_byteslices(b)
        assert h.tx_merkle_root(a) != h.tx_merkle_root(b)

    def test_cache_evicts_fifo(self):
        h = Hasher(device="cpu")
        h._tx_roots_cap = 4
        for i in range(6):
            h.tx_merkle_root([b"set-%d" % i])
        assert len(h._tx_roots) == 4
        assert (b"set-0",) not in h._tx_roots and (b"set-5",) in h._tx_roots


def _gated(h: Hasher, monkeypatch):
    """Make h's uncached tx root wait on the returned event, which a timer
    sets shortly after: the submission stays in flight while the caller
    looks it up."""
    gate = threading.Event()
    real = h._tx_merkle_root_uncached

    def slow(txs):
        gate.wait(30)
        return real(txs)

    monkeypatch.setattr(h, "_tx_merkle_root_uncached", slow)
    timer = threading.Timer(0.3, gate.set)
    timer.start()
    return timer


def test_tx_merkle_root_joins_an_inflight_submission(monkeypatch):
    h = Hasher(device="cpu", min_tpu_batch=1)
    txs = _txs(20, seed=12)
    timer = _gated(h, monkeypatch)
    fut = h.submit_tx_root(txs)
    assert h.submit_tx_root(list(txs)) is fut  # deduplicated while in flight
    root = h.tx_merkle_root(txs)
    timer.join()
    want = simple_hash_from_byteslices(txs)
    assert fut.result(30) == want and root == want
    stats = h.stats()
    assert stats["submitted_jobs"] == 1 and stats["tx_root_prehash_joins"] == 1
    assert h.submit_tx_root(txs).result(1) == want  # from the cache now
    assert h.stats()["submitted_jobs"] == 1


def test_a_failed_submission_raises_where_it_is_joined(monkeypatch):
    h = Hasher(device="cpu", min_tpu_batch=1)

    def boom(*args):
        raise RuntimeError("hash_blocks kernel launch failed: cudaError 700")

    monkeypatch.setattr(gateway.ops_merkle, "tx_root", boom)
    monkeypatch.setattr(gateway.ops_merkle, "part_set_nodes", boom)
    txs = _txs(5, seed=13)
    timer = _gated(h, monkeypatch)
    fut = h.submit_tx_root(txs)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        h.tx_merkle_root(txs)  # joins the submission, which fails
    timer.join()
    with pytest.raises(RuntimeError, match="cudaError 700"):
        fut.result(30)
    assert h.stats()["tx_root_prehash_joins"] == 0
    assert tuple(txs) not in h._tx_roots and not h._inflight_tx_roots
    with pytest.raises(RuntimeError, match="cudaError 700"):
        PartSet.from_data(b"x" * 5000, PART_SIZE, tree_submitter=h.submit_part_set_tree)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        PartSet.from_data(b"x" * 5000, PART_SIZE, tree_hasher=h.part_set_tree)
    assert h.stats()["cpu_leaves"] == 0


@pytest.mark.cuda
def test_make_block_on_the_card_matches_the_host_floor(batch_roots):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    txs = _txs(400, seed=14)
    commit, evidence, prev = pblock.empty_commit(), None, BlockID()
    h = Hasher(min_tpu_batch=1)
    batch_roots(h.tx_merkle_root)
    b, ps = _make(pblock, h, txs, commit, evidence, prev)
    h_cpu = Hasher(device="cpu", min_tpu_batch=10**9)
    batch_roots(h_cpu.tx_merkle_root)
    rb, rps = _make(pblock, h_cpu, txs, commit, evidence, prev)
    assert b.to_bytes() == rb.to_bytes() and b.hash() == rb.hash()
    assert ps.header() == rps.header()
    for i in range(ps.total):
        assert ps.get_part(i).proof == rps.get_part(i).proof
    assert h.stats()["cpu_leaves"] == 0 and h.stats()["tpu_part_batches"] == 1
