"""The port's duplicate-vote evidence (types/evidence.py, and the
ConsensusState that records it) on the cases of tests/test_evidence.py.

Two cases lean on modules the port does not hold yet: the pool's RPC
route (rpc/core/handlers, A.7e-1) and statesync/devchain.py (A.8). The
first serves the port's pool through the JAX package's route, so the
route's output is held against the port's objects; the second builds
its blocks through the port's execution path (`_Chain`, in
DevChain.commit_block's steps)."""

from __future__ import annotations

import pytest

from tendermint_tpu_torch.types import BlockID, PartSetHeader
from tendermint_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    EvidencePool,
)
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PREVOTE, Vote
from tests.test_torch_consensus import host_device  # noqa: F401 — autouse fixture



def make_val_set(n, power=10):
    """n validators with equal power; returns (ValidatorSet, [PrivValidatorFS])
    (tests/test_types.py's helper on the port's types)."""
    from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
    from tendermint_tpu_torch.types import PrivValidatorFS
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    privs = [PrivValidatorFS(gen_priv_key_ed25519(f"val-{i}".encode()), None) for i in range(n)]
    vs = ValidatorSet([Validator.new(p.get_pub_key(), power) for p in privs])
    privs.sort(key=lambda p: p.get_address())
    return vs, privs


class _Chain:
    """A one-validator chain that commits blocks through the port's
    execution path, as the JAX package's statesync/devchain.DevChain does:
    make_block, a signed seen commit, save_block, apply_block."""

    def __init__(self, app):
        import threading

        from tendermint_tpu_torch.abci.client import LocalClient
        from tendermint_tpu_torch.blockchain.store import BlockStore
        from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
        from tendermint_tpu_torch.libs.db import MemDB
        from tendermint_tpu_torch.proxy.app_conn import AppConnConsensus
        from tendermint_tpu_torch.state.state import State
        from tendermint_tpu_torch.types import GenesisDoc, GenesisValidator, PrivValidatorFS

        self.pv = PrivValidatorFS(gen_priv_key_ed25519(b"devchain-validator"), None)
        doc = GenesisDoc(genesis_time_ns=1_700_000_000 * 10**9, chain_id="test-chain",
                         validators=[GenesisValidator(self.pv.get_pub_key(), 10, "v0")])
        self.state = State.get_state(MemDB(), doc)
        self.block_store = BlockStore(MemDB())
        self._proxy = AppConnConsensus(LocalClient(app, threading.RLock()))
        self._seen = None

    def commit_block(self, txs=None, evidence=None):
        from tendermint_tpu_torch.state import apply_block
        from tendermint_tpu_torch.types.block import Block, Commit, empty_commit
        from tendermint_tpu_torch.types.services import MockMempool
        from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT

        st = self.state
        height = st.last_block_height + 1
        block, parts = Block.make_block(
            height=height, chain_id=st.chain_id, txs=list(txs or []),
            commit=empty_commit() if height == 1 else self._seen, prev_block_id=st.last_block_id,
            val_hash=st.validators.hash(), app_hash=st.app_hash,
            part_size=st.params().block_gossip.block_part_size_bytes,
            time_ns=st.last_block_time_ns + 1_000_000_000, evidence=evidence)
        bid = BlockID(block.hash(), parts.header())
        vote = Vote(validator_address=self.pv.get_address(), validator_index=0, height=height,
                    round_=0, type_=VOTE_TYPE_PRECOMMIT, block_id=bid)
        seen = Commit(bid, [self.pv.sign_vote(st.chain_id, vote)])
        self.block_store.save_block(block, parts, seen)
        apply_block(st, None, self._proxy, block, parts.header(), MockMempool())
        self._seen = seen
        return block

    def build(self, n_blocks: int) -> None:
        for _ in range(n_blocks):
            self.commit_block()


BLOCK_A = BlockID(b"\xaa" * 20, PartSetHeader(2, b"\xbb" * 20))
BLOCK_B = BlockID(b"\xcc" * 20, PartSetHeader(2, b"\xdd" * 20))


def _byz_signed_vote(priv, vs, height, round_, block_id, chain_id="test-chain"):
    """Sign bypassing the PrivValidatorFS double-sign guard (which
    correctly refuses the second conflicting vote — a real byzantine
    signer uses the raw key, like test_byzantine.ByzantinePrivValidator)."""
    idx, _ = vs.get_by_address(priv.get_address())
    vote = Vote(
        validator_address=priv.get_address(),
        validator_index=idx,
        height=height,
        round_=round_,
        type_=VOTE_TYPE_PREVOTE,
        block_id=block_id,
    )
    return vote.with_signature(priv.priv_key.sign(vote.sign_bytes(chain_id)))


def _conflicting_pair(priv, vs, height=1, round_=0, chain_id="test-chain"):
    va = _byz_signed_vote(priv, vs, height, round_, BLOCK_A, chain_id)
    vb = _byz_signed_vote(priv, vs, height, round_, BLOCK_B, chain_id)
    return va, vb


class TestDuplicateVoteEvidence:
    def test_valid_pair_validates(self):
        vs, privs = make_val_set(4)
        va, vb = _conflicting_pair(privs[0], vs)
        ev = DuplicateVoteEvidence.new(privs[0].get_pub_key(), va, vb)
        ev.validate("test-chain")  # no raise
        assert ev.address == privs[0].get_address()
        # canonical order: same hash regardless of construction order
        ev2 = DuplicateVoteEvidence.new(privs[0].get_pub_key(), vb, va)
        assert ev.hash() == ev2.hash()

    def test_agreeing_votes_rejected(self):
        vs, privs = make_val_set(4)
        va = _byz_signed_vote(privs[0], vs, 1, 0, BLOCK_A)
        ev = DuplicateVoteEvidence.new(privs[0].get_pub_key(), va, va)
        with pytest.raises(Exception, match="no conflict"):
            ev.validate("test-chain")

    def test_wrong_pubkey_rejected(self):
        vs, privs = make_val_set(4)
        va, vb = _conflicting_pair(privs[0], vs)
        ev = DuplicateVoteEvidence.new(privs[1].get_pub_key(), va, vb)
        with pytest.raises(Exception, match="does not match"):
            ev.validate("test-chain")

    def test_forged_signature_rejected(self):
        vs, privs = make_val_set(4)
        va, vb = _conflicting_pair(privs[0], vs)
        from tendermint_tpu_torch.crypto.keys import SignatureEd25519
        from dataclasses import replace

        vb = replace(vb, signature=SignatureEd25519(b"\x01" * 64))
        ev = DuplicateVoteEvidence.new(privs[0].get_pub_key(), va, vb)
        with pytest.raises(Exception, match="invalid signature"):
            ev.validate("test-chain")

    def test_wrong_chain_id_rejected(self):
        vs, privs = make_val_set(4)
        va, vb = _conflicting_pair(privs[0], vs)
        ev = DuplicateVoteEvidence.new(privs[0].get_pub_key(), va, vb)
        with pytest.raises(Exception, match="invalid signature"):
            ev.validate("other-chain")


class TestEvidencePool:
    def test_add_dedup_and_invalid_dropped(self):
        vs, privs = make_val_set(4)
        pool = EvidencePool()
        va, vb = _conflicting_pair(privs[0], vs)
        ev = DuplicateVoteEvidence.new(privs[0].get_pub_key(), va, vb)
        assert pool.add(ev, "test-chain")
        assert not pool.add(ev, "test-chain")  # dedup
        # arrival-order-swapped pair is the SAME evidence
        ev2 = DuplicateVoteEvidence.new(privs[0].get_pub_key(), vb, va)
        assert not pool.add(ev2, "test-chain")
        # invalid evidence silently refused
        bad = DuplicateVoteEvidence.new(privs[1].get_pub_key(), va, vb)
        assert not pool.add(bad, "test-chain")
        assert pool.size() == 1

    def test_bounded(self):
        vs, privs = make_val_set(4)
        pool = EvidencePool(max_size=2)
        for r in range(3):
            va, vb = _conflicting_pair(privs[0], vs, round_=r)
            assert pool.add(
                DuplicateVoteEvidence.new(privs[0].get_pub_key(), va, vb),
                "test-chain",
            )
        assert pool.size() == 2  # oldest evicted


def test_byzantine_double_vote_recorded_and_served():
    """The byzantine drill's assertion: a validator's
    conflicting prevotes arriving at a live ConsensusState are detected
    (the same ConflictingVotesError site the reference logs-and-punts
    at, state.go:1438-1447), validated against the validator's real key,
    recorded in the pool, and served by the `evidence` RPC route."""
    from tests.test_torch_reactors import make_genesis, make_node

    doc, pvs = make_genesis(2)
    node = make_node(doc, pvs[0])
    cs = node.cs
    vs = cs.rs.validators
    # the OTHER validator double-signs height 1 prevotes
    byz = pvs[1]
    va, vb = _conflicting_pair(byz, vs, chain_id=doc.chain_id)
    fired: list = []
    if cs.evsw is not None:
        from tendermint_tpu_torch.types import events as tev

        cs.evsw.add_listener_for_event(
            "ev-test", tev.EVENT_EVIDENCE, fired.append
        )
    cs.try_add_vote(va, "peer1")
    cs.try_add_vote(vb, "peer1")
    assert cs.evidence_pool.size() == 1
    assert fired and fired[0]["type"] == "duplicate_vote"
    ev = cs.evidence_pool.list()[0]
    assert ev.address == byz.get_address()
    assert {ev.vote_a.block_id.key(), ev.vote_b.block_id.key()} == {
        BLOCK_A.key(), BLOCK_B.key()
    }

    # the RPC route serves it (the JAX package's route over the port's
    # ConsensusState: rpc/ is not ported yet)
    from tendermint_tpu.rpc.core.handlers import evidence as evidence_route

    class _Ctx:
        consensus_state = cs

    rep = evidence_route(_Ctx())
    assert rep["count"] == 1
    assert rep["evidence"][0]["validator_address"] == byz.get_address().hex().upper()
    assert rep["evidence"][0]["type"] == "duplicate_vote"


# -- evidence commits: the block-embedding path --------------------------------


class TestEvidenceData:
    def _section(self, privs, vs, rounds=(0,), chain_id="test-chain"):
        from tendermint_tpu_torch.types.evidence import EvidenceData

        evs = []
        for r in rounds:
            va, vb = _conflicting_pair(privs[0], vs, round_=r, chain_id=chain_id)
            evs.append(DuplicateVoteEvidence.new(privs[0].get_pub_key(), va, vb))
        return EvidenceData(evs)

    def test_hash_empty_and_roundtrips(self):
        from tendermint_tpu_torch.codec.binary import Decoder, Encoder
        from tendermint_tpu_torch.types.evidence import EvidenceData

        vs, privs = make_val_set(4)
        assert EvidenceData().hash() == b""
        data = self._section(privs, vs, rounds=(0, 1))
        assert len(data.hash()) == 20
        e = Encoder()
        data.encode(e)
        back = EvidenceData.decode(Decoder(e.buf()))
        assert back.hash() == data.hash()
        assert EvidenceData.from_json(data.to_json()).hash() == data.hash()

    def test_validate_rejections(self):
        from tendermint_tpu_torch.types.evidence import (
            MAX_EVIDENCE_PER_BLOCK,
            EvidenceData,
            EvidenceError,
        )

        vs, privs = make_val_set(4)
        good = self._section(privs, vs)
        good.validate("test-chain", 2, vs)  # no raise
        # same-height (or future) evidence refused
        with pytest.raises(EvidenceError, match="outside"):
            good.validate("test-chain", 1, vs)
        # duplicate piece in one block refused
        dup = EvidenceData(good.evidence * 2)
        with pytest.raises(EvidenceError, match="duplicate"):
            dup.validate("test-chain", 2, vs)
        # a signer outside the validator set refused (make_val_set is
        # seed-deterministic, so build a disjoint set explicitly)
        from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
        from tendermint_tpu_torch.types import PrivValidatorFS
        from tendermint_tpu_torch.types.validator import Validator
        from tendermint_tpu_torch.types.validator_set import ValidatorSet

        other_vs = ValidatorSet(
            [
                Validator.new(
                    PrivValidatorFS(
                        gen_priv_key_ed25519(f"other-{i}".encode()), None
                    ).get_pub_key(),
                    10,
                )
                for i in range(4)
            ]
        )
        with pytest.raises(EvidenceError, match="not in the set"):
            good.validate("test-chain", 2, other_vs)
        # wrong chain (signatures don't bind) refused
        with pytest.raises(EvidenceError, match="invalid signature"):
            good.validate("other-chain", 2, vs)
        # non-canonical vote order refused (it would hash differently)
        va, vb = _conflicting_pair(privs[0], vs)
        if vb.block_id.key() < va.block_id.key():
            va, vb = vb, va
        swapped = DuplicateVoteEvidence(privs[0].get_pub_key(), vb, va)
        with pytest.raises(EvidenceError, match="canonical"):
            EvidenceData([swapped]).validate("test-chain", 2, vs)
        # oversized section refused
        big = EvidenceData(
            self._section(privs, vs, rounds=range(MAX_EVIDENCE_PER_BLOCK + 1)).evidence
        )
        with pytest.raises(EvidenceError, match="too much"):
            big.validate("test-chain", 2, vs)

    def test_block_carries_evidence_and_validates(self):
        """A devchain-committed block embeds the section; validate_block
        accepts the honest embedding and refuses a tampered one."""
        from tendermint_tpu_torch import state as _sm  # noqa: F401
        from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp
        from tendermint_tpu_torch.state import execution as sm
        from tendermint_tpu_torch.types.evidence import EvidenceData

        chain = _Chain(KVStoreApp())
        chain.build(2)
        vs = chain.state.validators
        priv = chain.pv
        va, vb = _conflicting_pair(
            priv, vs, height=1, chain_id=chain.state.chain_id
        )
        ev = DuplicateVoteEvidence.new(priv.get_pub_key(), va, vb)
        state_before = chain.state.copy()
        block = chain.commit_block(
            txs=[b"k=v"], evidence=EvidenceData([ev])
        )
        assert block.evidence.evidence and block.header.evidence_hash
        # the stored block round-trips with its evidence intact
        stored = chain.block_store.load_block(block.header.height)
        assert stored.header.evidence_hash == block.header.evidence_hash
        assert stored.evidence.evidence[0].hash() == ev.hash()
        sm.validate_block(state_before, stored)  # honest: no raise
        # tampered: strip the section but keep the header claim
        stripped = type(block)(
            stored.header, stored.data, stored.last_commit
        )
        with pytest.raises(sm.InvalidBlockError, match="evidence"):
            sm.validate_block(state_before, stripped)

    def test_header_hash_unchanged_without_evidence(self):
        """The Evidence map key only exists for non-empty sections: an
        evidence-free header hashes byte-identically to the pre-evidence
        format (cross-version fingerprint stability)."""
        from tendermint_tpu_torch.merkle.simple import simple_hash_from_map
        from tendermint_tpu_torch.types.block import Header
        from tendermint_tpu_torch.codec.binary import Encoder

        h = Header(
            chain_id="c", height=3, time_ns=7, num_txs=0,
            last_commit_hash=b"\x01" * 20, data_hash=b"\x02" * 20,
            validators_hash=b"\x03" * 20, app_hash=b"\x04" * 20,
        )
        e = Encoder()
        h.last_block_id.encode(e)
        legacy = simple_hash_from_map(
            {
                "ChainID": b"c",
                "Height": Encoder().write_varint(3).buf(),
                "Time": Encoder().write_time_ns(7).buf(),
                "NumTxs": Encoder().write_varint(0).buf(),
                "LastBlockID": e.buf(),
                "LastCommit": b"\x01" * 20,
                "Data": b"\x02" * 20,
                "Validators": b"\x03" * 20,
                "App": b"\x04" * 20,
            }
        )
        assert h.hash() == legacy
        h.evidence_hash = b"\x05" * 20
        assert h.hash() != legacy


class TestEvidencePoolCommitTracking:
    def test_pending_filters_and_mark_committed(self):
        vs, privs = make_val_set(4)
        pool = EvidencePool()
        va, vb = _conflicting_pair(privs[0], vs, height=5)
        ev = DuplicateVoteEvidence.new(privs[0].get_pub_key(), va, vb)
        assert pool.add(ev, "test-chain")
        # height gating: only strictly-older evidence is proposable
        assert pool.pending(before_height=5) == []
        assert pool.pending(before_height=6) == [ev]
        pool.mark_committed([ev])
        assert pool.pending(before_height=6) == []
        assert pool.committed_count() == 1
        # committed evidence never re-enters the pending set
        assert not pool.add(ev, "test-chain")
        assert pool.size() == 1

    def test_mark_committed_adopts_unknown_pieces(self):
        vs, privs = make_val_set(4)
        pool = EvidencePool()
        va, vb = _conflicting_pair(privs[0], vs, height=2)
        ev = DuplicateVoteEvidence.new(privs[0].get_pub_key(), va, vb)
        pool.mark_committed([ev])  # this node never detected it itself
        assert pool.size() == 1 and pool.committed_count() == 1
        assert pool.pending(before_height=100) == []
