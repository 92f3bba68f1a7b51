"""The port's vote micro-batching (consensus/vote_batcher.py) and its split
add (types/vote_set.py begin_add / finish_add) on the CPU: the cases of
tests/test_vote_batch.py, with the port's CPU Verifier where the JAX
package's take its CPU verifier.
"""

from __future__ import annotations

import threading
import time

import pytest

from test_torch_consensus import host_device  # noqa: F401
from test_torch_consensus import TEST_CHAIN_ID, ValidatorStub, make_cs_and_stubs, rand_gen_state
from tendermint_tpu_torch.consensus import messages as msgs
from tendermint_tpu_torch.consensus.state import MsgInfo
from tendermint_tpu_torch.consensus.vote_batcher import VoteBatcher
from tendermint_tpu_torch.ops import gateway
from tendermint_tpu_torch.types import (
    VOTE_TYPE_PRECOMMIT,
    VOTE_TYPE_PREVOTE,
    BlockID,
    VoteSet,
)
from tendermint_tpu_torch.types.vote import (
    ConflictingVotesError,
    InvalidSignatureError,
    InvalidValidatorAddressError,
    InvalidValidatorIndexError,
    UnexpectedStepError,
)


def _wait_until(cond, timeout=30.0, tick=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


def _byz_vote(pv, index, type_, block_id, height=1, round_=0):
    """Sign bypassing the PrivValidatorFS double-sign guard — a real
    byzantine signer uses the raw key (test_evidence's convention)."""
    from tendermint_tpu_torch.types import Vote

    vote = Vote(
        validator_address=pv.get_address(),
        validator_index=index,
        height=height,
        round_=round_,
        type_=type_,
        block_id=block_id,
    )
    return vote.with_signature(pv.priv_key.sign(vote.sign_bytes(TEST_CHAIN_ID)))


def _forge(vote):
    """Same vote, forged signature bytes (still 64B ed25519 shape)."""
    from dataclasses import replace

    from tendermint_tpu_torch.crypto.keys import SignatureEd25519

    raw = bytearray(vote.signature.raw)
    raw[0] ^= 0xFF
    return replace(vote, signature=SignatureEd25519(bytes(raw)))


BID = BlockID(b"\x21" * 20)


class TestSplitAddParity:
    """begin_add/commit_add must be add_vote case-for-case: the split
    path is what the batcher drives, and it may never drift."""

    def _vs_and_stubs(self, n=4):
        state, pvs = rand_gen_state(n)
        vs = VoteSet(TEST_CHAIN_ID, 1, 0, VOTE_TYPE_PREVOTE, state.validators)
        return vs, [ValidatorStub(pv, i) for i, pv in enumerate(pvs)]

    def test_valid_vote_both_paths(self):
        vs, stubs = self._vs_and_stubs()
        v = stubs[0].sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, BID)
        pending = vs.begin_add(v)
        assert pending is not None
        pk, sb, sig = pending.item()
        assert sb == v.sign_bytes(TEST_CHAIN_ID) and sig == v.signature.raw
        assert pending.commit(True) is True
        assert vs.get_by_index(0) is not None
        # exact duplicate: begin_add returns None (add_vote's False)
        assert vs.begin_add(v) is None
        assert vs.add_vote(v) is False

    def test_error_taxonomy_preserved(self):
        vs, stubs = self._vs_and_stubs()
        from dataclasses import replace

        good = stubs[1].sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, BID)
        with pytest.raises(UnexpectedStepError):
            vs.begin_add(replace(good, height=7))
        with pytest.raises(InvalidValidatorIndexError):
            vs.begin_add(replace(good, validator_index=99))
        with pytest.raises(InvalidValidatorAddressError):
            vs.begin_add(replace(good, validator_address=b"\x01" * 20))
        with pytest.raises(InvalidSignatureError):
            vs.begin_add(replace(good, signature=None))
        # a failed verdict rejects exactly this vote
        pending = vs.begin_add(good)
        with pytest.raises(InvalidSignatureError):
            pending.commit(False)
        assert vs.get_by_index(1) is None
        # ...and the vote can still be added with a passing verdict
        assert vs.begin_add(good).commit(True)

    def test_conflict_raises_at_commit(self):
        vs, stubs = self._vs_and_stubs()
        a = _byz_vote(stubs[2].pv, 2, VOTE_TYPE_PREVOTE, BID)
        b = _byz_vote(stubs[2].pv, 2, VOTE_TYPE_PREVOTE, BlockID(b"\x42" * 20))
        assert vs.begin_add(a).commit(True)
        pending = vs.begin_add(b)
        with pytest.raises(ConflictingVotesError):
            pending.commit(True)

    def test_duplicate_between_begin_and_commit_is_false(self):
        vs, stubs = self._vs_and_stubs()
        v = stubs[0].sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, BID)
        pending = vs.begin_add(v)
        assert vs.add_vote(v) is True  # interleaved add of the same vote
        assert pending.commit(True) is False  # degrades to duplicate

    def test_sign_bytes_memo_shared_across_quorum(self):
        vs, stubs = self._vs_and_stubs(8)
        sbs = set()
        for s in stubs:
            pending = vs.begin_add(
                s.sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, BID)
            )
            sbs.add(id(pending.sign_bytes))
            pending.commit(True)
        # one canonical serialization object served the whole quorum
        assert len(sbs) == 1


class TestVoteBatcher:
    def _batcher(self, min_batch=2):
        verifier = gateway.Verifier(device="cpu")
        return VoteBatcher(lambda: verifier, min_batch=min_batch), verifier

    def test_forged_lane_rejects_exactly_that_vote(self):
        """The acceptance property: one forged signature inside a mixed
        micro-batch rejects only its own vote; every other lane lands."""
        cs, stubs, prop_idx = make_cs_and_stubs(8)
        batcher = cs.vote_batcher
        votes = [
            s.sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, BID)
            for s in stubs
            if s.index != prop_idx
        ]
        forged_idx = votes[3].validator_index
        votes[3] = _forge(votes[3])
        cs.rs.validators = cs.state.validators  # rs seeded by constructor
        batcher.prepare(votes, cs.rs, TEST_CHAIN_ID)
        assert batcher.batches == 1 and batcher.batched_sigs == len(votes)
        results = {}
        for v in votes:
            try:
                results[v.validator_index] = cs.rs.votes.add_vote(
                    v, "peerX",
                    verifier=lambda pk, m, s: batcher.verdict((pk, m, s)),
                )
            except InvalidSignatureError:
                results[v.validator_index] = "rejected"
        assert results[forged_idx] == "rejected"
        good = [i for i in results if i != forged_idx]
        assert all(results[i] is True for i in good)
        prevotes = cs.rs.votes.prevotes(0)
        assert prevotes.get_by_index(forged_idx) is None
        for i in good:
            assert prevotes.get_by_index(i) is not None
        # only the forged lane fell back to a singleton re-verify... it
        # did NOT: its batch verdict was False and was consumed as such
        assert batcher.singletons == 0

    def test_double_sign_semantics_unchanged_through_batch(self):
        """Conflicting votes keep raising ConflictingVotesError (and feed
        evidence) when both ride the batched path."""
        cs, stubs, prop_idx = make_cs_and_stubs(4)
        s = next(x for x in stubs if x.index != prop_idx)
        a = _byz_vote(s.pv, s.index, VOTE_TYPE_PREVOTE, BID)
        b = _byz_vote(s.pv, s.index, VOTE_TYPE_PREVOTE, BlockID(b"\x55" * 20))
        cs.vote_batcher.prepare([a, b], cs.rs, TEST_CHAIN_ID)
        assert cs.rs.votes.add_vote(
            a, "p", verifier=lambda *it: cs.vote_batcher.verdict(it)
        )
        with pytest.raises(ConflictingVotesError):
            cs.rs.votes.add_vote(
                b, "p", verifier=lambda *it: cs.vote_batcher.verdict(it)
            )

    def test_floor_and_grouping(self):
        """Votes group per (height, round, type); groups below the
        min-batch floor stay singleton."""
        state, pvs = rand_gen_state(8)
        stubs = [ValidatorStub(pv, i) for i, pv in enumerate(pvs)]
        cs, _, _ = make_cs_and_stubs(1)
        batcher, _ = self._batcher(min_batch=4)

        class RS:
            pass

        from tendermint_tpu_torch.consensus.height_vote_set import HeightVoteSet

        rs = RS()
        rs.height = 1
        rs.votes = HeightVoteSet(TEST_CHAIN_ID, 1, state.validators)
        rs.votes.set_round(1)
        rs.last_commit = None
        pre = [s.sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, BID) for s in stubs[:5]]
        for s in stubs[5:8]:
            s.round_ = 1
        r1 = [s.sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, BID) for s in stubs[5:8]]
        batcher.prepare(pre + r1, rs, TEST_CHAIN_ID)
        # round-0 group (5 lanes) dispatched; round-1 group (3) under floor
        assert batcher.batches == 1
        assert batcher.batched_sigs == 5
        for v in r1:
            assert batcher.verdict(
                (state.validators.get_by_index(v.validator_index)[1].pub_key.raw,
                 v.sign_bytes(TEST_CHAIN_ID), v.signature.raw)
            )
        assert batcher.singletons == 3

    def test_failed_batch_raises_where_read_never_singletons(self):
        """A batch whose resolver dies re-raises where each lane's verdict
        is read, and no vote re-verifies as a singleton (the JAX package
        un-primes the lanes instead; the port's gateway keeps the error,
        so a failed device is never hidden behind CPU verifies)."""
        state, pvs = rand_gen_state(4)
        stubs = [ValidatorStub(pv, i) for i, pv in enumerate(pvs)]

        class BoomVerifier(gateway.Verifier):
            def verify_batch_async(self, items, _attempt=0):
                def resolve():
                    raise RuntimeError("transport died")

                return resolve

        boom = BoomVerifier(device="cpu")
        batcher = VoteBatcher(lambda: boom, min_batch=2)

        class RS:
            pass

        from tendermint_tpu_torch.consensus.height_vote_set import HeightVoteSet

        rs = RS()
        rs.height = 1
        rs.votes = HeightVoteSet(TEST_CHAIN_ID, 1, state.validators)
        rs.last_commit = None
        votes = [s.sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, BID) for s in stubs]
        batcher.prepare(votes, rs, TEST_CHAIN_ID)
        for v in votes:
            _, val = state.validators.get_by_index(v.validator_index)
            with pytest.raises(RuntimeError, match="transport died"):
                batcher.verdict(
                    (val.pub_key.raw, v.sign_bytes(TEST_CHAIN_ID), v.signature.raw)
                )
        assert batcher.singletons == 0

    def test_receive_routine_batches_and_counts(self):
        """End to end through the live receive routine: a 32-validator
        prevote burst rides micro-batches (counters + histogram move)
        and every vote lands."""
        from tendermint_tpu_torch.consensus import vote_batcher as cvb

        cs, stubs, prop_idx = make_cs_and_stubs(32)
        hist = cvb.vote_batch_hists()["batch"]
        count_before = hist._count if hasattr(hist, "_count") else None
        votes = [
            s.sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, BID)
            for s in stubs
            if s.index != prop_idx
        ]
        for v in votes:
            cs._inputs.put(("msg", MsgInfo(msgs.VoteMessage(v), "peer-test")))
        cs.start()
        try:
            def added():
                pv = cs.rs.votes.prevotes(0)
                if pv is None:
                    return 0
                return sum(
                    1 for s in stubs
                    if s.index != prop_idx
                    and pv.get_by_index(s.index) is not None
                )

            assert _wait_until(lambda: added() == len(votes), timeout=60), (
                f"only {added()}/{len(votes)} added"
            )
            assert cs.vote_batcher.batches >= 1
            assert cs.vote_batcher.batched_sigs >= len(votes) // 2
        finally:
            cs.stop()

    def test_serial_mode_is_pure_singleton(self):
        """vote_batching=False: no batch ever dispatches; every verdict
        is a one-signature verify (the bench's A/B seam and the WAL
        replay contract)."""
        cs, stubs, prop_idx = make_cs_and_stubs(8)
        cs.vote_batching = False
        votes = [
            s.sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, BID)
            for s in stubs
            if s.index != prop_idx
        ]
        for v in votes:
            cs._inputs.put(("msg", MsgInfo(msgs.VoteMessage(v), "peer-test")))
        cs.start()
        try:
            def added():
                pv = cs.rs.votes.prevotes(0)
                return 0 if pv is None else sum(
                    1 for s in stubs
                    if s.index != prop_idx
                    and pv.get_by_index(s.index) is not None
                )

            assert _wait_until(lambda: added() == len(votes), timeout=60)
            assert cs.vote_batcher.batches == 0
            assert cs.vote_batcher.singletons >= len(votes)
        finally:
            cs.stop()


class TestStragglerBatching:
    """The satellites: evidence and light-client turnover
    signatures route through the batch verifier."""

    def _evidence(self, n=1):
        from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence

        state, pvs = rand_gen_state(max(n, 2))
        out = []
        for i in range(n):
            # distinct block pairs per piece: evidence hashes exclude the
            # validator identity, so identical pairs would dedupe
            a = _byz_vote(pvs[i], i, VOTE_TYPE_PREVOTE,
                          BlockID(bytes([0x10 + i]) * 20))
            b = _byz_vote(pvs[i], i, VOTE_TYPE_PREVOTE,
                          BlockID(bytes([0x60 + i]) * 20))
            out.append(DuplicateVoteEvidence.new(pvs[i].get_pub_key(), a, b))
        return out, state

    def test_evidence_validate_batches(self):
        calls = []

        def counting_batch(items):
            calls.append(list(items))
            return gateway._cpu_verify_batch(list(items))

        evs, _ = self._evidence(1)
        evs[0].validate(TEST_CHAIN_ID, batch_verifier=counting_batch)
        assert len(calls) == 1 and len(calls[0]) == 2

    def test_evidence_data_one_batch_with_attribution(self):
        from dataclasses import replace

        from tendermint_tpu_torch.crypto.keys import SignatureEd25519
        from tendermint_tpu_torch.types.evidence import (
            DuplicateVoteEvidence,
            EvidenceData,
            EvidenceError,
        )

        evs, state = self._evidence(3)
        calls = []

        def counting_batch(items):
            calls.append(list(items))
            return gateway._cpu_verify_batch(list(items))

        ed = EvidenceData(list(evs))
        ed.validate(TEST_CHAIN_ID, 9, None, batch_verifier=counting_batch)
        assert len(calls) == 1 and len(calls[0]) == 6  # ONE call, 2 sigs/piece

        # forge ONE piece's vote_b: attribution names exactly that piece
        bad = evs[1]
        raw = bytearray(bad.vote_b.signature.raw)
        raw[1] ^= 0x80
        forged = DuplicateVoteEvidence(
            bad.pub_key, bad.vote_a,
            replace(bad.vote_b, signature=SignatureEd25519(bytes(raw))),
        )
        ed_bad = EvidenceData([evs[0], forged, evs[2]])
        with pytest.raises(EvidenceError, match="piece 1"):
            ed_bad.validate(
                TEST_CHAIN_ID, 9, None,
                batch_verifier=lambda items: gateway._cpu_verify_batch(items),
            )
        # the good pieces alone still validate
        EvidenceData([evs[0], evs[2]]).validate(
            TEST_CHAIN_ID, 9, None,
            batch_verifier=lambda items: gateway._cpu_verify_batch(items),
        )

class TestAggregateCommit:
    """The aggregate-commit prototype: half-aggregation correctness,
    wire/JSON round trips, the size win, the genesis format flag, and
    the mixed-net refusal."""

    def _commit(self, n=8, height=5):
        from tendermint_tpu_torch.types.block import Commit
        from tendermint_tpu_torch.types.vote import Vote

        state, pvs = rand_gen_state(n)
        bid = BlockID(b"\x44" * 20)
        pres = []
        for i, pv in enumerate(pvs):
            v = Vote(pv.get_address(), i, height, 0, VOTE_TYPE_PRECOMMIT, bid)
            pres.append(pv.sign_vote(TEST_CHAIN_ID, v))
        return Commit(bid, pres), state.validators

    def test_roundtrip_size_and_tamper(self):
        from tendermint_tpu_torch.types.agg_commit import AggregateCommit
        from tendermint_tpu_torch.types.validator_set import CommitError

        commit, vals = self._commit(8)
        agg = AggregateCommit.from_commit(commit, TEST_CHAIN_ID, vals)
        agg.verify(TEST_CHAIN_ID, vals)
        # the headline: meaningfully smaller than the full commit
        assert len(agg.to_bytes()) < 0.6 * len(commit.to_bytes())
        # wire + JSON round trips verify
        AggregateCommit.from_bytes(agg.to_bytes()).verify(TEST_CHAIN_ID, vals)
        AggregateCommit.from_json(agg.to_json()).verify(TEST_CHAIN_ID, vals)
        # tamper matrix: scalar, nonce point, signer bits
        bad = AggregateCommit.from_bytes(agg.to_bytes())
        bad.s_agg = bytes(32)
        with pytest.raises(CommitError):
            bad.verify(TEST_CHAIN_ID, vals)
        bad2 = AggregateCommit.from_bytes(agg.to_bytes())
        bad2.rs[0] = bytes(32)
        with pytest.raises(CommitError):
            bad2.verify(TEST_CHAIN_ID, vals)
        bad3 = AggregateCommit.from_bytes(agg.to_bytes())
        bad3.signers.set_index(0, False)
        with pytest.raises(CommitError):
            bad3.verify(TEST_CHAIN_ID, vals)

    def test_non_ascending_signer_indices_refused_at_decode(self):
        """Strictly-ascending signer indices are the canonical wire
        order — verify() pairs rs with signers.indices() (sorted), so
        any other order would mispair lanes and reject a valid
        aggregate; decode refuses it outright."""
        from tendermint_tpu_torch.codec.binary import Decoder, Encoder
        from tendermint_tpu_torch.types.agg_commit import AggregateCommit

        commit, vals = self._commit(8)
        agg = AggregateCommit.from_commit(commit, TEST_CHAIN_ID, vals)
        idxs = agg.signers.indices()
        swapped = [idxs[1], idxs[0]] + idxs[2:]
        e = Encoder()
        e.write_u8(0xAC)
        agg.block_id.encode(e)
        e.write_varint(agg.height())
        e.write_varint(agg.round_())
        e.write_varint(agg.signers.size)
        e.write_list(swapped, lambda enc, i: enc.write_varint(i))
        e.write_raw(b"".join(agg.rs))
        e.write_raw(agg.s_agg)
        with pytest.raises(ValueError, match="ascending"):
            AggregateCommit.decode(Decoder(e.buf()))

    def test_sub_quorum_refused(self):
        from tendermint_tpu_torch.types.agg_commit import AggregateCommit
        from tendermint_tpu_torch.types.block import Commit
        from tendermint_tpu_torch.types.validator_set import CommitError

        commit, vals = self._commit(6)
        # only 3/6 precommits: +2/3 impossible
        thin = Commit(
            commit.block_id,
            [p if i < 3 else None for i, p in enumerate(commit.precommits)],
        )
        with pytest.raises(CommitError):
            AggregateCommit.from_commit(thin, TEST_CHAIN_ID, vals)

    def test_forged_member_signature_fails_aggregate(self):
        from tendermint_tpu_torch.types.agg_commit import AggregateCommit
        from tendermint_tpu_torch.types.validator_set import CommitError

        commit, vals = self._commit(6)
        commit.precommits[2] = _forge(commit.precommits[2])
        agg = AggregateCommit.from_commit(commit, TEST_CHAIN_ID, vals)
        with pytest.raises(CommitError, match="aggregate signature"):
            agg.verify(TEST_CHAIN_ID, vals)

    def test_genesis_flag_and_mixed_net_refusal(self):
        from tendermint_tpu_torch.codec.binary import Decoder
        from tendermint_tpu_torch.types.agg_commit import AggregateCommit, decode_commit
        from tendermint_tpu_torch.types.genesis import GenesisDoc

        commit, vals = self._commit(4)
        agg = AggregateCommit.from_commit(commit, TEST_CHAIN_ID, vals)

        # the flag rides genesis; unknown values refused at load
        state, pvs = rand_gen_state(1)
        base = GenesisDoc(
            genesis_time_ns=1, chain_id="agg-chain",
            validators=[], commit_format="full",
        )
        base.validators = []  # bypass validate for the json shape check
        doc_json = {
            "genesis_time": 1, "chain_id": "agg-chain",
            "validators": [
                {"pub_key": pvs[0].get_pub_key().to_json(), "power": 1,
                 "name": "v"}
            ],
        }
        full_doc = GenesisDoc.from_json(dict(doc_json))
        agg_doc = GenesisDoc.from_json(
            dict(doc_json, commit_format="aggregate")
        )
        assert not full_doc.aggregate_commits()
        assert agg_doc.aggregate_commits()
        # the two genesis docs differ byte-for-byte: a mixed net cannot
        # silently share a chain id story
        assert full_doc.to_json() != agg_doc.to_json()
        with pytest.raises(ValueError):
            GenesisDoc.from_json(dict(doc_json, commit_format="bls"))

        # decode-side refusal: a full-format node fed aggregate bytes
        wire = agg.to_bytes()
        with pytest.raises(ValueError, match="refused"):
            decode_commit(Decoder(wire), aggregate_commits=False)
        # the aggregate-format node decodes both forms
        got = decode_commit(Decoder(wire), aggregate_commits=True)
        got.verify(TEST_CHAIN_ID, vals)
        full_wire = commit.to_bytes()
        decoded_full = decode_commit(Decoder(full_wire), aggregate_commits=True)
        assert decoded_full.height() == commit.height()


# -- the vote plane against the JAX package's ----------------------------------


def _vote_run(root: str):
    """One run of 40 prevotes through package `root`'s VoteBatcher and
    HeightVoteSet, lane 7 with a flipped signature bit: each vote's
    outcome (True, or the VoteError's type and message), the batcher's
    counts and the prevote set's bits."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    keys = mod("crypto.keys")
    types_ = mod("types")
    vote_mod = mod("types.vote")
    pvs = [mod("types.priv_validator").PrivValidatorFS(keys.gen_priv_key_ed25519(bytes([9, i]) * 16), None)
           for i in range(40)]
    vals = types_.ValidatorSet([mod("types.validator").Validator.new(pv.get_pub_key(), 1) for pv in pvs])
    pvs.sort(key=lambda pv: pv.get_address())
    hvs = mod("consensus.height_vote_set").HeightVoteSet(TEST_CHAIN_ID, 1, vals)
    bid = types_.BlockID(b"\x31" * 20)
    votes = []
    for i, pv in enumerate(pvs):
        v = pv.sign_vote(TEST_CHAIN_ID, vote_mod.Vote(pv.get_address(), i, 1, 0, vote_mod.VOTE_TYPE_PREVOTE, bid))
        if i == 7:
            raw = bytearray(v.signature.raw)
            raw[3] ^= 0x40
            v = v.with_signature(keys.SignatureEd25519(bytes(raw)))
        votes.append(v)
    if root == "tendermint_tpu_torch":
        verifier = gateway.Verifier(device="cpu")
    else:
        from tendermint_tpu.ops import gateway as jgateway

        verifier = jgateway.Verifier(use_tpu=False)
    batcher = mod("consensus.vote_batcher").VoteBatcher(lambda: verifier, min_batch=4)

    class RS:
        height = 1
        votes = hvs
        last_commit = None

    batcher.prepare(votes, RS(), TEST_CHAIN_ID)
    outcomes = []
    for v in votes:
        try:
            outcomes.append(hvs.add_vote(v, "peerX", verifier=lambda pk, m, s: batcher.verdict((pk, m, s))))
        except vote_mod.VoteError as exc:
            outcomes.append((type(exc).__name__, str(exc)))
    prevotes = hvs.prevotes(0)
    return outcomes, (batcher.batches, batcher.batched_sigs, batcher.singletons), \
        [prevotes.get_by_index(i) is not None for i in range(40)]


def test_forged_lane_run_equal_to_jax():
    """The same run of 40 votes with one forged lane through both packages'
    vote planes: equal verdicts (the forged vote alone refused, with the
    same InvalidSignatureError message), equal batch counts (one 40-lane
    micro-batch, B1's plain version in the port, no singleton) and equal
    prevote sets."""
    got = _vote_run("tendermint_tpu_torch")
    assert got == _vote_run("tendermint_tpu")
    outcomes, counts, bits = got
    assert counts == (1, 40, 0)
    assert [i for i, o in enumerate(outcomes) if o is not True] == [7]
    assert outcomes[7][0] == "InvalidSignatureError"
    assert bits == [i != 7 for i in range(40)]
