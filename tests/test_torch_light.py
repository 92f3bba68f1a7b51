"""The port's light client (tendermint_tpu_torch/rpc/light.py) against the
JAX package's.

tests/test_light.py's 12 cases run here on the port: a stub client serves
crafted chain data so the validator-change rule — adopt a new set only
when the OLD trusted set still signed > 2/3 of its power on the
transition commit — is tested for both the accept and the forged-set
cases, and across pruned gaps. Beside them: tests/test_statetree.py's
TestVerifiedQuery (state-tree proofs against light-verified headers, on
the port's DevChain), tests/test_vote_batch.py's batched turnover check,
tests/test_upgrade.py's aggregate overlap check, and the cross-package
cases: each package's LightClient walks the other's DevChain RPC stub to
the same headers, values and refusals."""

from __future__ import annotations

import importlib
import json
import types

import pytest

from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
from tendermint_tpu_torch.rpc.light import LightClient, LightClientError
from tendermint_tpu_torch.types import PrivValidatorFS
from tendermint_tpu_torch.types.block import Header
from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, Vote

CHAIN = "light-test-chain"


def _pv():
    return PrivValidatorFS(gen_priv_key_ed25519(), None)


def _commit_for(header: Header, vset: ValidatorSet, privs: dict):
    """Sign a +2/3 commit over `header` by every validator of `vset`
    that has a priv key in `privs` (address -> pv)."""
    from tendermint_tpu_torch.types.block import Commit

    block_id = BlockID(header.hash(), PartSetHeader(1, b"\x01" * 20))
    precommits: list = [None] * vset.size()
    for i in range(vset.size()):
        addr, val = vset.get_by_index(i)
        pv = privs.get(addr)
        if pv is None:
            continue
        vote = Vote(
            validator_address=addr,
            validator_index=i,
            height=header.height,
            round_=0,
            type_=VOTE_TYPE_PRECOMMIT,
            block_id=block_id,
        )
        precommits[i] = pv.sign_vote(CHAIN, vote)
    return Commit(block_id, precommits)


def _header(height: int, vset: ValidatorSet, last_block_id=None) -> Header:
    return Header(
        chain_id=CHAIN,
        height=height,
        time_ns=height * 1000,
        num_txs=0,
        last_block_id=last_block_id or BlockID(),
        last_commit_hash=b"\x02" * 20,
        data_hash=b"\x03" * 20,
        validators_hash=vset.hash(),
        app_hash=b"",
    )


class StubClient:
    def __init__(self):
        self.commits: dict = {}  # height -> {"header":..., "commit":...}
        self.valsets: dict = {}  # height -> ValidatorSet

    def add_height(self, header, commit, vset):
        self.commits[header.height] = {
            "header": header.to_json(),
            "commit": commit.to_json(),
        }
        self.valsets[header.height] = vset

    def commit(self, height):
        return self.commits[height]

    def validators(self, height=0):
        return {
            "block_height": height,
            "validators": self.valsets[height].to_json(),
        }


def _chain_with_change(old_signs_transition: bool):
    """Heights 1-2 under set {v1}; at height 3 the set becomes {v1, v2}
    (or {attacker} when old_signs_transition is False)."""
    pv1, pv2 = _pv(), _pv()
    v1 = Validator.new(pv1.get_pub_key(), 2)
    v2 = Validator.new(pv2.get_pub_key(), 1)
    old_set = ValidatorSet([v1.copy()])
    privs = {pv1.get_address(): pv1, pv2.get_address(): pv2}

    stub = StubClient()
    prev_id = None
    for h in (1, 2):
        hd = _header(h, old_set, prev_id)
        stub.add_height(hd, _commit_for(hd, old_set, privs), old_set)
        prev_id = BlockID(hd.hash(), PartSetHeader(1, b"\x01" * 20))

    if old_signs_transition:
        new_set = ValidatorSet([v1.copy(), v2.copy()])
    else:
        atk = _pv()
        privs[atk.get_address()] = atk
        new_set = ValidatorSet([Validator.new(atk.get_pub_key(), 5)])
    hd3 = _header(3, new_set, prev_id)
    stub.add_height(hd3, _commit_for(hd3, new_set, privs), new_set)
    return stub, old_set


def test_advance_accepts_overlapping_validator_change():
    stub, old_set = _chain_with_change(old_signs_transition=True)
    lc = LightClient(stub, CHAIN, old_set.copy())
    lc.advance(3)
    assert lc.height == 3
    assert lc.validators.size() == 2


def test_advance_rejects_forged_validator_set():
    """A self-consistent forged set + commit (signed only by attacker
    keys) must NOT be adopted: the trusted set signed none of its
    power on the transition."""
    stub, old_set = _chain_with_change(old_signs_transition=False)
    lc = LightClient(stub, CHAIN, old_set.copy())
    with pytest.raises(LightClientError, match="trusted set signed only"):
        lc.advance(3)


def test_advance_rejects_replayed_precommit_stuffing():
    """Condition (d) must only credit old-set power for
    precommits over THIS commit's block. A vote's sign-bytes exclude the
    validator index/address, so an attacker can re-wrap genuine old-set
    precommits replayed from the real chain (same height/round, the REAL
    block) into a forged commit over a forged block; without the block_id
    filter those replays satisfy (d) with zero old-set endorsement."""
    from tendermint_tpu_torch.types.block import Commit

    pv1 = _pv()
    v1 = Validator.new(pv1.get_pub_key(), 2)
    old_set = ValidatorSet([v1.copy()])
    privs = {pv1.get_address(): pv1}
    stub = StubClient()
    prev_id = None
    for h in (1, 2):
        hd = _header(h, old_set, prev_id)
        stub.add_height(hd, _commit_for(hd, old_set, privs), old_set)
        prev_id = BlockID(hd.hash(), PartSetHeader(1, b"\x01" * 20))

    # the REAL height-3 block the honest chain committed — the source of
    # the replayable precommit material
    real_hd3 = _header(3, old_set, prev_id)
    real_block_id = BlockID(real_hd3.hash(), PartSetHeader(1, b"\x01" * 20))

    # the forged chain: {v1, attacker} with the attacker holding +2/3 of
    # the NEW set, so the new-set tally passes on attacker signatures alone
    atk = _pv()
    new_set = ValidatorSet([v1.copy(), Validator.new(atk.get_pub_key(), 100)])
    forged_hd3 = _header(3, new_set, prev_id)
    forged_block_id = BlockID(forged_hd3.hash(), PartSetHeader(1, b"\x01" * 20))
    precommits: list = [None] * new_set.size()
    for i in range(new_set.size()):
        addr, _ = new_set.get_by_index(i)
        if addr == pv1.get_address():
            # replayed genuine precommit: v1's signature covers only
            # (block_id, height, round, type), so index/address re-wrap
            # is free for the attacker
            vote = Vote(addr, i, 3, 0, VOTE_TYPE_PRECOMMIT, real_block_id)
            precommits[i] = pv1.sign_vote(CHAIN, vote)
        else:
            vote = Vote(addr, i, 3, 0, VOTE_TYPE_PRECOMMIT, forged_block_id)
            precommits[i] = atk.sign_vote(CHAIN, vote)
    stub.add_height(forged_hd3, Commit(forged_block_id, precommits), new_set)

    lc = LightClient(stub, CHAIN, old_set.copy())
    with pytest.raises(LightClientError, match="trusted set signed only"):
        lc.advance(3)
    assert lc.validators.hash() == old_set.hash()


def test_failed_advance_does_not_install_candidate_set():
    """If verify_header rejects the transition commit
    AFTER the old-set-overlap check passed, the candidate set must not be
    left installed as trusted — a catching caller would otherwise verify
    all later headers against the attacker's set."""
    pv1, pv2, pv3 = _pv(), _pv(), _pv()
    v1 = Validator.new(pv1.get_pub_key(), 3)
    old_set = ValidatorSet([v1.copy()])
    privs = {pv1.get_address(): pv1, pv2.get_address(): pv2}  # pv3 never signs
    stub = StubClient()
    prev_id = None
    for h in (1, 2):
        hd = _header(h, old_set, prev_id)
        stub.add_height(hd, _commit_for(hd, old_set, privs), old_set)
        prev_id = BlockID(hd.hash(), PartSetHeader(1, b"\x01" * 20))
    # transition commit signed by v1+v2 only: the OLD-set overlap passes
    # (v1 is 100% of old power) but the NEW set's +2/3 tally fails (pv3
    # holds most of the new power and did not sign)
    new_set = ValidatorSet([
        v1.copy(),
        Validator.new(pv2.get_pub_key(), 1),
        Validator.new(pv3.get_pub_key(), 100),
    ])
    hd3 = _header(3, new_set, prev_id)
    stub.add_height(hd3, _commit_for(hd3, new_set, privs), new_set)

    lc = LightClient(stub, CHAIN, old_set.copy())
    with pytest.raises(LightClientError, match="commit verification failed"):
        lc.advance(3)
    assert lc.validators.hash() == old_set.hash()
    assert lc.height == 2
    # and the client still works against the honest chain from there
    lc.verify_header(2)


def test_set_change_at_trust_anchor_cannot_skip_chain_link():
    """A validator-set change landing on the FIRST height
    an advance() call processes used to skip the last_block_id chain-link
    check (prev_header was None). Out-of-band trust anchors are now
    verified before the walk, so a change at the anchor height cannot
    bypass chain linkage."""
    pv1, pv2 = _pv(), _pv()
    v1 = Validator.new(pv1.get_pub_key(), 2)
    old_set = ValidatorSet([v1.copy()])
    privs = {pv1.get_address(): pv1, pv2.get_address(): pv2}
    stub = StubClient()
    prev_id = None
    for h in (1, 2):
        hd = _header(h, old_set, prev_id)
        stub.add_height(hd, _commit_for(hd, old_set, privs), old_set)
        prev_id = BlockID(hd.hash(), PartSetHeader(1, b"\x01" * 20))
    # height 3 changes the set AND chains to garbage; its commit is
    # self-consistent and v1 signs it, so both the overlap and the
    # new-set tally would pass — only the chain link betrays it
    new_set = ValidatorSet([v1.copy(), Validator.new(pv2.get_pub_key(), 1)])
    bad_link = BlockID(b"\xee" * 20, PartSetHeader(1, b"\x01" * 20))
    hd3 = _header(3, new_set, bad_link)
    stub.add_height(hd3, _commit_for(hd3, new_set, privs), new_set)

    lc = LightClient(stub, CHAIN, old_set.copy(), trusted_height=3)
    with pytest.raises(LightClientError):
        lc.advance(3)
    assert lc.validators.hash() == old_set.hash()


def test_advance_rejects_unchained_header():
    """A validator change whose header does not chain to the verified
    previous header is rejected (the chain-link check runs before any
    commit verification)."""
    stub, old_set = _chain_with_change(old_signs_transition=True)
    hj = dict(stub.commits[3]["header"])
    hj["last_block_id"] = BlockID(
        b"\xee" * 20, PartSetHeader(1, b"\x01" * 20)
    ).to_json()
    stub.commits[3] = {"header": hj, "commit": stub.commits[3]["commit"]}
    lc = LightClient(stub, CHAIN, old_set.copy())
    with pytest.raises(LightClientError, match="does not chain"):
        lc.advance(3)


# -- >1/3 validator-set turnover (the statesync restore trust path) ----------
#
# A snapshot restore light-walks from its trust anchor to the snapshot
# height, so it must survive validator-set changes where MORE THAN A
# THIRD of the set turns over in one height — beyond the classic
# bisection skip-verify limit, fine for the sequential rule as long as
# the surviving old validators still carry > 2/3 of the OLD set's power
# on the transition commit (rpc/light.py _check_old_set_overlap).


def test_advance_accepts_over_one_third_turnover():
    """Old set {v1:7, v2:2}; the new set keeps only v1 and adds two
    newcomers holding 40/47 of the new power — way past 1/3 turnover.
    v1 alone carries 7/9 > 2/3 of the OLD power, so the sequential rule
    adopts the set; the walk then continues under it."""
    pv1, pv2, pv3, pv4 = _pv(), _pv(), _pv(), _pv()
    v1 = Validator.new(pv1.get_pub_key(), 7)
    old_set = ValidatorSet([v1.copy(), Validator.new(pv2.get_pub_key(), 2)])
    privs = {pv.get_address(): pv for pv in (pv1, pv2, pv3, pv4)}

    stub = StubClient()
    prev_id = None
    for h in (1, 2):
        hd = _header(h, old_set, prev_id)
        stub.add_height(hd, _commit_for(hd, old_set, privs), old_set)
        prev_id = BlockID(hd.hash(), PartSetHeader(1, b"\x01" * 20))

    new_set = ValidatorSet([
        v1.copy(),
        Validator.new(pv3.get_pub_key(), 20),
        Validator.new(pv4.get_pub_key(), 20),
    ])
    hd3 = _header(3, new_set, prev_id)
    stub.add_height(hd3, _commit_for(hd3, new_set, privs), new_set)
    prev_id = BlockID(hd3.hash(), PartSetHeader(1, b"\x01" * 20))
    # one more height under the NEW set: trust must keep walking
    hd4 = _header(4, new_set, prev_id)
    stub.add_height(hd4, _commit_for(hd4, new_set, privs), new_set)

    lc = LightClient(stub, CHAIN, old_set.copy())
    lc.advance(4)
    assert lc.height == 4
    assert lc.validators.hash() == new_set.hash()


def test_advance_rejects_exactly_two_thirds_old_overlap():
    """The overlap rule is STRICTLY greater than 2/3: a transition where
    the surviving old validators carry exactly 2/3 of the old power must
    be refused (the boundary an attacker holding 1/3 of the old keys
    would otherwise exploit)."""
    pv1, pv2 = _pv(), _pv()
    v1 = Validator.new(pv1.get_pub_key(), 2)
    old_set = ValidatorSet([v1.copy(), Validator.new(pv2.get_pub_key(), 1)])
    privs = {pv1.get_address(): pv1, pv2.get_address(): pv2}

    stub = StubClient()
    prev_id = None
    for h in (1, 2):
        hd = _header(h, old_set, prev_id)
        stub.add_height(hd, _commit_for(hd, old_set, privs), old_set)
        prev_id = BlockID(hd.hash(), PartSetHeader(1, b"\x01" * 20))

    # v2 (1/3 of old power) is dropped; only v1 (exactly 2/3) survives to
    # sign. The attacker dominates the new set so ITS +2/3 tally passes.
    atk = _pv()
    privs[atk.get_address()] = atk
    new_set = ValidatorSet([v1.copy(), Validator.new(atk.get_pub_key(), 100)])
    hd3 = _header(3, new_set, prev_id)
    stub.add_height(hd3, _commit_for(hd3, new_set, privs), new_set)

    lc = LightClient(stub, CHAIN, old_set.copy())
    with pytest.raises(LightClientError, match="signed only 2/3"):
        lc.advance(3)
    assert lc.validators.hash() == old_set.hash()
    assert lc.height == 2


# -- pruned-source horizon jump (bounded retention) ----------------------------


class PrunedStubClient(StubClient):
    """A source that pruned history below `base`: commits below it
    error exactly like the live RPC handler, and /status attests the
    earliest retained height."""

    def __init__(self, base: int):
        super().__init__()
        self.base = base
        self.commit_calls: list[int] = []

    def commit(self, height):
        self.commit_calls.append(height)
        if height < self.base:
            raise RuntimeError(
                f"height {height} is below the store's base {self.base}"
            )
        return super().commit(height)

    def status(self):
        return {
            "latest_block_height": max(self.commits, default=0),
            "earliest_block_height": self.base,
        }


def _pruned_chain(n: int, base: int, change_at: int | None = None,
                  old_signs_transition: bool = True):
    """n heights under {v1} (power 2), optionally switching sets at
    `change_at`; the stub only SERVES heights >= base."""
    pv1, pv2 = _pv(), _pv()
    v1 = Validator.new(pv1.get_pub_key(), 2)
    v2 = Validator.new(pv2.get_pub_key(), 1)
    genesis_set = ValidatorSet([v1.copy()])
    privs = {pv1.get_address(): pv1, pv2.get_address(): pv2}
    stub = PrunedStubClient(base)
    prev_id = None
    cur_set = genesis_set
    for h in range(1, n + 1):
        if change_at is not None and h == change_at:
            if old_signs_transition:
                cur_set = ValidatorSet([v1.copy(), v2.copy()])
            else:
                atk = _pv()
                privs[atk.get_address()] = atk
                cur_set = ValidatorSet([Validator.new(atk.get_pub_key(), 5)])
        hd = _header(h, cur_set, prev_id)
        stub.add_height(hd, _commit_for(hd, cur_set, privs), cur_set)
        prev_id = BlockID(hd.hash(), PartSetHeader(1, b"\x01" * 20))
    return stub, genesis_set


def test_advance_jumps_pruned_gap_same_set():
    """Genesis trust against a source whose base is 8: the sequential
    walk cannot fetch 1..7, but the trusted set's +2/3 signature on the
    horizon commit carries trust across the gap directly."""
    stub, genesis_set = _pruned_chain(12, base=8)
    lc = LightClient(stub, CHAIN, genesis_set.copy())
    lc.advance(12)
    assert lc.height == 12
    # exactly one failed probe below the base, then the jump
    assert stub.commit_calls[0] == 1
    assert 2 not in stub.commit_calls, "walk retried inside the pruned gap"
    assert stub.commit_calls[1] == 8


def test_advance_jumps_pruned_gap_with_overlapping_set_change():
    """The set changed INSIDE the pruned gap but the old trusted set
    still carries > 2/3 of its power on the horizon commit: rule (d)
    transfers trust without the (unknowable) chain linkage."""
    stub, genesis_set = _pruned_chain(12, base=8, change_at=5)
    lc = LightClient(stub, CHAIN, genesis_set.copy())
    lc.advance(12)
    assert lc.height == 12
    assert lc.validators.size() == 2


def test_advance_rejects_forged_set_across_pruned_gap():
    """A forged set past the pruned gap (zero old-set power on the
    horizon commit) must NOT be adopted — lying about the prune horizon
    weakens nothing."""
    stub, genesis_set = _pruned_chain(12, base=8, change_at=5,
                                      old_signs_transition=False)
    lc = LightClient(stub, CHAIN, genesis_set.copy())
    with pytest.raises(LightClientError, match="trusted set signed only"):
        lc.advance(12)
    assert lc.height == 0  # trust never moved


def test_advance_reraises_when_no_pruned_gap_attested():
    """A commit fetch failure WITHOUT a pruned-gap attestation (status
    shows the height should exist) re-raises: real transport errors must
    not silently skip verification."""
    stub, genesis_set = _pruned_chain(12, base=1)

    real_commit = stub.commit

    def flaky(height):
        if height == 3:
            raise RuntimeError("connection reset")
        return real_commit(height)

    stub.commit = flaky
    lc = LightClient(stub, CHAIN, genesis_set.copy())
    with pytest.raises(RuntimeError, match="connection reset"):
        lc.advance(12)
    assert lc.height == 2  # trust stopped exactly before the failure


# -- tests/test_statetree.py's TestVerifiedQuery, on the port ------------------


class TestVerifiedQuery:
    def _chain(self, n=6):
        from tendermint_tpu_torch.statesync.devchain import build_kvstore_chain

        chain = build_kvstore_chain(n)
        lc = LightClient(
            chain.rpc_stub(), chain.genesis_doc.chain_id,
            chain.state.load_validators(1), trusted_height=0,
        )
        return chain, lc

    def test_membership_and_absence(self):
        chain, lc = self._chain()
        head = chain.block_store.height()
        res = lc.verified_query(b"k5-0", height=head - 1)
        assert res["value"] == b"v5" and not res["absent"]
        assert res["height"] == head - 1
        gone = lc.verified_query(b"never-written", height=head - 1)
        assert gone["absent"] and gone["value"] is None

    def test_head_proof_needs_next_header(self):
        chain, lc = self._chain()
        head = chain.block_store.height()
        with pytest.raises(LightClientError, match="header"):
            lc.verified_query(b"k5-0", height=head)
        chain.build(1)  # header head+1 now exists
        res = lc.verified_query(b"k5-0", height=head)
        assert res["value"] == b"v5"

    def test_header_memo_one_verification_per_burst(self):
        """A 100-query burst at one height verifies that height's commit
        ONCE — repeat proofs ride the verified-header memo (every /commit
        fetch implies a verification, so counting fetches counts
        verifications)."""
        chain, lc = self._chain()
        head = chain.block_store.height()
        real = chain.rpc_stub()
        calls = {"commit": 0}

        class Counting:
            def __getattr__(self, name):
                return getattr(real, name)

            def commit(self, **kw):
                calls["commit"] += 1
                return real.commit(**kw)

        lc.client = Counting()
        first = lc.verified_query(b"k5-0", height=head - 1)
        assert first["value"] == b"v5"
        walked = calls["commit"]
        assert walked >= 1
        for _ in range(100):
            res = lc.verified_query(b"k5-0", height=head - 1)
            assert res["value"] == b"v5"
        assert calls["commit"] == walked

    def test_lying_node_detected(self):
        chain, lc = self._chain()
        head = chain.block_store.height()
        real = chain.rpc_stub()

        class Liar:
            def __getattr__(self, name):
                return getattr(real, name)

            def abci_query(self, **kw):
                out = real.abci_query(**kw)
                out["response"]["value"] = b"forged".hex().upper()
                return out

        lc.client = Liar()
        with pytest.raises(LightClientError, match="value"):
            lc.verified_query(b"k5-0", height=head - 1)

    def test_forged_proof_detected(self):
        chain, lc = self._chain()
        head = chain.block_store.height()
        real = chain.rpc_stub()

        class ProofForger:
            def __getattr__(self, name):
                return getattr(real, name)

            def abci_query(self, **kw):
                out = real.abci_query(**kw)
                raw = json.loads(bytes.fromhex(out["response"]["proof"]))
                step = raw["steps"][-1]
                flip = bytearray(bytes.fromhex(step[1]))
                flip[0] ^= 0x01
                step[1] = flip.hex().upper()
                out["response"]["proof"] = (
                    json.dumps(raw).encode().hex().upper()
                )
                return out

        lc.client = ProofForger()
        with pytest.raises(LightClientError, match="proof"):
            lc.verified_query(b"k5-0", height=head - 1)

    def test_unsupported_app_refused_loudly(self):
        from tendermint_tpu_torch.abci.apps.counter import CounterApp
        from tendermint_tpu_torch.statesync.devchain import DevChain

        chain = DevChain(CounterApp())
        chain.build(3)
        lc = LightClient(
            chain.rpc_stub(), chain.genesis_doc.chain_id,
            chain.state.load_validators(1), trusted_height=0,
        )
        with pytest.raises(LightClientError, match="proofs unsupported"):
            lc.verified_query(b"hash", height=2)


# -- the batched turnover checks (tests/test_vote_batch.py, test_upgrade.py) ---


def test_light_turnover_check_batches():
    """_check_old_set_overlap flushes its candidate signatures in one
    batch_verifier call with the tally unchanged."""
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT as PRE
    from test_torch_consensus import TEST_CHAIN_ID, rand_gen_state

    state, pvs = rand_gen_state(4)
    old_set = state.validators
    bid = BlockID(b"\x31" * 20)
    pres = []
    for i, pv in enumerate(pvs):
        v = Vote(pv.get_address(), i, 3, 0, PRE, bid)
        pres.append(pv.sign_vote(TEST_CHAIN_ID, v))
    from tendermint_tpu_torch.types.block import Commit

    commit = Commit(bid, pres)
    calls = []

    def counting_batch(items):
        calls.append(list(items))
        return gateway._cpu_verify_batch(list(items))

    lc = LightClient(None, TEST_CHAIN_ID, old_set, batch_verifier=counting_batch)
    # same-set "turnover": every old signer present -> accepted
    lc._check_old_set_overlap(3, commit, old_set)
    assert len(calls) == 1 and len(calls[0]) == 4
    # a disjoint new set leaves no creditable old power -> refused
    strangers = ValidatorSet([
        Validator.new(gen_priv_key_ed25519(bytes([7, i]) * 16).pub_key(), 1)
        for i in range(4)
    ])
    with pytest.raises(LightClientError):
        lc._check_old_set_overlap(3, commit, strangers)


def test_light_client_aggregate_overlap(monkeypatch):
    """tests/test_upgrade.py's TestAggregateRefusal case: the aggregate
    form of the overlap check verifies the aggregate against the new set
    (the port's default verifier, here on the CPU) and credits the old
    set's power over the signer bitmap."""
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit
    from test_torch_agg_commit import CHAIN as AGG_CHAIN
    from test_torch_agg_commit import _signed_commit

    monkeypatch.setattr(gateway, "_default_verifier", gateway.Verifier(min_tpu_batch=1, device="cpu"))
    vs, commit, height = _signed_commit()
    agg = AggregateCommit.from_commit(commit, AGG_CHAIN, vs)
    # trusted set IS the signing set: full old-set overlap, accepted
    LightClient(None, AGG_CHAIN, vs, height - 1)._check_old_set_overlap_aggregate(height, agg, vs)
    # a disjoint trusted set gets zero old-power from the bitmap
    old_privs = [gen_priv_key_ed25519(f"old-{i}".encode()) for i in range(4)]
    old_set = ValidatorSet([Validator.new(p.pub_key(), 10) for p in old_privs])
    lc = LightClient(None, AGG_CHAIN, old_set, height - 1)
    with pytest.raises(LightClientError):
        lc._check_old_set_overlap_aggregate(height, agg, vs)
    # and a forged aggregate never reaches the overlap tally
    forged = AggregateCommit.from_bytes(agg.to_bytes())
    forged.s_agg = bytes(32)
    lc_ok = LightClient(None, AGG_CHAIN, vs, height - 1)
    with pytest.raises(LightClientError, match="failed"):
        lc_ok._check_old_set_overlap_aggregate(height, forged, vs)


# -- across the packages --------------------------------------------------------


def _pkg(root: str) -> types.SimpleNamespace:
    light = importlib.import_module(f"{root}.rpc.light")
    return types.SimpleNamespace(
        LightClient=light.LightClient, LightClientError=light.LightClientError,
        devchain=importlib.import_module(f"{root}.statesync.devchain"),
        ValidatorSet=importlib.import_module(f"{root}.types.validator_set").ValidatorSet,
    )


PKGS = {"port": _pkg("tendermint_tpu_torch"), "jax": _pkg("tendermint_tpu")}


def _walk(walker, chain, stub=None) -> dict:
    """`walker`'s LightClient over `chain`'s RPC stub (or `stub`), trusting
    the genesis set: the headers it verifies to the chain's height less
    one, and verified reads of present and absent keys there."""
    head = chain.block_store.height()
    trusted = walker.ValidatorSet.from_json(chain.state.load_validators(1).to_json())
    lc = walker.LightClient(stub or chain.rpc_stub(), chain.genesis_doc.chain_id, trusted, 0)
    lc.advance(head - 1)
    reads = {k: lc.verified_query(k, height=head - 2) for k in (b"k3-0", b"k4-1", b"never-written")}
    return {
        "headers": [lc.header_at(h).hash() for h in range(1, head)],
        "height": lc.height,
        "reads": {k: (r["value"], r["absent"], r["height"]) for k, r in reads.items()},
    }


@pytest.mark.parametrize("walker,serving", [("port", "jax"), ("jax", "port")])
def test_light_client_walks_the_other_packages_chain(walker, serving):
    """Each package's LightClient walks the other package's DevChain (the
    same seeded validator, so the same chain) to the same headers and the
    same verified values as its own package's walk."""
    other = _walk(PKGS[walker], PKGS[serving].devchain.build_kvstore_chain(6))
    own = _walk(PKGS[walker], PKGS[walker].devchain.build_kvstore_chain(6))
    assert other == own
    assert other["reads"][b"k3-0"] == (b"v3", False, 4)
    assert other["reads"][b"never-written"] == (None, True, 4)


class _ForgedCommit:
    """An RPC stub whose commit at `height` carries a flipped signature."""

    def __init__(self, real, height: int):
        self.real, self.height = real, height

    def __getattr__(self, name):
        return getattr(self.real, name)

    def commit(self, height):
        out = self.real.commit(height=height)
        if int(height) == self.height:
            out = json.loads(json.dumps(out))
            pre = out["commit"]["precommits"][0]
            sig = bytearray(bytes.fromhex(pre["signature"][1]))
            sig[5] ^= 0x20
            pre["signature"][1] = sig.hex().upper()
        return out


@pytest.mark.parametrize("walker,serving", [("port", "jax"), ("jax", "port")])
def test_light_client_refusals_equal_across_packages(walker, serving):
    """A forged commit and a lying query value served by one package's
    chain are refused by the other package's LightClient with the same
    message as by its own package's, trust stopping at the same height."""

    def refusals(p, chain):
        head = chain.block_store.height()
        trusted = p.ValidatorSet.from_json(chain.state.load_validators(1).to_json())
        lc = p.LightClient(_ForgedCommit(chain.rpc_stub(), 3), chain.genesis_doc.chain_id, trusted, 0)
        with pytest.raises(p.LightClientError) as forged:
            lc.advance(head - 1)
        real = chain.rpc_stub()

        class Liar:
            def __getattr__(self, name):
                return getattr(real, name)

            def abci_query(self, **kw):
                out = real.abci_query(**kw)
                out["response"]["value"] = b"forged".hex().upper()
                return out

        liar = p.LightClient(Liar(), chain.genesis_doc.chain_id, trusted, 0)
        with pytest.raises(p.LightClientError) as lied:
            liar.verified_query(b"k3-0", height=head - 2)
        return str(forged.value), lc.height, str(lied.value)

    got = refusals(PKGS[walker], PKGS[serving].devchain.build_kvstore_chain(6))
    own = refusals(PKGS[walker], PKGS[walker].devchain.build_kvstore_chain(6))
    assert got == own
    assert got[1] == 2 and "commit verification failed" in got[0]
