"""The port's VoteSet against the JAX package's: the same votes, signed
with the JAX package's keys and carried into the port through their
binary bytes, go into both sets, which must agree on every add (result
or error class and message), on the bit arrays, the majority queries and
the peer claims, and on the commit they make, byte for byte. The set
mixes ed25519 and secp256k1 validators."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from tendermint_tpu.crypto.keys import gen_priv_key_ed25519, gen_priv_key_secp256k1
from tendermint_tpu.types import BlockID as JBlockID
from tendermint_tpu.types import PartSetHeader as JPSH
from tendermint_tpu.types import Validator as JValidator
from tendermint_tpu.types import ValidatorSet as JValidatorSet
from tendermint_tpu.types import Vote as JVote
from tendermint_tpu.types.vote import VOTE_TYPE_PRECOMMIT, VOTE_TYPE_PREVOTE
from tendermint_tpu.types.vote_set import VoteSet as JVoteSet
from tendermint_tpu_torch.ops.gateway import Verifier
from tendermint_tpu_torch.types import vote as tvote
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.validator_set import ValidatorSet
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.types.vote_set import VoteSet

CHAIN = "test-chain"
BLOCK_A = JBlockID(b"\xaa" * 20, JPSH(2, b"\xbb" * 20))
BLOCK_B = JBlockID(b"\xcc" * 20, JPSH(2, b"\xdd" * 20))
NIL = JBlockID()


def carry_vote_set(jset) -> VoteSet:
    """The port's VoteSet holding a JAX VoteSet's validator set (through
    its JSON) and its votes (each through its binary bytes, added with
    the port's own signature check)."""
    tset = VoteSet(jset.chain_id, jset.height, jset.round_, jset.type_,
                   ValidatorSet.from_json(jset.val_set.to_json()))
    for i in range(jset.size()):
        v = jset.get_by_index(i)
        if v is not None and not tset.add_vote(Vote.from_bytes(v.to_bytes())):
            raise AssertionError(f"vote {i} did not carry across")
    return tset


def _keys():
    """Three ed25519 validators and one secp256k1, powers 10-13, in the
    set's address order."""
    keys = [gen_priv_key_ed25519(b"vs-%d" % i) for i in range(3)] + [gen_priv_key_secp256k1(b"vs-3")]
    vs = JValidatorSet([JValidator.new(k.pub_key(), 10 + i) for i, k in enumerate(keys)])
    keys.sort(key=lambda k: k.pub_key().address())
    return vs, keys


def _vote(key, idx, height=1, round_=0, type_=VOTE_TYPE_PRECOMMIT, block_id=BLOCK_A, addr=None):
    v = JVote(addr or key.pub_key().address(), idx, height, round_, type_, block_id)
    return v.with_signature(key.sign(v.sign_bytes(CHAIN)))


def _tampered(vote):
    raw = bytearray(vote.signature.raw)
    raw[-1] ^= 1
    return vote.with_signature(type(vote.signature)(bytes(raw)))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # compared across the two packages by name and text
        return (type(exc).__name__, str(exc))


def _pair(type_=VOTE_TYPE_PRECOMMIT, height=1):
    jvs, keys = _keys()
    jset = JVoteSet(CHAIN, height, 0, type_, jvs)
    return jset, carry_vote_set(jset), keys


def _add_both(jset, tset, jvote):
    got = _outcome(lambda: tset.add_vote(Vote.from_bytes(jvote.to_bytes())))
    want = _outcome(lambda: jset.add_vote(jvote))
    assert got == want, jvote
    return got


def _same_state(jset, tset):
    assert repr(tset.bit_array()) == repr(jset.bit_array())
    assert repr(tset) == repr(jset)
    assert tset.has_two_thirds_majority() == jset.has_two_thirds_majority()
    assert tset.has_two_thirds_any() == jset.has_two_thirds_any()
    assert tset.has_all() == jset.has_all()
    assert tset.is_commit() == jset.is_commit()
    maj = jset.two_thirds_majority()
    assert (tset.two_thirds_majority() or BlockID()).to_json() == (maj or NIL).to_json()
    for i in range(jset.size()):
        jv, tv = jset.get_by_index(i), tset.get_by_index(i)
        assert (tv.to_bytes() if tv else None) == (jv.to_bytes() if jv else None)
        addr = jset.val_set.validators[i].address
        assert repr(tset.get_by_address(addr)) == repr(jset.get_by_address(addr))
    for bid in (BLOCK_A, BLOCK_B):
        jb, tb = jset.bit_array_by_block_id(bid), tset.bit_array_by_block_id(BlockID.from_json(bid.to_json()))
        assert repr(tb) == repr(jb)


def _cases(keys):
    """name -> the votes to add in order (the last one is the probe)."""
    k = keys
    ed = next(i for i, x in enumerate(k) if x.TYPE == 1)
    sec = next(i for i, x in enumerate(k) if x.TYPE == 2)
    return {
        "quorum_in_order": [_vote(k[i], i) for i in range(4)],
        "duplicate_is_false": [_vote(k[0], 0), _vote(k[0], 0)],
        "wrong_height": [_vote(k[0], 0, height=2)],
        "wrong_round": [_vote(k[0], 0, round_=1)],
        "wrong_type": [_vote(k[0], 0, type_=VOTE_TYPE_PREVOTE)],
        "index_out_of_range": [_vote(k[0], 9)],
        "address_mismatch": [_vote(k[0], 1)],
        "bad_ed25519_signature": [_tampered(_vote(k[ed], ed))],
        "bad_secp256k1_signature": [_tampered(_vote(k[sec], sec))],
        "different_signature_same_vote": [_vote(k[0], 0), _vote(k[0], 0).with_signature(_vote(k[1], 1).signature)],
        "missing_signature": [JVote(k[0].pub_key().address(), 0, 1, 0, VOTE_TYPE_PRECOMMIT, BLOCK_A)],
        "conflicting_votes": [_vote(k[0], 0), _vote(k[0], 0, block_id=BLOCK_B)],
        "nil_votes_count_in_sum": [_vote(k[i], i, block_id=NIL) for i in range(3)],
        "conflict_after_maj23_replaces_canonical": [
            _vote(k[0], 0, block_id=BLOCK_B), _vote(k[1], 1), _vote(k[2], 2), _vote(k[3], 3),
            _vote(k[0], 0)],
    }


@pytest.mark.parametrize("case", sorted(_cases(_keys()[1])))
def test_add_vote_same_results_and_errors_as_jax(case):
    jset, tset, keys = _pair()
    outcomes = [_add_both(jset, tset, v) for v in _cases(keys)[case]]
    want_last = {
        "duplicate_is_false": ("ok", False),
        "wrong_height": ("UnexpectedStepError", "expected 1/0/2, got 2/0/2"),
        "index_out_of_range": ("InvalidValidatorIndexError", "9"),
        "missing_signature": ("InvalidSignatureError", "missing signature"),
        "conflicting_votes": ("ConflictingVotesError", "conflicting votes"),
    }
    if case in want_last:
        assert outcomes[-1] == want_last[case]
    _same_state(jset, tset)


def test_error_classes_are_vote_errors():
    for name in ("UnexpectedStepError", "InvalidValidatorIndexError",
                 "InvalidValidatorAddressError", "InvalidSignatureError", "ConflictingVotesError"):
        assert issubclass(getattr(tvote, name), tvote.VoteError)
    jset, tset, keys = _pair()
    first = _vote(keys[0], 0)
    _add_both(jset, tset, first)
    with pytest.raises(tvote.ConflictingVotesError) as info:
        tset.add_vote(Vote.from_bytes(_vote(keys[0], 0, block_id=BLOCK_B).to_bytes()))
    assert info.value.vote_a.to_bytes() == first.to_bytes()
    assert info.value.vote_b.block_id.to_json() == BLOCK_B.to_json()
    with pytest.raises(ValueError, match="height 0"):
        VoteSet(CHAIN, 0, 0, VOTE_TYPE_PRECOMMIT, tset.val_set)


def test_peer_maj23_tracks_a_conflicting_block_as_jax_does():
    jset, tset, keys = _pair()
    for i in range(3):
        _add_both(jset, tset, _vote(keys[i], i))
    jset.set_peer_maj23("peer-1", BLOCK_B)
    tset.set_peer_maj23("peer-1", BlockID.from_json(BLOCK_B.to_json()))
    jset.set_peer_maj23("peer-1", BLOCK_A)  # a peer's first claim stands
    tset.set_peer_maj23("peer-1", BlockID.from_json(BLOCK_A.to_json()))
    # a conflicting vote for the claimed block is tracked, and still raises
    outcome = _add_both(jset, tset, _vote(keys[0], 0, block_id=BLOCK_B))
    assert outcome[0] == "ConflictingVotesError"
    assert tset.bit_array_by_block_id(BlockID.from_json(BLOCK_B.to_json())).get_index(0)
    _same_state(jset, tset)


def test_make_commit_bytes_equal_jax():
    jset, tset, keys = _pair()
    outcome = lambda s: _outcome(lambda: s.make_commit())  # noqa: E731
    assert outcome(tset) == outcome(jset) == ("ValueError", "cannot make commit without +2/3 majority")
    for i in (0, 2, 3):
        _add_both(jset, tset, _vote(keys[i], i))
    _add_both(jset, tset, _vote(keys[1], 1, block_id=NIL))
    jc, tc = jset.make_commit(), tset.make_commit()
    assert tc.to_bytes() == jc.to_bytes()
    assert tc.hash() == jc.hash()
    assert tc.to_json() == jc.to_json()
    tvs = ValidatorSet.from_json(jset.val_set.to_json())
    tvs.verify_commit(CHAIN, BlockID.from_json(BLOCK_A.to_json()), 1, tc)
    pj, pt, _ = _pair(type_=VOTE_TYPE_PREVOTE)
    assert outcome(pt) == outcome(pj) == ("ValueError", "commit requires precommit vote set")


def test_split_add_with_a_primed_verifier_equals_jax_add_vote():
    """begin_add for a run of votes, one primed batch through the port's
    Verifier (the plain kernel for the ed25519 lanes, the CPU for the
    secp256k1 lane), then commit_add with verify_one's verdicts."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain kernel is bound by per-op overhead
    try:
        jset, tset, keys = _pair()
        votes = [_vote(keys[i], i) for i in range(4)]
        votes[2] = _tampered(votes[2])
        pendings = [tset.begin_add(Vote.from_bytes(v.to_bytes())) for v in votes]
        assert tset.begin_add(Vote.from_bytes(votes[0].to_bytes())) is not None  # not added yet
        v = Verifier(min_tpu_batch=1, device="cpu")
        v.prime_cache_async([p.item() for p in pendings])
        got = [_outcome(lambda p=p: p.commit(v.verify_one(*p.item()))) for p in pendings]
        want = [_outcome(lambda jv=jv: jset.add_vote(jv)) for jv in votes]
        assert got == want
        assert [g[0] for g in got] == ["ok", "ok", "InvalidSignatureError", "ok"]
        st = v.stats()
        assert st["tpu_batches"] == 1 and st["tpu_sigs"] == 3 and st["cpu_sigs"] == 1
        _same_state(jset, tset)
        # a pending whose vote landed meanwhile degrades to a duplicate
        late = tset.begin_add(Vote.from_bytes(_vote(keys[2], 2).to_bytes()))
        assert late.commit(True) is True
        assert tset.commit_add(late, True) is False
    finally:
        torch.set_num_threads(before)


def test_secp256k1_votes_carry_across_byte_identical():
    _, keys = _keys()
    for idx, key in enumerate(keys):
        jv = _vote(key, idx)
        tv = Vote.from_bytes(jv.to_bytes())
        assert tv.to_bytes() == jv.to_bytes()
        assert Vote.from_json(jv.to_json()).to_json() == jv.to_json()
        assert (tv.signature.TYPE, tv.signature.raw) == (key.TYPE, jv.signature.raw)
    unsigned = dataclasses.replace(jv, signature=None).to_bytes()  # ends in type byte 0
    assert Vote.from_bytes(unsigned).to_bytes() == unsigned
    with pytest.raises(ValueError, match="unknown signature type 3"):
        Vote.from_bytes(unsigned[:-1] + b"\x03")
