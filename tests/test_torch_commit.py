"""The port's commit path against the JAX package's: validator sets and
commits are built and signed with the JAX package, carried into the port
through their JSON forms, and then hashed and verified by both.

Hashes, sign bytes and encodings must be byte-identical, and
verify_commit must accept or raise CommitError with the same message.
"""

from __future__ import annotations

import pytest

from tendermint_tpu.crypto.keys import SignatureEd25519 as JSig
from tendermint_tpu.crypto.keys import gen_priv_key_ed25519
from tendermint_tpu.ops.gateway import Verifier as JaxVerifier
from tendermint_tpu.types import BlockID as JBlockID
from tendermint_tpu.types import Commit as JCommit
from tendermint_tpu.types import PartSetHeader as JPSH
from tendermint_tpu.types import Validator as JValidator
from tendermint_tpu.types import ValidatorSet as JValidatorSet
from tendermint_tpu.types import Vote as JVote
from tendermint_tpu.types import VOTE_TYPE_PRECOMMIT, VOTE_TYPE_PREVOTE
from tendermint_tpu.types.validator_set import CommitError as JCommitError
from tendermint_tpu_torch.crypto.keys import PubKeyEd25519
from tendermint_tpu_torch.ops.gateway import Verifier
from tendermint_tpu_torch.types.block import Commit
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.validator import Validator
from tendermint_tpu_torch.types.validator_set import CommitError, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote

CHAIN = "test-chain"
BLOCK_ID = JBlockID(b"\xaa" * 20, JPSH(2, b"\xbb" * 20))
NIL = JBlockID()
N_VALS = 4


def _jax_set(n=N_VALS, power=10):
    """(set, keys in the set's address order); powers differ per key."""
    keys = [gen_priv_key_ed25519(f"tv-{i}".encode()) for i in range(n)]
    vs = JValidatorSet([JValidator.new(k.pub_key(), power + i) for i, k in enumerate(keys)])
    keys.sort(key=lambda k: k.pub_key().address())
    return vs, keys


def _vote(key, idx, height=1, round_=0, type_=VOTE_TYPE_PRECOMMIT, block_id=BLOCK_ID):
    v = JVote(key.pub_key().address(), idx, height, round_, type_, block_id)
    return v.with_signature(key.sign(v.sign_bytes(CHAIN)))


def _jax_commit(keys, signers):
    """Commit over len(keys) slots; `signers` maps slot -> vote kwargs
    (or {} for a plain precommit for BLOCK_ID)."""
    return JCommit(
        BLOCK_ID,
        [_vote(k, i, **signers[i]) if i in signers else None for i, k in enumerate(keys)],
    )


def _all(n, **kw):
    return {i: dict(kw) for i in range(n)}


def _tampered(commit):
    i = next(i for i, p in enumerate(commit.precommits) if p)
    bad = bytearray(commit.precommits[i].signature.raw)
    bad[0] ^= 1
    commit.precommits[i] = commit.precommits[i].with_signature(JSig(bytes(bad)))
    return commit


CASES = {
    "valid": lambda keys: (_jax_commit(keys, _all(4)), 1),
    "valid_three_of_four": lambda keys: (_jax_commit(keys, _all(3)), 1),
    "tampered": lambda keys: (_tampered(_jax_commit(keys, _all(4))), 1),
    "sub_quorum": lambda keys: (_jax_commit(keys, _all(2)), 1),
    "wrong_height": lambda keys: (_jax_commit(keys, _all(4)), 2),
    "wrong_size": lambda keys: (JCommit(BLOCK_ID, _jax_commit(keys, _all(4)).precommits[:3]), 1),
    "nil_precommit_counted_out": lambda keys: (
        _jax_commit(keys, {0: {}, 1: {}, 2: {"block_id": NIL}, 3: {"block_id": NIL}}), 1),
    "nil_precommit_quorum_holds": lambda keys: (
        _jax_commit(keys, {0: {}, 1: {}, 2: {}, 3: {"block_id": NIL}}), 1),
    "wrong_round": lambda keys: (_jax_commit(keys, {0: {}, 1: {}, 2: {}, 3: {"round_": 1}}), 1),
    "not_a_precommit": lambda keys: (
        _jax_commit(keys, {0: {}, 1: {}, 2: {}, 3: {"type_": VOTE_TYPE_PREVOTE}}), 1),
}


def _outcome(fn, err_type):
    try:
        fn()
    except err_type as exc:
        return str(exc)
    return None


@pytest.fixture(scope="module")
def jax_set():
    return _jax_set()


def test_validator_set_carries_across_byte_identical(jax_set):
    jvs, _ = jax_set
    tvs = ValidatorSet.from_json(jvs.to_json())
    assert tvs.hash() == jvs.hash()
    assert tvs.to_json() == jvs.to_json()
    assert tvs.total_voting_power() == jvs.total_voting_power()
    for i in range(jvs.size()):
        assert tvs.get_by_index(i)[0] == jvs.get_by_index(i)[0]
    # a set built in the port from the same keys is the same set
    built = ValidatorSet([
        Validator.new(PubKeyEd25519(v.pub_key.raw), v.voting_power) for v in reversed(jvs.validators)
    ])
    fresh = JValidatorSet([JValidator.new(v.pub_key, v.voting_power) for v in jvs.validators])
    assert built.to_json() == fresh.to_json()
    assert built.hash() == jvs.hash()


def test_commit_and_votes_carry_across_byte_identical(jax_set):
    jvs, keys = jax_set
    jc = CASES["nil_precommit_quorum_holds"](keys)[0]
    jc.precommits[2] = None
    tc = Commit.from_json(jc.to_json())
    assert tc.to_json() == jc.to_json()
    assert tc.hash() == jc.hash()
    assert tc.height() == jc.height() and tc.round_() == jc.round_()
    assert tc.validate_basic() == jc.validate_basic()
    for jp, tp in zip(jc.precommits, tc.precommits):
        if jp is None:
            assert tp is None
            continue
        assert tp.sign_bytes(CHAIN) == jp.sign_bytes(CHAIN)
        assert tp.to_bytes() == jp.to_bytes()
        assert repr(tp) == repr(jp)
        assert Vote.from_json(jp.to_json()).to_json() == jp.to_json()
    assert BlockID.from_json(BLOCK_ID.to_json()).canonical() == {
        "hash": BLOCK_ID.hash, "parts": {"hash": BLOCK_ID.parts_header.hash, "total": 2}
    }
    assert Commit.from_json(JCommit(NIL, []).to_json()).validate_basic() == "commit cannot be for nil block"


@pytest.mark.parametrize("route", ["sequential", "device_route"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_commit_same_outcome_as_jax(jax_set, case, route):
    jvs, keys = jax_set
    jc, height = CASES[case](keys)
    tvs = ValidatorSet.from_json(jvs.to_json())
    tc = Commit.from_json(jc.to_json())
    tbid = BlockID.from_json(BLOCK_ID.to_json())
    want = _outcome(lambda: jvs.verify_commit(CHAIN, BLOCK_ID, height, jc), JCommitError)
    if route == "sequential":
        bv = None
    else:
        v = Verifier(min_tpu_batch=1, device="cpu")  # the kernel's plain version
        bv = v.commit_batch_verifier()
    got = _outcome(lambda: tvs.verify_commit(CHAIN, tbid, height, tc, batch_verifier=bv), CommitError)
    assert got == want
    if case.startswith("valid") or case.endswith("quorum_holds"):
        assert want is None


def test_verify_commits_async_four_commits_one_bad(jax_set):
    jvs, keys = jax_set
    jcs = []
    for h in range(1, 5):
        jcs.append(_jax_commit(keys, {i: {"height": h} for i in range(4)}))
    _tampered(jcs[2])
    tvs = ValidatorSet.from_json(jvs.to_json())
    tbid = BlockID.from_json(BLOCK_ID.to_json())
    v = Verifier(min_tpu_batch=1, device="cpu")
    t_fin = tvs.verify_commits_async(
        CHAIN, [(tbid, h, Commit.from_json(c.to_json())) for h, c in enumerate(jcs, 1)],
        v.verify_batch_async,
    )
    j_fin = jvs.verify_commits_async(
        CHAIN, [(BLOCK_ID, h, c) for h, c in enumerate(jcs, 1)],
        JaxVerifier(use_tpu=False).verify_batch_async,
    )
    got = [_outcome(f, CommitError) for f in t_fin]
    want = [_outcome(f, JCommitError) for f in j_fin]
    assert got == want
    assert [g is None for g in got] == [True, True, False, True]
    assert v.stats()["tpu_batches"] == 1 and v.stats()["tpu_sigs"] == 16


def test_structurally_bad_commit_in_group_raises_at_its_finisher(jax_set):
    jvs, keys = jax_set
    good = Commit.from_json(_jax_commit(keys, _all(4)).to_json())
    tvs = ValidatorSet.from_json(jvs.to_json())
    tbid = BlockID.from_json(BLOCK_ID.to_json())
    fin = tvs.verify_commits_async(
        CHAIN, [(tbid, 1, good), (tbid, 5, good)], Verifier(device="cpu").verify_batch_async
    )
    fin[0]()
    with pytest.raises(CommitError, match="wrong height: 5 vs 1"):
        fin[1]()


def test_non_commit_is_refused_clearly(jax_set):
    """Neither a Commit nor an AggregateCommit (aggregates are verified
    now; tests/test_torch_agg_commit.py): refused with the error type the
    JAX package raises."""
    jvs, _ = jax_set
    tvs = ValidatorSet.from_json(jvs.to_json())
    with pytest.raises(AttributeError) as mine:
        tvs.verify_commit(CHAIN, BlockID(), 1, object())
    with pytest.raises(AttributeError) as theirs:
        jvs.verify_commit(CHAIN, JBlockID(), 1, object())
    assert str(mine.value) == str(theirs.value)
