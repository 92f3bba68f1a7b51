"""The port's aggregate commits against the JAX package's: validator sets,
commits and aggregates are built and signed with the JAX package, carried
into the port by their JSON and wire forms, and then encoded, hashed and
verified by both.

Bytes, hashes and JSON must be identical, and every verify route must
accept, or refuse with the JAX package's exact CommitError message. The
port verifies through a CPU `Verifier` (the dsm kernel's plain version)
installed as the gateway's default verifier; the JAX package through its
pure-Python CPU verifier.
"""

from __future__ import annotations

import pytest

from tendermint_tpu.codec.binary import Decoder as JDecoder
from tendermint_tpu.crypto import ed25519_agg as jagg
from tendermint_tpu.crypto.keys import gen_priv_key_ed25519
from tendermint_tpu.libs.bitarray import BitArray as JBitArray
from tendermint_tpu.ops import gateway as jgateway
from tendermint_tpu.types import BlockID as JBlockID
from tendermint_tpu.types import Commit as JCommit
from tendermint_tpu.types import PartSetHeader as JPSH
from tendermint_tpu.types import Validator as JValidator
from tendermint_tpu.types import ValidatorSet as JValidatorSet
from tendermint_tpu.types import Vote as JVote
from tendermint_tpu.types import VOTE_TYPE_PRECOMMIT
from tendermint_tpu.types.agg_commit import AggregateCommit as JAgg
from tendermint_tpu.types.agg_commit import decode_commit as j_decode_commit
from tendermint_tpu.types.validator_set import CommitError as JCommitError
from tendermint_tpu_torch.codec.binary import Decoder
from tendermint_tpu_torch.crypto import ed25519_agg
from tendermint_tpu_torch.libs.bitarray import BitArray
from tendermint_tpu_torch.ops import ed25519 as ted32
from tendermint_tpu_torch.ops import gateway
from tendermint_tpu_torch.types.agg_commit import (
    AggregateCommit,
    commit_from_json,
    commit_is_aggregate,
    decode_commit,
)
from tendermint_tpu_torch.types.block import Commit
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.validator_set import CommitError, ValidatorSet

CHAIN = "test-chain"
BLOCK_ID = JBlockID(b"\xaa" * 20, JPSH(2, b"\xbb" * 20))
OTHER_BLOCK = JBlockID(b"\xcc" * 20, JPSH(1, b"\xdd" * 20))
HEIGHT = 5
N_VALS = 4


@pytest.fixture(scope="module")
def jax_net():
    """(JAX set, keys in address order, a fully signed JAX Commit)."""
    keys = [gen_priv_key_ed25519(f"agg-{i}".encode()) for i in range(N_VALS)]
    vs = JValidatorSet([JValidator.new(k.pub_key(), 10 + i) for i, k in enumerate(keys)])
    keys.sort(key=lambda k: k.pub_key().address())
    pres = []
    for i, k in enumerate(keys):
        v = JVote(k.pub_key().address(), i, HEIGHT, 0, VOTE_TYPE_PRECOMMIT, BLOCK_ID)
        pres.append(v.with_signature(k.sign(v.sign_bytes(CHAIN))))
    return vs, keys, JCommit(BLOCK_ID, pres)


@pytest.fixture
def verifiers(monkeypatch):
    """The port's default verifier on the CPU, the JAX package's its pure-
    Python CPU verifier; returns the port's."""
    v = gateway.Verifier(min_tpu_batch=1, device="cpu")
    monkeypatch.setattr(gateway, "_default_verifier", v)
    monkeypatch.setattr(jgateway, "_default_verifier", jgateway.Verifier(use_tpu=False))
    return v


def _port(jobj, cls):
    return cls.from_json(jobj.to_json())


def _forged(jagg_commit):
    forged = JAgg.from_bytes(jagg_commit.to_bytes())
    s = int.from_bytes(forged.s_agg, "little")
    forged.s_agg = ((s + 1) % jagg.L).to_bytes(32, "little")
    return forged


def _dropped_bit(jagg_commit):
    tampered = JAgg.from_bytes(jagg_commit.to_bytes())
    tampered.signers.set_index(0, False)
    tampered.rs = tampered.rs[1:]
    return tampered


def _sub_quorum(jvs, keys, jcommit):
    """A well-formed aggregate of two of the four signers: the crypto
    holds, the power does not."""
    items = [(k.pub_key().raw, p.sign_bytes(CHAIN), p.signature.raw)
             for k, p in zip(keys[:2], jcommit.precommits[:2])]
    rs, s_agg = jagg.aggregate(items)
    return JAgg(BLOCK_ID, HEIGHT, 0, JBitArray.from_indices(N_VALS, [0, 1]), rs, s_agg)


CASES = {
    # case -> (aggregate maker, height, block id verified against)
    "valid": (lambda vs, keys, c: JAgg.from_commit(c, CHAIN, vs), HEIGHT, BLOCK_ID),
    "forged_scalar": (lambda vs, keys, c: _forged(JAgg.from_commit(c, CHAIN, vs)), HEIGHT, BLOCK_ID),
    "dropped_bit": (lambda vs, keys, c: _dropped_bit(JAgg.from_commit(c, CHAIN, vs)), HEIGHT, BLOCK_ID),
    "sub_quorum": (_sub_quorum, HEIGHT, BLOCK_ID),
    "wrong_height": (lambda vs, keys, c: JAgg.from_commit(c, CHAIN, vs), HEIGHT + 1, BLOCK_ID),
    "wrong_block": (lambda vs, keys, c: JAgg.from_commit(c, CHAIN, vs), HEIGHT, OTHER_BLOCK),
}


def _outcome(fn, err_type):
    try:
        fn()
    except err_type as exc:
        return str(exc)
    return None


def test_aggregate_carries_across_byte_identical(jax_net):
    jvs, _, jc = jax_net
    ja = JAgg.from_commit(jc, CHAIN, jvs)
    by_json = AggregateCommit.from_json(ja.to_json())
    by_wire = AggregateCommit.from_bytes(ja.to_bytes())
    for ta in (by_json, by_wire):
        assert ta.to_bytes() == ja.to_bytes()
        assert ta.hash() == ja.hash()
        assert ta.to_json() == ja.to_json()
        assert ta.sign_message(CHAIN) == ja.sign_message(CHAIN)
        assert ta.validate_basic() == ja.validate_basic() is None
        assert (ta.height(), ta.round_(), ta.size(), ta.num_signers()) == (
            ja.height(), ja.round_(), ja.size(), ja.num_signers())
        assert repr(ta) == repr(ja)
    assert by_json.signers.to_json() == ja.signers.to_json()
    assert BitArray.from_json(ja.signers.to_json()).indices() == ja.signers.indices()


def test_from_commit_in_the_port_gives_jax_bytes(jax_net):
    jvs, _, jc = jax_net
    tvs = _port(jvs, ValidatorSet)
    ta = AggregateCommit.from_commit(_port(jc, Commit), CHAIN, tvs)
    assert ta.to_bytes() == JAgg.from_commit(jc, CHAIN, jvs).to_bytes()
    # sub-quorum aggregation is refused with the same message
    short = JCommit(BLOCK_ID, jc.precommits[:2] + [None, None])
    want = _outcome(lambda: JAgg.from_commit(short, CHAIN, jvs), JCommitError)
    got = _outcome(lambda: AggregateCommit.from_commit(_port(short, Commit), CHAIN, tvs), CommitError)
    assert got == want and want.startswith("aggregable precommits carry only")


def test_decode_commit_dispatch_and_refusal(jax_net):
    jvs, _, jc = jax_net
    wire = JAgg.from_commit(jc, CHAIN, jvs).to_bytes()
    want = _outcome(lambda: j_decode_commit(JDecoder(wire), aggregate_commits=False), ValueError)
    got = _outcome(lambda: decode_commit(Decoder(wire), aggregate_commits=False), ValueError)
    assert got == want and want.startswith("aggregate commit refused")
    agg = decode_commit(Decoder(wire), aggregate_commits=True)
    assert commit_is_aggregate(agg) and agg.to_bytes() == wire
    full = decode_commit(Decoder(jc.to_bytes()), aggregate_commits=True)
    assert not commit_is_aggregate(full)
    assert full.to_bytes() == jc.to_bytes() and full.hash() == jc.hash()
    assert commit_from_json(agg.to_json()).to_bytes() == wire
    assert commit_from_json(jc.to_json()).to_bytes() == jc.to_bytes()
    with pytest.raises(ValueError, match="trailing bytes"):
        AggregateCommit.from_bytes(wire + b"\x00")


@pytest.mark.parametrize("route", ["verify_commit", "verify_commit_async", "verify_commits_async"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_same_outcome_as_jax(jax_net, verifiers, case, route):
    jvs, keys, jc = jax_net
    make, height, jbid = CASES[case]
    ja = make(jvs, keys, jc)
    tvs, ta, tbid = _port(jvs, ValidatorSet), _port(ja, AggregateCommit), _port(jbid, BlockID)

    def run(vs, bid, agg, verifier):
        if route == "verify_commit":
            return lambda: vs.verify_commit(CHAIN, bid, height, agg)
        if route == "verify_commit_async":
            return lambda: vs.verify_commit_async(CHAIN, bid, height, agg, verifier.verify_batch_async)()
        return lambda: vs.verify_commits_async(CHAIN, [(bid, height, agg)], verifier.verify_batch_async)[0]()

    want = _outcome(run(jvs, jbid, ja, jgateway._default_verifier), JCommitError)
    got = _outcome(run(tvs, tbid, ta, verifiers), CommitError)
    assert got == want
    assert (want is None) == (case == "valid")
    lanes = verifiers.stats()["agg_lanes_device"]
    if case in ("valid", "forged_scalar", "dropped_bit"):
        assert lanes == ta.num_signers() + 1  # the crypto ran, on the device route
    else:
        assert lanes == 0  # refused before any curve math


def test_aggregate_beside_plain_commits_in_one_group(jax_net, verifiers):
    jvs, _, jc = jax_net
    tvs, tc = _port(jvs, ValidatorSet), _port(jc, Commit)
    ta = AggregateCommit.from_json(JAgg.from_commit(jc, CHAIN, jvs).to_json())
    bid = _port(BLOCK_ID, BlockID)
    finishers = tvs.verify_commits_async(
        CHAIN, [(bid, HEIGHT, tc), (bid, HEIGHT, ta), (bid, HEIGHT + 1, ta)],
        verifiers.verify_batch_async)
    finishers[0]()
    finishers[1]()
    with pytest.raises(CommitError, match="wrong height: 6 vs 5"):
        finishers[2]()
    s = verifiers.stats()
    assert s["tpu_batches"] == 1 and s["tpu_sigs"] == N_VALS and s["agg_batches"] == 1


def test_verify_aggregate_size_gate(jax_net):
    jvs, _, jc = jax_net
    ja = JAgg.from_commit(jc, CHAIN, jvs)
    pubs = [jvs.get_by_index(i)[1].pub_key.raw for i in ja.signers.indices()]
    args = (pubs, [ja.sign_message(CHAIN)] * len(pubs), ja.rs, ja.s_agg)
    lanes = len(pubs) + 1
    jv = jgateway.Verifier(min_tpu_batch=lanes + 1, use_tpu=False)
    below = gateway.Verifier(min_tpu_batch=lanes + 1, device="cpu")
    before = ted32.launches
    assert below.verify_aggregate(*args) is jv.verify_aggregate(*args) is True
    assert below.stats() == jv.stats()  # agg_lanes_cpu moved, nothing else
    assert below.stats()["agg_lanes_cpu"] == lanes
    at = gateway.Verifier(min_tpu_batch=lanes, device="cpu")
    assert at.verify_aggregate(*args) is True
    assert at.stats()["agg_lanes_device"] == lanes and at.stats()["agg_batches"] == 1
    assert at.stats()["agg_lanes_cpu"] == 0
    assert ted32.launches == before  # the plain version is not a launch
    assert at.verify_aggregate(pubs, args[1], ja.rs, b"\xff" * 32) is False  # s >= L: no lanes
    assert at.stats()["agg_lanes_device"] == lanes
    assert ed25519_agg.verify_aggregate(*args) is jagg.verify_aggregate(*args)


def test_aggregate_verify_needs_a_card_by_default(jax_net, monkeypatch):
    """With no verifier passed, the port's aggregate verify reaches the
    card: no card is an error, not the pure-Python reference."""
    import torch

    jvs, _, jc = jax_net
    ta = AggregateCommit.from_json(JAgg.from_commit(jc, CHAIN, jvs).to_json())
    monkeypatch.setattr(gateway, "_default_verifier", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ta.verify(CHAIN, _port(jvs, ValidatorSet))
