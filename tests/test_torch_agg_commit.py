"""The port's aggregate commits against the JAX package's: validator sets,
commits and aggregates are built and signed with the JAX package, carried
into the port by their JSON and wire forms, and then encoded, hashed and
verified by both.

Bytes, hashes and JSON must be identical, and every verify route must
accept, or refuse with the JAX package's exact CommitError message. Then
the cases of tests/test_upgrade.py that need neither a reactor nor a node
process run on the port: the genesis schedule, the schedule handshake and
its refusal counter, AggregateLastCommit, the refusals and the commit
dispatch, and the boundary crash replay in process. The
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


# -- the cases of tests/test_upgrade.py that need neither a reactor nor a
# -- node process, on the port --------------------------------------------------

from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519 as port_gen_key  # noqa: E402
from tendermint_tpu_torch.types.agg_commit import AggregateLastCommit  # noqa: E402
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator  # noqa: E402
from tendermint_tpu_torch.types.priv_validator import PrivValidatorFS  # noqa: E402
from tendermint_tpu_torch.types.validator import Validator  # noqa: E402
from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT as PORT_PRECOMMIT  # noqa: E402
from tendermint_tpu_torch.types.vote import Vote  # noqa: E402

UP_BLOCK_ID = BlockID(b"\xaa" * 20, __import__("tendermint_tpu_torch.types.block_id", fromlist=["x"]).PartSetHeader(
    2, b"\xbb" * 20))


def make_val_set(n, power=10):
    """n validators with equal power (tests/test_types.py's helper, on the
    port); returns (ValidatorSet, [PrivValidatorFS]) in address order."""
    privs = [PrivValidatorFS(port_gen_key(f"val-{i}".encode()), None) for i in range(n)]
    vs = ValidatorSet([Validator.new(p.get_pub_key(), power) for p in privs])
    privs.sort(key=lambda p: p.get_address())
    return vs, privs


def signed_vote(priv, vs, height, round_, type_, block_id, chain_id="test-chain"):
    idx, _ = vs.get_by_address(priv.get_address())
    vote = Vote(validator_address=priv.get_address(), validator_index=idx, height=height,
                round_=round_, type_=type_, block_id=block_id)
    return priv.sign_vote(chain_id, vote)


def _signed_commit(n=4, height=5, drop=()):
    """A fully-signed precommit Commit over UP_BLOCK_ID; indices in `drop`
    abstain (None precommit)."""
    vs, privs = make_val_set(n)
    pres = []
    for i, pv in enumerate(privs):
        if i in drop:
            pres.append(None)
            continue
        pres.append(signed_vote(pv, vs, height, 0, PORT_PRECOMMIT,
                                UP_BLOCK_ID))
    return vs, Commit(UP_BLOCK_ID, pres), height


# -- the genesis schedule ---------------------------------------------------


class TestGenesisSchedule:
    def _doc(self, **kw):
        pv = port_gen_key(b"genesis-val")
        return GenesisDoc(
            genesis_time_ns=1,
            chain_id="up-chain",
            validators=[GenesisValidator(pv.pub_key(), 10, "v0")],
            **kw,
        )

    def test_flip_below_two_refused(self):
        doc = self._doc(upgrade_height=1, upgrade_format="aggregate")
        with pytest.raises(ValueError, match="upgrade_height must be >= 2"):
            doc.validate_and_complete()

    def test_same_format_flip_refused(self):
        doc = self._doc(upgrade_height=5, upgrade_format="full")
        with pytest.raises(ValueError, match="equals commit_format"):
            doc.validate_and_complete()

    def test_format_without_height_refused(self):
        doc = self._doc(upgrade_format="aggregate")
        with pytest.raises(ValueError, match="without upgrade_height"):
            doc.validate_and_complete()

    def test_unknown_upgrade_format_refused(self):
        doc = self._doc(upgrade_height=5, upgrade_format="zip")
        with pytest.raises(ValueError, match="unknown upgrade_format"):
            doc.validate_and_complete()

    def test_format_at_height_and_schedule_string(self):
        doc = self._doc(upgrade_height=4, upgrade_format="aggregate")
        doc.validate_and_complete()
        assert doc.commit_format_at(3) == "full"
        assert doc.commit_format_at(4) == "aggregate"
        assert doc.commit_format_at(10 ** 9) == "aggregate"
        assert not doc.aggregate_commits_at(3)
        assert doc.aggregate_commits_at(4)
        assert doc.schedule_string() == "full>aggregate@4"
        # no flip scheduled: the format holds forever
        plain = self._doc()
        plain.validate_and_complete()
        assert plain.commit_format_at(10 ** 9) == "full"
        assert plain.schedule_string() == "full"

    def test_schedule_json_round_trip(self):
        doc = self._doc(upgrade_height=7, upgrade_format="aggregate")
        doc.validate_and_complete()
        obj = doc.to_json()
        assert obj["upgrade_height"] == 7
        assert obj["upgrade_format"] == "aggregate"
        back = GenesisDoc.from_json(obj)
        assert back.schedule_string() == doc.schedule_string()
        # an unscheduled doc serializes without the keys (byte-compat
        # with every pre-flag genesis)
        plain = self._doc()
        plain.validate_and_complete()
        assert "upgrade_height" not in plain.to_json()


# -- schedule-gated handshake ----------------------------------------------


def _node_info(seed: bytes, schedule: str | None, network: str = "up-net",
               legacy_format: str | None = None):
    from tendermint_tpu_torch.p2p.node_info import NodeInfo

    other = []
    if schedule is not None:
        other.append(f"commit_schedule={schedule}")
    if legacy_format is not None:
        other.append(f"commit_format={legacy_format}")
    return NodeInfo(port_gen_key(seed).pub_key(), "m", network,
                    "1/test", other=other)


class TestScheduleHandshake:
    def test_same_schedule_compatible(self):
        a = _node_info(b"a", "full>aggregate@100")
        b = _node_info(b"b", "full>aggregate@100")
        assert a.compatible_with(b) is None

    def test_schedule_mismatch_named(self):
        # same format TODAY, different flip height — the disagreement
        # that forks AT the flip, so it must refuse at the handshake
        a = _node_info(b"a", "full>aggregate@100")
        b = _node_info(b"b", "full>aggregate@200")
        reason = a.compatible_with(b)
        assert reason is not None
        assert reason.startswith("commit schedule mismatch")
        assert "full>aggregate@100" in reason

    def test_legacy_format_flag_fallback(self):
        # an older peer advertises only commit_format=; an unscheduled
        # node reads as schedule "full" and stays compatible
        old = _node_info(b"a", None, legacy_format="full")
        new = _node_info(b"b", "full")
        assert new.compatible_with(old) is None
        flipped = _node_info(b"c", "full>aggregate@4")
        assert flipped.compatible_with(old) is not None


class _FakeStream:
    def close(self):
        pass


class _FakePeer:
    outbound = True

    def __init__(self, info):
        self._info = info
        self.stream = _FakeStream()

    def handshake(self, _our_info):
        return self._info

    def pub_key(self):
        return self._info.pub_key


class TestScheduleRefusedCounter:
    def test_mismatch_counted_as_schedule_refused(self):
        from tendermint_tpu_torch.p2p.switch import Switch

        sw = Switch()
        sw.node_info = _node_info(b"ours", "full>aggregate@4")
        with pytest.raises(ConnectionError, match="commit schedule mismatch"):
            sw.add_peer(_FakePeer(_node_info(b"them", "full")))
        assert sw.adversary["schedule_refused"] == 1
        # a plain network mismatch refuses too but does NOT land in the
        # schedule counter — the operator alarm stays specific
        with pytest.raises(ConnectionError, match="network mismatch"):
            sw.add_peer(_FakePeer(
                _node_info(b"other", "full>aggregate@4", network="else")))
        assert sw.adversary["schedule_refused"] == 1


# -- the AggregateLastCommit stand-in --------------------------------------


@pytest.mark.usefixtures("verifiers")
class TestAggregateLastCommit:
    def test_stand_in_contract(self):
        vs, commit, height = _signed_commit()
        agg = AggregateCommit.from_commit(commit, "test-chain", vs)
        alc = AggregateLastCommit(agg, vs)
        assert alc.has_two_thirds_majority()
        assert alc.two_thirds_majority() == UP_BLOCK_ID
        assert alc.make_commit() is agg
        assert alc.has_all()
        # vote-gossip must find NO per-vote lane to ship (the reactor's
        # aggregate catchup branch ships the whole commit instead)
        assert alc.bit_array().num_true_bits() == 0
        # but coverage screens still see the signer lanes
        assert alc.get_by_index(0) is not None
        # and late precommits cannot be absorbed
        vote = signed_vote(make_val_set(4)[1][0], vs, height, 0,
                           PORT_PRECOMMIT, UP_BLOCK_ID)
        assert alc.begin_add(vote) is None
        assert alc.add_vote(vote) is False


# -- forged / sub-quorum refusal (the shared ingest core) ------------------


@pytest.mark.usefixtures("verifiers")
class TestAggregateRefusal:
    def test_sub_quorum_aggregation_refused(self):
        vs, commit, _ = _signed_commit(drop=(2, 3))  # 2 of 4 signed
        with pytest.raises(CommitError, match="only 20/40 power"):
            AggregateCommit.from_commit(commit, "test-chain", vs)

    def test_forged_scalar_refused_everywhere(self):
        vs, commit, height = _signed_commit()
        agg = AggregateCommit.from_commit(commit, "test-chain", vs)
        agg.verify("test-chain", vs, agg_verifier=ed25519_agg.verify_aggregate)
        forged = AggregateCommit.from_bytes(agg.to_bytes())
        forged.s_agg = bytes(32)
        # the direct verify (what gossip's _screen_agg_commit calls)
        with pytest.raises(CommitError, match="failed verification"):
            forged.verify("test-chain", vs,
                          agg_verifier=ed25519_agg.verify_aggregate)
        # and the set-level commit verify (fast-sync / statesync /
        # store ingest all route through ValidatorSet.verify_commit)
        with pytest.raises(CommitError):
            vs.verify_commit("test-chain", UP_BLOCK_ID, height, forged)

    def test_dropped_signer_bit_refused(self):
        vs, commit, _ = _signed_commit()
        agg = AggregateCommit.from_commit(commit, "test-chain", vs)
        tampered = AggregateCommit.from_bytes(agg.to_bytes())
        # claim one fewer signer while keeping the same scalar: the
        # bitmap/nonce invariant trips before any curve math
        tampered.signers.set_index(0, False)
        tampered.rs = tampered.rs[1:]
        with pytest.raises(CommitError):
            tampered.verify("test-chain", vs,
                            agg_verifier=ed25519_agg.verify_aggregate)


# -- wire / JSON dispatch ---------------------------------------------------


class TestCommitDispatch:
    def test_decode_commit_schedule_gate(self):
        vs, commit, _ = _signed_commit()
        agg = AggregateCommit.from_commit(commit, "test-chain", vs)
        with pytest.raises(ValueError, match="aggregate commit refused"):
            decode_commit(Decoder(agg.to_bytes()), aggregate_commits=False)
        got = decode_commit(Decoder(agg.to_bytes()), aggregate_commits=True)
        assert commit_is_aggregate(got)
        # full commits pass regardless of the flag (pre-flip blocks are
        # served to post-flip nodes during catchup)
        full = decode_commit(Decoder(commit.to_bytes()),
                             aggregate_commits=True)
        assert not commit_is_aggregate(full)

    def test_commit_from_json_dispatch(self):
        vs, commit, _ = _signed_commit()
        agg = AggregateCommit.from_commit(commit, "test-chain", vs)
        back = commit_from_json(agg.to_json())
        assert commit_is_aggregate(back)
        assert back.to_bytes() == agg.to_bytes()
        full = commit_from_json(commit.to_json())
        assert not commit_is_aggregate(full)
        assert full.to_bytes() == commit.to_bytes()


def _upgrade_node_run(root, doc, target):
    """A 1-validator port node over the sqlite stores, consensus WAL and
    privval in `root`: a fresh KVStoreApp (the Handshaker replays the
    stored blocks into it), WAL catchup, then consensus until the store
    reaches `target`; then it stops."""
    import time

    from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.config import test_config
    from tendermint_tpu_torch.consensus import ConsensusState
    from tendermint_tpu_torch.consensus.replay import Handshaker
    from tendermint_tpu_torch.libs.db import db_provider
    from tendermint_tpu_torch.libs.events import EventSwitch
    from tendermint_tpu_torch.mempool import Mempool
    from tendermint_tpu_torch.proxy import AppConns, LocalClientCreator
    from tendermint_tpu_torch.state.state import State

    cfg = test_config().set_root(root)
    dbs = {n: db_provider(n, "sqlite", root) for n in ("state", "blockstore")}
    store = BlockStore(dbs["blockstore"])
    state = State.get_state(dbs["state"], doc)
    conns = AppConns(LocalClientCreator(KVStoreApp()), Handshaker(state, store))
    conns.start()
    mp = Mempool(cfg.mempool, conns.mempool())
    cs = ConsensusState(cfg.consensus, state.copy(), conns.consensus(), store, mp,
                        verifier=gateway.Verifier(device="cpu"))
    cs.set_priv_validator(PrivValidatorFS.load(root + "/priv_validator.json"))
    evsw = EventSwitch()
    evsw.start()
    cs.set_event_switch(evsw)
    cs.start()
    try:
        deadline = time.monotonic() + 30
        while store.height() < target:
            assert time.monotonic() < deadline, f"stalled at {store.height()}"
            time.sleep(0.01)
    finally:
        cs.stop()
        conns.stop()
        evsw.stop()
    formats = {h: store.load_block(h).commit_format() for h in range(2, store.height() + 1)}
    for db in dbs.values():
        db.close()
    return formats


def test_upgrade_boundary_crash_replay(tmp_path, verifiers, monkeypatch):
    """The JAX test SIGKILLs a node process as it crosses the flip, twice;
    the port has no node process yet, so here a 1-validator ConsensusState
    stops and a new one restarts over the same sqlite stores, WAL and
    privval, twice: replay re-derives the commit format per height. The
    first restart's WAL straddles #ENDHEIGHT around the upgrade height 4,
    the second starts inside the aggregate era; the store holds full
    LastCommits below 4 and aggregates from 4 on, and the restarted node
    keeps committing aggregates."""
    from tendermint_tpu_torch.config import reset_test_root

    monkeypatch.setattr(gateway, "_default_hasher", gateway.Hasher(device="cpu"))
    root = str(tmp_path / "node")
    reset_test_root(root, chain_id="upgrade-crash-chain")
    doc = GenesisDoc.from_file(root + "/genesis.json")
    doc.upgrade_height = 4
    doc.upgrade_format = "aggregate"
    doc.validate_and_complete()
    _upgrade_node_run(root, doc, 4)
    _upgrade_node_run(root, doc, 6)
    formats = _upgrade_node_run(root, doc, 7)
    assert formats[2] == formats[3] == "full"
    assert all(formats[h] == "aggregate" for h in range(4, max(formats) + 1)) and max(formats) >= 7
