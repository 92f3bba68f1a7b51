"""The port's consensus state machine (consensus/state.py and the modules
it drives) on the CPU, and against the JAX package's.

The module-level helpers are the port's copy of tests/consensus_common.py's
harness: real ConsensusStates over in-memory DBs with validator stubs, fake
peers whose votes are signed locally and injected into the peer queue. The
other consensus test files of the port import them from here, with the
`host_device` fixture, which makes the gateway's default verifier and
hasher CPU instances (B1's, dsm's, K1's and K3's plain versions at or above
their size gates): a port ConsensusState has no CPU default.

The cases of tests/test_consensus.py run on the port, but for the two that
need the consensus reactor. Beside them: a JAX and a port ConsensusState
driven by the same seeded committee commit equal chains across the
upgrade height; each package reads the other's WAL; a node of each package
restarts from the other's stores and WAL and extends the chain equally;
and a device error from the vote plane or the commit verify stops
consensus visibly.
"""

import tempfile
import threading
import time

import pytest

from tendermint_tpu_torch.abci.apps.counter import CounterApp
from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config import test_config as _test_config
from tendermint_tpu_torch.consensus import messages as msgs
from tendermint_tpu_torch.consensus.height_vote_set import HeightVoteSet
from tendermint_tpu_torch.consensus.round_state import RoundStep
from tendermint_tpu_torch.consensus.state import ConsensusState, MsgInfo
from tendermint_tpu_torch.consensus.ticker import MockTicker, TimeoutInfo, TimeoutTicker
from tendermint_tpu_torch.consensus.wal import WAL, WALMessage, decode_wal_line
from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
from tendermint_tpu_torch.libs.db import MemDB
from tendermint_tpu_torch.libs.events import EventSwitch
from tendermint_tpu_torch.mempool import Mempool
from tendermint_tpu_torch.ops import gateway
from tendermint_tpu_torch.ops.gateway import Hasher, Verifier
from tendermint_tpu_torch.proxy.app_conn import AppConnConsensus, AppConnMempool
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.types import (
    VOTE_TYPE_PRECOMMIT,
    VOTE_TYPE_PREVOTE,
    BlockID,
    GenesisDoc,
    GenesisValidator,
    PrivValidatorFS,
    Vote,
)
from tendermint_tpu_torch.types import events as tev


# the JAX test config's liveness timeouts (a 0.1 s propose) leave no room
# for K1's and K3's plain versions in torch under a loaded CPU: the default
# Hasher of these tests hashes on the host, as the JAX package's CPU path
# does; the committee tests below, with generous timeouts, run the plain
# versions
HOST_HASH_GATE = 1 << 30


@pytest.fixture(autouse=True)
def host_device(monkeypatch):
    """The gateway's default verifier and hasher on the CPU: what a
    ConsensusState built without `verifier=` takes, what its part sets and
    tx roots hash on, and what an aggregate LastCommit verifies through.
    One torch thread: the plain versions are bound by per-op overhead, and
    intra-op threads only contend with the other test workers."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(gateway, "_default_verifier", Verifier(device="cpu"))
    monkeypatch.setattr(gateway, "_default_hasher", Hasher(device="cpu", min_tpu_batch=HOST_HASH_GATE))
    yield
    torch.set_num_threads(threads)


# -- the harness (tests/consensus_common.py) ----------------------------------

TEST_CHAIN_ID = "test_chain"


class ValidatorStub:
    """A fake validator: signs votes locally for injection
    (common_test.go:49-105)."""

    def __init__(self, pv: PrivValidatorFS, index: int):
        self.pv = pv
        self.index = index
        self.height = 1
        self.round_ = 0

    def sign_vote(self, type_: int, chain_id: str, block_id: BlockID) -> Vote:
        vote = Vote(
            validator_address=self.pv.get_address(),
            validator_index=self.index,
            height=self.height,
            round_=self.round_,
            type_=type_,
            block_id=block_id,
        )
        return self.pv.sign_vote(chain_id, vote)


def rand_gen_state(n_validators: int, power: int = 1):
    """N deterministic-ish validators + genesis state over MemDB
    (common_test.go:292-322)."""
    pvs = []
    gen_vals = []
    for i in range(n_validators):
        pv = PrivValidatorFS(gen_priv_key_ed25519(), None)
        pvs.append(pv)
        gen_vals.append(GenesisValidator(pv.get_pub_key(), power, f"val{i}"))
    # sort stubs in validator-set order (by address) so indices line up
    order = sorted(range(n_validators), key=lambda i: pvs[i].get_address())
    pvs = [pvs[i] for i in order]
    doc = GenesisDoc(
        genesis_time_ns=time.time_ns(),
        chain_id=TEST_CHAIN_ID,
        validators=[gen_vals[i] for i in order],
    )
    state = State.get_state(MemDB(), doc)
    return state, pvs


def new_consensus_state(state, pv, app=None, config=None):
    """Real ConsensusState over in-proc app (common_test.go:474-481)."""
    if config is None:
        # each state machine gets its own root so WALs never leak across
        # tests (a shared relative wal path replays a stale WAL!)
        import tempfile

        config = _test_config().consensus
        config.root_dir = tempfile.mkdtemp(prefix="cs-test-")
    app = app if app is not None else CounterApp()
    mtx = threading.RLock()
    mp = Mempool(_test_config().mempool, AppConnMempool(LocalClient(app, mtx)))
    store = BlockStore(MemDB())
    evsw = EventSwitch()
    evsw.start()
    cs = ConsensusState(
        config, state, AppConnConsensus(LocalClient(app, mtx)), store, mp,
        verifier=Verifier(device="cpu"),
    )
    cs.set_event_switch(evsw)
    if pv is not None:
        cs.set_priv_validator(pv)
    return cs


def make_cs_and_stubs(n_validators: int, app=None, config=None):
    state, pvs = rand_gen_state(n_validators)
    # cs's own validator is whichever sorted validator is round-0 proposer,
    # so proposer-driven tests work for any n (common_test uses vss[0])
    proposer = state.validators.get_proposer()
    prop_idx = next(
        i for i, pv in enumerate(pvs) if pv.get_address() == proposer.address
    )
    cs = new_consensus_state(state, pvs[prop_idx], app=app, config=config)
    stubs = [ValidatorStub(pv, i) for i, pv in enumerate(pvs)]
    return cs, stubs, prop_idx


def add_votes(cs: ConsensusState, *votes: Vote) -> None:
    """Inject peer votes (common_test.go:131-140)."""
    for v in votes:
        cs.peer_msg_queue.put(MsgInfo(msgs.VoteMessage(v), "peer-test"))


def sign_add_votes(cs, stubs, type_, block_id: BlockID, skip_index: int) -> None:
    votes = [
        s.sign_vote(type_, TEST_CHAIN_ID, block_id)
        for s in stubs
        if s.index != skip_index
    ]
    add_votes(cs, *votes)


class EventCollector:
    """Subscribe to events and wait on them (consensus/common.go:11-19)."""

    def __init__(self, evsw: EventSwitch, event: str, listener_id: str = "collector"):
        self.items: list = []
        self._cond = threading.Condition()
        evsw.add_listener_for_event(listener_id + event, event, self._on)

    def _on(self, data):
        with self._cond:
            self.items.append(data)
            self._cond.notify_all()

    def wait_for(self, n: int, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            while len(self.items) < n:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True


def wait_for_height(cs: ConsensusState, height: int, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while cs.rs.height < height:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


# -- the cases of tests/test_consensus.py ------------------------------------


class TestSingleValidator:
    def test_makes_blocks(self):
        """One validator, counter app: the chain advances on its own."""
        cs, stubs, _ = make_cs_and_stubs(1)
        blocks = EventCollector(cs.evsw, tev.EVENT_NEW_BLOCK)
        cs.start()
        try:
            assert blocks.wait_for(3, timeout=15), "expected 3 blocks"
        finally:
            cs.stop()
        heights = [d.block.header.height for d in blocks.items[:3]]
        assert heights == [1, 2, 3]

    def test_commits_txs_and_app_hash_advances(self):
        cs, stubs, _ = make_cs_and_stubs(1, app=KVStoreApp())
        blocks = EventCollector(cs.evsw, tev.EVENT_NEW_BLOCK)
        cs.mempool.check_tx(b"x=1")
        cs.start()
        try:
            assert blocks.wait_for(3, timeout=15)
        finally:
            cs.stop()
        # the tx landed in an early block and the app hash is bound into a
        # later header
        all_txs = [tx for d in blocks.items for tx in d.block.data.txs]
        assert b"x=1" in all_txs
        assert blocks.items[2].block.header.app_hash != b""

    def test_new_round_event_sequence(self):
        cs, stubs, _ = make_cs_and_stubs(1)
        rounds = EventCollector(cs.evsw, tev.EVENT_NEW_ROUND)
        cs.start()
        try:
            assert rounds.wait_for(2, timeout=15)
        finally:
            cs.stop()
        assert rounds.items[0].height == 1
        assert rounds.items[1].height == 2


class TestMultiValidatorQuorum:
    def test_full_round_with_stub_votes(self):
        """cs is the round-0 proposer of a 4-validator set; the other 3
        validators' votes are injected (state_test.go FullRound2 analog)."""
        cs, stubs, prop_idx = make_cs_and_stubs(4)
        votes = EventCollector(cs.evsw, tev.EVENT_VOTE)
        blocks = EventCollector(cs.evsw, tev.EVENT_NEW_BLOCK)
        cs.start()
        try:
            # proposer signs its own prevote
            assert votes.wait_for(1, timeout=10)
            own_prevote = votes.items[0].vote
            assert own_prevote.type_ == VOTE_TYPE_PREVOTE
            block_id = own_prevote.block_id
            assert block_id.hash, "proposer should prevote its own proposal"

            sign_add_votes(cs, stubs, VOTE_TYPE_PREVOTE, block_id, prop_idx)
            # +2/3 prevotes -> cs precommits
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                pcs = [v for v in votes.items if v.vote.type_ == VOTE_TYPE_PRECOMMIT]
                if pcs:
                    break
                time.sleep(0.01)
            assert pcs and pcs[0].vote.block_id.hash == block_id.hash

            for s in stubs:
                s.height, s.round_ = 1, 0
            sign_add_votes(cs, stubs, VOTE_TYPE_PRECOMMIT, block_id, prop_idx)
            assert blocks.wait_for(1, timeout=10), "block should commit"
            assert blocks.items[0].block.header.height == 1
        finally:
            cs.stop()

    def test_no_quorum_no_commit(self):
        """With only 1/4 voting, nothing commits."""
        cs, stubs, _ = make_cs_and_stubs(4)
        blocks = EventCollector(cs.evsw, tev.EVENT_NEW_BLOCK)
        cs.start()
        try:
            assert not blocks.wait_for(1, timeout=1.0)
            assert cs.rs.height == 1
        finally:
            cs.stop()

    def test_nil_prevotes_precommit_nil_and_new_round(self):
        """+2/3 nil prevotes -> cs precommits nil; +2/3 nil precommits ->
        next round, same height."""
        cs, stubs, prop_idx = make_cs_and_stubs(4)
        votes = EventCollector(cs.evsw, tev.EVENT_VOTE)
        rounds = EventCollector(cs.evsw, tev.EVENT_NEW_ROUND)
        cs.start()
        try:
            assert votes.wait_for(1, timeout=10)
            sign_add_votes(cs, stubs, VOTE_TYPE_PREVOTE, BlockID(), prop_idx)
            deadline = time.monotonic() + 10
            nil_pc = None
            while time.monotonic() < deadline and nil_pc is None:
                for v in votes.items:
                    if (
                        v.vote.type_ == VOTE_TYPE_PRECOMMIT
                        and v.vote.validator_index != prop_idx  # ours comes via event too
                        or (v.vote.type_ == VOTE_TYPE_PRECOMMIT)
                    ):
                        nil_pc = v.vote
                        break
                time.sleep(0.01)
            assert nil_pc is not None
            assert not nil_pc.block_id.hash, "precommit should be nil"

            sign_add_votes(cs, stubs, VOTE_TYPE_PRECOMMIT, BlockID(), prop_idx)
            # +2/3 nil precommits → precommit-wait timeout → round 1
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and cs.rs.round_ == 0:
                time.sleep(0.01)
            assert cs.rs.height == 1
            assert cs.rs.round_ >= 1
        finally:
            cs.stop()


class TestHeightVoteSet:
    def test_catchup_round_budget(self):
        state, pvs = rand_gen_state(2)
        hvs = HeightVoteSet(TEST_CHAIN_ID, 1, state.validators)
        stub = ValidatorStub(pvs[0], 0)
        added_rounds = []
        for r in (5, 6, 7):
            stub.round_ = r
            v = stub.sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, BlockID())
            added_rounds.append(hvs.add_vote(v, peer_id="peerX"))
        # two catchup rounds allowed, third dropped
        assert added_rounds == [True, True, False]

    def test_pol_info(self):
        state, pvs = rand_gen_state(1)
        hvs = HeightVoteSet(TEST_CHAIN_ID, 1, state.validators)
        stub = ValidatorStub(pvs[0], 0)
        assert hvs.pol_info() == (-1, None)
        bid = BlockID(b"\x01" * 20)
        v = stub.sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, bid)
        hvs.add_vote(v, peer_id="")
        r, pol = hvs.pol_info()
        assert r == 0 and pol.hash == bid.hash


class TestTicker:
    def test_fires_after_duration(self):
        t = TimeoutTicker()
        t.start()
        t.schedule_timeout(TimeoutInfo(0.05, 1, 0, RoundStep.PROPOSE))
        ti = t.chan.get(timeout=2)
        assert ti.height == 1 and ti.step == RoundStep.PROPOSE
        t.stop()

    def test_newer_replaces_older(self):
        t = TimeoutTicker()
        t.start()
        t.schedule_timeout(TimeoutInfo(0.5, 1, 0, RoundStep.PROPOSE))
        t.schedule_timeout(TimeoutInfo(0.05, 1, 0, RoundStep.PREVOTE_WAIT))
        ti = t.chan.get(timeout=2)
        assert ti.step == RoundStep.PREVOTE_WAIT
        t.stop()

    def test_stale_ignored(self):
        t = TimeoutTicker()
        t.start()
        t.schedule_timeout(TimeoutInfo(0.05, 5, 0, RoundStep.PROPOSE))
        t.schedule_timeout(TimeoutInfo(0.01, 1, 0, RoundStep.PROPOSE))  # stale
        ti = t.chan.get(timeout=2)
        assert ti.height == 5
        t.stop()


class TestWAL:
    def test_roundtrip_and_endheight_search(self, tmp_path):
        wal = WAL(str(tmp_path / "wal"))
        wal.start()
        wal.save(WALMessage.timeout(TimeoutInfo(1.0, 1, 0, RoundStep.PROPOSE)))
        wal.write_end_height(1)
        vote_msg = None
        state, pvs = rand_gen_state(1)
        stub = ValidatorStub(pvs[0], 0)
        v = stub.sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, BlockID())
        wal.save(WALMessage.msg_info(msgs.VoteMessage(v), "peerA"))
        wal.stop()

        wal2 = WAL(str(tmp_path / "wal"))
        lines = wal2.lines_after_height(1)
        assert lines is not None
        entries = [decode_wal_line(ln) for ln in lines if ln.strip()]
        kinds = [e[0] for e in entries if e]
        assert "msg_info" in kinds
        decoded = next(e for e in entries if e[0] == "msg_info")
        assert decoded[1].vote.signature == v.signature
        assert decoded[2] == "peerA"
        # marker for an uncommitted height: not found
        assert wal2.lines_after_height(7) is None

    def test_fresh_wal_has_height0_marker(self, tmp_path):
        wal = WAL(str(tmp_path / "wal"))
        wal.start()
        wal.stop()
        wal2 = WAL(str(tmp_path / "wal"))
        assert wal2.lines_after_height(0) == []


class TestCrashRecovery:
    def _run_node(self, root, app, state_db, store_db, n_blocks, chain_db_doc):
        """Run a 1-validator node until n_blocks commit; leave WAL+dbs."""
        from tendermint_tpu_torch.abci.client import LocalClient
        from tendermint_tpu_torch.blockchain.store import BlockStore
        from tendermint_tpu_torch.consensus.state import ConsensusState
        from tendermint_tpu_torch.libs.events import EventSwitch
        from tendermint_tpu_torch.mempool import Mempool
        from tendermint_tpu_torch.proxy.app_conn import AppConnConsensus, AppConnMempool
        from tendermint_tpu_torch.state.state import State
        from tendermint_tpu_torch.types import PrivValidatorFS

        cfg = _test_config()
        cfg.set_root(root)
        doc = chain_db_doc
        state = State.get_state(state_db, doc)
        pv = PrivValidatorFS.load(root + "/priv_validator.json")
        mtx = threading.RLock()
        mp = Mempool(cfg.mempool, AppConnMempool(LocalClient(app, mtx)))
        store = BlockStore(store_db)
        evsw = EventSwitch()
        evsw.start()
        cs = ConsensusState(
            cfg.consensus, state, AppConnConsensus(LocalClient(app, mtx)), store, mp
        )
        cs.set_event_switch(evsw)
        cs.set_priv_validator(pv)
        blocks = EventCollector(evsw, tev.EVENT_NEW_BLOCK)
        cs.start()
        ok = blocks.wait_for(n_blocks, timeout=20)
        cs.stop()
        assert ok
        return cs

    def test_restart_continues_chain(self, tmp_path):
        """Stop after 2 blocks; restart with fresh app; handshake replays
        the chain into the app and consensus continues from height 3."""
        from tendermint_tpu_torch.config import reset_test_root
        from tendermint_tpu_torch.consensus.replay import Handshaker
        from tendermint_tpu_torch.libs.db import MemDB
        from tendermint_tpu_torch.proxy.multi_app_conn import AppConns
        from tendermint_tpu_torch.proxy.client_creator import LocalClientCreator
        from tendermint_tpu_torch.state.state import State
        from tendermint_tpu_torch.types import GenesisDoc

        root = str(tmp_path / "node")
        reset_test_root(root, chain_id="crash-test")
        doc = GenesisDoc.from_file(root + "/genesis.json")
        state_db, store_db = MemDB(), MemDB()
        app = KVStoreApp()

        cs1 = self._run_node(root, app, state_db, store_db, 2, doc)
        committed_height = cs1.state.last_block_height
        assert committed_height >= 2
        committed_app_hash = cs1.state.app_hash

        # "crash": new app instance knows nothing; handshake replays it
        app2 = KVStoreApp()
        state2 = State.get_state(state_db, doc)
        from tendermint_tpu_torch.blockchain.store import BlockStore

        store2 = BlockStore(store_db)
        hs = Handshaker(state2, store2)
        conns = AppConns(LocalClientCreator(app2), hs)
        conns.start()
        assert hs.n_blocks >= 1 or app2.height > 0
        assert app2.app_hash == committed_app_hash

        # consensus resumes and extends the chain
        cs2 = self._run_node(root, app2, state_db, store_db, 1, doc)
        assert cs2.state.last_block_height > committed_height


class TestWALTruncation:
    """WAL recovery from arbitrary truncation (consensus/replay_test.go:61-66
    replays fixtures cut at every line; TestWALCrash* in replay_test.go cover
    the crash-mid-write residues). A crash can leave the WAL cut anywhere;
    catchup must treat a torn TAIL line as the expected residue and replay
    everything before it (replay.py catchup_replay)."""

    def _record(self, tmp_path, n_blocks=2):
        """Run a 1-validator node for n_blocks; return everything needed to
        restart from arbitrary WAL prefixes."""
        from tendermint_tpu_torch.config import reset_test_root
        from tendermint_tpu_torch.libs.db import MemDB
        from tendermint_tpu_torch.types import GenesisDoc

        root = str(tmp_path / "rec")
        reset_test_root(root, chain_id="wal-trunc")
        with open(root + "/priv_validator.json", "rb") as f:
            pre_pv = f.read()  # privval BEFORE it ever signed
        doc = GenesisDoc.from_file(root + "/genesis.json")
        state_db, store_db = MemDB(), MemDB()
        app = KVStoreApp()
        TestCrashRecovery()._run_node(root, app, state_db, store_db, n_blocks, doc)
        cfg = _test_config()
        cfg.set_root(root)
        wal_file = cfg.consensus.wal_file()
        with open(wal_file, "rb") as f:
            wal_bytes = f.read()
        return root, doc, state_db, store_db, wal_file, wal_bytes, pre_pv

    def _fresh_cs(self, root, doc, pre_pv, wal_trunc: bytes):
        """A brand-new node (fresh dbs/app, pre-run privval) whose WAL file
        holds `wal_trunc`."""
        import os

        from tendermint_tpu_torch.abci.client import LocalClient
        from tendermint_tpu_torch.blockchain.store import BlockStore
        from tendermint_tpu_torch.consensus.state import ConsensusState
        from tendermint_tpu_torch.libs.db import MemDB
        from tendermint_tpu_torch.libs.events import EventSwitch
        from tendermint_tpu_torch.mempool import Mempool
        from tendermint_tpu_torch.proxy.app_conn import AppConnConsensus, AppConnMempool
        from tendermint_tpu_torch.state.state import State
        from tendermint_tpu_torch.types import PrivValidatorFS

        os.makedirs(root, exist_ok=True)
        with open(root + "/priv_validator.json", "wb") as f:
            f.write(pre_pv)
        cfg = _test_config()
        cfg.set_root(root)
        wal_file = cfg.consensus.wal_file()
        os.makedirs(os.path.dirname(wal_file), exist_ok=True)
        with open(wal_file, "wb") as f:
            f.write(wal_trunc)
        state = State.get_state(MemDB(), doc)
        app = KVStoreApp()
        mtx = threading.RLock()
        mp = Mempool(cfg.mempool, AppConnMempool(LocalClient(app, mtx)))
        evsw = EventSwitch()
        evsw.start()
        cs = ConsensusState(
            cfg.consensus,
            state,
            AppConnConsensus(LocalClient(app, mtx)),
            BlockStore(MemDB()),
            mp,
        )
        cs.set_event_switch(evsw)
        cs.set_priv_validator(PrivValidatorFS.load(root + "/priv_validator.json"))
        return cs, wal_file

    def test_replay_from_every_truncation_point(self, tmp_path):
        """Cut the recorded WAL at every line boundary plus mid-line tears;
        a fresh node must replay the surviving prefix without an exception
        and land on a sane height every time."""
        from tendermint_tpu_torch.consensus.replay import catchup_replay

        _, doc, _, _, _, wal_bytes, pre_pv = self._record(tmp_path)
        points = set()
        off = 0
        # the v2 WAL is binary (newline bytes appear only inside JSON
        # payloads), so "line" boundaries are arbitrary cut points — keep
        # them, and add an even byte stride so the sweep density never
        # depends on how many 0x0A bytes this run's frames happened to hold;
        # the stride stays coarse because each point replays a full
        # consensus state machine (~0.5 s) and the per-byte-exhaustive
        # sweep already runs at the WAL layer in tests/test_wal_repair.py
        for ln in wal_bytes.splitlines(keepends=True):
            if len(ln) > 8:
                points.add(off + len(ln) // 2)  # torn mid-line tail
                points.add(off + len(ln) - 1)  # complete line, newline lost
            off += len(ln)
            points.add(off)  # clean cut after this line
        for cut in range(8, len(wal_bytes), max(1, len(wal_bytes) // 16)):
            points.add(cut)
        assert len(points) > 20, "recording produced a suspiciously short WAL"
        heights = {}
        for i, cut in enumerate(sorted(points)):
            cs, wal_file = self._fresh_cs(
                str(tmp_path / f"t{i}"), doc, pre_pv, wal_bytes[:cut]
            )
            cs.open_wal(wal_file)
            try:
                catchup_replay(cs, cs.rs.height)
                # height 1 fully replayed iff its commit survived the cut
                assert cs.rs.height in (1, 2), f"cut={cut}: height {cs.rs.height}"
                heights[cut] = cs.rs.height
            finally:
                cs.wal.stop()
                cs.evsw.stop()
        # the sweep must not be vacuous: a full prefix commits height 1,
        # and some earlier cut leaves it uncommitted
        assert heights[max(heights)] == 2
        assert 1 in heights.values()

    def test_crash_residue_restart_extends_chain(self, tmp_path):
        """The realistic crash residues — WAL intact, final line torn
        mid-write, final line never written — against the PERSISTED node
        state: restart must replay and commit a further block."""
        residues = {
            "intact": lambda b: b,
            "torn-tail": lambda b: b[: len(b) - len(b.splitlines(keepends=True)[-1]) // 2],
            "missing-tail": lambda b: b[: len(b) - len(b.splitlines(keepends=True)[-1])],
        }
        for name, cut in residues.items():
            root, doc, state_db, store_db, wal_file, wal_bytes, _ = self._record(
                tmp_path / name
            )
            with open(wal_file, "wb") as f:
                f.write(cut(wal_bytes))
            app2 = KVStoreApp()
            from tendermint_tpu_torch.blockchain.store import BlockStore
            from tendermint_tpu_torch.consensus.replay import Handshaker
            from tendermint_tpu_torch.proxy.client_creator import LocalClientCreator
            from tendermint_tpu_torch.proxy.multi_app_conn import AppConns
            from tendermint_tpu_torch.state.state import State

            hs = Handshaker(State.get_state(state_db, doc), BlockStore(store_db))
            AppConns(LocalClientCreator(app2), hs).start()
            before = State.get_state(state_db, doc).last_block_height
            cs = TestCrashRecovery()._run_node(
                root, app2, state_db, store_db, 1, doc
            )
            assert cs.state.last_block_height > before, f"residue {name!r} stalled"


# -- adversarial robustness (peer-facing surfaces) ---------------------------


class TestMessageDecodeRobustness:
    """msg_from_json handles raw attacker JSON: anything off-contract
    must raise ValueError (-> peer error), never propagate garbage."""

    def test_malformed_envelopes(self):
        import pytest as _pytest

        from tendermint_tpu_torch.consensus.messages import msg_from_json

        for bad in (
            None, [], 42, "x",
            {"type": 7, "data": {}},
            {"type": "nope", "data": {}},
            {"type": "vote", "data": []},
            {"type": "new_round_step"},
        ):
            with _pytest.raises(ValueError):
                msg_from_json(bad)

    def test_scalar_field_bounds(self):
        import pytest as _pytest

        from tendermint_tpu_torch.consensus.messages import msg_from_json

        good = {
            "height": 5, "round": 0, "step": 1,
            "seconds_since_start_time": 0, "last_commit_round": -1,
        }
        assert msg_from_json({"type": "new_round_step", "data": good}).height == 5
        for key, bad in (
            ("height", -1), ("height", 1 << 70), ("height", "5"),
            ("height", True), ("round", -2), ("step", 99),
        ):
            data = dict(good, **{key: bad})
            with _pytest.raises(ValueError):
                msg_from_json({"type": "new_round_step", "data": data})

    def test_bitarray_bounds(self):
        import pytest as _pytest

        from tendermint_tpu_torch.consensus.messages import msg_from_json

        ok = {
            "type": "proposal_pol",
            "data": {"height": 1, "proposal_pol_round": 0,
                     "proposal_pol": {"bits": 4, "elems": "f"}},
        }
        assert msg_from_json(ok).proposal_pol.size == 4
        for bits in (-1, 1 << 30, "4", None):
            bad = {
                "type": "proposal_pol",
                "data": {"height": 1, "proposal_pol_round": 0,
                         "proposal_pol": {"bits": bits, "elems": "f"}},
            }
            with _pytest.raises(ValueError):
                msg_from_json(bad)

    def test_nested_vote_garbage_rejected(self):
        """Off-contract scalars nested inside a Vote must fail at decode
        (-> peer disconnect), not deep in the consensus loop."""
        import pytest as _pytest

        from tendermint_tpu_torch.consensus.messages import msg_from_json

        def vote(**over):
            v = {
                "validator_address": "aa" * 20, "validator_index": 0,
                "height": 7, "round": 0, "type": 1,
                "block_id": {"hash": "", "parts": {"total": 0, "hash": ""}},
                "signature": None,
            }
            v.update(over)
            return {"type": "vote", "data": {"vote": v}}

        assert msg_from_json(vote()).vote.height == 7
        for bad in (
            vote(height="7"), vote(height=True), vote(round=-1),
            vote(validator_index=1 << 30), vote(validator_address="zz"),
            vote(block_id={"hash": "x" * 200, "parts": {"total": 0, "hash": ""}}),
            vote(signature=[1, "ab"]), vote(signature="junk"),
        ):
            with _pytest.raises(ValueError):
                msg_from_json(bad)


def test_live_vote_path_batches_on_gateway():
    """SURVEY §7 deferred vote verification: a burst of gossiped votes
    from 100 validators must ride the batched kernel (verifier tpu_sigs
    moves) while VoteSet keeps per-vote accept/reject semantics."""
    from tendermint_tpu_torch.consensus.state import MsgInfo
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.types import BlockID
    from tendermint_tpu_torch.types.vote import VOTE_TYPE_PREVOTE

    def wait_until(cond, timeout=60.0, tick=0.1):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return True
            time.sleep(tick)
        return cond()

    cs, stubs, prop_idx = make_cs_and_stubs(100)
    verifier = gateway.Verifier(min_tpu_batch=8, device="cpu")
    cs.verifier = verifier
    fake_block = BlockID(hash=b"\x17" * 20)
    votes = [
        s.sign_vote(VOTE_TYPE_PREVOTE, TEST_CHAIN_ID, fake_block)
        for s in stubs
        if s.index != prop_idx
    ]
    # pre-load the routine's input queue directly: deterministic burst —
    # via the forwarder threads, GIL scheduling could drip votes in below
    # the batch threshold and make the batch assertion flaky
    for v in votes:
        cs._inputs.put(("msg", MsgInfo(msgs.VoteMessage(v), "peer-test")))
    cs.start()
    try:
        n = len(votes)

        def added():
            prevotes = cs.rs.votes.prevotes(0)
            if prevotes is None:
                return 0
            return sum(
                1 for s in stubs
                if s.index != prop_idx and prevotes.get_by_index(s.index) is not None
            )

        # wait for APPLICATION, not just verification: priming counts the
        # stats before the receive routine has tallied every vote
        assert wait_until(lambda: added() == n, timeout=120), (
            f"only {added()}/{n} votes added; stats {verifier.stats()}"
        )
        st = verifier.stats()
        # the burst must have landed on the batched path, not vote-by-vote
        assert st["tpu_batches"] >= 1 and st["tpu_sigs"] >= 32, st
    finally:
        cs.stop()


# -- the port's ConsensusState against the JAX package's -----------------------
#
# The committee of the consensus_committee cell (chip_smoke.py phase 31), at
# 4 and 32 validators: committee_node wires a node of either package as
# node/node.py wires one (sqlite stores, the signed kvstore behind AppConns
# with the Handshaker, a gated mempool with its WAL, the consensus WAL on
# disk, pipeline_apply on), and committee_pump drives it with stub
# validators as benches/bench_committee.py does, with signed txs.

import importlib  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

CPKG = {"port": chip_smoke.committee_pkg("tendermint_tpu_torch"),
        "jax": chip_smoke.committee_pkg("tendermint_tpu")}
COMMITTEE_HEIGHTS = 6
COMMITTEE_UPGRADE = 4
COMMITTEE_TXS = 20  # a height's signed txs; one more is forged and refused by the gate
COMMITTEE_FORGED_HEIGHT = 2  # one stub's precommit carries a flipped signature


@pytest.fixture
def jax_host_device(monkeypatch):
    """The JAX package's default verifier on its CPU path (its aggregate
    LastCommits verify through it)."""
    from tendermint_tpu.ops import gateway as jgateway

    monkeypatch.setattr(jgateway, "_default_verifier", jgateway.Verifier(use_tpu=False))


def _committee(p, n: int):
    """(keys in address order, genesis, the node's key) of the seeded
    committee: benches/bench_committee.py's seeds, every power 1, the node
    the height-1 proposer."""
    keys = [p.gen_priv_key_ed25519((b"committee-%05d" % i).ljust(32, b"\x00")) for i in range(n)]
    keys.sort(key=lambda k: k.pub_key().address())
    flat = chip_smoke.committee_genesis(p, keys, b"", 1, COMMITTEE_UPGRADE)
    own = chip_smoke.committee_schedule(p, flat, 1)[1]
    return keys, flat, next(k for k in keys if k.pub_key().address() == own)


def _bursts(p, heights: int = COMMITTEE_HEIGHTS):
    """A height's signed kv txs (new keys, then updates of the last
    height's) and one with a flipped signature bit, shuffled in."""
    out = []
    for h in range(1, heights + 1):
        txs = []
        for i in range(COMMITTEE_TXS):
            key = b"k%d-%d" % (h - 1 if h > 1 and i % 3 == 0 else h, i)
            txs.append(p.make_sig_tx(bytes([h, i % 7]) * 16, key + b"=v%d-%d" % (h, i)))
        forged = p.make_sig_tx(bytes([h, 99]) * 16, b"forged=%d" % h)
        txs.insert(h % COMMITTEE_TXS, forged[:40] + bytes([forged[40] ^ 0x10]) + forged[41:])
        out.append({"txs": txs, "forged": [h % COMMITTEE_TXS]})
    return out


def _devices(p):
    """(verifier, hasher) of a node: the port's CPU Verifier (B1's and dsm's
    plain versions at or above the 32-lane gate) and CPU Hasher (K1's and
    K3's at or above 16 leaves); the JAX package's CPU verifier and its
    default hasher."""
    if p.root == "tendermint_tpu_torch":
        return Verifier(device="cpu"), Hasher(device="cpu")
    from tendermint_tpu.ops import gateway as jgateway

    return jgateway.Verifier(use_tpu=False), None


def _run(p, root, keys, doc, first, last, forged_height=None, restarted=False):
    """Start a node of package `p` in `root` (its home made beforehand),
    pump heights first..last and stop it. Returns (pump result, stored
    records of heights 1..last, the saved state's bytes, refused votes)."""
    verifier, hasher = _devices(p)
    node = chip_smoke.committee_node(p, root, doc, verifier, hasher)
    try:
        out = chip_smoke.committee_pump(node, keys, _bursts(p), first, last, forged_height=forged_height,
                                        restarted=restarted, wait_s=60)
        records = node.records(1, last)
    finally:
        state = node.stop()
    rejects = [(r["height"], r["type"], r["err"].split(":")[0]) for r in node.flight.rejects]
    return out, records, state, rejects


@pytest.mark.parametrize("n", [4, 32])
def test_committee_chain_equal_to_jax(n, tmp_path, jax_host_device):
    """The same seeded committee drives a JAX and a port ConsensusState
    through COMMITTEE_HEIGHTS heights across the upgrade height: per height
    the block hash, part-set root, header app hash, stored block bytes,
    seen commit and applied State.bytes_() are equal, and so are the saved
    state's bytes, the gate's
    refusals (the forged tx alone), the proposers and the refused votes
    (the forged precommit alone). Exact: all are bytes or integers."""
    got = {}
    for name, p in CPKG.items():
        keys, doc, own_key = _committee(p, n)
        root = str(tmp_path / name)
        chip_smoke.committee_home(p, root, own_key)
        got[name] = _run(p, root, keys, doc, 1, COMMITTEE_HEIGHTS, forged_height=COMMITTEE_FORGED_HEIGHT)
    out, records, state, rejects = got["port"]
    jout, jrecords, jstate, jrejects = got["jax"]
    assert records == jrecords and state == jstate
    assert out["refused"] == jout["refused"] and out["proposers"] == jout["proposers"]
    assert out["states"] == jout["states"] and len(out["states"]) == COMMITTEE_HEIGHTS + 1
    assert rejects == jrejects == [(COMMITTEE_FORGED_HEIGHT, 2, "InvalidSignatureError")]
    assert all(r == [h % COMMITTEE_TXS] for h, r in out["refused"].items())
    assert [r["format"] for r in records] == ["full"] * (COMMITTEE_UPGRADE - 1) + ["aggregate"] * (
        COMMITTEE_HEIGHTS - COMMITTEE_UPGRADE + 1)
    assert all(len(CPKG["port"].Block.from_bytes(r["block"]).data.txs) == COMMITTEE_TXS for r in records)


def _wal_view(p, wal_file):
    """Every record of a WAL read by package `p`: the decoded messages in
    their JSON form."""
    wal = importlib.import_module(f"{p.root}.consensus.wal")
    out = []
    for line in wal.read_wal_lines(wal_file):
        e = wal.decode_wal_line(line)
        if e is None:
            continue
        if e[0] == "msg_info":
            e = ("msg_info", p.msgs.msg_to_json(e[1]), e[2])
        elif e[0] == "timeout":
            e = ("timeout", e[1].to_json())
        out.append(e)
    return out


def test_wal_read_by_both_packages(tmp_path, jax_host_device):
    """Each package's consensus WAL, written over a 4-validator chain of 5
    heights across the upgrade, decodes to equal messages in both packages,
    every #ENDHEIGHT marker included."""
    for name, p in CPKG.items():
        keys, doc, own_key = _committee(p, 4)
        root = str(tmp_path / name)
        chip_smoke.committee_home(p, root, own_key)
        _run(p, root, keys, doc, 1, 5)
        wal_file = CPKG["port"].test_config().set_root(root).consensus.wal_file()
        views = [_wal_view(q, wal_file) for q in CPKG.values()]
        assert views[0] == views[1]
        kinds = {e[0] for e in views[0]}
        assert {"msg_info", "endheight", "timeout"} <= kinds
        assert [e[1] for e in views[0] if e[0] == "endheight"] == [0, 1, 2, 3, 4, 5]


@pytest.mark.parametrize("first,then", [("jax", "port"), ("port", "jax")])
def test_restart_from_the_other_packages_files(first, then, tmp_path, jax_host_device):
    """A node of one package commits heights 1-3 of a 4-validator chain and
    stops. A node of the other package restarts from a copy of its files
    (sqlite stores, WAL, privval: the Handshaker replays the stored blocks
    into a fresh app, the WAL catchup the rest) and commits heights 4-5
    across the upgrade height, equal to the first package's own
    continuation from the same files."""
    pa, pb = CPKG[first], CPKG[then]
    keys, doc, own_key = _committee(pa, 4)
    sched = chip_smoke.committee_schedule(pa, doc, 5)
    assert sched[4] != own_key.pub_key().address()  # no own proposal in flight at the stop
    home = str(tmp_path / "home")
    chip_smoke.committee_home(pa, home, own_key)
    _run(pa, home, keys, doc, 1, 3)
    shutil.copytree(home, str(tmp_path / "copy"))
    ja, jrec, jstate, _ = _run(pa, home, keys, doc, 4, 5, restarted=True)
    kb, docb, _ = _committee(pb, 4)
    pbo, prec, pstate, _ = _run(pb, str(tmp_path / "copy"), kb, docb, 4, 5, restarted=True)
    assert prec == jrec and pstate == jstate and pbo["refused"] == ja["refused"]
    assert pbo["states"] == ja["states"]
    assert [r["format"] for r in prec] == ["full"] * 3 + ["aggregate"] * 2


# -- a device error stops consensus visibly ------------------------------------


class _FailingVerifier(Verifier):
    """A CPU Verifier whose vote micro-batch (`fail="vote"`) or commit verify
    (`fail="commit"`) raises DeviceError once armed: a kernel that fails to
    launch on the card."""

    def __init__(self, fail: str):
        super().__init__(device="cpu")
        self.fail = fail
        self.armed = False

    def _boom(self):
        raise gateway.DeviceError("ed25519_verify kernel launch failed: cudaError 700")

    def prime_cache_async(self, items, on_done=None):
        if self.armed and self.fail == "vote":
            self._boom()
        return super().prime_cache_async(items, on_done)

    def commit_batch_verifier(self):
        inner = super().commit_batch_verifier()

        def verify(items):
            if self.armed and self.fail == "commit":
                self._boom()
            return inner(items)

        return verify


@pytest.mark.parametrize("fail,at", [("vote", 2), ("commit", 3)])
def test_device_error_stops_consensus(fail, at, tmp_path, caplog):
    """An 8-validator port chain whose verifier raises DeviceError from
    height `at` on, in the vote plane (the prevotes' micro-batch) or in
    validate_block's LastCommit verify: the receive routine stops with the
    error in `device_error`, logged once; no vote of the failed batch
    falls through to a singleton verify, no later height commits, and the
    node never prevotes height `at`'s block."""
    p = CPKG["port"]
    keys, doc, own_key = _committee(p, 8)
    root = str(tmp_path / "home")
    chip_smoke.committee_home(p, root, own_key)
    verifier = _FailingVerifier(fail)
    node = chip_smoke.committee_node(p, root, doc, verifier, Hasher(device="cpu"))
    cs = node.cs
    seen = {}

    def arm(h):
        if h == at:
            seen["singletons"] = cs.vote_batcher.singletons
            verifier.armed = True

    try:
        with pytest.raises(AssertionError, match="device error"):
            chip_smoke.committee_pump(node, keys, _bursts(p), 1, COMMITTEE_HEIGHTS, wait_s=60, on_height=arm)
        assert isinstance(cs.device_error, gateway.DeviceError)
        assert "cudaError 700" in str(cs.device_error)
        cs._thread.join(timeout=5)
        assert not cs._thread.is_alive()  # the receive routine ended
        time.sleep(0.2)
        assert node.store.height() == at - 1 and cs.rs.height == at
        assert cs.vote_batcher.singletons == seen["singletons"]
        prevotes = cs.rs.votes.prevotes(0)
        own = own_key.pub_key().address()
        own_idx, _ = cs.rs.validators.get_by_address(own)
        assert prevotes.get_by_index(own_idx) is None or fail == "vote"
        if fail == "vote":
            # no stub's prevote was verified one by one and added
            assert prevotes.bit_array().num_true_bits() <= 1
        stopped = [r for r in caplog.records if "consensus stopped at height" in r.getMessage()]
        assert len(stopped) == 1
    finally:
        node.stop()


# -- the reactor's peer mirror (tests/test_consensus.py's cases that need the
# consensus reactor) ----------------------------------------------------------


class TestPeerStateRobustness:
    """The reactor's peer mirror is driven by attacker-controlled
    messages; stale or replayed ones must never move it backwards
    (reactor.go:1050-1053)."""

    def _ps(self):
        from tendermint_tpu_torch.consensus.reactor import PeerState

        return PeerState(peer=object())

    def _nrs(self, h, r, s, last_commit_round=0):
        return msgs.NewRoundStepMessage(
            height=h, round_=r, step=s,
            seconds_since_start_time=0, last_commit_round=last_commit_round,
        )

    def test_stale_new_round_step_ignored(self):
        ps = self._ps()
        ps.apply_new_round_step(self._nrs(5, 2, 3))
        ps.ensure_vote_bit_arrays(5, 4)
        ps.prs.prevotes.set_index(1, True)

        # replayed earlier round: bit arrays must survive
        ps.apply_new_round_step(self._nrs(5, 1, 6))
        assert ps.prs.round_ == 2
        assert ps.prs.prevotes is not None and ps.prs.prevotes.get_index(1)

        # exact duplicate: also a no-op
        ps.apply_new_round_step(self._nrs(5, 2, 3))
        assert ps.prs.prevotes is not None

        # genuine progress still applies and resets
        ps.apply_new_round_step(self._nrs(5, 3, 1))
        assert ps.prs.round_ == 3
        assert ps.prs.prevotes is None

    def test_last_commit_bit_array_uses_last_commit_size(self):
        ps = self._ps()
        ps.apply_new_round_step(self._nrs(7, 0, 1))
        # current set has 10 validators, height-6 commit had 4
        ps.ensure_vote_bit_arrays(7, 10)
        ps.ensure_vote_bit_arrays(6, 4)
        assert ps.prs.prevotes.size == 10
        assert ps.prs.last_commit.size == 4


def test_add_peer_message_never_blocks_when_full():
    """The peer recv routine calls add_peer_message; a full queue (state
    machine behind or stopped) must drop, not block — a blocking put
    wedges the whole multiplexed connection and hands a flooding peer a
    DoS lever."""
    from tests.test_torch_reactors import make_genesis, make_node

    doc, pvs = make_genesis(1)
    node = make_node(doc, pvs[0])  # cs constructed, NOT started: no drain
    cs = node.cs

    class _Msg:
        pass

    for _ in range(cs.peer_msg_queue.maxsize):
        cs.add_peer_message(_Msg(), "peerX")
    assert cs.peer_msg_queue.full()
    t0 = time.monotonic()
    for _ in range(3):
        cs.add_peer_message(_Msg(), "peerX")
    dt = time.monotonic() - t0
    assert dt < 3 * cs.PEER_PUT_TIMEOUT + 1.0, f"wedged for {dt:.1f}s"
    assert cs._peer_msg_drops == 3
    # the sibling peer-originated entry points share the bounded helper
    from tendermint_tpu_torch.types import PartSetHeader

    block_id = BlockID(b"\x11" * 20, PartSetHeader(1, b"\x22" * 20))
    v = Vote(b"\x00" * 20, 0, 1, 0, VOTE_TYPE_PREVOTE, block_id)
    t0 = time.monotonic()
    cs.add_vote_msg(v, "peerX")
    assert time.monotonic() - t0 < cs.PEER_PUT_TIMEOUT + 1.0
    assert cs._peer_msg_drops == 4


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "serial"])
@pytest.mark.parametrize("error", ["device", "other"])
def test_post_apply_hook_device_error_stops_consensus(error, pipelined, caplog):
    """The post-apply hook (where a node wires its snapshot producer) raises
    at height 2. A DeviceError goes to stop_on_device_error: logged once,
    kept in device_error, and no height after 2 commits. Any other error
    of the hook is logged and consensus goes on, as in the JAX package."""
    config = _test_config().consensus
    config.root_dir = tempfile.mkdtemp(prefix="cs-test-")
    config.pipeline_apply = pipelined
    cs, _stubs, _ = make_cs_and_stubs(1, app=KVStoreApp(), config=config)

    def hook(state, block):
        if block.header.height == 2:
            if error == "device":
                raise gateway.DeviceError("K1 snapshot digests: cudaError 700")
            raise ValueError("disk full")

    cs.post_apply_hook = hook
    cs.start()
    try:
        if error == "device":
            deadline = time.monotonic() + 15
            while cs.device_error is None and time.monotonic() < deadline:
                time.sleep(0.01)
            assert isinstance(cs.device_error, gateway.DeviceError)
            time.sleep(1.0)
            assert cs.block_store.height() <= 3
            stopped_at = cs.block_store.height()
            time.sleep(0.5)
            assert cs.block_store.height() == stopped_at
            stopped = [r for r in caplog.records if "consensus stopped at height" in r.getMessage()]
            assert len(stopped) == 1
        else:
            assert wait_for_height(cs, 5, timeout=15)
            assert cs.device_error is None
            assert any("post-apply hook failed at 2" in r.getMessage() for r in caplog.records)
    finally:
        cs.stop()
