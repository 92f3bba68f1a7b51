"""The port's gossip reactors (consensus/reactor.py, mempool/reactor.py)
on the CPU, and against the JAX package's.

The module-level helpers are the port's copy of tests/test_reactors.py's
harness (make_genesis, make_node, start_consensus_net, stop_net): nets of
port nodes over in-process pipe switches. The other gossip test files of
the port import them from here, with the `host_device` fixture of
tests/test_torch_consensus.py (the gateway's default verifier and hasher
on the CPU: a port ConsensusState has no CPU default, and an aggregate
LastCommit verifies through the default verifier).

The consensus and mempool cases of tests/test_reactors.py run on the
port (its fast-sync cases are in tests/test_torch_fastsync.py). Beside
them: two JAX and two port validators of one chain commit equal blocks
and states across the upgrade height, txs fed on either side reach every
block through the other package's mempool reactor, and a late observer of
each package catches up from the other's validators through aggregate
catch-up commits; every message the reactors send decodes in the other
package to an equal message; and a device error in the aggregate screen
stops consensus and keeps the peer.
"""

from __future__ import annotations

import importlib
import socket
import tempfile
import threading
import time
import types

import pytest

from tendermint_tpu_torch.abci.apps.counter import CounterApp
from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config import test_config as _test_config
from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
from tendermint_tpu_torch.libs.db import MemDB
from tendermint_tpu_torch.libs.events import EventSwitch
from tendermint_tpu_torch.mempool import Mempool
from tendermint_tpu_torch.mempool.reactor import MempoolReactor
from tendermint_tpu_torch.ops import gateway
from tendermint_tpu_torch.ops.gateway import Verifier
from tendermint_tpu_torch.p2p import make_connected_switches
from tendermint_tpu_torch.proxy.app_conn import AppConnConsensus, AppConnMempool
from tendermint_tpu_torch.state.state import State
from tendermint_tpu_torch.types import GenesisDoc, GenesisValidator, PrivValidatorFS
from tendermint_tpu_torch.types import events as tev
from tests.test_torch_consensus import host_device  # noqa: F401 — autouse fixture

TEST_CHAIN_ID = "reactor_test_chain"


def wait_until(cond, timeout=30.0, tick=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


class Node:
    def __init__(self, cs: ConsensusState, evsw: EventSwitch, mempool: Mempool,
                 store: BlockStore, state: State):
        self.cs = cs
        self.evsw = evsw
        self.mempool = mempool
        self.store = store
        self.state = state
        self.blocks: list = []

    def subscribe_blocks(self) -> None:
        self.evsw.add_listener_for_event(
            "test", tev.EVENT_NEW_BLOCK, lambda d: self.blocks.append(d.block)
        )


def make_genesis(n: int, **doc_kw):
    pvs = [PrivValidatorFS(gen_priv_key_ed25519(), None) for _ in range(n)]
    pvs.sort(key=lambda pv: pv.get_address())
    doc = GenesisDoc(
        genesis_time_ns=time.time_ns(),
        chain_id=TEST_CHAIN_ID,
        validators=[GenesisValidator(pv.get_pub_key(), 1, f"v{i}") for i, pv in enumerate(pvs)],
        **doc_kw,
    )
    return doc, pvs


def make_node(doc: GenesisDoc, pv, app=None) -> Node:
    """A port node over MemDBs and a local app, its ConsensusState on the
    CPU verifier."""
    config = _test_config().consensus
    config.root_dir = tempfile.mkdtemp(prefix="reactor-test-")
    app = app if app is not None else CounterApp()
    mtx = threading.RLock()
    mempool = Mempool(_test_config().mempool, AppConnMempool(LocalClient(app, mtx)))
    store = BlockStore(MemDB())
    state = State.get_state(MemDB(), doc)
    evsw = EventSwitch()
    evsw.start()
    cs = ConsensusState(
        config, state, AppConnConsensus(LocalClient(app, mtx)), store, mempool,
        verifier=Verifier(device="cpu"),
    )
    cs.set_event_switch(evsw)
    if pv is not None:
        cs.set_priv_validator(pv)
    return Node(cs, evsw, mempool, store, state)


def node_info(sw, moniker: str, network: str = TEST_CHAIN_ID):
    from tendermint_tpu_torch.p2p.node_info import NodeInfo, default_version

    return NodeInfo(pub_key=sw.node_priv_key.pub_key(), moniker=moniker, network=network,
                    version=default_version("test"))


def start_consensus_net(n: int, app_factory=None, switch_factory=None,
                        genesis=None):
    """genesis=(doc, pvs) overrides make_genesis(n) — e.g. a doc whose
    validator set covers only some of the n nodes (the rest run as full
    nodes until a val-tx adds them)."""
    doc, pvs = genesis if genesis is not None else make_genesis(n)
    nodes = [make_node(doc, pvs[i], app_factory() if app_factory else None)
             for i in range(n)]
    for node in nodes:
        node.subscribe_blocks()

    def init(i, sw):
        node = nodes[i]
        con_r = ConsensusReactor(node.cs, fast_sync=False)
        con_r.set_event_switch(node.evsw)
        sw.add_reactor("CONSENSUS", con_r)
        mem_r = MempoolReactor(_test_config().mempool, node.mempool)
        sw.add_reactor("MEMPOOL", mem_r)
        sw.set_node_info(node_info(sw, f"node{i}"))
        return sw

    switches = make_connected_switches(n, init, switch_factory=switch_factory)
    return nodes, switches


def stop_net(nodes, switches):
    for sw in switches:
        sw.stop()
    for node in nodes:
        node.evsw.stop()


def two_node_switches(nodes, fast_sync=(False, False)):
    """A started Switch with a ConsensusReactor for each of two nodes,
    not yet connected."""
    from tendermint_tpu_torch.p2p import Switch

    switches = []
    for i, node in enumerate(nodes):
        sw = Switch()
        con_r = ConsensusReactor(node.cs, fast_sync=fast_sync[i])
        con_r.set_event_switch(node.evsw)
        sw.add_reactor("CONSENSUS", con_r)
        sw.set_node_info(node_info(sw, f"node{i}"))
        switches.append(sw)
    for sw in switches:
        sw.start()
    return switches


# -- consensus reactor --------------------------------------------------------


@pytest.mark.slow
def test_reactor_net_makes_blocks():
    """4 validators over real reactors: every node commits blocks
    (consensus/reactor_test.go:24-79)."""
    nodes, switches = start_consensus_net(4)
    try:
        assert wait_until(
            lambda: all(len(n.blocks) >= 2 for n in nodes), timeout=60
        ), [len(n.blocks) for n in nodes]
        # all nodes agree on block 1's hash
        h1 = [n.store.load_block(1).hash() for n in nodes]
        assert len(set(h1)) == 1
    finally:
        stop_net(nodes, switches)


@pytest.mark.slow
def test_reactor_net_commits_txs():
    """A tx checked into one node's mempool gossips to the proposer and
    lands in a block everywhere (atomic-broadcast shape)."""
    nodes, switches = start_consensus_net(4, app_factory=KVStoreApp)
    try:
        tx = b"reactor-test-key=reactor-test-value"
        nodes[3].mempool.check_tx(tx)
        assert wait_until(
            lambda: all(
                any(tx in b.data.txs for b in n.blocks) for n in nodes
            ),
            timeout=60,
        ), [sum(len(b.data.txs) for b in n.blocks) for n in nodes]
    finally:
        stop_net(nodes, switches)


@pytest.mark.slow
def test_reactor_net_commits_under_fuzzed_transport():
    """4 validators whose every p2p stream is wrapped in the chaos fuzz
    layer (random per-op delays, p2p/fuzz.py — the reference's
    FuzzedConnection): consensus must still commit and agree."""
    from tendermint_tpu_torch.p2p import Switch
    from tendermint_tpu_torch.p2p.peer import PeerConfig

    def fuzzy_switch():
        return Switch(peer_config=PeerConfig(
            fuzz=True,
            fuzz_config={"prob_sleep": 0.2, "max_delay": 0.03, "seed": 7},
        ))

    nodes, switches = start_consensus_net(4, switch_factory=fuzzy_switch)
    try:
        assert wait_until(
            lambda: all(len(nd.blocks) >= 3 for nd in nodes), timeout=90
        ), [len(nd.blocks) for nd in nodes]
        h2 = [nd.store.load_block(2).hash() for nd in nodes]
        assert len(set(h2)) == 1
    finally:
        stop_net(nodes, switches)


@pytest.mark.slow
def test_validator_set_change_on_live_net():
    """reference consensus/reactor_test.go:82+ (TestValidatorSetChanges),
    end to end over real reactors: a val-tx through the persistent
    kvstore app adds a live full node to the validator set; the new
    validator starts signing; a power-0 val-tx removes it again and the
    chain keeps going."""
    from tendermint_tpu_torch.abci.apps.kvstore import PersistentKVStoreApp

    pvs = [PrivValidatorFS(gen_priv_key_ed25519(), None) for _ in range(3)]
    pvs.sort(key=lambda pv: pv.get_address())
    doc = GenesisDoc(
        genesis_time_ns=time.time_ns(),
        chain_id=TEST_CHAIN_ID,
        validators=[
            GenesisValidator(pvs[i].get_pub_key(), 10, f"v{i}") for i in range(2)
        ],
    )
    nodes, switches = start_consensus_net(
        3,
        app_factory=lambda: PersistentKVStoreApp(
            tempfile.mkdtemp(prefix="valchg-")
        ),
        genesis=(doc, pvs),
    )
    try:
        assert wait_until(lambda: nodes[0].store.height() >= 2, timeout=30)
        pub_hex = pvs[2].get_pub_key().raw.hex().upper()
        nodes[0].mempool.check_tx(b"val:" + pub_hex.encode() + b"/4")
        assert wait_until(
            lambda: all(n.cs.state.validators.size() == 3 for n in nodes),
            timeout=30,
        ), [n.cs.state.validators.size() for n in nodes]

        def newcomer_signed():
            h = nodes[0].store.height()
            for height in range(max(2, h - 5), h + 1):
                blk = nodes[0].store.load_block(height)
                if blk is not None and sum(
                    1 for pc in blk.last_commit.precommits if pc is not None
                ) == 3:
                    return True
            return False
        assert wait_until(newcomer_signed, timeout=60)
        nodes[1].mempool.check_tx(b"val:" + pub_hex.encode() + b"/0")
        assert wait_until(
            lambda: all(n.cs.state.validators.size() == 2 for n in nodes),
            timeout=30,
        ), [n.cs.state.validators.size() for n in nodes]
        h_after = nodes[0].store.height()
        assert wait_until(lambda: nodes[0].store.height() >= h_after + 2, timeout=30)
    finally:
        stop_net(nodes, switches)


def test_consensus_catchup_of_behind_peer_on_live_chain():
    """A node far behind that is already in consensus mode (no fast sync)
    catches up through the gossip catch-up branches — block parts from
    the peer's store (reactor.go:494-535) and stored-commit precommits
    (reactor.go:637-645) — while the chain keeps moving, then converges
    once production pauses."""
    from tendermint_tpu_torch.p2p import connect2_switches

    doc, pvs = make_genesis(1)
    node_a = make_node(doc, pvs[0])
    node_b = make_node(doc, None)  # non-validator observer
    node_a.subscribe_blocks()
    node_b.subscribe_blocks()
    switches = two_node_switches((node_a, node_b))
    try:
        assert wait_until(lambda: node_a.store.height() >= 6, timeout=60)
        connect2_switches(switches, 0, 1)
        h0 = node_b.store.height()
        assert wait_until(
            lambda: node_b.store.height() > h0, timeout=90
        ), f"B made no progress from {h0}, A at {node_a.store.height()}"
        h1 = node_b.store.height()
        assert wait_until(
            lambda: node_b.store.height() > h1, timeout=90
        ), f"B stalled at {h1} after initial progress, A at {node_a.store.height()}"
        node_a.cs.stop()
        target = node_a.store.height()
        assert wait_until(
            lambda: node_b.store.height() >= target, timeout=120
        ), f"B stalled at {node_b.store.height()}, target {target}"
        got = node_b.store.load_block(3)
        want = node_a.store.load_block(3)
        assert got is not None and got.hash() == want.hash()
    finally:
        stop_net([node_a, node_b], switches)


# -- mempool reactor ----------------------------------------------------------


def test_mempool_reactor_gossips_txs():
    """Tx checked on one node appears in the other's mempool."""
    doc, _pvs = make_genesis(1)
    n1, n2 = make_node(doc, None, CounterApp()), make_node(doc, None, CounterApp())

    def init(i, sw):
        node = (n1, n2)[i]
        sw.add_reactor("MEMPOOL", MempoolReactor(_test_config().mempool, node.mempool))
        sw.set_node_info(node_info(sw, f"m{i}"))
        return sw

    switches = make_connected_switches(2, init)
    try:
        tx = (0).to_bytes(8, "big")  # counter app wants ordered u64 txs
        n1.mempool.check_tx(tx)
        assert wait_until(lambda: n2.mempool.size() == 1, timeout=10)
        assert n2.mempool.reap(10) == [tx]
    finally:
        stop_net([n1, n2], switches)


def test_vote_gossip_marks_peer_only_on_successful_send():
    """pick_vote_to_send does not mark the peer as having the vote — the
    mark lands in _send_vote only after peer.send succeeds (reactor.go
    PickSendVote's order); a failed send leaves the vote pickable and
    counts on the per-peer failure series."""
    from tendermint_tpu_torch.consensus.reactor import PeerState
    from tendermint_tpu_torch.libs.bitarray import BitArray
    from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT

    class _Vote:
        height, round_, type_, validator_index = 5, 0, VOTE_TYPE_PRECOMMIT, 1

        def to_json(self):
            return {"height": self.height}

    class _VoteSet:
        height, round_, type_ = 5, 0, VOTE_TYPE_PRECOMMIT

        def size(self):
            return 4

        def bit_array(self):
            ba = BitArray(4)
            ba.set_index(1, True)
            return ba

        def get_by_index(self, index):
            assert index == 1
            return _Vote()

    class _Peer:
        def __init__(self, ok):
            self.ok = ok
            self.sent = 0

        def send(self, ch, raw):
            self.sent += 1
            return self.ok

    ps = PeerState(peer=None)
    ps.prs.height, ps.prs.round_ = 5, 0
    ps.ensure_vote_bit_arrays(5, 4)
    vs = _VoteSet()
    picks0 = ps.m_vote_picks.value
    sends0 = ps.m_vote_sends.value
    fails0 = ps.m_vote_send_failures.value

    assert ps.pick_vote_to_send(vs) is not None
    assert ps.pick_vote_to_send(vs) is not None
    assert ps.m_vote_picks.value == picks0

    failing = _Peer(ok=False)
    assert not ConsensusReactor._send_vote(None, failing, ps, _Vote())
    assert failing.sent == 1
    assert ps.pick_vote_to_send(vs) is not None, (
        "a failed send must leave the vote pickable"
    )
    assert ps.m_vote_picks.value == picks0 + 1
    assert ps.m_vote_sends.value == sends0
    assert ps.m_vote_send_failures.value == fails0 + 1

    assert ConsensusReactor._send_vote(None, _Peer(ok=True), ps, _Vote())
    assert ps.pick_vote_to_send(vs) is None
    assert ps.m_vote_picks.value == picks0 + 2
    assert ps.m_vote_sends.value == sends0 + 1
    assert ps.m_vote_send_failures.value == fails0 + 1


def test_last_commit_gossip_reaches_peer_in_a_later_round():
    """A laggard one height behind whose round raced past the commit round
    has no tracking bit array at the commit's round until the height+1
    gossip branch ensures the catch-up commit round; the engagement is
    counted per peer, once a round."""
    from tendermint_tpu_torch.consensus.reactor import PeerState
    from tendermint_tpu_torch.libs.bitarray import BitArray
    from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT

    class _LastCommit:
        height, round_, type_ = 5, 0, VOTE_TYPE_PRECOMMIT

        def size(self):
            return 4

        def bit_array(self):
            ba = BitArray(4)
            for i in range(3):
                ba.set_index(i, True)
            return ba

        def get_by_index(self, index):
            return ("vote", index)

    ps = PeerState(peer=None)
    ps.prs.height, ps.prs.round_ = 5, 2
    ps.ensure_vote_bit_arrays(5, 4)
    catchups0 = ps.m_catchup_commits.value
    assert ps.pick_vote_to_send(_LastCommit()) is None
    ps.ensure_catchup_commit_round(5, 0, 4)
    assert ps.m_catchup_commits.value == catchups0 + 1
    ps.ensure_catchup_commit_round(5, 0, 4)
    assert ps.m_catchup_commits.value == catchups0 + 1
    assert ps.pick_vote_to_send(_LastCommit()) is not None
    ps.set_has_vote(5, 0, VOTE_TYPE_PRECOMMIT, 0)
    ps.set_has_vote(5, 0, VOTE_TYPE_PRECOMMIT, 1)
    ps.set_has_vote(5, 0, VOTE_TYPE_PRECOMMIT, 2)
    assert ps.pick_vote_to_send(_LastCommit()) is None


# -- Commit's gossip names -----------------------------------------------------


def test_commit_gossip_names_equal_jax():
    """Commit.type_, bit_array and get_by_index (what the catch-up gossip
    reads of a stored commit) equal the JAX package's on the same commit,
    and bit_array hands out a copy of its cached array."""
    from tendermint_tpu.types.block import Commit as JCommit
    from tendermint_tpu_torch.types.block import Commit

    p = _pkg("tendermint_tpu_torch")
    keys = [gen_priv_key_ed25519(bytes([i]) * 32) for i in range(5)]
    bid = p.BlockID(b"\x11" * 20, p.PartSetHeader(1, b"\x22" * 20))
    pcs = [p.PrivValidatorFS(k, None).sign_vote(
        "c", p.Vote(k.pub_key().address(), i, 3, 0, p.VOTE_TYPE_PRECOMMIT, bid)) if i != 2 else None
        for i, k in enumerate(keys)]
    mine = Commit(bid, pcs)
    theirs = JCommit.from_json(mine.to_json())
    assert mine.type_() == theirs.type_() == 2
    assert mine.bit_array().to_json() == theirs.bit_array().to_json()
    assert mine.bit_array().indices() == [0, 1, 3, 4]
    for i in range(5):
        a, b = mine.get_by_index(i), theirs.get_by_index(i)
        assert (a is None and b is None) or a.to_json() == b.to_json()
    ba = mine.bit_array()
    ba.set_index(0, False)
    assert mine.bit_array().get_index(0)


# -- the two packages in one net -----------------------------------------------


def _pkg(root: str) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        root=root,
        msgs=mod("consensus.messages"),
        reactor=mod("consensus.reactor"),
        mreactor=mod("mempool.reactor"),
        ConsensusState=mod("consensus.state").ConsensusState,
        SignedKVStoreApp=mod("abci.apps.signedkv").SignedKVStoreApp,
        make_sig_tx=mod("abci.apps.signedkv").make_sig_tx,
        LocalClient=mod("abci.client").LocalClient,
        BlockStore=mod("blockchain.store").BlockStore,
        test_config=mod("config").test_config,
        MemDB=mod("libs.db").MemDB,
        EventSwitch=mod("libs.events").EventSwitch,
        BitArray=mod("libs.bitarray").BitArray,
        Mempool=mod("mempool").Mempool,
        AppConnConsensus=mod("proxy.app_conn").AppConnConsensus,
        AppConnMempool=mod("proxy.app_conn").AppConnMempool,
        State=mod("state.state").State,
        GenesisDoc=mod("types.genesis").GenesisDoc,
        GenesisValidator=mod("types.genesis").GenesisValidator,
        PrivValidatorFS=mod("types.priv_validator").PrivValidatorFS,
        gen_priv_key_ed25519=mod("crypto.keys").gen_priv_key_ed25519,
        BlockID=mod("types.block_id").BlockID,
        PartSetHeader=mod("types.block_id").PartSetHeader,
        Vote=mod("types.vote").Vote,
        VOTE_TYPE_PREVOTE=mod("types.vote").VOTE_TYPE_PREVOTE,
        VOTE_TYPE_PRECOMMIT=mod("types.vote").VOTE_TYPE_PRECOMMIT,
        Switch=mod("p2p").Switch,
        SocketStream=mod("p2p.stream").SocketStream,
        NodeInfo=mod("p2p.node_info").NodeInfo,
        default_version=mod("p2p.node_info").default_version,
        tev=mod("types.events"),
        gateway=mod("ops.gateway"),
    )


PORT = _pkg("tendermint_tpu_torch")
JAX = _pkg("tendermint_tpu")
PKGS = {"port": PORT, "jax": JAX}
MIXED_UPGRADE = 3
MIXED_HEIGHTS = 6
MIXED_TXS = 8  # fed to each package's first validator


def _keys(p, n: int, tag: bytes = b"mixed"):
    keys = [p.gen_priv_key_ed25519((tag + b"-%03d" % i).ljust(32, b"\x00")) for i in range(n)]
    keys.sort(key=lambda k: k.pub_key().address())
    return keys


def _mixed_genesis(p, keys):
    return p.GenesisDoc(
        genesis_time_ns=1_700_000_000 * 10**9, chain_id=TEST_CHAIN_ID,
        validators=[p.GenesisValidator(k.pub_key(), 1, f"v{i}") for i, k in enumerate(keys)],
        upgrade_height=MIXED_UPGRADE, upgrade_format="aggregate",
    )


def _host_verifier(p):
    if p is PORT:
        return Verifier(device="cpu")
    return p.gateway.Verifier(use_tpu=False)


class _StateLog:
    """The bytes of every State a node saves, in order (its state DB's
    writes of the state key), and every app hash its app commits."""

    def __init__(self, p, app):
        self.states: list[bytes] = []
        self.app_hashes: list[bytes] = []
        log = self

        class db(p.MemDB):
            def set_sync(self, key, value):
                if key == b"stateKey":
                    if not log.states or log.states[-1] != value:
                        log.states.append(value)
                return super().set_sync(key, value)

        self.db = db()
        commit = app.commit

        def logged_commit():
            res = commit()
            log.app_hashes.append(bytes(res.data))
            return res

        app.commit = logged_commit


class MixedNode:
    """A node of package `p` (port or JAX) over MemDBs and a signed kvstore:
    its ConsensusState, consensus and mempool reactors on a Switch of its
    package, on the host verifier; `key` None is a non-validator."""

    def __init__(self, p, name: str, doc, key):
        self.p, self.name = p, name
        config = p.test_config().consensus
        config.root_dir = tempfile.mkdtemp(prefix="reactor-mixed-")
        self.verifier = _host_verifier(p)
        self.app = p.SignedKVStoreApp()
        self.app.deliver_verifier = self.verifier
        self.log = _StateLog(p, self.app)
        mtx = threading.RLock()
        self.mempool = p.Mempool(p.test_config().mempool, p.AppConnMempool(p.LocalClient(self.app, mtx)))
        self.store = p.BlockStore(p.MemDB())
        state = p.State.get_state(self.log.db, doc)
        self.evsw = p.EventSwitch()
        self.evsw.start()
        self.cs = p.ConsensusState(config, state, p.AppConnConsensus(p.LocalClient(self.app, mtx)), self.store,
                                   self.mempool, verifier=self.verifier)
        self.cs.set_event_switch(self.evsw)
        if key is not None:
            self.cs.set_priv_validator(p.PrivValidatorFS(key, None))
        self.sw = p.Switch()
        self.con_r = p.reactor.ConsensusReactor(self.cs, fast_sync=False)
        self.con_r.set_event_switch(self.evsw)
        self.sw.add_reactor("CONSENSUS", self.con_r)
        self.mem_r = p.mreactor.MempoolReactor(p.test_config().mempool, self.mempool)
        self.sw.add_reactor("MEMPOOL", self.mem_r)
        self.sw.set_node_info(p.NodeInfo(pub_key=self.sw.node_priv_key.pub_key(), moniker=name,
                                         network=TEST_CHAIN_ID, version=p.default_version("test")))
        self.received_txs: list[bytes] = []
        self.screened: list[tuple[int, str, bool]] = []  # (height, sender, passed)
        receive, screen = self.mem_r.receive, self.con_r._screen_agg_commit

        def logged_receive(ch_id, peer, msg_bytes):
            import json

            self.received_txs.append(bytes.fromhex(json.loads(msg_bytes)["tx"]))
            return receive(ch_id, peer, msg_bytes)

        def logged_screen(peer, msg):
            ok = screen(peer, msg)
            self.screened.append((msg.height, peer.node_info.moniker, ok))
            return ok

        self.mem_r.receive = logged_receive
        self.con_r._screen_agg_commit = logged_screen

    def start(self) -> None:
        self.sw.start()

    def stop(self) -> None:
        self.sw.stop()
        self.evsw.stop()


def connect_across(a: MixedNode, b: MixedNode) -> None:
    """Peer a's and b's switches over a socket pair, each end on its own
    package's stream and secret connection; a dials."""
    s1, s2 = socket.socketpair()
    errs: list = []

    def add(node, sock, outbound):
        try:
            node.sw.add_peer_from_stream(node.p.SocketStream(sock), outbound=outbound)
        except Exception as exc:  # noqa: BLE001
            errs.append(exc)

    threads = [threading.Thread(target=add, args=(a, s1, True), daemon=True),
               threading.Thread(target=add, args=(b, s2, False), daemon=True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    if errs:
        raise errs[0]


@pytest.fixture
def jax_host_verifier(monkeypatch):
    """The JAX package's default verifier on its CPU path: its aggregate
    LastCommits and screens verify through it."""
    monkeypatch.setattr(JAX.gateway, "_default_verifier", JAX.gateway.Verifier(use_tpu=False))


def test_mixed_net_commits_equal_chains_and_catches_up_across_packages(jax_host_verifier):
    """Two JAX and two port validators of one 4-validator chain at equal
    power (neither package has a quorum alone), peered over socket pairs
    with secret connections, commit MIXED_HEIGHTS heights across the
    upgrade to aggregate commits at MIXED_UPGRADE. Signed-kvstore txs fed
    to one JAX and one port validator reach the other package's nodes
    through their mempool reactors, and every block. Then a port observer
    peered with the JAX validators alone, and a JAX observer peered with
    the port validators alone, start empty and catch up, each through an
    AggregateCommitMessage screened from the other package. At every
    height all six stores hold equal block bytes, and the apps equal app
    hashes and saved State bytes."""
    nodes = []
    try:
        keys = {name: _keys(p, 4) for name, p in PKGS.items()}
        docs = {name: _mixed_genesis(p, keys[name]) for name, p in PKGS.items()}
        layout = [("jax", "J0"), ("port", "P0"), ("jax", "J1"), ("port", "P1")]
        vals = [MixedNode(PKGS[pk], name, docs[pk], keys[pk][i]) for i, (pk, name) in enumerate(layout)]
        nodes.extend(vals)
        for n in vals:
            n.start()
        for i in range(4):
            for j in range(i + 1, 4):
                connect_across(vals[i], vals[j])
        fed = {}
        for n in (vals[0], vals[1]):
            txs = [n.p.make_sig_tx(bytes([i + 1]) * 32, b"%s-k%d=v%d" % (n.name.encode(), i, i))
                   for i in range(MIXED_TXS)]
            for tx in txs:
                n.mempool.check_tx(tx)
            fed[n.name] = txs
        assert wait_until(lambda: all(n.store.height() >= MIXED_HEIGHTS + 1 for n in vals), timeout=90), \
            [n.store.height() for n in vals]
        observers = [MixedNode(PORT, "PO", docs["port"], None), MixedNode(JAX, "JO", docs["jax"], None)]
        nodes.extend(observers)
        for n in observers:
            n.start()
        for v in (vals[0], vals[2]):
            connect_across(v, observers[0])
        for v in (vals[1], vals[3]):
            connect_across(v, observers[1])
        assert wait_until(lambda: all(n.store.height() >= MIXED_HEIGHTS for n in observers), timeout=90), \
            [n.store.height() for n in observers]
        for n in nodes:
            n.cs.stop()
        # every height: equal block bytes, app hashes and saved states
        for h in range(1, MIXED_HEIGHTS + 1):
            blocks = {n.name: n.store.load_block(h).to_bytes() for n in nodes}
            assert len(set(blocks.values())) == 1, (h, sorted(blocks))
        for n in nodes:
            assert len(n.log.app_hashes) >= MIXED_HEIGHTS and len(n.log.states) > MIXED_HEIGHTS, n.name
        assert len({tuple(n.log.app_hashes[:MIXED_HEIGHTS]) for n in nodes}) == 1
        assert len({tuple(n.log.states[:MIXED_HEIGHTS + 1]) for n in nodes}) == 1
        formats = [vals[0].store.load_block(h).commit_format() for h in range(2, MIXED_HEIGHTS + 1)]
        assert formats == ["full"] * (MIXED_UPGRADE - 2) + ["aggregate"] * (MIXED_HEIGHTS - MIXED_UPGRADE + 1)
        # the fed txs: in the chain, and over the wire into the other package
        committed = {tx for h in range(1, vals[0].store.height() + 1) for tx in vals[0].store.load_block(h).data.txs}
        for fed_by, other in (("J0", "port"), ("P0", "jax")):
            assert set(fed[fed_by]) <= committed
            heard = {tx for n in vals if n.p is PKGS[other] for tx in n.received_txs}
            assert set(fed[fed_by]) <= heard, f"{fed_by}'s txs never crossed to the {other} nodes"
        # the catch-up: each observer screened aggregate commits from the
        # other package's validators alone, none refused (a False is a
        # second sender's copy of a height the observer has left)
        for obs, senders in ((observers[0], {"J0", "J1"}), (observers[1], {"P0", "P1"})):
            passed = {h for h, _s, ok in obs.screened if ok}
            assert passed and min(passed) < MIXED_HEIGHTS, obs.screened
            assert {s for _h, s, _ok in obs.screened} <= senders
            assert obs.store.load_block(MIXED_UPGRADE).commit_format() == "aggregate"
            assert obs.con_r.agg_commits_rejected == 0
        assert sum(v.con_r.agg_commits_sent for v in vals if v.p is JAX) >= 1
        assert sum(v.con_r.agg_commits_sent for v in vals if v.p is PORT) >= 1
    finally:
        for n in nodes:
            n.stop()


def _reactor_messages(p) -> list:
    """One message of every kind the consensus reactor sends, built by
    package `p` from the same seeded keys and bytes."""
    m = p.msgs
    keys = _keys(p, 4, b"msgs")
    pvs = [p.PrivValidatorFS(k, None) for k in keys]
    types_mod = importlib.import_module(f"{p.root}.types")
    parts = types_mod.PartSet.from_data(bytes(range(256)) * 40, 4096)
    bid = p.BlockID(b"\x5a" * 20, parts.header())
    votes = [pv.sign_vote(TEST_CHAIN_ID, p.Vote(pv.get_address(), i, 7, 1, p.VOTE_TYPE_PRECOMMIT, bid))
             for i, pv in enumerate(pvs)]
    commit = importlib.import_module(f"{p.root}.types.block").Commit(bid, votes[:3] + [None])
    vs_mod = importlib.import_module(f"{p.root}.types.validator_set")
    val_mod = importlib.import_module(f"{p.root}.types.validator")
    vset = vs_mod.ValidatorSet([val_mod.Validator.new(k.pub_key(), 1) for k in keys])
    agg = importlib.import_module(f"{p.root}.types.agg_commit").AggregateCommit.from_commit(
        commit, TEST_CHAIN_ID, vset)
    proposal = p.PrivValidatorFS(keys[0], None).sign_proposal(TEST_CHAIN_ID, importlib.import_module(f"{p.root}.types.proposal").Proposal(
        7, 1, parts.header(), 0, bid))
    hb = p.PrivValidatorFS(keys[1], None).sign_heartbeat(TEST_CHAIN_ID, importlib.import_module(f"{p.root}.types.heartbeat").Heartbeat(
        pvs[1].get_address(), 1, 7, 1, 3))
    bits = p.BitArray.from_indices(4, [0, 2, 3])
    return [
        m.NewRoundStepMessage(7, 1, 3, 2, 0),
        m.CommitStepMessage(7, parts.header(), bits),
        m.HasVoteMessage(7, 1, p.VOTE_TYPE_PREVOTE, 2),
        m.HasBlockPartMessage(7, 1, 0),
        m.ProposalHeartbeatMessage(hb),
        m.VoteSetMaj23Message(7, 1, p.VOTE_TYPE_PRECOMMIT, bid),
        m.ProposalMessage(proposal),
        m.ProposalPOLMessage(7, 0, bits),
        m.BlockPartMessage(7, 1, parts.get_part(1)),
        m.AggregateCommitMessage(7, agg),
        m.VoteMessage(votes[3]),
        m.VoteSetBitsMessage(7, 1, p.VOTE_TYPE_PRECOMMIT, bid, bits),
    ]


def test_reactor_messages_decode_across_packages():
    """Every message the consensus reactor sends, built by each package
    from the same inputs, encodes through its `_enc` to equal bytes and
    decodes in the other package to a message whose own `_enc` gives the
    same bytes; the same holds for the mempool reactor's tx frame, which
    the other package's MempoolReactor.receive hands to its check_tx."""
    port, jax = _reactor_messages(PORT), _reactor_messages(JAX)
    assert [type(a).__name__ for a in port] == [type(b).__name__ for b in jax]
    kinds = set()
    for a, b in zip(port, jax):
        raw = PORT.reactor._enc(a)
        assert raw == JAX.reactor._enc(b), type(a).__name__
        assert JAX.reactor._enc(JAX.reactor._dec(raw)) == raw
        assert PORT.reactor._enc(PORT.reactor._dec(raw)) == raw
        assert type(JAX.reactor._dec(raw)).__name__ == type(a).__name__
        kinds.add(type(a).__name__)
    assert len(kinds) == 12
    tx = PORT.make_sig_tx(b"\x07" * 32, b"crossing=1")
    frame = PORT.mreactor._encode_tx(tx)
    assert frame == JAX.mreactor._encode_tx(tx)
    for p in PKGS.values():
        got = []

        class _Mempool:
            def check_tx(self, tx, **kw):
                got.append((tx, kw["source"]))

        class _Peer:
            def id(self):
                return "peer-x"

        r = p.mreactor.MempoolReactor(p.test_config().mempool, _Mempool())
        r.receive(p.mreactor.MEMPOOL_CHANNEL, _Peer(), frame)
        assert got == [(tx, "peer")]


class _ScreenFailsVerifier(Verifier):
    """A CPU Verifier whose aggregate verify raises DeviceError once armed:
    a dsm launch that fails on the card."""

    armed = False

    def verify_aggregate(self, *args, **kw):
        if self.armed:
            raise gateway.DeviceError("ed25519_dsm kernel launch failed: cudaError 700")
        return super().verify_aggregate(*args, **kw)


def test_device_error_in_the_aggregate_screen_stops_consensus_and_keeps_the_peer(monkeypatch, caplog):
    """A port validator that falls behind a 4-validator port net past the
    upgrade height catches up through aggregate catch-up commits; its
    default verifier's verify_aggregate raises DeviceError during the
    reactor's screen. The node's ConsensusState keeps the error in
    `device_error` (logged once) and commits no later height, and the peer
    that sent the commit is still connected: no stop_peer_for_error."""
    from tendermint_tpu_torch.p2p import Switch, connect2_switches

    verifier = _ScreenFailsVerifier(device="cpu")
    monkeypatch.setattr(gateway, "_default_verifier", verifier)
    doc, pvs = make_genesis(4, upgrade_height=2, upgrade_format="aggregate")
    nodes, switches = [], []
    stopped: list = []
    orig = Switch.stop_peer_for_error

    def recorded(self, peer, reason):
        stopped.append((self.node_info.moniker, str(reason)))
        return orig(self, peer, reason)

    monkeypatch.setattr(Switch, "stop_peer_for_error", recorded)
    try:
        for i in range(4):
            nodes.append(make_node(doc, pvs[i]))

        def init(i, sw):
            con_r = ConsensusReactor(nodes[i].cs, fast_sync=False)
            con_r.set_event_switch(nodes[i].evsw)
            sw.add_reactor("CONSENSUS", con_r)
            sw.set_node_info(node_info(sw, f"node{i}"))
            return sw

        switches = [init(i, Switch()) for i in range(4)]
        for sw in switches[:3]:
            sw.start()
        for i in range(3):
            for j in range(i + 1, 3):
                connect2_switches(switches, i, j)
        # three of four validators are a quorum: the chain runs without node 3
        assert wait_until(lambda: all(n.store.height() >= 5 for n in nodes[:3]), timeout=60)
        for n in nodes[:3]:
            n.cs.stop()  # a fixed target: the laggard stays behind it
        lag = nodes[3]
        verifier.armed = True
        switches[3].start()
        for i in range(3):
            connect2_switches(switches, i, 3)
        assert wait_until(lambda: lag.cs.device_error is not None, timeout=60), lag.store.height()
        assert isinstance(lag.cs.device_error, gateway.DeviceError)
        assert "cudaError 700" in str(lag.cs.device_error)
        height = lag.store.height()
        assert height < 5
        lag.cs._thread.join(timeout=5)
        assert not lag.cs._thread.is_alive()  # the receive routine ended
        time.sleep(1.0)
        assert lag.store.height() == height  # no later height commits
        assert switches[3].peers.size() == 3  # every peer kept
        assert not [s for s in stopped if s[0] == "node3"], stopped
        logs = [r for r in caplog.records if "consensus stopped at height" in r.getMessage()]
        assert len(logs) == 1
    finally:
        stop_net(nodes, switches)
