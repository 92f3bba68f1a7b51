"""The port's fast sync (blockchain/pool.py, blockchain/reactor.py) over
its transport, against the JAX package's.

Node A builds its chain through a package's execution path (State,
apply_block, a KVStoreApp behind AppConns, save_block with every
validator's precommits) and serves it from its BlockStore through a
BlockchainReactor(fast_sync=False). Node B starts empty and fast-syncs
from it: two switches on 127.0.0.1 (port 0), B dialing A's listener,
every peer on a secret connection. The consensus reactor is a stub that
records switch_to_consensus(state). B stores and applies every height the
pool can prove: A's height less one, since the last block waits for its
successor's LastCommit.

The cases of tests/test_reactors.py that fast-sync run on the port.
Beside them: a port node syncs from a JAX node and a JAX node from a port
node, to equal store records, states and app hashes, across an upgrade to
aggregate commits; a tampered peer is stopped once and none of its
blocks is stored; 1,000-validator commits reach the verifier in groups of
at most four; and a verifier error stops the sync, visibly, with the peer
still connected.
"""

from __future__ import annotations

import importlib
import time
import types

import pytest

CHAIN_ID = "fastsync-chain"


def _pkg(root: str) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    block = mod("types.block")
    p2p = mod("p2p")
    return types.SimpleNamespace(
        root=root,
        Block=block.Block,
        Commit=block.Commit,
        empty_commit=block.empty_commit,
        AggregateCommit=mod("types.agg_commit").AggregateCommit,
        GenesisDoc=mod("types.genesis").GenesisDoc,
        GenesisValidator=mod("types.genesis").GenesisValidator,
        gen_priv_key_ed25519=mod("crypto.keys").gen_priv_key_ed25519,
        SignatureEd25519=mod("crypto.keys").SignatureEd25519,
        Vote=mod("types.vote").Vote,
        VOTE_TYPE_PRECOMMIT=mod("types.vote").VOTE_TYPE_PRECOMMIT,
        State=mod("state").State,
        apply_block=mod("state").apply_block,
        BlockStore=mod("blockchain.store").BlockStore,
        MemDB=mod("libs.db").MemDB,
        KVStoreApp=mod("abci.apps.kvstore").KVStoreApp,
        AppConns=mod("proxy").AppConns,
        LocalClientCreator=mod("proxy").LocalClientCreator,
        MockMempool=mod("types.services").MockMempool,
        Switch=p2p.Switch,
        Reactor=p2p.Reactor,
        NodeInfo=p2p.NodeInfo,
        NetAddress=p2p.NetAddress,
        PeerConfig=p2p.PeerConfig,
        MConnConfig=p2p.MConnConfig,
        default_version=mod("p2p.node_info").default_version,
        Listener=mod("p2p.listener").Listener,
        reactor=mod("blockchain.reactor"),
    )


PORT = _pkg("tendermint_tpu_torch")
JAX = _pkg("tendermint_tpu")


@pytest.fixture(autouse=True)
def _host_default_verifier(monkeypatch):
    """An aggregate LastCommit verifies through the gateway's default
    verifier, the card's by default: on the CPU, B1's and dsm's plain
    versions."""
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.ops.gateway import Verifier

    monkeypatch.setattr(gateway, "_default_verifier", Verifier(device="cpu"))


def wait_until(cond, timeout=60.0, tick=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


def genesis(p, n: int, upgrade_height: int = 0):
    """n validators of equal power, keys from fixed seeds (the same keys
    in both packages), and an upgrade to aggregate commits when given."""
    keys = [p.gen_priv_key_ed25519(b"fastsync-val-%d" % i) for i in range(n)]
    doc = p.GenesisDoc(genesis_time_ns=0, chain_id=CHAIN_ID,
                       validators=[p.GenesisValidator(k.pub_key(), 10, f"v{i}") for i, k in enumerate(keys)],
                       upgrade_height=upgrade_height, upgrade_format="aggregate" if upgrade_height else "")
    return doc, {k.pub_key().address(): k for k in keys}


def sign_commit(p, vals, keys, height: int, bid):
    votes = [p.Vote(v.address, idx, height, 0, p.VOTE_TYPE_PRECOMMIT, bid) for idx, v in enumerate(vals.validators)]
    sb = votes[0].sign_bytes(CHAIN_ID)
    return p.Commit(bid, [vote.with_signature(keys[vote.validator_address].sign(sb)) for vote in votes])


class Chain:
    """Node A's chain, built with package `p` as a validator node builds
    it: the LastCommit in the format the schedule requires, apply_block,
    then save_block with the height's precommits as the seen commit."""

    def __init__(self, p, doc, keys, heights: int, txs: int = 3):
        self.p, self.doc = p, doc
        self.state = p.State.get_state(p.MemDB(), doc)
        self.store = p.BlockStore(p.MemDB())
        conns = p.AppConns(p.LocalClientCreator(p.KVStoreApp()))
        conns.start()
        self.states, self.app_hashes = {}, {}
        seen = None
        part_size = doc.consensus_params.block_gossip.block_part_size_bytes
        try:
            for h in range(1, heights + 1):
                st = self.state
                if h == 1:
                    last = p.empty_commit()
                elif doc.aggregate_commits_at(h):
                    last = p.AggregateCommit.from_commit(seen, CHAIN_ID, st.last_validators)
                else:
                    last = seen
                block_txs = [b"key-%d-%d=value-%d" % (h, i, h * i) for i in range(txs)]
                block, parts = p.Block.make_block(h, CHAIN_ID, block_txs, last, st.last_block_id,
                                                  st.validators.hash(), st.app_hash, part_size, time_ns=h * 10**9)
                p.apply_block(st, None, conns.consensus(), block, parts.header(), p.MockMempool())
                seen = sign_commit(p, st.last_validators, keys, h, st.last_block_id)
                self.store.save_block(block, parts, seen)
                self.states[h], self.app_hashes[h] = st.bytes_(), st.app_hash
        finally:
            conns.stop()

    @property
    def height(self) -> int:
        return self.store.height()


def _consensus_stub(p):
    class ConsensusStub(p.Reactor):
        """Records each switch_to_consensus(state) as the state's bytes."""

        def __init__(self):
            self.switched: list[bytes] = []

        def start(self):
            pass

        def stop(self):
            pass

        def get_channels(self):
            return []

        def switch_to_consensus(self, state):
            self.switched.append(state.bytes_())

    return ConsensusStub()


class Node:
    """A switch on 127.0.0.1 with a listener, a BlockchainReactor over
    `store` and a copy of `state` (as node/node.py hands it one), and the
    consensus stub. A serving node passes its chain's store and state; a
    syncing node starts from genesis on empty stores."""

    def __init__(self, p, doc, fast_sync: bool, chain: Chain | None = None, rate: float | None = None,
                 **reactor_kw):
        self.p, self.doc = p, doc
        if chain is not None:
            self.state, self.store = chain.state, chain.store
        else:
            self.state, self.store = p.State.get_state(p.MemDB(), doc), p.BlockStore(p.MemDB())
        self.conns = p.AppConns(p.LocalClientCreator(p.KVStoreApp()))
        self.conns.start()
        peer_config = None
        if rate is not None:
            peer_config = p.PeerConfig(mconfig=p.MConnConfig(send_rate=rate, recv_rate=rate))
        self.sw = p.Switch(peer_config=peer_config)
        self.bc = p.reactor.BlockchainReactor(self.state.copy(), self.conns.consensus(), self.store, fast_sync,
                                              status_update_interval=0.5, **reactor_kw)
        self.consensus = _consensus_stub(p)
        self.sw.add_reactor("BLOCKCHAIN", self.bc)
        self.sw.add_reactor("CONSENSUS", self.consensus)
        self.sw.set_node_info(p.NodeInfo(pub_key=self.sw.node_priv_key.pub_key(), moniker=p.root,
                                         network=CHAIN_ID, version=p.default_version("test"),
                                         other=[f"commit_schedule={doc.schedule_string()}"]))
        self.listener = p.Listener("127.0.0.1:0")
        self.sw.add_listener(self.listener)
        self.stops: list[tuple[str, str]] = []
        stop_peer = self.sw.stop_peer_for_error

        def recording_stop(peer, reason):
            self.stops.append((peer.id(), str(reason)))
            stop_peer(peer, reason)

        self.sw.stop_peer_for_error = recording_stop
        self.sw.start()

    def dial(self, other: "Node"):
        return self.sw.dial_peer_with_address(self.p.NetAddress("127.0.0.1", other.listener.internal_address().port))

    def node_id(self) -> str:
        return self.sw.node_priv_key.pub_key().address().hex()

    def stop(self) -> None:
        self.sw.stop()
        self.conns.stop()


def records(store, heights):
    """What a store holds for `heights`: block bytes, block meta, and the
    block's LastCommit as the store keeps it."""
    out = []
    for h in heights:
        commit = store.load_block_commit(h - 1) if h > 1 else None
        out.append((store.load_block(h).to_bytes(), store.load_block_meta(h).to_json(),
                    commit.to_json() if commit is not None else None))
    return out


def assert_synced(a: Chain, b: Node) -> int:
    """B holds A's heights 1..H-1, record for record; its state (the
    reactor's and the one saved in its state DB) and app hash are A's at
    H-1; consensus took over once, with that state."""
    target = a.height - 1
    assert b.store.height() == target
    assert records(b.store, range(1, target + 1)) == records(a.store, range(1, target + 1))
    # the seen commit B saves for h is the LastCommit of A's block h+1
    assert [b.store.load_seen_commit(h).to_json() for h in range(1, target + 1)] == \
        [a.store.load_block(h + 1).last_commit.to_json() for h in range(1, target + 1)]
    assert b.bc.state.bytes_() == a.states[target]
    assert b.p.State.load_state(b.state.db, b.doc).bytes_() == a.states[target]
    assert b.bc.state.app_hash == a.app_hashes[target] == a.store.load_block(target + 1).header.app_hash
    assert b.consensus.switched == [a.states[target]]
    assert b.bc.fast_sync is False and getattr(b.bc, "sync_error", None) is None
    return target


def sync(a: Chain, b: Node, serving: Node, timeout=60.0) -> None:
    b.dial(serving)
    assert wait_until(lambda: b.consensus.switched, timeout=timeout), (
        f"B at {b.store.height()}, A at {a.height}; peers {b.sw.peers.size()}; stops {b.stops}")


# -- the cases of tests/test_reactors.py --------------------------------------


def test_fast_sync_catches_up_and_switches():
    """B starts empty with fast_sync=True against A's chain; it downloads,
    verifies and applies the blocks, then switches to consensus
    (blockchain/reactor.go:174-262, 204-217)."""
    doc, keys = genesis(PORT, 1)
    a = Chain(PORT, doc, keys, heights=8)
    node_a = Node(PORT, doc, fast_sync=False, chain=a)
    node_b = Node(PORT, doc, fast_sync=True)
    try:
        sync(a, node_b, node_a)
        assert assert_synced(a, node_b) == 7
        assert node_b.store.load_block(2).hash() == a.store.load_block(2).hash()
        assert node_b.bc.blocks_synced == 7 and not node_b.stops and not node_a.stops
    finally:
        node_a.stop()
        node_b.stop()


@pytest.mark.slow
def test_fast_sync_rides_the_tpu_gateway():
    """Fast sync wired as node/node.py wires it routes the commits'
    signatures and the part hashing through the gateway: the stats move,
    and the synced chain equals node A's."""
    from tendermint_tpu_torch.ops.gateway import Hasher, Verifier

    verifier = Verifier(min_tpu_batch=1, device="cpu")
    hasher = Hasher(min_tpu_batch=1, device="cpu")
    doc, keys = genesis(PORT, 1)
    a = Chain(PORT, doc, keys, heights=5)
    node_a = Node(PORT, doc, fast_sync=False, chain=a)
    node_b = Node(PORT, doc, fast_sync=True, batch_verifier=verifier.commit_batch_verifier(),
                  async_batch_verifier=verifier.verify_batch_async, part_hasher=hasher.part_leaf_hashes,
                  part_tree_hasher=hasher.part_set_tree)
    try:
        sync(a, node_b, node_a, timeout=300)
        assert_synced(a, node_b)
        vstats, hstats = verifier.stats(), hasher.stats()
        assert vstats["tpu_sigs"] > 0 and vstats["tpu_batches"] > 0, vstats
        assert hstats["tpu_part_batches"] > 0 and hstats["tpu_leaves"] > 0, hstats
    finally:
        node_a.stop()
        node_b.stop()


def test_speculative_group_spans_never_overshoot():
    from tendermint_tpu.blockchain.reactor import group_spans as jax_group_spans
    from tendermint_tpu_torch.blockchain.reactor import group_spans

    assert group_spans([1000] * 9, 4096) == [(0, 4), (4, 8), (8, 9)]
    assert group_spans([5000, 100, 100], 4096) == [(0, 1), (1, 3)]
    assert group_spans([1024] * 4, 4096) == [(0, 4)]
    assert group_spans([1025] * 4, 4096) == [(0, 3), (3, 4)]
    assert group_spans([], 4096) == []
    import numpy as np

    rng = np.random.default_rng(3)
    for _ in range(50):
        sizes = rng.integers(1, 3000, size=int(rng.integers(0, 20))).tolist()
        assert group_spans(sizes, 4096) == jax_group_spans(sizes, 4096)


def test_fastsync_flag_clears_on_switchover():
    doc, _ = genesis(PORT, 1)
    state = PORT.State.get_state(PORT.MemDB(), doc)
    bc = PORT.reactor.BlockchainReactor(state.copy(), None, PORT.BlockStore(PORT.MemDB()), fast_sync=True,
                                        status_update_interval=0.05)

    class _FakePool:
        def is_running(self):
            return True

        def is_caught_up(self):
            return True

        def stop(self):
            pass

        def peek_blocks(self, n):
            return []

        def peek_two_blocks(self):
            return (None, None)

    class _FakeSwitch:
        def reactor(self, name):
            return None

        def broadcast(self, *a, **k):
            return []

    bc.pool = _FakePool()
    bc.switch = _FakeSwitch()
    bc._started = True
    assert bc.fast_sync is True
    bc._pool_routine()
    assert bc.fast_sync is False and bc.sync_error is None


# -- across the packages ------------------------------------------------------


@pytest.mark.parametrize("server,client", [(JAX, PORT), (PORT, JAX)], ids=["port-syncs-from-jax", "jax-syncs-from-port"])
def test_fast_sync_across_packages(server, client):
    """One package's node serves a 4-validator chain of 6 heights from its
    store, upgrade height 4 (blocks 2-3 carry full LastCommits, 4-6
    aggregate ones); the other package's node fast-syncs it over TCP and
    secret connections to equal records, state and app hash."""
    doc_s, keys = genesis(server, 4, upgrade_height=4)
    a = Chain(server, doc_s, keys, heights=6)
    doc_c = client.GenesisDoc.from_json(doc_s.to_json())
    node_a = Node(server, doc_s, fast_sync=False, chain=a)
    node_b = Node(client, doc_c, fast_sync=True)
    try:
        sync(a, node_b, node_a)
        assert assert_synced(a, node_b) == 5
        formats = [node_b.store.load_block(h).commit_format() for h in range(2, 6)]
        assert formats == ["full", "full", "aggregate", "aggregate"]
        assert not node_b.stops and not node_a.stops
    finally:
        node_a.stop()
        node_b.stop()


def test_blockchain_channel_and_messages_equal_jax():
    """The blockchain channel's descriptor and the reactor's messages are
    the JAX package's, byte for byte."""
    doc_p, _ = genesis(PORT, 1)
    doc_j, _ = genesis(JAX, 1)
    out = {}
    for p, doc in ((PORT, doc_p), (JAX, doc_j)):
        bc = p.reactor.BlockchainReactor(p.State.get_state(p.MemDB(), doc), None, p.BlockStore(p.MemDB()),
                                         fast_sync=True)
        (desc,) = bc.get_channels()
        out[p.root] = (p.reactor.BLOCKCHAIN_CHANNEL, desc.id, desc.priority, desc.send_queue_capacity,
                       desc.recv_message_capacity, bc._status_response(),
                       p.reactor._enc({"type": "block_request", "height": 7}),
                       p.reactor._enc({"type": "no_block_response", "height": 7}),
                       p.reactor.TRY_SYNC_INTERVAL, p.reactor.STATUS_UPDATE_INTERVAL,
                       p.reactor.SWITCH_TO_CONSENSUS_INTERVAL)
    assert out["tendermint_tpu_torch"] == out["tendermint_tpu"]


# -- what the card needs of the port ------------------------------------------


def test_tampered_peer_is_stopped_once_and_nothing_tampered_is_stored():
    """Peer C serves A's chain with one signature of block 4's LastCommit
    flipped, so block 3 cannot be proven from what C sent. B dials C
    first (every height is asked of C), then A: C is stopped for "sent
    invalid block" exactly once, heights 3 and 4 come again from A, and
    B's store holds A's blocks only."""
    doc, keys = genesis(PORT, 4)
    a = Chain(PORT, doc, keys, heights=7)
    c_store = PORT.BlockStore(PORT.MemDB())
    part_size = doc.consensus_params.block_gossip.block_part_size_bytes
    for h in range(1, a.height + 1):
        block = a.store.load_block(h)
        if h == 4:
            pre = block.last_commit.precommits[1]
            raw = bytearray(pre.signature.raw)
            raw[5] ^= 0x20
            block.last_commit.precommits[1] = pre.with_signature(PORT.SignatureEd25519(bytes(raw)))
            block.last_commit._hash = None
        c_store.save_block(block, block.make_part_set(part_size), a.store.load_seen_commit(h))
    c_chain = types.SimpleNamespace(state=a.state.copy(), store=c_store)
    node_a = Node(PORT, doc, fast_sync=False, chain=a)
    node_c = Node(PORT, doc, fast_sync=False, chain=c_chain)
    node_b = Node(PORT, doc, fast_sync=True)
    try:
        node_b.dial(node_c)
        assert wait_until(lambda: node_c.node_id() in node_b.bc.pool.peers, timeout=20)
        node_b.dial(node_a)
        assert wait_until(lambda: node_b.consensus.switched, timeout=60), (node_b.store.height(), node_b.stops)
        assert_synced(a, node_b)
        assert node_b.stops == [(node_c.node_id(), "sent invalid block")]
        assert node_b.sw.peers.size() == 1 and node_b.sw.peers.has(node_a.node_id())
        assert node_b.store.load_block(4).to_bytes() == a.store.load_block(4).to_bytes()
    finally:
        for n in (node_a, node_b, node_c):
            n.stop()


def test_thousand_validator_commits_verify_in_groups_of_four_or_fewer():
    """1,000-validator commits: every batch that reaches the async
    verifier holds whole commits, at most group_sig_target // 1,000 = 4 of
    them, and every height's commit is verified exactly once."""
    from tendermint_tpu_torch import native

    n_vals, heights = 1000, 9
    doc, keys = genesis(PORT, n_vals)
    a = Chain(PORT, doc, keys, heights=heights, txs=2)
    batches: list[int] = []

    def recording_verifier(items):
        batches.append(len(items))
        oks = native.ed25519_verify_batch(items)
        return lambda: oks

    node_a = Node(PORT, doc, fast_sync=False, chain=a, rate=64e6)
    node_b = Node(PORT, doc, fast_sync=True, rate=64e6, async_batch_verifier=recording_verifier,
                  batch_verifier=native.ed25519_verify_batch)
    try:
        sync(a, node_b, node_a, timeout=120)
        assert_synced(a, node_b)
        assert all(n % n_vals == 0 and 0 < n <= 4 * n_vals for n in batches), batches
        assert sum(batches) == n_vals * (heights - 1), batches
    finally:
        node_a.stop()
        node_b.stop()


def test_verifier_error_stops_the_sync_visibly_and_keeps_the_peer():
    """A resolver that raises RuntimeError (a kernel that fails to launch)
    is not a bad block: no peer is stopped, nothing is stored, the reactor
    stops with the error in sync_error, and A stays connected."""
    doc, keys = genesis(PORT, 4)
    a = Chain(PORT, doc, keys, heights=5)

    def failing_verifier(items):
        def resolve():
            raise RuntimeError("kernel launch failed")

        return resolve

    node_a = Node(PORT, doc, fast_sync=False, chain=a)
    node_b = Node(PORT, doc, fast_sync=True, async_batch_verifier=failing_verifier)
    try:
        node_b.dial(node_a)
        assert wait_until(lambda: node_b.bc.sync_error is not None, timeout=30)
        assert isinstance(node_b.bc.sync_error, RuntimeError)
        assert "kernel launch failed" in str(node_b.bc.sync_error)
        assert not node_b.bc.is_running() and not node_b.bc.pool.is_running()
        time.sleep(0.5)
        assert node_b.stops == [] and node_a.stops == []
        assert node_b.sw.peers.size() == 1 and node_a.sw.peers.size() == 1
        assert node_b.store.height() == 0 and node_b.consensus.switched == []
    finally:
        node_a.stop()
        node_b.stop()


def test_fast_sync_hands_over_to_the_real_consensus_reactor(monkeypatch):
    """A port validator that starts empty fast-syncs from a port net, hands
    over through switch_to_consensus to its real ConsensusReactor (no
    stand-in), and then commits new heights with the net: its store passes
    the height it synced to, with the blocks the net made, and a later
    block's LastCommit holds its own precommit. The net's validator holds
    3 of the 4 votes, so the chain moves while the new one syncs; its
    commit timeout paces it at about two blocks a second."""
    from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor
    from tendermint_tpu_torch.consensus.reactor import ConsensusReactor
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.ops.gateway import Hasher
    from tendermint_tpu_torch.p2p import Switch, connect2_switches
    from tendermint_tpu_torch.types import GenesisDoc, GenesisValidator, PrivValidatorFS
    from tests.test_torch_reactors import TEST_CHAIN_ID, make_node, node_info, stop_net

    monkeypatch.setattr(gateway, "_default_hasher", Hasher(device="cpu", min_tpu_batch=1 << 30))
    pvs = sorted((PrivValidatorFS(PORT.gen_priv_key_ed25519(b"handover-%d" % i), None) for i in range(2)),
                 key=lambda pv: pv.get_address())
    doc = GenesisDoc(genesis_time_ns=0, chain_id=TEST_CHAIN_ID,
                     validators=[GenesisValidator(pvs[0].get_pub_key(), 3, "net"),
                                 GenesisValidator(pvs[1].get_pub_key(), 1, "joiner")])
    net, joiner = make_node(doc, pvs[0]), make_node(doc, pvs[1])
    net.cs.config.timeout_commit = 0.5
    net.cs.config.skip_timeout_commit = False

    def init(i, node):
        fast_sync = i == 1
        sw = Switch()
        con_r = ConsensusReactor(node.cs, fast_sync=fast_sync)
        con_r.set_event_switch(node.evsw)
        sw.add_reactor("CONSENSUS", con_r)
        sw.add_reactor("BLOCKCHAIN", BlockchainReactor(
            node.state.copy(), node.cs.proxy_app_conn, node.store, fast_sync=fast_sync,
            status_update_interval=0.5))
        sw.set_node_info(node_info(sw, f"node{i}"))
        return sw

    switches = [init(i, n) for i, n in enumerate((net, joiner))]
    for sw in switches:
        sw.start()
    try:
        assert wait_until(lambda: net.store.height() >= 4, timeout=60)
        connect2_switches(switches, 0, 1)
        con_r = switches[1].reactor("CONSENSUS")
        assert wait_until(lambda: not con_r.fast_sync, timeout=60), joiner.store.height()
        synced = joiner.store.height()
        assert synced >= 3
        assert wait_until(lambda: joiner.store.height() >= synced + 3, timeout=60), \
            (joiner.store.height(), net.store.height())
        top = joiner.store.height()
        for h in range(1, top + 1):
            assert joiner.store.load_block(h).hash() == net.store.load_block(h).hash()

        def signed_by_joiner():
            for h in range(synced + 2, net.store.height() + 1):
                pcs = net.store.load_block(h).last_commit.precommits
                if len(pcs) == 2 and pcs[1] is not None:
                    return True
            return False

        assert wait_until(signed_by_joiner, timeout=60)
        assert joiner.cs.device_error is None
    finally:
        stop_net([net, joiner], switches)
