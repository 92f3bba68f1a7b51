"""The port's verified read-replica tier (tendermint_tpu_torch/replica/),
on the cases of tests/test_replica.py, with the replica verifying on the
gateway's default Verifier set to the CPU (`host_defaults`: a port replica
takes the card's, and there is none here).

The upstream is a REAL RPCServer over the port's DevChain: the replica
follows it through the same WS subscription + HTTP fetch path it uses
against a live node, so reconnect/replay, tamper detection, and the
serve-window semantics are exercised end to end in-process. Beside them:
a JAX replica and a port replica following one upstream serve equal
verified reads, blocks, commits, validator sets, status and metrics, and
refuse the same lying upstream; and the port's device rule (no card and
no daemon raises before binding; a DeviceError under the follower stops
it, kept and shown, never retried)."""

from __future__ import annotations

import json
import queue
import shutil
import socket
import tempfile
import threading
import time
import urllib.error
import urllib.request

import pytest

from tendermint_tpu_torch.config.toml import ensure_root
from tendermint_tpu_torch.libs.events import EventSwitch
from tendermint_tpu_torch.node.light_anchor import load_anchor
from tendermint_tpu_torch.ops import gateway
from tendermint_tpu_torch.replica import ProofCache, ReplicaDaemon
from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError, WSClient
from tendermint_tpu_torch.rpc.core.handlers import RPCError
from tendermint_tpu_torch.rpc.core.pipe import RPCContext
from tendermint_tpu_torch.rpc.light import LightClient, LightClientError
from tendermint_tpu_torch.rpc.server import RPCServer
from tendermint_tpu_torch.statesync.devchain import build_kvstore_chain
from tendermint_tpu_torch.types import events as tev

INITIAL_HEIGHT = 6

# Completeness contract for the replica's flat metric surface — the
# replica-side twin of METRICS_REQUIRED_KEYS in tests/test_node_rpc.py
# (a separate daemon, a separate tuple). Adding a replica_* family?
# Extend this so the test below guards the new name; catalog rows live
# in docs/observability.md.
REPLICA_METRICS_REQUIRED_KEYS = (
    # follower plane
    "replica_height",
    "replica_lag_heights",
    "replica_upstream_height",
    "replica_upstream_connected",
    "replica_upstream_reconnects",
    # proof-carrying cache
    "replica_cache_hits",
    "replica_cache_misses",
    "replica_cache_entries",
    "replica_cache_invalidations",
    "replica_proof_verify_failures",
    # serving plane
    "replica_served_reads_total",
    "replica_relayed_events_total",
)


def _wait(cond, timeout: float = 15.0, every: float = 0.02, what: str = ""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(every)
    raise AssertionError(f"timed out waiting for {what or cond}")


def _drain_heights(ws, want: set[int], timeout: float = 10.0) -> set[int]:
    """Collect NewBlock heights off a WS client until `want` is covered
    (or the timeout lapses)."""
    heights: set[int] = set()
    deadline = time.monotonic() + timeout
    while (want - heights) and time.monotonic() < deadline:
        try:
            ev = ws.next_event(timeout=0.5)
        except queue.Empty:
            continue
        hdr = ((ev.get("data") or {}).get("block") or {}).get("header") or {}
        h = hdr.get("height")
        if isinstance(h, int) and not isinstance(h, bool):
            heights.add(h)
    return heights


class UpstreamSim:
    """A DevChain behind a real RPCServer: the subset of a node's
    surface a replica consumes (status/genesis/commit/validators/block/
    abci_query over HTTP, NewBlock announcements over WS). `stop()` +
    `start()` on the same port models an upstream restart."""

    def __init__(self, chain, port: int = 0):
        self.chain = chain
        self._port = port
        self.evsw: EventSwitch | None = None
        self.srv: RPCServer | None = None
        self.start()

    def _routes(self) -> dict:
        chain = self.chain
        stub = chain.rpc_stub()

        def status(ctx):
            return {
                "latest_block_height": chain.block_store.height(),
                "earliest_block_height": 1,
            }

        def genesis(ctx):
            return {"genesis": chain.genesis_doc.to_json()}

        def commit(ctx, height=0):
            return stub.commit(height)

        def validators(ctx, height=0):
            return stub.validators(height)

        def block(ctx, height=0):
            h = int(height)
            meta = chain.block_store.load_block_meta(h)
            blk = chain.block_store.load_block(h)
            return {
                "block_meta": meta.to_json() if meta else None,
                "block": blk.to_json() if blk else None,
            }

        def abci_query(ctx, data="", path="", height=0, prove=False):
            return stub.abci_query(data, path, height, prove)

        return {
            "status": (status, []),
            "genesis": (genesis, []),
            "commit": (commit, ["height"]),
            "validators": (validators, ["height"]),
            "block": (block, ["height"]),
            "abci_query": (abci_query, ["data", "path", "height", "prove"]),
        }

    def start(self) -> None:
        self.evsw = EventSwitch()
        self.evsw.start()
        ctx = RPCContext(event_switch=self.evsw)
        self.srv = RPCServer(
            f"tcp://127.0.0.1:{self._port}", ctx, routes=self._routes()
        )
        self.srv.start()
        self._port = self.srv.port

    @property
    def port(self) -> int:
        return self._port

    def announce(self, height: int) -> None:
        """What a node's consensus fires on commit — just enough of the
        NewBlock event for a follower to learn the height."""
        self.evsw.fire_event(
            tev.EVENT_NEW_BLOCK, {"block": {"header": {"height": int(height)}}}
        )

    def commit_and_announce(self, txs: list[bytes]) -> int:
        self.chain.commit_block(txs)
        h = self.chain.block_store.height()
        self.announce(h)
        return h

    def stop(self) -> None:
        srv, self.srv = self.srv, None
        if srv is None:
            return
        srv.stop()
        # in-process stop() leaves live WS sessions parked in their
        # handler threads: force-teardown so followers see EOF — the
        # in-process analogue of the upstream process dying
        for conn in list(srv.admission._ws):
            conn._teardown()
        self.evsw.stop()


@pytest.fixture(scope="module", autouse=True)
def host_defaults():
    """The gateway's default verifier on the CPU for the module's replicas:
    a port replica takes the card's default, and there is none here."""
    saved = gateway._default_verifier
    gateway._default_verifier = gateway.Verifier(device="cpu")
    yield
    gateway._default_verifier = saved


def _home() -> str:
    return tempfile.mkdtemp(prefix="tmd", dir="/tmp")


@pytest.fixture(scope="module")
def sim():
    s = UpstreamSim(build_kvstore_chain(INITIAL_HEIGHT))
    yield s
    s.stop()


@pytest.fixture(scope="module")
def replica(sim):
    home = _home()
    cfg = ensure_root(home)
    cfg.replica.upstream = f"127.0.0.1:{sim.port}"
    cfg.replica.laddr = "tcp://127.0.0.1:0"
    rep = ReplicaDaemon(cfg)
    rep.start()
    try:
        _wait(lambda: rep._ingested >= INITIAL_HEIGHT, what="initial catch-up")
    except BaseException:
        rep.stop()
        raise
    yield rep
    rep.stop()
    shutil.rmtree(home, ignore_errors=True)


def _addr(rep) -> str:
    return f"127.0.0.1:{rep.rpc_port}"


# -- proof cache units -------------------------------------------------------


class TestProofCache:
    def test_exact_get_and_latest_floor(self):
        c = ProofCache(8)
        ent = {"response": {"value": "AA"}}
        c.put("", "6b31", 5, ent)
        assert c.get("", "6B31", 5) is ent  # key hex is case-insensitive
        assert c.get_latest("", "6b31", 1) is ent
        # proven below the staleness floor -> must refetch
        assert c.get_latest("", "6b31", 6) is None
        st = c.stats()
        assert st["hits"] == 2 and st["misses"] == 1

    def test_key_invalidation_spares_pinned_reads(self):
        c = ProofCache(8)
        kh = b"k".hex()
        c.put("", kh, 5, {"v": 1})
        c.note_block(6, [b"k=new", b"other"])
        # "latest" must refetch (the key changed at 6)...
        assert c.get_latest("", kh, 1) is None
        # ...but the height-pinned proof is still a valid answer for 5
        assert c.get("", kh, 5) == {"v": 1}
        # an untouched key keeps serving latest
        c.put("", b"z".hex(), 5, {"v": 2})
        assert c.get_latest("", b"z".hex(), 1) == {"v": 2}

    def test_all_mode_invalidates_every_key(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_REPLICA_INVALIDATE", "all")
        c = ProofCache(8)
        c.put("", b"a".hex(), 5, {"v": 1})
        c.note_block(6, [b"unrelated-opaque-tx"])
        assert c.get_latest("", b"a".hex(), 1) is None
        assert c.get("", b"a".hex(), 5) == {"v": 1}

    def test_lru_eviction_clears_latest_pointer(self):
        c = ProofCache(2)
        c.put("", "aa", 1, {"n": 1})
        c.put("", "bb", 2, {"n": 2})
        c.put("", "cc", 3, {"n": 3})  # evicts ("", "aa", 1)
        assert c.stats()["entries"] == 2
        assert c.get("", "aa", 1) is None
        assert c.get_latest("", "aa", 1) is None  # no dangling pointer

    def test_prune_drops_stale_touch_rows(self):
        c = ProofCache(8)
        c.note_block(3, [b"a=1"])
        c.note_block(9, [b"b=2"])
        c.prune(5)
        assert b"a".hex() not in c._touched
        assert c._touched[b"b".hex()] == 9


# -- daemon construction guards ---------------------------------------------


def test_upstream_is_required():
    cfg = ensure_root(_home())
    with pytest.raises(ValueError, match="upstream"):
        ReplicaDaemon(cfg)


def test_query_before_bootstrap_is_typed_warming():
    cfg = ensure_root(_home())
    cfg.replica.upstream = "127.0.0.1:1"
    rep = ReplicaDaemon(cfg)  # never started: no verified state
    with pytest.raises(RPCError, match="replica_warming"):
        rep.query(data=b"k".hex(), height=0)


# -- follow + verified read path ---------------------------------------------


def test_follows_upstream_and_serves_verified_reads(replica):
    """A client light pointed at the replica verifies end to end —
    trust bootstraps from the replica's /genesis, advances through its
    re-served commits, and the proof checks against the walk."""
    lc = LightClient.from_genesis(HTTPClient(_addr(replica)))
    res = lc.verified_query(b"k3-0")
    assert res["value"] == b"v3"
    assert not res["absent"]

    hits0 = replica.cache.stats()["hits"]
    reads0 = replica.served_reads_total
    res2 = lc.verified_query(b"k3-0")
    assert res2["value"] == b"v3"
    assert res2["height"] == res["height"]
    assert replica.cache.stats()["hits"] >= hits0 + 1
    assert replica.served_reads_total >= reads0 + 1
    assert replica.proof_verify_failures == 0


def test_status_carries_replica_identity_and_lag(replica):
    st = HTTPClient(_addr(replica)).status()
    assert st["node_info"]["replica"] is True
    assert st["node_info"]["upstream"] == replica.upstream
    assert st["latest_block_height"] >= INITIAL_HEIGHT
    assert st["earliest_block_height"] >= 1
    assert st["replica_lag_heights"] == 0
    assert st["replica"]["connected"] is True
    assert st["replica"]["max_lag_heights"] == replica.max_lag()


def test_block_and_blockchain_windows(replica):
    c = HTTPClient(_addr(replica))
    h = replica._ingested
    blk = c.block(height=h)
    assert blk["block"]["header"]["height"] == h
    info = c.blockchain(min_height=1, max_height=h)
    assert info["last_height"] >= h
    metas = info["block_metas"]
    assert metas, "replica served an empty recent window"
    got = [m["header"]["height"] for m in metas]
    assert got == sorted(got, reverse=True)  # newest first
    # outside the verified window: typed error naming the window start
    with pytest.raises(RPCClientError, match="no commit"):
        c.commit(height=10_000)


def test_metrics_on_both_surfaces(replica):
    flat = HTTPClient(_addr(replica)).metrics()
    for key in REPLICA_METRICS_REQUIRED_KEYS:
        assert key in flat, f"missing {key} in replica metrics"
    assert flat["replica_height"] >= INITIAL_HEIGHT
    # the ingress plane runs on the replica's own listener
    assert "rpc_inflight" in flat
    body = urllib.request.urlopen(
        f"http://{_addr(replica)}/metrics", timeout=10
    ).read().decode()
    assert "replica_height" in body
    assert "replica_served_reads_total" in body


def test_follower_absorbs_upstream_sheds_as_pacing(replica):
    # a rate-limited upstream answers `shed:<reason>` (HTTP 429/503);
    # the follower must retry through it, not raise into the
    # reconnect path — and anything non-shed must still propagate
    calls = []

    def shed_twice():
        calls.append(1)
        if len(calls) < 3:
            raise RPCClientError("shed:rate_limited")
        return "through"

    assert replica._shed_paced(shed_twice) == "through"
    assert len(calls) == 3

    def hard_fail():
        raise RPCClientError("HTTP 500")

    with pytest.raises(RPCClientError, match="HTTP 500"):
        replica._shed_paced(hard_fail)


def test_health_probe(replica):
    with urllib.request.urlopen(
        f"http://{_addr(replica)}/health", timeout=10
    ) as resp:
        assert resp.status == 200
        report = json.loads(resp.read().decode())
    assert report["status"] == "ok"
    assert report["checks"]["upstream_connected"]["ok"] is True


def test_stale_replica_refuses_latest_reads(replica, monkeypatch):
    monkeypatch.setenv("TENDERMINT_REPLICA_MAX_LAG_HEIGHTS", "2")
    old = replica.upstream_height
    replica.upstream_height = replica._ingested + 5
    try:
        with pytest.raises(RPCClientError, match="replica_stale"):
            HTTPClient(_addr(replica)).abci_query(
                data=b"k1-0".hex(), path="", height=0, prove=True
            )
    finally:
        replica.upstream_height = old


# -- tamper: a lying replica is detected, never trusted ----------------------


def test_tampered_responses_rejected_client_side(replica, monkeypatch):
    """Flipping one byte in a cached value or proof is rejected by EVERY
    verifying client — 100%, both tamper modes."""
    keys = [b"k1-0", b"k2-1", b"k3-0", b"k4-1", b"k5-0"]
    for mode in ("value", "proof"):
        monkeypatch.setenv("TENDERMINT_REPLICA_TAMPER", mode)
        lc = LightClient.from_genesis(HTTPClient(_addr(replica)))
        rejected = 0
        for key in keys:
            with pytest.raises(LightClientError):
                lc.verified_query(key)
            rejected += 1
        assert rejected == len(keys)
    # the knob corrupts at serve time only: clean env serves clean bytes
    monkeypatch.delenv("TENDERMINT_REPLICA_TAMPER")
    lc = LightClient.from_genesis(HTTPClient(_addr(replica)))
    assert lc.verified_query(b"k3-0")["value"] == b"v3"


# -- WS relay lifecycle ------------------------------------------------------


def test_event_relay_one_upstream_many_clients(replica, sim):
    subs = [WSClient(_addr(replica)) for _ in range(3)]
    try:
        for ws in subs:
            ws.subscribe(tev.EVENT_NEW_BLOCK)
        h = sim.commit_and_announce([b"relay-1=r1"])
        _wait(lambda: replica._ingested >= h, what=f"ingest of {h}")
        for ws in subs:
            assert h in _drain_heights(ws, {h})
    finally:
        for ws in subs:
            ws.close()


def test_client_eviction_never_tears_down_upstream_sub(replica, sim):
    ws = WSClient(_addr(replica))
    ws.subscribe(tev.EVENT_NEW_BLOCK)
    _wait(lambda: len(replica._rpc.admission._ws) >= 1, what="ws register")
    # force-evict EVERY downstream subscriber (what queue-overflow
    # eviction does) — the shared upstream subscription must survive
    for conn in list(replica._rpc.admission._ws):
        conn._teardown()
    reconnects0 = replica.upstream_reconnects
    h = sim.commit_and_announce([b"evict-1=e1"])
    _wait(lambda: replica._ingested >= h, what=f"ingest of {h}")
    assert replica.upstream_reconnects == reconnects0
    # and a fresh subscriber picks up the stream
    ws2 = WSClient(_addr(replica))
    try:
        ws2.subscribe(tev.EVENT_NEW_BLOCK)
        h2 = sim.commit_and_announce([b"evict-2=e2"])
        assert h2 in _drain_heights(ws2, {h2})
    finally:
        ws2.close()
        ws.close()


def test_upstream_drop_reconnects_and_replays(replica, sim):
    """Upstream restart: the follower re-subscribes with backoff and
    replays the heights committed while it was dark — downstream WS
    clients see every replayed block, none skipped."""
    ws = WSClient(_addr(replica))
    try:
        ws.subscribe(tev.EVENT_NEW_BLOCK)
        reconnects0 = replica.upstream_reconnects
        sim.stop()
        _wait(lambda: not replica.connected, what="drop detection")
        # two blocks commit while the replica is dark
        sim.chain.build(2, tx_fn=lambda h: [b"dark-%d=d%d" % (h, h)])
        sim.start()
        target = sim.chain.block_store.height()
        _wait(lambda: replica._ingested >= target, timeout=30,
              what=f"replay to {target}")
        assert replica.upstream_reconnects > reconnects0
        assert replica.connected
        # both missed heights were relayed to the surviving client
        missed = {target - 1, target}
        assert _drain_heights(ws, missed) >= missed
    finally:
        ws.close()
    # the replayed state serves verified reads immediately (a proof at
    # the newest provable height: header H commits block H-1's state)
    lc = LightClient.from_genesis(HTTPClient(_addr(replica)))
    h = replica._ingested - 1
    assert lc.verified_query(b"dark-%d" % h)["value"] == b"d%d" % h


# -- tiering: a replica follows a replica ------------------------------------


def test_replica_chains_behind_replica(replica):
    home = _home()
    cfg = ensure_root(home)
    cfg.replica.upstream = _addr(replica)
    cfg.replica.laddr = "tcp://127.0.0.1:0"
    b = ReplicaDaemon(cfg)
    b.start()
    try:
        head = replica._ingested
        _wait(lambda: b._ingested >= head, what="tier-2 catch-up")
        lc = LightClient.from_genesis(HTTPClient(_addr(b)))
        res = lc.verified_query(b"k2-0")
        assert res["value"] == b"v2"
        assert b.proof_verify_failures == 0
    finally:
        b.stop()
    # stop persisted the trust anchor: a restart resumes, not re-walks
    anchor = load_anchor(cfg.replica.root_dir, b.genesis_doc.chain_id)
    assert anchor is not None
    assert anchor[0] >= 2


# -- against the JAX package ----------------------------------------------------


def _jax_replica(upstream: str, home: str):
    from tendermint_tpu.config.toml import ensure_root as jensure_root
    from tendermint_tpu.replica import ReplicaDaemon as JReplicaDaemon

    cfg = jensure_root(home)
    cfg.replica.upstream = upstream
    cfg.replica.laddr = "tcp://127.0.0.1:0"
    return JReplicaDaemon(cfg)


def _port_replica(upstream: str, home: str):
    cfg = ensure_root(home)
    cfg.replica.upstream = upstream
    cfg.replica.laddr = "tcp://127.0.0.1:0"
    return ReplicaDaemon(cfg)


@pytest.fixture
def pair():
    """A JAX replica and a port replica following one upstream (a fresh
    port DevChain behind a real RPCServer), both caught up to its head."""
    s = UpstreamSim(build_kvstore_chain(INITIAL_HEIGHT))
    homes = [_home(), _home()]
    upstream = f"127.0.0.1:{s.port}"
    reps = {"jax": _jax_replica(upstream, homes[0]), "port": _port_replica(upstream, homes[1])}
    started = []
    try:
        for rep in reps.values():
            rep.start()
            started.append(rep)
        head = s.chain.block_store.height()
        for name, rep in reps.items():
            _wait(lambda rep=rep: rep._ingested >= head and rep.connected, what=f"{name} catch-up")
        yield s, reps
    finally:
        for rep in started:
            rep.stop()
        s.stop()
        for h in homes:
            shutil.rmtree(h, ignore_errors=True)


STATUS_CHAIN_FIELDS = ("latest_block_hash", "latest_app_hash", "latest_block_height",
                       "earliest_block_height", "latest_block_time", "replica_lag_heights")


def _served(rep, head: int) -> dict:
    """What one replica serves over its own RPC, in one fixed order:
    verified reads through a LightClient pointed at it, the raw proven
    abci_query bodies, blocks, the blockchain window, commits, validator
    sets, status's chain fields and the replica_* metrics."""
    c = HTTPClient(_addr(rep))
    lc = LightClient.from_genesis(HTTPClient(_addr(rep)))
    keys = [b"k1-0", b"k3-1", b"k5-0", b"never-written"]
    reads = {}
    for k in keys:
        r = lc.verified_query(k)
        reads[k] = (r["value"], r["absent"], r["height"])
    pinned = {k: c.abci_query(data=k.hex(), path="", height=head - 1, prove=True) for k in keys}
    st = c.status()
    flat = c.metrics()
    return {
        "reads": reads,
        "pinned": pinned,
        "blocks": [c.block(height=h) for h in range(1, head + 1)],
        "blockchain": [c.blockchain(min_height=1, max_height=head), c.blockchain()],
        "commits": [c.commit(height=h) for h in range(1, head + 1)],
        "validators": [c.validators(height=0)] + [c.validators(height=h) for h in range(1, head + 1)],
        "status": {k: st[k] for k in STATUS_CHAIN_FIELDS},
        "status_replica": st["replica"],
        "node_info": st["node_info"],
        "metrics": {k: flat[k] for k in REPLICA_METRICS_REQUIRED_KEYS},
    }


def test_jax_and_port_replicas_serve_equal_bodies(pair):
    """One upstream, a JAX replica and a port replica: the same verified
    values, the same proven abci_query, block, blockchain, commit and
    validators bodies, the same status chain fields and the same
    replica_* metric values after the same reads."""
    s, reps = pair
    head = s.chain.block_store.height()
    served = {name: _served(rep, head) for name, rep in reps.items()}
    assert served["port"] == served["jax"]
    got = served["port"]
    assert got["reads"][b"k3-1"] == (b"v3", False, head - 1)
    assert got["reads"][b"never-written"] == (None, True, head - 1)
    assert got["status"]["latest_block_height"] == head
    assert got["metrics"]["replica_proof_verify_failures"] == 0
    assert got["metrics"]["replica_cache_hits"] >= 1


class _LyingBlockSim(UpstreamSim):
    """An upstream whose /block at `bad` carries a header the verified
    commit did not sign (its app hash flipped)."""

    bad = 4

    def _routes(self) -> dict:
        routes = super()._routes()
        real_block, params = routes["block"]

        def block(ctx, height=0):
            out = real_block(ctx, height)
            if int(height) == self.bad and out["block"] is not None:
                out = json.loads(json.dumps(out))
                hdr = out["block"]["header"]
                app = bytearray(bytes.fromhex(hdr["app_hash"]) or b"\x00")
                app[0] ^= 0x01
                hdr["app_hash"] = app.hex().upper()
            return out

        routes["block"] = (block, params)
        return routes


def test_both_replicas_refuse_a_block_not_matching_its_verified_header():
    """An upstream serving block bytes that are not the ones the verified
    commit signed: both packages' replicas refuse the height, count it in
    proof_verify_failures, and serve nothing past the height before it."""
    s = _LyingBlockSim(build_kvstore_chain(INITIAL_HEIGHT))
    homes = [_home(), _home()]
    upstream = f"127.0.0.1:{s.port}"
    reps = {"jax": _jax_replica(upstream, homes[0]), "port": _port_replica(upstream, homes[1])}
    started = []
    try:
        for rep in reps.values():
            rep.start()
            started.append(rep)
        for name, rep in reps.items():
            _wait(lambda rep=rep: rep.proof_verify_failures >= 1, what=f"{name} refusal")
        seen = {}
        for name, rep in reps.items():
            with pytest.raises(RPCClientError, match="no block"):
                HTTPClient(_addr(rep)).block(height=_LyingBlockSim.bad)
            seen[name] = (rep._ingested, rep.light.height, rep.proof_verify_failures >= 1,
                          HTTPClient(_addr(rep)).block(height=_LyingBlockSim.bad - 1)["block"]["header"]["height"])
        assert seen["port"] == seen["jax"] == (_LyingBlockSim.bad - 1, _LyingBlockSim.bad, True,
                                               _LyingBlockSim.bad - 1)
    finally:
        for rep in started:
            rep.stop()
        s.stop()
        for h in homes:
            shutil.rmtree(h, ignore_errors=True)


# -- the port's device rule -----------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_no_card_no_daemon_raises_before_binding(monkeypatch):
    """A port replica takes the gateway's default Verifier when it is
    built: with no card, no serving daemon and none injected, building it
    raises resolve_device's RuntimeError and its listener never binds (the
    JAX replica verifies on the CPU). The card is taken away on every
    host, a CUDA one too."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(gateway, "_default_verifier", None)
    monkeypatch.setenv("TENDERMINT_DEVD_SOCK", "/nonexistent/devd.sock")
    monkeypatch.delenv("TENDERMINT_DEVD_SOCKS", raising=False)
    monkeypatch.delenv("TENDERMINT_TPU_KERNEL", raising=False)
    cfg = ensure_root(_home())
    port = _free_port()
    cfg.replica.upstream = "127.0.0.1:1"
    cfg.replica.laddr = f"tcp://127.0.0.1:{port}"
    with pytest.raises(RuntimeError, match="CUDA is not available; pass device='cpu'"):
        ReplicaDaemon(cfg)
    with socket.socket() as s:  # nothing listens there
        assert s.connect_ex(("127.0.0.1", port)) != 0


class _FailingVerifier(gateway.Verifier):
    """A CPU Verifier whose commit verify raises DeviceError: a kernel that
    fails to launch on the card."""

    def __init__(self):
        super().__init__(device="cpu")
        self.calls = 0
        self._mtx = threading.Lock()

    def commit_batch_verifier(self):
        def verify(items):
            with self._mtx:
                self.calls += 1
            raise gateway.DeviceError("ed25519_verify kernel launch failed: cudaError 700")

        return verify


def test_device_error_in_the_walk_stops_the_follower_visibly(sim, monkeypatch):
    """A DeviceError under the follower's light walk ends the follow loop
    at once: it is kept in `device_error`, the health verdict fails (HTTP
    503) and `device_errors` counts it; the walk is not retried through
    the reconnect path and nothing past trust is served."""
    failing = _FailingVerifier()
    monkeypatch.setattr(gateway, "_default_verifier", failing)
    home = _home()
    rep = _port_replica(f"127.0.0.1:{sim.port}", home)
    assert rep.verifier is failing
    rep.start()
    try:
        _wait(lambda: rep.device_error is not None, what="the device error")
        rep._follow.join(timeout=5.0)
        assert not rep._follow.is_alive()  # the follow loop ended
        assert isinstance(rep.device_error, gateway.DeviceError)
        assert "cudaError 700" in str(rep.device_error)
        time.sleep(3 * rep.cfg.reconnect_backoff_s)
        assert failing.calls == 1  # no retry
        assert rep.upstream_reconnects == 0 and not rep.connected
        assert rep._ingested == 0 and rep.light.height == 0
        report = rep.health_view()
        assert report["status"] == "failing" and report["code"] == 2
        assert report["checks"]["device"] == {"ok": False, "error": str(rep.device_error)}
        assert rep.stats()["device_errors"] == 1
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(f"http://{_addr(rep)}/health", timeout=10)
        assert exc_info.value.code == 503
        assert HTTPClient(_addr(rep)).metrics()["replica_device_errors"] == 1
    finally:
        rep.stop()
        shutil.rmtree(home, ignore_errors=True)
