"""The port's overload plane on tests/test_overload.py: the RPC ingress
admission (rpc/admission.py: token buckets, the in-flight and connection
caps, the load-shed ladder, request deadlines) in TestAdmission, the
WebSocket fan-out backpressure (rpc/server.py WSConnection) in
TestWSBackpressure, and the mempool lanes (mempool/mempool.py: priority
lanes, typed rejects, per-source limits, reap order) in TestMempoolLanes
and TestLaneHammer. The file's four live-node cases need the node, which
the port does not hold yet (A.7e-2). The last case holds the port's
lanes against the JAX package's on the same submissions."""

from __future__ import annotations

import socket
import threading
import time
from types import SimpleNamespace

import pytest

from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.types import CODE_MEMPOOL_FULL
from tendermint_tpu_torch.config import test_config as _test_config
from tendermint_tpu_torch.mempool import (
    Mempool,
    MempoolFullError,
    MempoolSourceLimitError,
    TxInCacheError,
)
from tendermint_tpu_torch.proxy.app_conn import AppConnMempool
from tendermint_tpu_torch.rpc import admission
from tendermint_tpu_torch.rpc.admission import AdmissionController, retry_after_header
from tendermint_tpu_torch.rpc.core import handlers


def wait_until(cond, timeout=30.0, tick=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


@pytest.fixture(autouse=True)
def _clean_request_tls():
    """Admission state rides a thread-local; tests must not leak a
    deadline or source into each other (or into other test files)."""
    yield
    admission.clear_deadline()
    admission._tls.source_ip = ""


# -- admission unit matrix ---------------------------------------------------


class TestAdmission:
    def test_token_bucket_burst_edge(self, monkeypatch):
        """Exactly `burst` requests admit back-to-back; the next one is a
        429 with a positive Retry-After derived from the refill rate."""
        monkeypatch.setenv("TENDERMINT_RPC_RATE_LIMIT", "5")
        monkeypatch.setenv("TENDERMINT_RPC_RATE_BURST", "2")
        ctl = AdmissionController()
        for _ in range(2):
            a = ctl.admit_request("9.9.9.9", "write")
            assert a
            ctl.request_done()
        a = ctl.admit_request("9.9.9.9", "write")
        assert not a
        assert a.status == 429
        assert a.reason == admission.SHED_RATE_LIMITED
        assert 0 < a.retry_after <= 0.2 + 0.01  # (1 token) / (5/s)
        assert ctl.sheds[admission.SHED_RATE_LIMITED] == 1
        # a different source has its own bucket
        assert ctl.admit_request("8.8.8.8", "write")
        ctl.request_done()
        # waiting one refill interval restores exactly one token
        time.sleep(0.21)
        assert ctl.admit_request("9.9.9.9", "write")
        ctl.request_done()
        assert not ctl.admit_request("9.9.9.9", "write")

    def test_unix_peers_exempt_from_rate_limit(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_RPC_RATE_LIMIT", "1")
        monkeypatch.setenv("TENDERMINT_RPC_RATE_BURST", "1")
        ctl = AdmissionController()
        for _ in range(10):
            assert ctl.admit_request("unix", "write")
            ctl.request_done()
        assert ctl.sheds_total == 0

    def test_inflight_cap(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_RPC_MAX_INFLIGHT", "2")
        ctl = AdmissionController()
        assert ctl.admit_request("1.1.1.1", "read")
        assert ctl.admit_request("1.1.1.1", "read")
        a = ctl.admit_request("1.1.1.1", "read")
        assert not a and a.status == 503
        assert a.reason == admission.SHED_INFLIGHT
        ctl.request_done()
        assert ctl.admit_request("1.1.1.1", "read")
        ctl.request_done()
        ctl.request_done()
        assert ctl.inflight == 0

    def test_connection_cap(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_RPC_MAX_CONNECTIONS", "1")
        ctl = AdmissionController()
        assert ctl.conn_acquire()
        a = ctl.conn_acquire()
        assert not a and a.reason == admission.SHED_CONN_CAP
        ctl.conn_release()
        assert ctl.conn_acquire()

    def test_ladder_sheds_reads_never_writes(self):
        ctl = AdmissionController()
        ctl.pressure_fn = lambda: admission.PRESSURE_SHED_READS
        for kind in ("read", "ws"):
            a = ctl.admit_request("1.1.1.1", kind)
            assert not a and a.reason == admission.SHED_READS
        # writes pass the edge even at shed-writes: the MEMPOOL decides
        # by lane, so the priority lane stays reachable
        ctl.pressure_fn = lambda: admission.PRESSURE_SHED_WRITES
        assert ctl.admit_request("1.1.1.1", "write")
        ctl.request_done()
        # ops stays observable at any ladder level, uncounted
        assert ctl.admit_request("1.1.1.1", "ops")
        assert ctl.inflight == 0

    def test_deadline_armed_and_cleared(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_RPC_DEADLINE_S", "0.5")
        ctl = AdmissionController()
        assert ctl.admit_request("1.1.1.1", "write")
        left = admission.deadline_remaining()
        assert left is not None and 0 < left <= 0.5
        assert admission.request_source() == "1.1.1.1"
        ctl.request_done()
        assert admission.deadline_remaining() is None
        assert admission.request_source() == ""

    def test_deadline_expiry_mid_handler(self):
        """A handler wait that outlives the request budget fails typed
        (deadline_exceeded) and lands on the deadline shed counter —
        never the generic timed-out 500."""
        ctl = AdmissionController()
        ctx = SimpleNamespace(node=SimpleNamespace(rpc_admission=ctl))
        admission.set_deadline(0.02)
        time.sleep(0.03)
        with pytest.raises(handlers.RPCError, match="deadline_exceeded"):
            handlers._wait_or_deadline(ctx, threading.Event(), 10.0, "CheckTx")
        assert ctl.sheds[admission.SHED_DEADLINE] == 1
        # without a deadline the handler's own timeout still fires
        admission.clear_deadline()
        with pytest.raises(handlers.RPCError, match="timed out"):
            handlers._wait_or_deadline(ctx, threading.Event(), 0.01, "CheckTx")
        assert ctl.sheds[admission.SHED_DEADLINE] == 1

    def test_retry_after_header_contract(self):
        # RFC 7231: whole seconds, and never "0" (clients would hot-loop)
        assert retry_after_header(0.05) == "1"
        assert retry_after_header(1.0) == "1"
        assert retry_after_header(3.2) == "4"

    def test_snapshot_keys(self):
        snap = AdmissionController().snapshot()
        for key in ("inflight", "connections", "sheds", "deadline_rejects",
                    "ws_clients", "ws_evictions", "ws_dropped_events"):
            assert key in snap, key


# -- WS fan-out backpressure (unit: no sockets on the event-bus side) --------


class _FakeWSServer:
    def __init__(self, ctl):
        self.admission = ctl
        self.ctx = SimpleNamespace(event_switch=None)
        import logging

        self.logger = logging.getLogger("test.ws")


class TestWSBackpressure:
    def _conn(self, ctl):
        from tendermint_tpu_torch.rpc.server import WSConnection

        a, b = socket.socketpair()
        self._peer = b
        return WSConnection(_FakeWSServer(ctl), a)

    def test_queue_overflow_drops_oldest_then_evicts(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_RPC_WS_QUEUE", "4")
        monkeypatch.setenv("TENDERMINT_RPC_WS_MAX_OVERFLOWS", "2")
        ctl = AdmissionController()
        conn = self._conn(ctl)
        assert ctl.ws_register(conn)
        assert ctl.ws_clients() == 1
        # writer thread deliberately NOT started: the consumer is stuck
        for i in range(4):
            conn.send_json({"i": i})
        assert conn.sendq_depth() == 4
        conn.send_json({"i": 4})  # overflow 1: drop-oldest, stay connected
        assert ctl.ws_dropped_events == 1
        assert conn.sendq_depth() == 4
        assert not conn._torn
        conn.send_json({"i": 5})  # overflow 2: evicted
        assert ctl.ws_evictions == 1
        assert conn._torn
        assert ctl.ws_clients() == 0
        # post-eviction sends are no-ops, not errors (event bus safety)
        conn.send_json({"i": 6})
        self._peer.close()

    def test_ws_client_cap(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_RPC_WS_MAX_CLIENTS", "1")
        ctl = AdmissionController()
        c1, c2 = self._conn(ctl), self._conn(ctl)
        assert ctl.ws_register(c1)
        assert not ctl.ws_register(c2)
        assert ctl.sheds[admission.SHED_WS_CAP] == 1
        ctl.ws_unregister(c1)
        assert ctl.ws_register(c2)

    def test_queue_frac_feeds_pressure(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_RPC_WS_QUEUE", "8")
        ctl = AdmissionController()
        conn = self._conn(ctl)
        ctl.ws_register(conn)
        assert ctl.ws_queue_frac() == 0.0
        for i in range(4):
            conn.send_json({"i": i})
        assert ctl.ws_queue_frac() == pytest.approx(0.5)


def _mk_lane_mempool():
    cfg = _test_config().mempool
    return Mempool(cfg, AppConnMempool(LocalClient(KVStoreApp())))


def _sync_check(mp, tx, **kw):
    """LocalClient is synchronous: the response callback fires inside
    check_tx, so box holds the (possibly mutated) ResponseCheckTx."""
    box = {}
    mp.check_tx(tx, lambda res: box.__setitem__("res", res), **kw)
    return box["res"]


class TestMempoolLanes:
    def test_reap_drains_lanes_in_priority_order(self):
        mp = _mk_lane_mempool()
        mp.check_tx(b"bulk:a=1")
        mp.check_tx(b"plain-a=1")
        mp.check_tx(b"pri:a=1")
        mp.check_tx(b"bulk:b=1")
        mp.check_tx(b"pri:b=1")
        assert mp.reap(-1) == [
            b"pri:a=1", b"pri:b=1",      # priority lane, FIFO within
            b"plain-a=1",                 # default lane
            b"bulk:a=1", b"bulk:b=1",     # bulk lane last
        ]
        assert mp.reap(3) == [b"pri:a=1", b"pri:b=1", b"plain-a=1"]
        assert mp.lane_counts == {"priority": 2, "default": 1, "bulk": 2}

    def test_lane_full_mutates_response_typed(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_MEMPOOL_LANE_BULK_MAX_TXS", "2")
        mp = _mk_lane_mempool()
        assert _sync_check(mp, b"bulk:a=1").code == 0
        assert _sync_check(mp, b"bulk:b=1").code == 0
        res = _sync_check(mp, b"bulk:c=1")
        assert res.code == CODE_MEMPOOL_FULL
        assert res.log == "mempool_lane_full:bulk"
        assert mp.lane_full["bulk"] == 1
        assert mp.size() == 2
        # other lanes unaffected, and the rejected tx left the dedup
        # cache so it can resubmit once the lane drains
        assert _sync_check(mp, b"pri:c=1").code == 0
        mp.lock()
        try:
            mp.update(1, [b"bulk:a=1"])
        finally:
            mp.unlock()
        assert _sync_check(mp, b"bulk:c=1").code == 0

    def test_lane_byte_cap(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_MEMPOOL_LANE_DEFAULT_MAX_BYTES", "16")
        mp = _mk_lane_mempool()
        assert _sync_check(mp, b"k1=0123456789").code == 0  # 12 bytes
        res = _sync_check(mp, b"k2=0123456789")
        assert res.code == CODE_MEMPOOL_FULL
        assert res.log == "mempool_lane_full:default"

    def test_pool_cap_fails_fast_at_intake(self, monkeypatch):
        for lane in ("PRIORITY", "DEFAULT", "BULK"):
            monkeypatch.setenv(f"TENDERMINT_MEMPOOL_LANE_{lane}_MAX_TXS", "1")
        mp = _mk_lane_mempool()
        assert mp.pool_cap == 3
        mp.check_tx(b"pri:a=1")
        mp.check_tx(b"plain=1")
        mp.check_tx(b"bulk:a=1")
        with pytest.raises(MempoolFullError, match="^mempool_full:"):
            mp.check_tx(b"plain=2")
        assert mp.pool_full_rejects == 1
        # fail-fast dropped the cache entry: resubmission after drain works
        mp.lock()
        try:
            mp.update(1, [b"plain=1"])
        finally:
            mp.unlock()
        mp.check_tx(b"plain=2")
        assert mp.size() == 3

    def test_per_source_limit(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_MEMPOOL_SOURCE_MAX_TXS", "2")
        mp = _mk_lane_mempool()
        mp.check_tx(b"a=1", source_id="1.2.3.4")
        mp.check_tx(b"b=1", source_id="1.2.3.4")
        with pytest.raises(MempoolSourceLimitError,
                           match="^mempool_source_limit: rpc:1.2.3.4"):
            mp.check_tx(b"c=1", source_id="1.2.3.4")
        assert mp.source_limited == 1
        # another source (and the peer plane) is unaffected
        mp.check_tx(b"c=1", source_id="5.6.7.8")
        mp.check_tx(b"d=1", source="peer", source_id="peerX")
        assert mp.source_counts == {"rpc:1.2.3.4": 2, "rpc:5.6.7.8": 1,
                                    "peer:peerX": 1}
        # committing a tx releases its slot
        mp.lock()
        try:
            mp.update(1, [b"a=1"])
        finally:
            mp.unlock()
        mp.check_tx(b"e=1", source_id="1.2.3.4")

    def test_shed_writes_spares_priority_lane(self):
        mp = _mk_lane_mempool()
        mp.pressure_fn = lambda: 2  # PRESSURE_SHED_WRITES
        res = _sync_check(mp, b"plain=1")
        assert res.code == CODE_MEMPOOL_FULL
        assert res.log == "mempool_shed_writes:default"
        res = _sync_check(mp, b"bulk:a=1")
        assert res.log == "mempool_shed_writes:bulk"
        assert mp.shed_writes == 2
        # the whole point of the ladder: priority writes still land
        assert _sync_check(mp, b"pri:a=1").code == 0
        assert mp.size() == 1

    def test_gossip_stays_lane_blind(self):
        """The CList the reactor walks keeps ARRIVAL order — lanes bias
        reap (block building), never gossip, so blocks stay
        byte-identical across nodes that disagree about lane config."""
        mp = _mk_lane_mempool()
        order = [b"bulk:a=1", b"pri:a=1", b"plain=1"]
        for tx in order:
            mp.check_tx(tx)
        walked, el = [], mp.txs_front()
        while el is not None:
            walked.append(el.value.tx)
            el = el.next()
        assert walked == order


class TestLaneHammer:
    def test_concurrent_mixed_source_checktx_vs_update_reap(self):
        """4 submitter threads (rpc + peer sources, all three lanes, some
        deliberate duplicates) race a churn thread doing reap + update.
        Afterwards every accounting plane must agree with the pool."""
        mp = _mk_lane_mempool()
        stop = threading.Event()
        dups_hit = []
        errors = []

        def submitter(t):
            prefixes = [b"pri:", b"", b"bulk:"]
            kw = ({"source": "rpc", "source_id": f"10.0.0.{t}"}
                  if t % 2 == 0 else
                  {"source": "peer", "source_id": f"peer{t}"})
            for i in range(150):
                tx = prefixes[i % 3] + f"k{t}-{i}=v".encode()
                try:
                    mp.check_tx(tx, **kw)
                except TxInCacheError:
                    dups_hit.append(tx)
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                if i % 25 == 0:
                    # the same tx from every thread: dedup-cache hammer
                    try:
                        mp.check_tx(b"dup=1", **kw)
                    except TxInCacheError:
                        dups_hit.append(b"dup=1")

        def churner():
            height = 0
            while not stop.is_set():
                txs = mp.reap(20)
                height += 1
                mp.lock()
                try:
                    mp.update(height, txs[:10])
                finally:
                    mp.unlock()
                time.sleep(0.001)

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(4)]
        churn = threading.Thread(target=churner)
        churn.start()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        stop.set()
        churn.join(timeout=60)
        assert not errors, errors

        # -- invariants: lanes, bytes, and sources all agree with the pool
        by_lane = {"priority": 0, "default": 0, "bulk": 0}
        by_lane_bytes = dict.fromkeys(by_lane, 0)
        by_source: dict[str, int] = {}
        el = mp.txs_front()
        while el is not None:
            memtx = el.value
            by_lane[memtx.lane] += 1
            by_lane_bytes[memtx.lane] += len(memtx.tx)
            by_source[memtx.source] = by_source.get(memtx.source, 0) + 1
            el = el.next()
        assert mp.lane_counts == by_lane
        assert mp.lane_bytes == by_lane_bytes
        assert mp.source_counts == by_source
        assert sum(by_lane.values()) == mp.size()
        # the shared dup tx collided at the cache and was counted
        assert mp.cache_dups >= len(dups_hit) > 0
        assert not mp._pending_source, "pending-source map leaked entries"


def test_lanes_equal_jax(monkeypatch):
    """The same submissions (three lanes, two sources, a duplicate, a
    per-source overflow) into a port and a JAX mempool give the same
    typed refusals, the same source counts and the same reap order."""
    import importlib

    monkeypatch.setenv("TENDERMINT_MEMPOOL_SOURCE_MAX_TXS", "2")

    def run(root: str):
        m = importlib.import_module(f"{root}.mempool")
        kv = importlib.import_module(f"{root}.abci.apps.kvstore")
        lc = importlib.import_module(f"{root}.abci.client")
        ac = importlib.import_module(f"{root}.proxy.app_conn")
        cfgm = importlib.import_module(f"{root}.config")
        cfg = cfgm.test_config().mempool
        mp = m.Mempool(cfg, ac.AppConnMempool(lc.LocalClient(kv.KVStoreApp())))
        out = []
        subs = [(b"bulk:k1=v", "rpc", "1.2.3.4"), (b"k2=v", "rpc", "1.2.3.4"),
                (b"prio:k3=v", "peer", "p1"), (b"k2=v", "rpc", "5.6.7.8"),
                (b"k4=v", "rpc", "1.2.3.4"), (b"prio:k5=v", "rpc", "1.2.3.4"),
                (b"bulk:k6=v", "peer", "p1"), (b"k7=v", "rpc", "9.9.9.9")]
        for tx, src, sid in subs:
            try:
                _sync_check(mp, tx, source=src, source_id=sid)
                out.append("ok")
            except Exception as exc:  # noqa: BLE001 — the typed refusal is the result
                out.append(type(exc).__name__)
        return out, dict(mp.source_counts), mp.reap(-1)

    got = run("tendermint_tpu_torch")
    assert got == run("tendermint_tpu")
    assert {"ok", "TxInCacheError", "MempoolSourceLimitError"} <= set(got[0])
