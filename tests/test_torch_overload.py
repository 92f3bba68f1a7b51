"""The port's mempool lanes (mempool/mempool.py: priority lanes, typed
rejects, per-source limits, reap order) on tests/test_overload.py's
TestMempoolLanes and TestLaneHammer. The file's other cases need the RPC
admission plane and a live node, which the port does not hold yet
(A.7e-1, A.7e-2). The last case holds the port's lanes against the JAX
package's on the same submissions."""

from __future__ import annotations

import threading
import time

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


def wait_until(cond, timeout=30.0, tick=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


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
