"""The port's bounded-retention lifecycle (docs/state-sync.md § Retention),
on the cases of tests/test_retention.py.

Covers the retention coordinator's safe-retain-height formula, the
block store's crash-safe prune (watermark-first + clean_base resume,
held with a REAL SIGKILL mid-delete in a subprocess), WAL chunk
retention, prune-vs-concurrent-reader races (RPC block reads and the
statesync producer racing an in-flight prune_to see base-consistent
results, never partial deletes), the RPC range clamping on pruned
stores, the fast-sync pool's below-base peer ineligibility, and the
below-horizon statesync fallback trigger.

The live multi-node tiers — the retention soak (disk bounded by
retention, wiped node re-joins via snapshot), the adversarial statesync
offerer matrix, and the laggard-below-horizon auto-switch — live in
tests/test_netchaos.py (slow-marked) and benches/bench_retention.py
(`make retention-smoke`, tier 1).
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from tendermint_tpu_torch.blockchain.pool import BlockPool
from tendermint_tpu_torch.blockchain.store import BlockStore
from tendermint_tpu_torch.config.config import PruningConfig
from tendermint_tpu_torch.libs.db import FileDB, MemDB
from tendermint_tpu_torch.node.retention import (
    MIN_RETAIN_BLOCKS,
    RetentionCoordinator,
)
from tendermint_tpu_torch.statesync.devchain import build_kvstore_chain
from tests.test_torch_consensus import host_device  # noqa: F401 — autouse: CPU gateway defaults

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- safe-retain-height formula ----------------------------------------------


class _FakeSnapStore:
    def __init__(self, heights):
        self._heights = list(heights)

    def heights(self):
        return sorted(self._heights)


class _FakeEvPool:
    def __init__(self, min_h):
        self._min = min_h

    def min_pending_height(self):
        return self._min


class _FakeTree:
    def __init__(self, versions):
        self._versions = list(versions)

    def versions(self):
        return sorted(self._versions)


class _FakeTreeApp:
    def __init__(self, versions):
        self.tree = _FakeTree(versions)


def _coord(retain=20, interval=5, **kw):
    cfg = PruningConfig(retain_blocks=retain, interval_heights=interval)
    return RetentionCoordinator(cfg, BlockStore(MemDB()), **kw)


class TestSafeRetainHeight:
    def test_operator_target_alone(self):
        c = _coord(retain=20)
        safe, floors = c.safe_retain_height(100)
        assert safe == 81 and floors == {"operator": 81}

    def test_never_below_one(self):
        safe, _ = _coord(retain=50).safe_retain_height(10)
        assert safe == 1

    def test_snapshot_floor_wins(self):
        c = _coord(retain=5, snapshot_store=_FakeSnapStore([60, 80]))
        safe, floors = c.safe_retain_height(100)
        # operator target 96, oldest published snapshot 60: the producer
        # must stay serviceable, so 60 wins
        assert safe == 60 and floors["snapshots"] == 60

    def test_evidence_floor_wins(self):
        c = _coord(retain=5, evidence_pool=_FakeEvPool(42))
        safe, floors = c.safe_retain_height(100)
        assert safe == 42 and floors["evidence"] == 42

    def test_statetree_floor_wins(self):
        c = _coord(retain=5, tree_app=_FakeTreeApp([70, 71, 72]))
        safe, floors = c.safe_retain_height(100)
        assert safe == 70 and floors["statetree"] == 70

    def test_min_of_all_planes(self):
        c = _coord(
            retain=10,
            snapshot_store=_FakeSnapStore([85]),
            evidence_pool=_FakeEvPool(88),
            tree_app=_FakeTreeApp([80, 90]),
        )
        safe, floors = c.safe_retain_height(100)
        assert floors == {
            "operator": 91, "snapshots": 85, "evidence": 88, "statetree": 80,
        }
        assert safe == 80

    def test_absent_planes_do_not_constrain(self):
        c = _coord(
            retain=10,
            snapshot_store=_FakeSnapStore([]),
            evidence_pool=_FakeEvPool(None),
            tree_app=_FakeTreeApp([]),
        )
        safe, floors = c.safe_retain_height(100)
        assert safe == 91 and set(floors) == {"operator"}

    def test_retain_clamped_to_min(self):
        c = _coord(retain=1)
        assert c.retain_blocks == MIN_RETAIN_BLOCKS

    def test_disabled_coordinator_is_inert(self):
        cfg = PruningConfig()  # retain_blocks=0 -> off
        chain = build_kvstore_chain(6)

        class _S:
            last_block_height = 6

        c = RetentionCoordinator(cfg, chain.block_store)
        assert c.maybe_prune(_S()) is None
        assert chain.block_store.base() == 1

    def test_maybe_prune_interval_and_never_raises(self):
        chain = build_kvstore_chain(20)
        cfg = PruningConfig(retain_blocks=5, interval_heights=10)
        c = RetentionCoordinator(cfg, chain.block_store)

        class _S:
            last_block_height = 7

        assert c.maybe_prune(_S()) is None  # off-interval: no pass
        _S.last_block_height = 20
        assert c.maybe_prune(_S()) == 15  # 1..15 pruned, 16..20 kept
        assert chain.block_store.base() == 16
        assert chain.block_store.height() == 20
        # a failing plane must not raise out of the hook (executor tail)
        c.block_store = None  # everything below explodes
        assert c.maybe_prune(_S()) is None
        assert c.prune_failures == 1

    def test_prune_pass_is_bounded_by_max_per_pass(self):
        """Enabling pruning on a deep archive drains the backlog across
        passes (max_per_pass heights each) instead of one unbounded
        delete inside the post-apply hook — which runs INLINE in
        consensus commit under the serial finalize."""
        chain = build_kvstore_chain(30)
        cfg = PruningConfig(retain_blocks=5, interval_heights=1)
        c = RetentionCoordinator(cfg, chain.block_store)
        c.max_per_pass = 8

        class _S:
            last_block_height = 30

        assert c.maybe_prune(_S()) == 8  # base 1 -> 9
        assert chain.block_store.base() == 9
        assert c.maybe_prune(_S()) == 8  # -> 17
        assert c.maybe_prune(_S()) == 8  # -> 25
        assert c.maybe_prune(_S()) == 1  # -> the operator target, 26
        assert chain.block_store.base() == 26
        assert c.maybe_prune(_S()) == 0  # caught up

    def test_stats_shape_numeric(self):
        c = _coord(retain=7, snapshot_store=_FakeSnapStore([3]))
        c.prune(head=0)
        s = c.stats()
        for k, v in s.items():
            assert isinstance(v, (int, float)), (k, v)
        for k in ("enabled", "retain_blocks", "runs", "pruned_heights",
                  "wal_chunks_pruned", "last_retain_height",
                  "floor_operator", "floor_snapshots", "disk_total_bytes"):
            assert k in s


# -- block store: crash-safe prune --------------------------------------------


class TestStorePruneCrashSafety:
    def test_prune_basic_and_counters(self):
        chain = build_kvstore_chain(12)
        store = chain.block_store
        assert store.prune_to(8) == 7
        assert (store.base(), store.height()) == (8, 12)
        assert store.pruned_heights == 7 and store.prune_runs == 1
        assert store.load_block(7) is None
        assert store.load_block_meta(3) is None
        assert store.load_block(8) is not None
        # idempotent / below-base no-ops
        assert store.prune_to(8) == 0
        with pytest.raises(ValueError, match="past head"):
            store.prune_to(99)

    def test_interrupted_prune_resumes_on_open(self):
        """Crash AFTER the watermark flush but MID-delete: the reopened
        store sees base=retain, clean_base=old — and finishes the
        deletes itself (no leftover keys below base, ever)."""
        chain = build_kvstore_chain(10)
        db = chain.block_store_db
        store = chain.block_store

        real_delete = db.delete
        calls = {"n": 0}

        class _Boom(RuntimeError):
            pass

        def hooked(key):
            real_delete(key)
            calls["n"] += 1
            if calls["n"] >= 3:
                raise _Boom("simulated crash mid-prune")

        db.delete = hooked
        with pytest.raises(_Boom):
            store.prune_to(6)
        db.delete = real_delete

        # readers on the crashed-in-memory store already see base 6
        assert store.base() == 6
        # a fresh open resumes the delete and marks clean
        store2 = BlockStore(db)
        assert (store2.base(), store2.height()) == (6, 10)
        wm = json.loads(db.get(b"blockStore"))
        assert wm["clean_base"] == 6
        leftovers = [
            k for k, _v in db.iterate_prefix(b"H:")
            if int(k.split(b":")[1]) < 6
        ]
        assert leftovers == []
        assert store2.load_block(6) is not None

    def test_sigkill_mid_prune_subprocess(self, tmp_path):
        """The real crash model: a subprocess SIGKILLs itself mid-delete
        (after the watermark flushed). The reopened store's base is the
        new retain height and the open-time resume clears every leftover
        key below it — the store.py watermark-first claim, held with an
        actual kill."""
        db_path = str(tmp_path / "blockstore.db")
        db = FileDB(db_path)
        build_kvstore_chain(10, block_store_db=db)
        db.close()

        child = f"""
import os, signal, sys
sys.path.insert(0, {REPO_ROOT!r})
from tendermint_tpu_torch.libs.db import FileDB
from tendermint_tpu_torch.blockchain.store import BlockStore
db = FileDB({db_path!r})
store = BlockStore(db)
real = db.delete
n = [0]
def hooked(key):
    real(key)
    n[0] += 1
    if n[0] >= 4:
        os.kill(os.getpid(), signal.SIGKILL)
db.delete = hooked
store.prune_to(7)
print("UNREACHABLE")
"""
        proc = subprocess.run(
            [sys.executable, "-c", child], capture_output=True, text=True,
            timeout=120, cwd=REPO_ROOT,
        )
        assert proc.returncode == -signal.SIGKILL, (
            proc.returncode, proc.stdout, proc.stderr,
        )
        assert "UNREACHABLE" not in proc.stdout

        db2 = FileDB(db_path)
        store2 = BlockStore(db2)
        assert (store2.base(), store2.height()) == (7, 10)
        wm = json.loads(db2.get(b"blockStore"))
        assert wm["base"] == 7 and wm["clean_base"] == 7
        for prefix in (b"H:", b"SC:", b"P:"):
            for k, _v in db2.iterate_prefix(prefix):
                h = int(k.split(b":")[1])
                assert h >= 7, f"leftover {k!r} below base after resume"
        # the store still serves its retained range
        assert store2.load_block(7) is not None
        assert store2.load_seen_commit(10) is not None
        db2.close()

    def test_pre_round19_watermark_still_loads(self):
        """A watermark without clean_base (older home) opens cleanly and
        treats base as clean."""
        chain = build_kvstore_chain(5)
        db = chain.block_store_db
        db.set_sync(b"blockStore", json.dumps({"height": 5, "base": 2}).encode())
        store = BlockStore(db)
        assert (store.base(), store.height()) == (2, 5)


# -- prune vs concurrent readers ----------------------------------------------


class TestPruneReaderRaces:
    def test_rpc_reads_and_producer_race_inflight_prune(self):
        """RPC block reads and the statesync producer's host_sections
        racing an in-flight prune_to must see base-consistent results:
        either a full, decodable answer or a clean below-base outcome —
        never a partial block or an unhandled decode error."""
        from tendermint_tpu_torch.statesync.producer import host_sections

        chain = build_kvstore_chain(60, txs_per_block=3)
        store = chain.block_store
        errors: list = []
        stop = threading.Event()

        def reader():
            while not stop.is_set():
                for h in range(1, store.height() + 1):
                    base = store.base()
                    blk = store.load_block(h)
                    meta = store.load_block_meta(h)
                    if blk is not None:
                        # a served block is COMPLETE and decodable
                        if blk.header.height != h:
                            errors.append(("height", h))
                    elif h >= store.base() and h >= base:
                        # absent inside the CURRENT retained range and
                        # the range seen before the read: a real hole
                        errors.append(("hole", h, base, store.base()))
                    if meta is None and h >= store.base() and h >= base:
                        errors.append(("meta-hole", h))

        # the producer's state handle pinned at a height the pruner WILL
        # overtake mid-test: before that, full sections must build;
        # after, the clean ValueError fallback — never anything else
        pinned = chain.state.copy()
        pinned.last_block_height = 30
        saw_valueerror = []

        def producer_reader():
            # what the snapshot producer does between commit and prune:
            # a height pruned mid-read must surface as the producer's
            # clean ValueError (caught upstream), nothing else
            while not stop.is_set():
                try:
                    sections, _seen = host_sections(pinned, store)
                    assert sections["block"]["meta"] is not None
                except ValueError:
                    saw_valueerror.append(1)  # clean fallback path

        threads = [
            threading.Thread(target=reader, daemon=True),
            threading.Thread(target=reader, daemon=True),
            threading.Thread(target=producer_reader, daemon=True),
        ]
        for t in threads:
            t.start()
        try:
            for retain in range(5, 56, 5):
                store.prune_to(retain)
                time.sleep(0.01)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        assert not errors, errors[:10]
        assert store.base() == 55
        # the pinned height crossed the base mid-test, so the producer
        # path exercised its clean fallback at least once
        assert saw_valueerror


# -- WAL chunk retention ------------------------------------------------------


class TestWalRetention:
    def _make_wal(self, root: str, chunk_size: int = 600):
        from tendermint_tpu_torch.consensus.wal import WAL

        wal = WAL(
            os.path.join(root, "cs.wal", "wal"),
            flush_interval_s=0.02,
            chunk_size=chunk_size,
        )
        wal.start()
        return wal

    def _fill(self, wal, heights: int, per_height: int = 4):
        for h in range(1, heights + 1):
            for i in range(per_height):
                wal.save({"type": "msg_info", "peer_id": "",
                          "msg": {"pad": "x" * 64, "h": h, "i": i}})
            wal.write_end_height(h)

    def test_prune_drops_old_chunks_and_replay_survives(self, tmp_path):
        wal = self._make_wal(str(tmp_path))
        self._fill(wal, 30)
        paths_before = wal.group.chunk_paths()
        assert len(paths_before) > 4, "fixture must span several chunks"

        pruned = wal.prune_to(25)
        assert pruned > 0
        assert wal.stats()["chunks_pruned"] == pruned
        paths_after = wal.group.chunk_paths()
        assert len(paths_after) == len(paths_before) - pruned
        # everything replay can still be asked for survives: retention
        # keeps blocks >= 25, so markers >= 24 must all resolve
        for h in (24, 25, 28, 30):
            lines = wal.lines_after_height(h)
            assert lines is not None, f"marker {h} lost by prune"
        wal.stop()

        # a reopen (repair scan + clean watermark with a pruned PREFIX)
        # must come up clean and keep working
        wal2 = self._make_wal(str(tmp_path))
        assert wal2.lines_after_height(30) is not None
        self._fill_more(wal2, 31, 33)
        assert wal2.lines_after_height(33) == []
        wal2.stop()

    def _fill_more(self, wal, lo, hi):
        for h in range(lo, hi + 1):
            wal.save({"type": "msg_info", "peer_id": "",
                      "msg": {"pad": "y" * 64, "h": h}})
            wal.write_end_height(h)

    def test_prune_noop_cases(self, tmp_path):
        wal = self._make_wal(str(tmp_path), chunk_size=1 << 20)
        self._fill(wal, 10)
        # single head chunk: nothing rotated, nothing to prune
        assert wal.prune_to(9) == 0
        wal.stop()

    def test_prune_stops_at_first_unlink_failure(self, tmp_path,
                                                 monkeypatch):
        """A failed unlink must STOP the pass, not skip ahead: deleting
        newer chunks past a surviving older one punches a mid-log hole
        that permanently invalidates the clean watermark (its tolerance
        covers a LEADING pruned run only). The stuck chunk simply
        retries on the next pass."""
        import tendermint_tpu_torch.consensus.wal as walmod

        wal = self._make_wal(str(tmp_path))
        self._fill(wal, 30)
        chunks_before = wal.group.chunk_paths()
        stuck = chunks_before[0]
        real_unlink = os.unlink

        def flaky(path, *a, **kw):
            if path == stuck:
                raise OSError("simulated EACCES")
            return real_unlink(path, *a, **kw)

        monkeypatch.setattr(walmod.os, "unlink", flaky)
        assert wal.prune_to(25) == 0  # stopped before deleting ANYTHING
        assert wal.group.chunk_paths() == chunks_before
        monkeypatch.setattr(walmod.os, "unlink", real_unlink)
        assert wal.prune_to(25) > 0  # next pass finishes the job
        wal.stop()

    def test_prune_keeps_boundary_chunk(self, tmp_path):
        """The anchor chunk (newest one holding a marker <= retain-1)
        must SURVIVE — deleting it would cut records between its marker
        and the next chunk's first marker."""
        wal = self._make_wal(str(tmp_path))
        self._fill(wal, 40)
        wal.prune_to(35)
        # every marker from retain-1 up must still be found
        for h in range(34, 41):
            assert wal.lines_after_height(h) is not None
        wal.stop()


# -- RPC range clamping on pruned stores --------------------------------------


class TestRpcClamping:
    def _ctx(self, chain):
        class _Ctx:
            block_store = chain.block_store
        return _Ctx()

    def test_blockchain_info_clamps_not_errors(self):
        from tendermint_tpu_torch.rpc.core.handlers import RPCError, blockchain_info

        chain = build_kvstore_chain(20)
        chain.block_store.prune_to(10)
        ctx = self._ctx(chain)

        # explicit range straddling the base: clamps to [10, 15]
        info = blockchain_info(ctx, min_height=2, max_height=15)
        got = [m["header"]["height"] for m in info["block_metas"]]
        assert got == list(range(15, 9, -1))
        assert info["base"] == 10 and info["last_height"] == 20

        # range ENTIRELY below the base: empty, not an error
        info = blockchain_info(ctx, min_height=2, max_height=8)
        assert info["block_metas"] == [] and info["base"] == 10

        # a caller-inverted range is still the caller's error
        with pytest.raises(RPCError, match="min height"):
            blockchain_info(ctx, min_height=15, max_height=12)

        # default window on a deeply pruned store clamps to the base
        chain.block_store.prune_to(18)
        got = [
            m["header"]["height"]
            for m in blockchain_info(ctx)["block_metas"]
        ]
        assert got == [20, 19, 18]

    def test_status_reports_earliest_height(self):
        from tendermint_tpu_torch.rpc.core.handlers import status

        chain = build_kvstore_chain(12)
        chain.block_store.prune_to(9)

        class _Ctx:
            block_store = chain.block_store
            switch = None
            priv_validator = None

        st = status(_Ctx())
        assert st["earliest_block_height"] == 9
        assert st["latest_block_height"] == 12

    def test_tx_proof_below_base_is_clear_error(self):
        from tendermint_tpu_torch.rpc.core.handlers import RPCError, tx as rpc_tx
        from tendermint_tpu_torch.types.tx import tx_hash

        class _Res:
            height, index = 2, 0

            class result:
                code, data, log = 0, b"", ""

            tx = b"k2-0=v2"

        class _Indexer:
            def get(self, h):
                return _Res()

        chain = build_kvstore_chain(10)
        chain.block_store.prune_to(6)

        class _Ctx:
            block_store = chain.block_store
            tx_indexer = _Indexer()

        # without proof: the indexed result still serves
        out = rpc_tx(_Ctx(), tx_hash(b"k2-0=v2").hex(), prove=False)
        assert out["height"] == 2
        # with proof: the block is gone — clear error, not a crash
        with pytest.raises(RPCError, match="below the store's base"):
            rpc_tx(_Ctx(), tx_hash(b"k2-0=v2").hex(), prove=True)


# -- fast-sync pool: bases + horizon ------------------------------------------


class TestPoolHorizon:
    def _pool(self, start=1):
        sent = []
        pool = BlockPool(
            start, request_fn=lambda h, p: sent.append((h, p)),
            timeout_fn=lambda p, r: None,
        )
        return pool, sent

    def test_below_base_peer_ineligible_without_round_trip(self):
        """A peer whose base is above the wanted height is never asked —
        the old behavior burned a block_request/no_block_response round
        trip per retry."""
        pool, sent = self._pool(start=1)
        pool.set_peer_height("pruned", 100, base=50)
        pool._started_at = time.monotonic()
        pool._spawn_and_retry()
        # heights the peer retains are fair game; nothing below its base
        assert sent, "the peer must still serve its retained range"
        assert all(h >= 50 for h, _p in sent), sent[:5]
        # an archive peer arrives: the below-base heights flow to IT
        sent.clear()
        pool.set_peer_height("archive", 100, base=1)
        pool._spawn_and_retry()
        low = [(h, p) for h, p in sent if h < 50]
        assert low and all(p == "archive" for _h, p in low)

    def test_base_zero_means_serves_everything(self):
        pool, sent = self._pool(start=1)
        pool.set_peer_height("old-proto", 100)  # no base reported
        pool._started_at = time.monotonic()
        pool._spawn_and_retry()
        assert sent and all(p == "old-proto" for _h, p in sent)

    def test_below_horizon_detection(self):
        pool, _ = self._pool(start=1)
        assert pool.below_horizon() is None  # no peers: undecidable
        pool.set_peer_height("a", 100, base=40)
        pool.set_peer_height("b", 90, base=35)
        assert pool.below_horizon() == 35
        # one peer that can serve height 1 clears the verdict
        pool.set_peer_height("c", 95, base=1)
        assert pool.below_horizon() is None
        pool.remove_peer("c")
        assert pool.below_horizon() == 35

    def test_peers_behind_us_do_not_count(self):
        pool, _ = self._pool(start=50)
        pool.set_peer_height("laggard", 10, base=1)
        assert pool.below_horizon() is None


class TestReactorHorizonFallback:
    def _reactor(self):
        from tests.test_torch_reactors import make_genesis, make_node
        from tendermint_tpu_torch.blockchain.reactor import BlockchainReactor

        doc, pvs = make_genesis(1)
        node = make_node(doc, pvs[0])
        bc = BlockchainReactor(
            node.state.copy(), node.cs.proxy_app_conn, node.store,
            fast_sync=True,
        )

        class _FakeSwitch:
            def reactor(self, name):
                return None

            def broadcast(self, *a, **k):
                return []

        bc.switch = _FakeSwitch()
        bc._started = True
        return bc

    def test_two_strikes_then_fallback(self):
        bc = self._reactor()
        calls = []

        class _Pool:
            below = 40
            stopped = False

            def below_horizon(self):
                return self.below

            def stop(self):
                self.stopped = True

        bc.pool = _Pool()
        bc.horizon_fallback = lambda h: calls.append(h) or True
        assert bc._check_horizon() is False  # strike 1: no trigger yet
        assert calls == []
        assert bc._check_horizon() is True  # strike 2: statesync armed
        assert calls == [40]
        assert bc.pool.stopped and bc._deferred
        assert bc.below_horizon_fallbacks == 1

    def test_recovering_horizon_resets_strikes(self):
        bc = self._reactor()

        class _Pool:
            below = 40

            def below_horizon(self):
                return self.below

        bc.pool = _Pool()
        bc.horizon_fallback = lambda h: True
        assert bc._check_horizon() is False
        bc.pool.below = None  # an archive peer showed up
        assert bc._check_horizon() is False
        bc.pool.below = 40
        assert bc._check_horizon() is False  # strikes restarted

    def test_failed_fallback_keeps_fast_sync(self):
        bc = self._reactor()

        class _Pool:
            stopped = False

            def below_horizon(self):
                return 40

            def stop(self):
                self.stopped = True

        bc.pool = _Pool()
        bc.horizon_fallback = lambda h: False  # node can't statesync
        assert bc._check_horizon() is False
        assert bc._check_horizon() is False
        assert not bc.pool.stopped and not bc._deferred
        assert bc.below_horizon_fallbacks == 0


# -- statesync reactor: stall strikes -----------------------------------------


class TestOffererStallBan:
    def _reactor(self, tmp, ban_after=2):
        from tendermint_tpu_torch.statesync.reactor import StateSyncReactor
        from tendermint_tpu_torch.statesync.snapshot import SnapshotStore

        r = StateSyncReactor(SnapshotStore(os.path.join(tmp, "snaps")))
        r.stall_ban_after = ban_after

        class _Sw:
            stopped = []

            class peers:
                @staticmethod
                def get(pid):
                    return None

        r.switch = _Sw()
        return r

    def test_stall_strikes_ban_after_threshold(self, tmp_path):
        r = self._reactor(str(tmp_path), ban_after=2)
        r._note_stall("peerA", "chunk 0")
        assert r.offerer_bans_stall == 0
        r._note_stall("peerA", "chunk 1")
        assert r.offerer_bans_stall == 1
        assert r.offerers_banned == 1 and r.peers_banned == 1

    def test_answer_clears_strikes(self, tmp_path):
        r = self._reactor(str(tmp_path), ban_after=2)
        r._note_stall("peerA", "chunk 0")
        r._clear_stall("peerA")
        r._note_stall("peerA", "chunk 2")
        assert r.offerer_bans_stall == 0  # never two in a row

    def test_accomplice_answer_does_not_launder_staller_strikes(
            self, tmp_path):
        """_fetch_window attribution contract: strikes clear only for
        the peer that ACTUALLY answered — a staller whose chunks an
        accomplice keeps answering must not have its strikes cleared
        (each of its windows still burns the full timeout). Driven at
        the _note_stall/_clear_stall level the window code calls:
        clear(accomplice) between two staller strikes must not reset
        the staller."""
        r = self._reactor(str(tmp_path), ban_after=2)
        r._note_stall("staller", "chunk 0")
        r._clear_stall("accomplice")  # someone ELSE answered
        r._note_stall("staller", "chunk 1")
        assert r.offerer_bans_stall == 1

    def test_ban_kinds_counted(self, tmp_path):
        r = self._reactor(str(tmp_path))
        r._ban_peer("x", "forged manifest", kind="forged")
        r._ban_peer("y", "bad chunk", kind="corrupt")
        r._ban_peer("z", "plain ban")  # no kind: not an offerer ban
        s = r.stats()
        assert s["offerer_bans_forged"] == 1
        assert s["offerer_bans_corrupt"] == 1
        assert s["offerers_banned"] == 2
        assert s["peers_banned"] == 3


# -- WAL + store wired through the coordinator --------------------------------


class TestCoordinatorDrivesPlanes:
    def test_prune_drives_store_and_wal(self, tmp_path):
        from tendermint_tpu_torch.consensus.wal import WAL

        chain = build_kvstore_chain(30)
        wal = WAL(
            os.path.join(str(tmp_path), "cs.wal", "wal"),
            flush_interval_s=0.02, chunk_size=600,
        )
        wal.start()
        for h in range(1, 31):
            for i in range(4):
                wal.save({"type": "msg_info", "peer_id": "",
                          "msg": {"pad": "x" * 64, "h": h, "i": i}})
            wal.write_end_height(h)
        chunks_before = len(wal.group.chunk_paths())

        cfg = PruningConfig(retain_blocks=8, interval_heights=1)
        c = RetentionCoordinator(
            cfg, chain.block_store, wal_fn=lambda: wal,
            db_dir=str(tmp_path),
            wal_dir=os.path.join(str(tmp_path), "cs.wal"),
            snapshot_dir=os.path.join(str(tmp_path), "snaps"),
        )

        class _S:
            last_block_height = 30

        pruned = c.maybe_prune(_S())
        assert pruned == 22
        assert chain.block_store.base() == 23
        assert c.wal_chunks_pruned > 0
        assert len(wal.group.chunk_paths()) < chunks_before
        assert wal.lines_after_height(30) is not None
        s = c.stats()
        assert s["runs"] == 1 and s["pruned_heights"] == 22
        assert s["disk_wal_bytes"] > 0
        wal.stop()


class TestTxIndexRetention:
    """the kv tx index was the last per-height disk term a
    pruned node kept growing forever — it now rides the same retention
    pass as the block store and WAL."""

    @staticmethod
    def _indexer_with(heights):
        from tendermint_tpu_torch.state.txindex import Batch, KVTxIndexer
        from tendermint_tpu_torch.types.tx import TxResult, tx_hash

        ix = KVTxIndexer(MemDB())
        hashes = {}
        for h in heights:
            b = Batch()
            for i in range(3):
                tx = f"tx-{h}-{i}".encode()
                b.add(TxResult(height=h, index=i, tx=tx, result=None))
                hashes[(h, i)] = tx_hash(tx)
            ix.add_batch(b)
        return ix, hashes

    def test_prune_to_drops_below_and_keeps_rest(self):
        ix, hashes = self._indexer_with(range(1, 11))
        assert ix.prune_to(6) == 5 * 3  # heights 1..5, 3 txs each
        assert ix.pruned_txs == 15
        for (h, i), hsh in hashes.items():
            got = ix.get(hsh)
            if h < 6:
                assert got is None, (h, i)
            else:
                assert got is not None and got.height == h
        # idempotent: nothing left below the safe height
        assert ix.prune_to(6) == 0
        # and the height keys went with the primaries (no orphan scan
        # debt): a later deeper pass only counts the still-live txs
        assert ix.prune_to(11) == 5 * 3
        assert ix.pruned_txs == 30

    def test_pre_round_20_records_survive(self):
        """Txs indexed before the height keys existed have no secondary
        key — pruning must leave them alone (the safe failure direction
        for an index), not guess at their heights."""
        from tendermint_tpu_torch.state.txindex import KVTxIndexer
        from tendermint_tpu_torch.types.tx import tx_hash

        ix = KVTxIndexer(MemDB())
        old = b"pre-index-prune-tx"
        ix.db.set(tx_hash(old), b'{"height": 2, "index": 0, "tx": "", "result": null}')
        assert ix.prune_to(100) == 0
        assert ix.db.get(tx_hash(old)) is not None

    def test_coordinator_drives_tx_indexer_and_stats(self, tmp_path):
        ix, _ = self._indexer_with(range(1, 21))
        chain = build_kvstore_chain(20)
        cfg = PruningConfig(retain_blocks=5, interval_heights=1)
        c = RetentionCoordinator(
            cfg, chain.block_store, tx_indexer=ix, db_dir=str(tmp_path),
        )

        class _S:
            last_block_height = 20

        assert c.maybe_prune(_S()) == 15  # safe height 16
        assert ix.pruned_txs == 15 * 3
        s = c.stats()
        assert s["tx_index_pruned"] == 45
        assert "disk_txindex_bytes" in s
        # an indexer without prune_to (the null impl) is simply skipped
        from tendermint_tpu_torch.state.txindex import NullTxIndexer

        c2 = RetentionCoordinator(
            cfg, build_kvstore_chain(20).block_store,
            tx_indexer=NullTxIndexer(),
        )
        assert c2.maybe_prune(_S()) == 15
        assert c2.stats()["tx_index_pruned"] == 0


# -- the coordinator beside the JAX package's ---------------------------------


def _retention_run(root: str, tmp: str) -> list:
    """One retention history in package `root`: a 40-block kvstore chain,
    its WAL and a kv tx index, with snapshot, evidence and state-tree
    floors that move between passes; returns every pass's safe height,
    floors, prune result, store base and stats (but the disk gauges, which
    count file bytes)."""
    import importlib

    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    chain = mod("statesync.devchain").build_kvstore_chain(40, txs_per_block=3)
    wal = mod("consensus.wal").WAL(os.path.join(tmp, "cs.wal", "wal"), flush_interval_s=0.02, chunk_size=600)
    wal.start()
    for h in range(1, 41):
        for i in range(3):
            wal.save({"type": "msg_info", "peer_id": "", "msg": {"pad": "x" * 64, "h": h, "i": i}})
        wal.write_end_height(h)
    txindex, txmod = mod("state.txindex"), mod("types.tx")
    ix = txindex.KVTxIndexer(mod("libs.db").MemDB())
    for h in range(1, 41):
        b = txindex.Batch()
        for i in range(3):
            b.add(txmod.TxResult(height=h, index=i, tx=f"tx-{h}-{i}".encode(), result=None))
        ix.add_batch(b)
    snaps, ev, tree = _FakeSnapStore([12, 16]), _FakeEvPool(14), _FakeTreeApp([10, 11, 12])
    cfg = mod("config.config").PruningConfig(retain_blocks=6, interval_heights=4)
    c = mod("node.retention").RetentionCoordinator(
        cfg, chain.block_store, snapshot_store=snaps, wal_fn=lambda: wal, evidence_pool=ev, tree_app=tree,
        tx_indexer=ix)
    c.max_per_pass = 7

    class _S:
        last_block_height = 0

    out = []
    try:
        for head, snap_heights, ev_min, versions in (
            (20, [12, 16], 14, [10, 11, 12]),
            (24, [16, 20], 14, [18, 19, 20, 21]),
            (28, [20, 24], None, [25, 26]),
            (30, [24], None, []),  # off the interval: no pass
            (32, [28], 30, [29, 30]),
            (40, [], None, [38]),
            (40, [], None, [38]),
        ):
            snaps._heights, ev._min, tree.tree._versions = snap_heights, ev_min, versions
            _S.last_block_height = head
            safe = c.safe_retain_height(head)
            pruned = c.maybe_prune(_S())
            stats = {k: v for k, v in c.stats().items() if not k.startswith("disk_")}
            out.append((head, safe, pruned, chain.block_store.base(), stats))
        base = chain.block_store.base()
        out.append([chain.block_store.load_block(h).hash() for h in range(base, 41)])
        out.append(wal.lines_after_height(base) is not None)
        c.block_store = None  # every plane below fails: the hook logs, counts and carries on
        _S.last_block_height = 44
        out.append((c.maybe_prune(_S()), c.prune_failures))
    finally:
        wal.stop()
    return out


def test_coordinator_equal_to_jax(tmp_path):
    """Both packages' RetentionCoordinators, given equal stores (block
    store, WAL, tx index) and the same snapshot heights, evidence and
    state-tree floors pass after pass, take the same safe heights and
    floors, prune the same heights, WAL chunks and indexed txs, keep the
    same blocks and report the same stats."""
    jax_side = _retention_run("tendermint_tpu", str(tmp_path / "jax"))
    port_side = _retention_run("tendermint_tpu_torch", str(tmp_path / "port"))
    assert [row[2] for row in port_side[:7]] == [7, 6, 6, None, 7, 7, 1]
    assert port_side[7] and port_side[9] == (None, 1)
    assert port_side == jax_side
