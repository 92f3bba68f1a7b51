"""Retention coordinator: bounded-disk lifecycle for a node that serves
heavy traffic forever (docs/state-sync.md § Retention).

A `[pruning]` config section (`retain_blocks`, `interval_heights`, off
by default) arms automatic pruning of the block store and the consensus
WAL on the apply executor's tail — the same post-apply hook the
snapshot producer rides, AFTER it, so a snapshot published at height H
is on disk before the prune computes its floor.

The SAFE retain height is the minimum of every plane that still needs
history:

    safe = min(head - retain_blocks + 1,          # the operator target
               min(published snapshot heights),   # statesync producer
                                                  #   must stay serviceable
               min(pending evidence heights),     # conflicts stay auditable
               min(statetree retained versions))  # proofs at retained
                                                  #   versions need headers

so an aggressive operator target silently defers to whichever subsystem
retains deeper — disk stays bounded by the LARGEST of the retention
knobs, never truncated under a plane that still serves the range. The
block-store prune itself is crash-safe (watermark-first + clean_base
resume, blockchain/store.py); WAL retention drops whole rotated chunks
below the horizon (consensus/wal.py prune_to); snapshot-store retention
stays with the producer (`snapshot_keep_recent`) whose oldest published
height is this coordinator's floor.

`maybe_prune` NEVER raises — like the snapshot hook, a retention
failure must not wedge the apply executor (and therefore the consensus
join).

Telemetry: the `pruning_*` family on both metric surfaces — enabled /
target / runs / pruned heights / last retain height / the per-plane
floors of the last run / per-plane disk gauges (block store, WAL,
snapshots; refreshed at most every DISK_GAUGE_REFRESH_S so scrapes stay
cheap) — plus `blockstore_pruned_heights_total` on the store producer.
"""

from __future__ import annotations

import logging
import os
import time

logger = logging.getLogger("node.retention")

# consensus always needs the head block's seen commit and the previous
# block's meta/commit linkage; a retain target below this is an operator
# typo, not a policy
MIN_RETAIN_BLOCKS = 2
DISK_GAUGE_REFRESH_S = 5.0
# heights pruned per pass, at most: enabling [pruning] on a deep archive
# must drain the backlog across passes, not delete the whole history
# synchronously inside one post-apply hook (in serial finalize mode that
# hook runs INLINE in consensus commit — an unbounded first pass would
# stall rounds for the O(backlog) delete)
DEFAULT_MAX_PER_PASS = 2000


def dir_bytes(path: str, prefix: str | None = None) -> int:
    """Total file bytes under `path` (0 when absent). `prefix` keeps
    only files whose NAME starts with it — the db_dir holds every
    per-name DB (blockstore, state, tx_index), and the blockstore gauge
    must count only the plane retention actually prunes."""
    total = 0
    for dirpath, _dirs, files in os.walk(path):
        for fn in files:
            if prefix is not None and not fn.startswith(prefix):
                continue
            try:
                total += os.path.getsize(os.path.join(dirpath, fn))
            except OSError:
                continue
    return total


class RetentionCoordinator:
    def __init__(
        self,
        cfg,
        block_store,
        snapshot_store=None,
        wal_fn=None,
        evidence_pool=None,
        tree_app=None,
        tx_indexer=None,
        db_dir: str = "",
        wal_dir: str = "",
        snapshot_dir: str = "",
    ):
        """cfg is a config.PruningConfig. wal_fn() returns the consensus
        WAL (None before consensus starts). tree_app is the in-process
        app carrying a VersionedTree, or None — read per run, since a
        statesync restore rebinds app.tree. tx_indexer is the kv tx
        index (the last per-height disk term on a pruned node), pruned
        on the same pass; Null/absent indexers no-op."""
        from tendermint_tpu_torch.libs.envknob import env_number

        self.enabled = cfg.retain_blocks > 0
        self.retain_blocks = max(int(cfg.retain_blocks), MIN_RETAIN_BLOCKS)
        self.interval = max(int(cfg.interval_heights), 1)
        self.max_per_pass = max(int(env_number(
            "TENDERMINT_RETENTION_MAX_PER_PASS", DEFAULT_MAX_PER_PASS,
            cast=int,
        )), 1)
        self.block_store = block_store
        self.snapshot_store = snapshot_store
        self.wal_fn = wal_fn
        self.evidence_pool = evidence_pool
        self.tree_app = tree_app
        self.tx_indexer = tx_indexer
        self._db_dir = db_dir
        self._wal_dir = wal_dir
        self._snapshot_dir = snapshot_dir

        # gauges (pruning_* on both metric surfaces)
        self.runs = 0
        self.pruned_heights = 0
        self.wal_chunks_pruned = 0
        self.tx_index_pruned = 0
        self.last_retain_height = 0
        self.prune_failures = 0
        self._last_floors: dict[str, int] = {}
        self._disk_cache: tuple[float, dict[str, int]] | None = None

    # -- the formula -------------------------------------------------------

    def safe_retain_height(self, head: int) -> tuple[int, dict[str, int]]:
        """(safe retain height, per-plane floors actually considered).
        The floors dict is what the pruning_floor_* gauges export — an
        operator whose disk is not shrinking reads WHICH plane pinned
        retention straight off a scrape."""
        floors = {"operator": max(head - self.retain_blocks + 1, 1)}
        if self.snapshot_store is not None:
            heights = self.snapshot_store.heights()
            if heights:
                floors["snapshots"] = heights[0]
        if self.evidence_pool is not None:
            ev = self.evidence_pool.min_pending_height()
            if ev is not None:
                floors["evidence"] = ev
        tree = getattr(self.tree_app, "tree", None)
        if tree is not None:
            try:
                versions = tree.versions()
            except Exception:  # noqa: BLE001 — mid-rebind during restore
                versions = []
            if versions:
                floors["statetree"] = max(versions[0], 1)
        return min(floors.values()), floors

    # -- the hook ----------------------------------------------------------

    def maybe_prune(self, state, block=None) -> int | None:
        """The post-apply hook (runs on the executor tail, after the
        snapshot producer): prune when the just-applied height lands on
        the interval. NEVER raises. Returns heights pruned, or None when
        the check did not run."""
        if not self.enabled:
            return None
        h = state.last_block_height
        if h == 0 or h % self.interval != 0:
            return None
        try:
            return self.prune(h)
        except Exception:  # noqa: BLE001 — retention is best-effort
            self.prune_failures += 1
            logger.exception("retention prune at height %d failed", h)
            return None

    def prune(self, head: int | None = None) -> int:
        """One retention pass: compute the safe height and drive the
        block store + WAL. Returns block-store heights pruned."""
        if head is None:
            head = self.block_store.height()
        safe, floors = self.safe_retain_height(head)
        # a floor above the store head (stale snapshot listing, head=0)
        # clamps: prune_to refuses to disown heights it never had
        safe = min(safe, self.block_store.height())
        # bound the pass: a deep backlog (pruning newly enabled on an
        # archive home) drains max_per_pass heights per interval instead
        # of stalling the apply hook for the whole history at once
        base = self.block_store.base()
        if base > 0:
            safe = min(safe, base + self.max_per_pass)
        self._last_floors = floors
        pruned = 0
        if safe > self.block_store.base():
            pruned = self.block_store.prune_to(safe)
        wal = self.wal_fn() if self.wal_fn is not None else None
        wal_pruned = 0
        if wal is not None and hasattr(wal, "prune_to"):
            wal_pruned = wal.prune_to(safe)
        tx_pruned = 0
        if self.tx_indexer is not None and hasattr(self.tx_indexer, "prune_to"):
            tx_pruned = self.tx_indexer.prune_to(safe)
        self.runs += 1
        self.pruned_heights += pruned
        self.wal_chunks_pruned += wal_pruned
        self.tx_index_pruned += tx_pruned
        self.last_retain_height = max(self.last_retain_height, safe)
        if pruned or wal_pruned or tx_pruned:
            logger.info(
                "retention: pruned %d height(s) + %d WAL chunk(s) + %d "
                "indexed tx(s) below %d "
                "(floors: %s)", pruned, wal_pruned, tx_pruned, safe,
                {k: v for k, v in sorted(floors.items())},
            )
        return pruned

    # -- observability -----------------------------------------------------

    def _disk_gauges(self) -> dict[str, int]:
        """Per-plane disk byte gauges, refreshed at most every
        DISK_GAUGE_REFRESH_S (an os.walk per scrape would make GET
        /metrics O(files); the cadence is plenty for capacity alerts)."""
        now = time.monotonic()
        if self._disk_cache is not None and now - self._disk_cache[0] < DISK_GAUGE_REFRESH_S:
            return self._disk_cache[1]
        gauges = {
            # db_dir also holds the state/tx-index DBs retention never
            # touches; count only the block store's own files
            # (libs/db.py db_provider names them "blockstore.<ext>")
            "disk_blockstore_bytes": dir_bytes(
                self._db_dir, prefix="blockstore."
            ),
            "disk_txindex_bytes": dir_bytes(
                self._db_dir, prefix="tx_index."
            ),
            "disk_wal_bytes": dir_bytes(self._wal_dir),
            "disk_snapshots_bytes": dir_bytes(self._snapshot_dir),
        }
        gauges["disk_total_bytes"] = sum(gauges.values())
        self._disk_cache = (now, gauges)
        return gauges

    def stats(self) -> dict:
        out = {
            "enabled": int(self.enabled),
            "retain_blocks": self.retain_blocks if self.enabled else 0,
            "interval_heights": self.interval,
            "runs": self.runs,
            "pruned_heights": self.pruned_heights,
            "wal_chunks_pruned": self.wal_chunks_pruned,
            "tx_index_pruned": self.tx_index_pruned,
            "last_retain_height": self.last_retain_height,
            "prune_failures": self.prune_failures,
        }
        for plane in ("operator", "snapshots", "evidence", "statetree"):
            out[f"floor_{plane}"] = self._last_floors.get(plane, 0)
        out.update(self._disk_gauges())
        return out
