"""Snapshot producer: export a deterministic snapshot of (app state +
state + block-store tail) at configured height intervals.

Runs SYNCHRONOUSLY on the post-apply hook (consensus finalize_commit /
fast-sync _try_sync), between one block's Commit and the next height's
first DeliverTx — the only point where app.snapshot() is guaranteed to
observe exactly height H. The in-process apps serialize in microseconds
to low milliseconds at test scales; a deployment whose app state is
huge raises snapshot_interval, it does not move the hook.

Pipelined execution (docs/execution-pipeline.md): under the
pipelined finalize the hook fires from the APPLY EXECUTOR thread, not
the consensus receive routine — and the quiesce guarantee holds by the
executor's ordering: apply(H+1), the only source of the next DeliverTx,
is queued behind this hook on the same single worker. Executor-thread
audit: `state` is the executor-local post-H copy; the block store is
lock-protected and block H was saved BEFORE the apply was submitted (the
stage-1 ordering invariant), so host_sections can always serve H; the
gateway hasher and the SnapshotStore take their own locks. Concurrent
mempool CheckTx against app.snapshot() predates the pipeline (CheckTx
never ran on the consensus thread either) and is read-only in the
kvstore family. The NEVER-RAISES contract of maybe_snapshot is what
keeps a producer failure from wedging the executor — and therefore the
join — regression-tested in tests/test_pipeline.py.

Format 2 (docs/state-tree.md):

- The node-local SEEN commit moved OUT of the digested payload into the
  manifest sidecar, so replica payloads — and manifest ROOTS — are
  byte-identical even when replicas saw different precommit subsets
  (deterministic snapshot roots).
- Apps backed by the authenticated state tree emit DELTA snapshots
  between full ones (`full_every` controls the cadence): chunk 0 is the
  host section (state/validators_info/block H), chunks 1.. carry the
  changed entries SINCE the previous snapshot, each entry shipping with
  its membership (upsert) or absence (delete) proof against the NEW
  app hash — a restoring node verifies every chunk against consensus
  before anything applies, and resumes a crashed chain trustlessly.
  Any precondition miss (no tree, pruned base version, base snapshot
  gone, chain length at full_every) falls back to a full snapshot.

Full payload (format 2, canonical JSON, sort_keys — byte-identical
across replicas at the same height):

    {
      "format": 2, "kind": "full", "chain_id": ..., "height": H,
      "app_state": hex(app.snapshot()),
      "state": State.to_json() AFTER applying H,
      "validators_info": {height: saveValidatorsInfo record, ...},
      "block": {"meta": ..., "parts": [...]}      # NO seen commit here
    }

The block section carries height H itself (meta + parts; the seen
commit rides the manifest) so a restored node can serve /block and
/commit at its base height and seed a BlockStore whose head is real,
not a phantom watermark.
"""

from __future__ import annotations

import json
import logging
import time

from tendermint_tpu_torch.libs.envknob import env_number
from tendermint_tpu_torch.statesync.snapshot import (
    KIND_DELTA,
    MAX_CHUNK_BYTES,
    Manifest,
    SnapshotStore,
    chunk_payload,
)

logger = logging.getLogger("statesync.producer")

DEFAULT_CHUNK_SIZE = 64 * 1024
DEFAULT_FULL_EVERY = 4


def validators_info_records(state) -> dict:
    """The state-DB validator-history records a restored node needs so
    load_validators resolves for every height it can be asked about
    (>= the snapshot height): a self-contained full set at H (the set
    that SIGNED H), the current set at its last-changed height, and the
    pointer record for H+1 (state/state.py saveValidatorsInfo shape)."""
    h = state.last_block_height
    lhc = max(state.last_height_validators_changed, 1)
    records: dict = {}
    # the full current set lives where the last-changed pointer lands
    records[str(lhc)] = {
        "last_height_changed": lhc,
        "validator_set": state.validators.to_json(),
    }
    # height H resolves directly to the set that signed it (when lhc == H
    # the set changed entering H, so validators == last_validators
    # membership-wise and either record serves)
    records.setdefault(
        str(h),
        {"last_height_changed": h, "validator_set": state.last_validators.to_json()},
    )
    if str(h + 1) not in records:
        records[str(h + 1)] = {"last_height_changed": lhc}
    return records


def host_sections(state, block_store) -> tuple[dict, dict]:
    """(sections, seen_commit_json) for a snapshot at
    state.last_block_height: the embedded state, validator-history
    records, and block H (meta + parts). The seen commit is returned
    SEPARATELY — format 2 carries it in the manifest, outside the
    digested bytes, so replica roots don't diverge on per-node precommit
    subsets. Raises ValueError when the block store cannot serve the
    height (e.g. it was just pruned past it)."""
    h = state.last_block_height
    meta = block_store.load_block_meta(h)
    seen = block_store.load_seen_commit(h)
    if meta is None or seen is None:
        raise ValueError(f"block store cannot serve height {h} for snapshot")
    parts = []
    for i in range(meta.block_id.parts_header.total):
        part = block_store.load_block_part(h, i)
        if part is None:
            raise ValueError(f"missing part {i} of block {h}")
        parts.append(part.to_json())
    sections = {
        "state": state.to_json(),
        "validators_info": validators_info_records(state),
        "block": {"meta": meta.to_json(), "parts": parts},
    }
    return sections, seen.to_json()


def build_payload(state, app_state: bytes, block_store) -> tuple[dict, dict]:
    """(full-snapshot payload object, seen_commit_json) for a snapshot
    at state.last_block_height."""
    sections, seen_json = host_sections(state, block_store)
    obj = {
        "format": 2,
        "kind": "full",
        "chain_id": state.chain_id,
        "height": state.last_block_height,
        "app_state": app_state.hex(),
        **sections,
    }
    return obj, seen_json


def encode_payload(obj: dict) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


class SnapshotProducer:
    def __init__(
        self,
        store: SnapshotStore,
        app,
        block_store,
        hasher=None,
        interval: int = 0,
        keep_recent: int = 2,
        chunk_size: int | None = None,
        full_every: int | None = None,
    ):
        self.store = store
        self.app = app
        self.block_store = block_store
        self.hasher = hasher
        self.interval = interval
        if full_every is None:
            full_every = int(
                env_number(
                    "TENDERMINT_STATESYNC_FULL_EVERY", DEFAULT_FULL_EVERY,
                    cast=int,
                )
            )
        self.full_every = max(int(full_every), 1)
        from tendermint_tpu_torch.statesync.snapshot import MAX_DELTA_CHAIN

        if self.full_every > MAX_DELTA_CHAIN:
            # every restorer hard-rejects chains past MAX_DELTA_CHAIN;
            # producing longer ones would make the freshest snapshots
            # unrestorable by construction
            logger.warning(
                "snapshot_full_every %d > restorable chain bound %d; clamping",
                self.full_every, MAX_DELTA_CHAIN,
            )
            self.full_every = MAX_DELTA_CHAIN
        # delta snapshots need the app's authenticated state tree (diff
        # + proofs); apps without one always produce full snapshots
        tree = getattr(app, "tree", None)
        self.tree = tree if hasattr(tree, "diff") else None
        if self.tree is not None and self.full_every > 1 and interval > 0:
            # the delta base is `interval` heights back: the tree must
            # retain at least that many versions or every delta falls
            # back to full on a pruned base
            self.tree.keep_recent = max(self.tree.keep_recent, interval + 2)
        if self.full_every > 1:
            # a delta chain is only servable while its full base (and
            # every intermediate delta) survives retention
            keep_recent = max(keep_recent, self.full_every + 1)
        self.keep_recent = keep_recent
        if chunk_size is None:
            chunk_size = int(
                env_number(
                    "TENDERMINT_STATESYNC_CHUNK_BYTES", DEFAULT_CHUNK_SIZE, cast=int
                )
            )
        if chunk_size < 1024:
            logger.warning(
                "statesync chunk size %d B < 1 KiB floor; clamping", chunk_size
            )
            chunk_size = 1024
        if chunk_size > MAX_CHUNK_BYTES:
            # a wider chunk would pass local framing but every peer's
            # manifest/chunk decode (and the wire capacity) rejects it —
            # clamp so the snapshots produced are actually servable
            logger.warning(
                "statesync chunk size %d B > %d ceiling; clamping",
                chunk_size, MAX_CHUNK_BYTES,
            )
            chunk_size = MAX_CHUNK_BYTES
        self.chunk_size = chunk_size
        # gauges (statesync_* in the metrics RPC)
        self.snapshots_taken = 0
        self.snapshot_failures = 0
        self.deltas_taken = 0
        self.delta_fallbacks = 0
        self.last_snapshot_height = 0
        self.last_snapshot_seconds = 0.0
        self.last_snapshot_bytes = 0

    def _chunk_digests(self, chunks: list[bytes]) -> list[bytes]:
        """Per-chunk RIPEMD-160 through the hashing gateway when one is
        wired (streamed devd plane / AVX batch / CPU fallback — the same
        routing ladder the part plane rides), plain CPU otherwise."""
        if self.hasher is not None:
            return self.hasher.part_leaf_hashes(chunks)
        from tendermint_tpu_torch.statesync.snapshot import chunk_digest

        return [chunk_digest(c) for c in chunks]

    def maybe_snapshot(self, state, block=None) -> int | None:
        """The post-apply hook: snapshot when the just-applied height
        lands on the interval. Never raises for a failed snapshot — a
        snapshot failure must not take down the consensus or fast-sync
        path that called it. A device error (ops.gateway.DeviceError,
        from the chunk digests) is not a snapshot failure: it is raised
        to the caller, whose own rule for it applies, where the JAX
        package counts it as a failed snapshot."""
        from tendermint_tpu_torch.ops.gateway import DeviceError

        h = state.last_block_height
        if self.interval <= 0 or h == 0 or h % self.interval != 0:
            return None
        try:
            return self.snapshot(state)
        except DeviceError:
            raise
        except Exception:  # noqa: BLE001 — producer is best-effort
            self.snapshot_failures += 1
            logger.exception("snapshot at height %d failed", h)
            return None

    # -- delta production ----------------------------------------------------

    def _delta_base(self, h: int) -> Manifest | None:
        """The previous snapshot's manifest, iff a delta on top of it is
        allowed and possible: the app has a tree retaining both
        versions whose committed roots line up, and the chain of
        consecutive deltas stays under full_every."""
        if self.tree is None or self.full_every <= 1:
            return None
        heights = [x for x in self.store.heights() if x < h]
        if not heights:
            return None
        base = self.store.load_manifest(heights[-1])
        if base is None:
            return None
        # consecutive deltas ending at the base; a chain of
        # full_every - 1 deltas means this one must be full
        chain = 0
        walk = base
        while walk is not None and walk.kind == KIND_DELTA and chain < self.full_every:
            chain += 1
            walk = self.store.load_manifest(walk.base_height)
        if walk is None or chain >= self.full_every - 1:
            return None
        if not (self.tree.has_version(base.height) and self.tree.has_version(h)):
            return None
        try:
            if self.tree.root_hash(base.height) != base.app_hash:
                # the stored base predates this app instance (restart
                # rebuilt the tree with only the current version)
                return None
        except Exception:  # noqa: BLE001 — any doubt means full
            return None
        return base

    def _build_delta_chunks(
        self, state, base: Manifest
    ) -> tuple[list[bytes], dict] | None:
        """(delta chunk list, seen_commit_json) — host section first,
        then proof-carrying entry groups — or None when the diff is
        unavailable (pruned journal -> fall back to full)."""
        from tendermint_tpu_torch.statetree.tree import TreeError

        h = state.last_block_height
        try:
            upserts, deletes = self.tree.diff(base.height, h)
        except TreeError as exc:
            logger.info("delta diff %d..%d unavailable (%s)", base.height, h, exc)
            return None
        sections, seen_json = host_sections(state, self.block_store)
        aux = None
        snapshot_aux = getattr(self.app, "snapshot_aux", None)
        if snapshot_aux is not None:
            aux = snapshot_aux()
        host = {
            "format": 2,
            "kind": "delta",
            "section": "host",
            "chain_id": state.chain_id,
            "height": h,
            "base_height": base.height,
            "app_aux": aux,
            **sections,
        }
        chunks = [encode_payload(host)]
        # entry groups: each entry ships with its proof against the NEW
        # root. Proof STEPS dedupe into a per-chunk table (the upper
        # tree levels are shared by every path in the chunk — inlining
        # them per entry made small deltas LARGER than full snapshots);
        # an entry's proof is its bottom-up list of step indices.
        group: dict = {"section": "delta", "steps": [], "sets": [], "dels": []}
        step_index: dict[str, int] = {}
        group_bytes = 64

        def flush():
            nonlocal group, step_index, group_bytes
            if group["sets"] or group["dels"]:
                chunks.append(encode_payload(group))
            group = {"section": "delta", "steps": [], "sets": [], "dels": []}
            step_index = {}
            group_bytes = 64

        def proof_refs(key) -> list[int]:
            nonlocal group_bytes
            refs = []
            for step in self.tree.prove(key, h).steps:
                sj = step.to_json()
                sk = "|".join(sj)
                idx = step_index.get(sk)
                if idx is None:
                    idx = len(group["steps"])
                    group["steps"].append(sj)
                    step_index[sk] = idx
                    group_bytes += len(sk) + 16
                refs.append(idx)
            return refs

        for key in sorted(upserts):
            entry = [key.hex().upper(), upserts[key].hex().upper(), proof_refs(key)]
            group["sets"].append(entry)
            group_bytes += len(entry[0]) + len(entry[1]) + 6 * len(entry[2])
            if group_bytes >= self.chunk_size:
                flush()
        for key in deletes:
            entry = [key.hex().upper(), proof_refs(key)]
            group["dels"].append(entry)
            group_bytes += len(entry[0]) + 6 * len(entry[1])
            if group_bytes >= self.chunk_size:
                flush()
        flush()
        if any(len(c) > MAX_CHUNK_BYTES for c in chunks):
            # a single oversized entry (or host section) cannot ride the
            # wire; a full snapshot chunks by size and always can
            logger.warning("delta chunk exceeds wire ceiling; going full")
            return None
        return chunks, seen_json

    # -- the whole path ------------------------------------------------------

    def snapshot(self, state) -> int:
        """Export a snapshot at state.last_block_height (delta against
        the previous one when possible, full otherwise). Returns the
        height. Raises on apps without snapshot support or a block store
        that cannot serve the height."""
        t0 = time.perf_counter()
        h = state.last_block_height
        base = self._delta_base(h)
        built = None
        if base is not None:
            built = self._build_delta_chunks(state, base)
            if built is None:
                self.delta_fallbacks += 1
        if built is not None:
            chunks, seen_json = built
            manifest = Manifest(
                height=h,
                chain_id=state.chain_id,
                chunk_size=self.chunk_size,
                total_bytes=sum(len(c) for c in chunks),
                chunk_digests=self._chunk_digests(chunks),
                header_hash=state.last_block_id.hash,
                app_hash=state.app_hash,
                kind=KIND_DELTA,
                base_height=base.height,
                seen_commit=seen_json,
            )
            self.deltas_taken += 1
            kind = "delta"
        else:
            app_state = self.app.snapshot()
            if app_state is None:
                raise ValueError(
                    f"{type(self.app).__name__} does not support snapshots"
                )
            obj, seen_json = build_payload(state, app_state, self.block_store)
            payload = encode_payload(obj)
            chunks = chunk_payload(payload, self.chunk_size)
            manifest = Manifest(
                height=h,
                chain_id=state.chain_id,
                chunk_size=self.chunk_size,
                total_bytes=len(payload),
                chunk_digests=self._chunk_digests(chunks),
                header_hash=state.last_block_id.hash,
                app_hash=state.app_hash,
                seen_commit=seen_json,
            )
            kind = "full"
        self.store.save(manifest, chunks)
        self.store.prune(self.keep_recent)
        self.snapshots_taken += 1
        self.last_snapshot_height = h
        self.last_snapshot_bytes = manifest.total_bytes
        self.last_snapshot_seconds = round(time.perf_counter() - t0, 4)
        logger.info(
            "%s snapshot at height %d: %d chunk(s), %d bytes, root %s (%.1f ms)",
            kind, h, manifest.chunks, manifest.total_bytes,
            manifest.root.hex()[:12], self.last_snapshot_seconds * 1000,
        )
        return h

    def stats(self) -> dict:
        """Producer-side gauges ONLY. The shared SnapshotStore's gauges
        are exported by the reactor's stats() (the reactor always exists
        on a node; the store is not folded in here as well, so
        the statesync_* wiring in node/telemetry.py is collision-free —
        no more setdefault ordering deciding which copy wins)."""
        return {
            "interval": self.interval,
            "snapshots_taken": self.snapshots_taken,
            "snapshot_failures": self.snapshot_failures,
            "deltas_taken": self.deltas_taken,
            "delta_fallbacks": self.delta_fallbacks,
            "last_snapshot_height": self.last_snapshot_height,
            "last_snapshot_seconds": self.last_snapshot_seconds,
            "last_snapshot_bytes": self.last_snapshot_bytes,
        }
