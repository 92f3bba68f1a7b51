"""Persistent block store (reference: blockchain/store.go).

Per height: BlockMeta, the block's parts (so gossip can serve individual
parts without reassembly), the block's LastCommit under height-1 ("C:"),
and the SeenCommit — the +2/3 precommits actually observed, which may be
for a different round than the canonical LastCommit ("SC:",
blockchain/store.go:34-38). A height watermark JSON is written LAST so a
crash mid-save leaves the previous height authoritative
(blockchain/store.go:217-240).
"""

from __future__ import annotations

import json
import threading

from tendermint_tpu_torch.libs.db import DB
from tendermint_tpu_torch.types import Block, Commit, Part, PartSet
from tendermint_tpu_torch.types.block_meta import BlockMeta

_STORE_KEY = b"blockStore"


def _meta_key(height: int) -> bytes:
    return b"H:%d" % height


def _part_key(height: int, index: int) -> bytes:
    return b"P:%d:%d" % (height, index)


def _commit_key(height: int) -> bytes:
    return b"C:%d" % height


def _seen_commit_key(height: int) -> bytes:
    return b"SC:%d" % height


class BlockStore:
    def __init__(self, db: DB):
        self.db = db
        self._mtx = threading.Lock()
        self._prune_mtx = threading.Lock()  # serializes prune_to callers
        self._height = 0
        self._base = 0
        # crash-safe prune bookkeeping: `clean_base` is the
        # lowest height that may still hold data on disk. prune_to
        # advances `base` FIRST (readers disown the range immediately),
        # deletes, then advances clean_base — so clean_base < base marks
        # an interrupted prune whose leftovers this open resumes deleting
        self._clean_base = 0
        # gauges (blockstore_* via the metrics RPC)
        self.pruned_heights = 0
        self.prune_runs = 0
        buf = db.get(_STORE_KEY)
        if buf:
            obj = json.loads(buf)
            self._height = obj["height"]
            # stores older than the base field have no base: a non-empty store starts
            # at height 1 (nothing was ever pruned before base existed)
            self._base = obj.get("base", 1 if self._height else 0)
            self._clean_base = obj.get("clean_base", self._base)
            if self._clean_base < self._base:
                self._resume_prune()

    def height(self) -> int:
        with self._mtx:
            return self._height

    def base(self) -> int:
        """Lowest height this store can serve: >1 after a
        statesync restore or prune_to — heights below it are legitimately
        absent, not missing."""
        with self._mtx:
            return self._base

    def _set_watermark_locked(self) -> None:
        self.db.set_sync(
            _STORE_KEY,
            json.dumps({
                "height": self._height,
                "base": self._base,
                "clean_base": self._clean_base,
            }).encode(),
        )

    # -- loads -------------------------------------------------------------

    def _get_json(self, key: bytes):
        buf = self.db.get(key)
        return json.loads(buf) if buf else None

    def load_block_meta(self, height: int) -> BlockMeta | None:
        obj = self._get_json(_meta_key(height))
        return BlockMeta.from_json(obj) if obj else None

    def load_block_part(self, height: int, index: int) -> Part | None:
        obj = self._get_json(_part_key(height, index))
        return Part.from_json(obj) if obj else None

    def load_block(self, height: int) -> Block | None:
        """Reassemble from parts (blockchain/store.go:60-81)."""
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        chunks = []
        for i in range(meta.block_id.parts_header.total):
            part = self.load_block_part(height, i)
            if part is None:
                return None
            chunks.append(part.bytes_)
        return Block.from_bytes(b"".join(chunks))

    def load_block_commit(self, height: int):
        """The canonical commit for `height`, i.e. block height+1's
        LastCommit (blockchain/store.go:102-110). Polymorphic: the key
        C:h holds whatever form block h+1 carried — full below the
        upgrade boundary, AggregateCommit at and above it."""
        from tendermint_tpu_torch.types.agg_commit import commit_from_json

        obj = self._get_json(_commit_key(height))
        return commit_from_json(obj) if obj else None

    def load_seen_commit(self, height: int):
        """SC:h holds whatever form the node OBSERVED the commit in —
        its own VoteSet's full commit when it took part in consensus, or
        an aggregate when the height arrived via fast-sync past the
        upgrade boundary."""
        from tendermint_tpu_torch.types.agg_commit import commit_from_json

        obj = self._get_json(_seen_commit_key(height))
        return commit_from_json(obj) if obj else None

    # -- save --------------------------------------------------------------

    def save_block(self, block: Block, block_parts: PartSet, seen_commit: Commit) -> None:
        """blockchain/store.go:147-172. Height watermark is flushed sync,
        last."""
        height = block.header.height
        if height != self.height() + 1:
            raise ValueError(f"BlockStore can only save contiguous blocks. Wanted {self.height() + 1}, got {height}")
        if not block_parts.is_complete():
            raise ValueError("BlockStore can only save complete block part sets")

        meta = BlockMeta.from_block(block, block_parts)
        self.db.set(_meta_key(height), json.dumps(meta.to_json(), sort_keys=True).encode())
        for i in range(block_parts.total):
            part = block_parts.get_part(i)
            self.db.set(_part_key(height, i), json.dumps(part.to_json(), sort_keys=True).encode())
        self.db.set(
            _commit_key(height - 1),
            json.dumps(block.last_commit.to_json(), sort_keys=True).encode(),
        )
        self.db.set(
            _seen_commit_key(height),
            json.dumps(seen_commit.to_json(), sort_keys=True).encode(),
        )
        with self._mtx:
            self._height = height
            if self._base == 0:
                self._base = height  # first block this store ever held
                self._clean_base = height
            self._set_watermark_locked()

    def seed_snapshot(self, meta: BlockMeta, parts: list[Part], seen_commit: Commit) -> None:
        """Statesync restore: install block H (meta + parts + seen
        commit) as BOTH base and head of an empty store, so the restored
        node serves /block and /commit at its base and save_block's
        contiguity check accepts H+1 from fast sync. The caller verified
        meta/parts/commit against the light-verified header chain."""
        height = meta.header.height
        if self.height() != 0:
            raise ValueError(
                f"seed_snapshot on a non-empty store (height {self.height()})"
            )
        if len(parts) != meta.block_id.parts_header.total:
            raise ValueError("seed_snapshot: part count does not match meta")
        self.db.set(_meta_key(height), json.dumps(meta.to_json(), sort_keys=True).encode())
        for i, part in enumerate(parts):
            self.db.set(_part_key(height, i), json.dumps(part.to_json(), sort_keys=True).encode())
        self.db.set(
            _seen_commit_key(height),
            json.dumps(seen_commit.to_json(), sort_keys=True).encode(),
        )
        with self._mtx:
            self._height = height
            self._base = height
            self._clean_base = height
            self._set_watermark_locked()

    def _delete_heights(self, lo: int, hi: int) -> int:
        """Delete the data of heights [lo, hi) plus the canonical commit
        under lo-1 (block lo's LastCommit, stored under lo-1 at save
        time — below the new base once hi is the base). Pure deletes; no
        watermark writes."""
        deleted = 0
        for h in range(lo, hi):
            meta = self.load_block_meta(h)
            if meta is not None:
                for i in range(meta.block_id.parts_header.total):
                    self.db.delete(_part_key(h, i))
            self.db.delete(_meta_key(h))
            self.db.delete(_commit_key(h))
            self.db.delete(_seen_commit_key(h))
            deleted += 1
        self.db.delete(_commit_key(lo - 1))
        return deleted

    def _resume_prune(self) -> None:
        """Open-time recovery: a crash mid-prune left clean_base < base —
        the heights in between are already disowned (readers treat them
        as pruned) but may still hold partial data. Finish their deletes
        and advance clean_base. Runs from __init__, single-threaded."""
        self._delete_heights(self._clean_base, self._base)
        self._clean_base = self._base
        self._set_watermark_locked()

    def prune_to(self, retain_height: int) -> int:
        """Delete everything below `retain_height`; returns the number of
        heights pruned. The watermark (with the new base) is flushed
        FIRST, so a crash mid-prune leaves heights the store already
        disowned — readers see base and treat them as pruned — never a
        base claiming heights whose data is half-deleted. The old base
        persists as `clean_base` until the deletes finish, so the next
        open resumes an interrupted prune instead of leaking the
        half-deleted range forever (tests/test_retention.py SIGKILLs a
        pruning subprocess mid-delete to hold this). Concurrent callers
        serialize on a dedicated lock — overlapping delete ranges would
        let the faster caller's clean_base claim cover the slower one's
        unfinished deletes."""
        with self._prune_mtx:
            return self._prune_to_serialized(retain_height)

    def _prune_to_serialized(self, retain_height: int) -> int:
        with self._mtx:
            if retain_height <= self._base:
                return 0
            if retain_height > self._height:
                raise ValueError(
                    f"cannot prune to {retain_height} past head {self._height}"
                )
            old_base, self._base = self._base, retain_height
            # clean_base stays at old_base: the watermark now says
            # "[old_base, retain) is disowned but possibly on disk"
            self._set_watermark_locked()
        pruned = self._delete_heights(old_base, retain_height)
        with self._mtx:
            self._clean_base = retain_height
            self._set_watermark_locked()
            self.pruned_heights += pruned
            self.prune_runs += 1
        return pruned
