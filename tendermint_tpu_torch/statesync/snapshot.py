"""Snapshot manifest, chunking, and the on-disk snapshot store.

A snapshot of height H is one deterministic byte payload (canonical JSON,
built by producer.py) split into fixed-size chunks. The manifest carries
the per-chunk RIPEMD-160 digests plus their simple-Merkle root
(merkle.simple.FlatTree — the same tree the part-set plane uses, so the
devd hash_stream kernel serves both), and the two hashes that tie the
snapshot to the light-verified header chain: the height-H header hash and
the post-H app hash (== header H+1's app_hash).

On disk (<db_dir>/snapshots/<height>/):
    manifest.json
    chunk-000000, chunk-000001, ...

Each chunk file is CRC-framed exactly like a WAL record
(libs/crc32c.py): magic ``TMSNAP1\\n`` then ``u32 crc32c(payload) |
u32 len(payload) | payload`` big-endian — a torn or bit-rotted chunk is
detected at load time and the whole snapshot is treated as damaged
(deleted, never served). The store is retention-bounded: `prune(keep)`
drops all but the newest `keep` snapshots.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import struct
import threading

from tendermint_tpu_torch.crypto.hashing import ripemd160
from tendermint_tpu_torch.libs.crc32c import crc32c
from tendermint_tpu_torch.merkle.simple import FlatTree

logger = logging.getLogger("statesync.snapshot")

FORMAT = 2
KIND_FULL = "full"
KIND_DELTA = "delta"
# a delta chain longer than this is garbage (the producer's full_every
# knob clamps far below); bounds the reactor's base-manifest recursion
MAX_DELTA_CHAIN = 32
CHUNK_MAGIC = b"TMSNAP1\n"
_FRAME = struct.Struct(">II")  # crc32c(payload), len(payload)
MANIFEST_FILE = "manifest.json"
# a chunk is bounded by the manifest's chunk_size; this is the absolute
# decode-time ceiling against garbage manifests/files. It must also FIT
# the wire: a chunk rides hex-encoded inside a JSON chunk_response, so
# the reactor's recv_message_capacity must cover 2x this plus framing —
# raise them together (reactor.get_channels notes the arithmetic)
MAX_CHUNK_BYTES = 4 * 1024 * 1024


class SnapshotError(Exception):
    pass


def chunk_payload(payload: bytes, chunk_size: int) -> list[bytes]:
    """Fixed-size split; at least one (possibly empty) chunk so a
    zero-byte payload still has a well-formed manifest."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    n = max((len(payload) + chunk_size - 1) // chunk_size, 1)
    return [payload[i * chunk_size : (i + 1) * chunk_size] for i in range(n)]


def chunk_digests_root(digests: list[bytes]) -> bytes:
    """Merkle root over the chunk digests via the flat builder — the one
    hash the manifest pins the whole chunk list to."""
    return FlatTree.from_leaf_digests(list(digests)).root()


class Manifest:
    """The snapshot's table of contents. `chunk_digests[i]` is the raw
    ripemd160 of chunk i's payload (the Part.Hash convention — NOT
    length-prefixed), `root` their simple-Merkle root.

    Format 2: the node-local SEEN commit is carried HERE, as
    a sidecar the digested payload never includes — replica payloads
    (and so manifest roots) are byte-identical even when replicas saw
    different precommit subsets (the
    commit is re-verified at restore exactly as before, any +2/3 seen
    commit passes). Format 2 also adds `kind`: "full" manifests chunk
    one canonical payload by fixed size; "delta" manifests carry one
    host chunk plus self-verifying changed-entry chunks against
    `base_height`'s snapshot (docs/state-tree.md). Format 1 manifests
    (older homes) still decode and restore."""

    def __init__(
        self,
        height: int,
        chain_id: str,
        chunk_size: int,
        total_bytes: int,
        chunk_digests: list[bytes],
        header_hash: bytes,
        app_hash: bytes,
        format_: int = FORMAT,
        kind: str = KIND_FULL,
        base_height: int = 0,
        seen_commit: dict | None = None,
    ):
        self.format = format_
        self.height = height
        self.chain_id = chain_id
        self.chunk_size = chunk_size
        self.total_bytes = total_bytes
        self.chunk_digests = chunk_digests
        self.header_hash = header_hash
        self.app_hash = app_hash
        self.kind = kind
        self.base_height = base_height
        self.seen_commit = seen_commit  # JSON form (types.block.Commit)
        self.root = chunk_digests_root(chunk_digests)

    @property
    def chunks(self) -> int:
        return len(self.chunk_digests)

    def to_json(self) -> dict:
        out = {
            "format": self.format,
            "height": self.height,
            "chain_id": self.chain_id,
            "chunks": self.chunks,
            "chunk_size": self.chunk_size,
            "total_bytes": self.total_bytes,
            "chunk_digests": [d.hex().upper() for d in self.chunk_digests],
            "root": self.root.hex().upper(),
            "header_hash": self.header_hash.hex().upper(),
            "app_hash": self.app_hash.hex().upper(),
        }
        if self.format >= 2:
            out["kind"] = self.kind
            if self.kind == KIND_DELTA:
                out["base_height"] = self.base_height
            if self.seen_commit is not None:
                out["seen_commit"] = self.seen_commit
        return out

    def lite(self) -> dict:
        """The discovery form gossiped in snapshots_response / served by
        the RPC route — enough to pick a snapshot, not to verify one."""
        out = {
            "format": self.format,
            "height": self.height,
            "chain_id": self.chain_id,
            "chunks": self.chunks,
            "total_bytes": self.total_bytes,
            "root": self.root.hex().upper(),
            "header_hash": self.header_hash.hex().upper(),
            "kind": self.kind,
        }
        if self.kind == KIND_DELTA:
            out["base_height"] = self.base_height
        return out

    @classmethod
    def from_json(cls, obj) -> "Manifest":
        """Decode an UNTRUSTED manifest (it arrives over p2p). Every
        violation raises ValueError, the reactor's peer-error alphabet."""
        from tendermint_tpu_torch.codec import jsonval as jv

        if not isinstance(obj, dict):
            raise ValueError("manifest must be an object")
        fmt = jv.int_field(obj, "format", 1, 1 << 16)
        height = jv.int_field(obj, "height", 1, jv.MAX_HEIGHT)
        chain_id = obj.get("chain_id")
        if not isinstance(chain_id, str) or len(chain_id) > 256:
            raise ValueError("bad manifest chain_id")
        chunk_size = jv.int_field(obj, "chunk_size", 1, MAX_CHUNK_BYTES)
        total_bytes = jv.int_field(obj, "total_bytes", 0, 1 << 40)
        raw = obj.get("chunk_digests")
        # 2^18 chunks at the 64 KiB default = a 16 GiB snapshot (1 TiB at
        # the 4 MiB ceiling); anything wider is garbage, not state — and
        # the digest list must fit a manifest_response inside the
        # reactor's recv_message_capacity
        if not isinstance(raw, list) or not 1 <= len(raw) <= (1 << 18) or any(
            not isinstance(d, str) or len(d) != 40 for d in raw
        ):
            raise ValueError("bad manifest chunk_digests")
        kind = obj.get("kind", KIND_FULL) if fmt >= 2 else KIND_FULL
        if kind not in (KIND_FULL, KIND_DELTA):
            raise ValueError(f"bad manifest kind {kind!r}")
        base_height = 0
        if kind == KIND_DELTA:
            base_height = jv.int_field(obj, "base_height", 1, jv.MAX_HEIGHT)
            if base_height >= height:
                raise ValueError("delta base_height must be below height")
        seen_commit = None
        if fmt >= 2 and "seen_commit" in obj:
            seen_commit = obj["seen_commit"]
            # validate NOW (it arrives over p2p); keep the JSON form —
            # restore re-parses and signature-verifies it. Polymorphic:
            # post-upgrade snapshots carry an AggregateCommit here
            # (docs/upgrade.md), dispatched on the "s_agg" key
            from tendermint_tpu_torch.types.agg_commit import commit_from_json

            commit_from_json(jv.dict_field(obj, "seen_commit"))
        m = cls(
            height=height,
            chain_id=chain_id,
            chunk_size=chunk_size,
            total_bytes=total_bytes,
            chunk_digests=[bytes.fromhex(d) for d in raw],
            header_hash=jv.hex_field(obj, "header_hash", max_bytes=20),
            app_hash=jv.hex_field(obj, "app_hash", max_bytes=64),
            format_=fmt,
            kind=kind,
            base_height=base_height,
            seen_commit=seen_commit,
        )
        # full snapshots: total_bytes must agree with the chunk count —
        # exactly the last chunk may run short (chunk_payload's
        # fixed-size split, min 1). Delta chunks are semantic units
        # (host section + entry groups), not fixed-size slices; each is
        # still bounded by MAX_CHUNK_BYTES at every decode site.
        if m.kind == KIND_FULL and not (
            (m.chunks - 1) * m.chunk_size
            < max(m.total_bytes, 1)
            <= m.chunks * m.chunk_size
        ):
            raise ValueError("manifest total_bytes does not fit its chunk count")
        claimed_root = jv.hex_field(obj, "root", max_bytes=20)
        # the root must MATCH the digest list — a manifest whose root and
        # digests disagree can never verify, reject it at decode time
        if claimed_root != m.root:
            raise ValueError("manifest root does not match chunk digests")
        if len(m.header_hash) != 20:
            raise ValueError("bad manifest header_hash")
        return m


def frame_chunk(payload: bytes) -> bytes:
    return CHUNK_MAGIC + _FRAME.pack(crc32c(payload), len(payload)) + payload


def unframe_chunk(buf: bytes) -> bytes:
    """Inverse of frame_chunk; raises SnapshotError on any damage —
    wrong magic, bad length, trailing garbage, or CRC mismatch."""
    if not buf.startswith(CHUNK_MAGIC):
        raise SnapshotError("bad chunk magic")
    off = len(CHUNK_MAGIC)
    if len(buf) < off + _FRAME.size:
        raise SnapshotError("truncated chunk frame")
    crc, length = _FRAME.unpack_from(buf, off)
    if length > MAX_CHUNK_BYTES or len(buf) != off + _FRAME.size + length:
        raise SnapshotError("chunk length mismatch")
    payload = buf[off + _FRAME.size :]
    if crc32c(payload) != crc:
        raise SnapshotError("chunk crc mismatch")
    return payload


def chunk_digest(payload: bytes) -> bytes:
    return ripemd160(payload)


class SnapshotStore:
    """Retention-bounded directory of snapshots. Publication is atomic at
    directory granularity: a snapshot is assembled under a `.tmp` name
    and os.replace'd into place, so readers never see a half-written
    snapshot under its final name."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self._mtx = threading.Lock()
        # parsed-manifest cache: from_json re-Merkles the whole digest
        # list, and the serving paths (snapshots_request, the RPC route)
        # are remotely triggerable — re-parsing trusted local files per
        # request would let any peer burn CPU with one-line messages
        self._manifest_cache: dict[int, Manifest] = {}
        os.makedirs(base_dir, exist_ok=True)
        # gauges (exported as statesync_* via the metrics RPC)
        self.chunks_served = 0
        self.load_failures = 0

    # -- paths -------------------------------------------------------------

    def _dir(self, height: int) -> str:
        return os.path.join(self.base_dir, f"{height:010d}")

    @staticmethod
    def chunk_name(index: int) -> str:
        return f"chunk-{index:06d}"

    # -- writing -----------------------------------------------------------

    def save(self, manifest: Manifest, chunks: list[bytes],
             keep_recent: int | None = None) -> str:
        """Publish a snapshot; with `keep_recent`, also drop all but the
        newest `keep_recent` under the same lock, so that a reader never
        lists more than that."""
        if len(chunks) != manifest.chunks:
            raise SnapshotError(
                f"{len(chunks)} chunks for a {manifest.chunks}-chunk manifest"
            )
        final = self._dir(manifest.height)
        tmp = final + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, payload in enumerate(chunks):
            with open(os.path.join(tmp, self.chunk_name(i)), "wb") as f:
                f.write(frame_chunk(payload))
        # manifest last: its presence is what marks the dir complete
        with open(os.path.join(tmp, MANIFEST_FILE), "w") as f:
            json.dump(manifest.to_json(), f, sort_keys=True)
        with self._mtx:
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            # deliberately NOT cached here: the first load after a save
            # parses the published file, so on-disk damage is still
            # detected once per process (the load-time contract tests
            # rely on); only load-verified manifests enter the cache
            self._manifest_cache.pop(manifest.height, None)
            if keep_recent is not None:
                self._prune_locked(keep_recent)
        return final

    def delete(self, height: int) -> None:
        with self._mtx:
            self._delete_locked(height)

    def _delete_locked(self, height: int) -> None:
        self._manifest_cache.pop(height, None)
        d = self._dir(height)
        if os.path.isdir(d):
            shutil.rmtree(d)

    def prune(self, keep_recent: int) -> list[int]:
        """Drop all but the newest `keep_recent` snapshots; returns the
        pruned heights."""
        with self._mtx:
            return self._prune_locked(keep_recent)

    def _prune_locked(self, keep_recent: int) -> list[int]:
        pruned = self._heights_locked()[:-max(keep_recent, 1)]
        for h in pruned:
            self._delete_locked(h)
        return pruned

    # -- reading -----------------------------------------------------------

    def heights(self) -> list[int]:
        """Published snapshot heights, ascending (dirs with a manifest)."""
        with self._mtx:
            return self._heights_locked()

    def _heights_locked(self) -> list[int]:
        out = []
        try:
            names = os.listdir(self.base_dir)
        except FileNotFoundError:
            return []
        for name in names:
            if name.isdigit() and os.path.exists(
                os.path.join(self.base_dir, name, MANIFEST_FILE)
            ):
                out.append(int(name))
        return sorted(out)

    def load_manifest(self, height: int) -> Manifest | None:
        with self._mtx:
            cached = self._manifest_cache.get(height)
        if cached is not None:
            return cached
        path = os.path.join(self._dir(height), MANIFEST_FILE)
        try:
            with open(path) as f:
                m = Manifest.from_json(json.load(f))
        except FileNotFoundError:
            return None
        except (ValueError, OSError) as exc:
            self.load_failures += 1
            logger.warning("damaged manifest at height %d: %s", height, exc)
            return None
        with self._mtx:
            self._manifest_cache[height] = m
        return m

    def load_chunk(self, height: int, index: int) -> bytes | None:
        """Chunk payload, CRC-verified. None when absent; raises
        SnapshotError on damage — the serving reactor then drops the
        whole snapshot rather than feed a peer bytes it KNOWS are bad."""
        path = os.path.join(self._dir(height), self.chunk_name(index))
        try:
            with open(path, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            return None
        payload = unframe_chunk(buf)
        self.chunks_served += 1
        return payload

    def stats(self) -> dict:
        heights = self.heights()
        return {
            "snapshots": len(heights),
            "last_height": heights[-1] if heights else 0,
            "chunks_served": self.chunks_served,
            "load_failures": self.load_failures,
        }
