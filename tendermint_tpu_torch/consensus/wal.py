"""Consensus write-ahead log (reference: consensus/wal.go).

Every input to the receive routine — peer/internal messages and timeouts
— is logged BEFORE processing, plus step-transition events; on restart the
tail since the last `#ENDHEIGHT: h` marker replays through the state
machine (consensus/replay.go:98-148). "light" mode skips logging gossiped
block parts (consensus/wal.go:79-86).

The storage format (docs/crash-recovery.md):

v2 — CRC-framed records with group commit. Every chunk starts with the
8-byte magic ``TMWAL2\\r\\n``; each record is framed as

    u32 crc32c(payload) | u32 len(payload) | payload        (big-endian)

where the payload is the exact JSON line (or ``#ENDHEIGHT: h`` marker)
the legacy format stored, so `decode_wal_line` is format-agnostic.
Records never span chunks (autofile.Group only rotates between writes).

Durability contract (group commit):
- `save()` buffers to the OS (write+flush, no fsync); a background
  flusher fsyncs at a bounded interval (`flush_interval_s`, default
  0.1 s) — so at most one interval of UNCOMMITTED inputs can be lost to
  a power failure, which is safe: replay treats them as never arrived.
- `write_end_height()` fsyncs synchronously — a committed height is
  durable before the block applies, so recovery can never lose a height
  past its last synced ``#ENDHEIGHT``.
- `sync_every_write=True` restores fsync-per-record (the legacy-strength
  bound; ~10-40x slower on real disks, benches/bench_wal.py).

Repair on open: scan every chunk forward; at the first record whose
magic/length/CRC fails, back the damaged tail (and any later chunks) up
to ``<wal>.corrupt-<stamp>`` and truncate — a torn write anywhere in the
tail leaves a clean, replayable log instead of wedging the validator.

Legacy JSON-line WALs are detected by their first byte and served
read/write-compatible with the old code (per-line fsync, line search) so
older node homes keep replaying.
"""

from __future__ import annotations

import json
import logging
import math
import os
import struct
import threading
import time

from tendermint_tpu_torch.consensus import messages as msgs
from tendermint_tpu_torch.consensus.ticker import TimeoutInfo
from tendermint_tpu_torch.libs.autofile import Group
from tendermint_tpu_torch.libs.crc32c import crc32c
from tendermint_tpu_torch.libs.envknob import env_number
from tendermint_tpu_torch.libs.service import BaseService

logger = logging.getLogger("consensus.wal")

MAGIC = b"TMWAL2\r\n"
_FRAME = struct.Struct(">II")  # crc32c(payload), len(payload)
# bound on a single record: a block part is <= 64 KiB, hex-expanded and
# json-wrapped well under this; anything larger is framing damage
MAX_RECORD_BYTES = 8 * 1024 * 1024
# ceiling for the flusher's Event.wait — threading.TIMEOUT_MAX overflows
# on some platforms when handed to the C layer, and no sane group-commit
# interval approaches an hour anyway
_FLUSH_WAIT_CAP_S = 3600.0
# the clean watermark re-persists once the synced position has
# advanced this far within one chunk (rotation crossings always persist):
# bounds the post-crash deep scan to ~stride + the unsynced tail without
# putting a sidecar write on every group commit
_WATERMARK_STRIDE = 1024 * 1024


def _frame(payload: bytes) -> bytes:
    # enforce the reader's bound at the producer: an oversize (or empty)
    # record would frame + fsync fine today and then read back as DAMAGE on
    # the next open — repair would truncate there and quarantine everything
    # after it, retroactively discarding durable records. Fail loudly now.
    if not 0 < len(payload) <= MAX_RECORD_BYTES:
        raise ValueError(
            f"WAL record of {len(payload)} bytes is outside "
            f"(0, {MAX_RECORD_BYTES}]; refusing to write a frame the "
            "repair pass would treat as corruption"
        )
    return _FRAME.pack(crc32c(payload), len(payload)) + payload


def _unused_path(path: str) -> str:
    """First non-existing name in path, path.1, path.2, ... — every repair
    artifact (tail backup, quarantined chunk) gets its own file, even when
    the head's quarantine name collides with the tail backup's."""
    cand, k = path, 0
    while os.path.exists(cand):
        k += 1
        cand = f"{path}.{k}"
    return cand


def scan_frames(buf: bytes, start: int = 0) -> tuple[list[bytes], int | None]:
    """Parse one chunk's bytes into record payloads.

    Returns (payloads, bad_offset): bad_offset is None for a clean chunk,
    else the byte offset of the first record whose magic/length/CRC check
    fails — exactly where the repair pass truncates.

    An EMPTY buffer is clean, not damaged: a prior repair that cut a
    chunk at offset 0 leaves a zero-byte file in the group, and flagging
    it bad again on every later open would re-quarantine every newer
    chunk — including freshly fsynced #ENDHEIGHTs.

    `start` > 0 resumes mid-chunk at a known frame boundary (the clean
    watermark): the magic check is skipped — bytes before
    `start` were covered by a synced flush and are trusted unread.
    """
    if not buf:
        return [], None
    if start > 0:
        off = start
    else:
        if not buf.startswith(MAGIC):
            return [], 0
        off = len(MAGIC)
    payloads: list[bytes] = []
    n = len(buf)
    while off < n:
        if off + _FRAME.size > n:
            return payloads, off
        crc, length = _FRAME.unpack_from(buf, off)
        # length 0 is also damage: no writer emits empty records, and
        # all-zero fill (a torn allocation) would otherwise VALIDATE —
        # crc32c(b"") == 0 matches four zero crc bytes
        if not 0 < length <= MAX_RECORD_BYTES or off + _FRAME.size + length > n:
            return payloads, off
        payload = buf[off + _FRAME.size : off + _FRAME.size + length]
        if crc32c(payload) != crc:
            return payloads, off
        payloads.append(payload)
        off += _FRAME.size + length
    return payloads, None


class WALMessage:
    """Tagged union of loggable inputs: msg_info (peer or internal
    message), timeout, or event (step marker)."""

    @staticmethod
    def msg_info(msg, peer_id: str) -> dict:
        return {"type": "msg_info", "peer_id": peer_id, "msg": msgs.msg_to_json(msg)}

    @staticmethod
    def timeout(ti: TimeoutInfo) -> dict:
        return {"type": "timeout", "timeout": ti.to_json()}

    @staticmethod
    def event_round_state(rs_event) -> dict:
        return {
            "type": "event",
            "height": rs_event.height,
            "round": rs_event.round_,
            "step": rs_event.step,
        }


class WAL(BaseService):
    def __init__(
        self,
        wal_file: str,
        light: bool = False,
        flush_interval_s: float = 0.1,
        sync_every_write: bool = False,
        chunk_size: int | None = None,
    ):
        super().__init__("WAL")
        self.light = light
        self._path = wal_file
        self._flush_interval_s = env_number(
            "TENDERMINT_WAL_FLUSH_S", flush_interval_s
        )
        # range-clamp the knobs, same never-kill-startup contract as the
        # parse: zero/negative/nan intervals busy-spin the flusher thread,
        # inf overflows Event.wait with an uncaught OverflowError that
        # silently KILLS it (records then durable only at ENDHEIGHT)
        if not (0 < self._flush_interval_s <= _FLUSH_WAIT_CAP_S):
            clamped = min(
                max(self._flush_interval_s, 0.001), _FLUSH_WAIT_CAP_S
            )
            if not math.isfinite(clamped):  # nan propagates through min/max
                clamped = 0.1
            logger.warning(
                "wal flush interval %r outside (0, %g]; clamping to %gs",
                self._flush_interval_s, _FLUSH_WAIT_CAP_S, clamped,
            )
            self._flush_interval_s = clamped
        self._sync_every = sync_every_write
        if chunk_size is None:
            chunk_size = env_number(
                "TENDERMINT_WAL_CHUNK_BYTES", 10 * 1024 * 1024, cast=int
            )
        # a chunk bound at or below the magic header would rotate on every
        # flush (a fresh head is born >= the bound) — one file + fsync per
        # record, silently worse than fsync-per-record mode
        if chunk_size < 64:
            logger.warning(
                "wal chunk bound %d B < 64 B floor; clamping", chunk_size
            )
            chunk_size = 64
        os.makedirs(os.path.dirname(wal_file) or ".", exist_ok=True)

        # latency distributions: how long each group-commit
        # fsync took and how many records it covered — the histograms
        # the durability-policy knobs are tuned against (scrape-only;
        # the flat wal_* gauges stay the legacy metrics-RPC surface)
        from tendermint_tpu_torch.libs import telemetry

        reg = telemetry.default_registry()
        self._fsync_hist = reg.histogram(
            "wal_fsync_seconds",
            "WAL group-commit fsync latency (one fsync per group)",
        )
        self._group_hist = reg.histogram(
            "wal_group_records",
            "records covered by one WAL group-commit fsync",
            buckets=telemetry.size_buckets(16384),
        )

        # gauges (exported as wal_* via the metrics RPC)
        self._records = 0
        self._fsyncs = 0
        self._pending = 0  # records buffered since the last fsync
        self._group_last = 0
        self._group_max = 0
        self._synced_records = 0  # sum of group sizes (for the avg)
        self._repairs = 0
        self._truncated_bytes = 0
        # retention plane: whole rotated chunks dropped by
        # prune_to, plus a per-chunk max-#ENDHEIGHT memo (rotated chunks
        # are immutable, so one scan per chunk per process suffices)
        self._chunks_pruned = 0
        self._chunk_marker_cache: dict[str, int | None] = {}
        # clean-watermark plane (ROADMAP open item): chunks a
        # synced flush already covered skip the open-time CRC deep scan
        self._wm_path = wal_file + ".clean"
        self._wm_written: tuple[int, int] | None = None  # (chunk_index, offset)
        self._scan_skipped_chunks = 0
        self._scan_skipped_bytes = 0

        self._legacy = self._detect_legacy()
        self._records_at_open = 0
        if not self._legacy:
            self._records_at_open = self._repair()
        self._wmtx = threading.Lock()  # guards the gauge/fsync bookkeeping
        self._sync_mtx = threading.Lock()  # serializes fsyncers only
        self._last_sync = time.monotonic()
        self._flusher: threading.Thread | None = None
        self._flush_stop = threading.Event()
        self.group = Group(
            wal_file,
            chunk_size=chunk_size,
            header=b"" if self._legacy else MAGIC,
            crash_hooks=True,
        )

    # -- format detection + repair ----------------------------------------

    def _detect_legacy(self) -> bool:
        """A legacy WAL stored JSON text lines, so its chunks open
        with '{' (a json record) or '#' (the ENDHEIGHT seed) — exactly
        and only those two bytes; v2 chunks open with MAGIC. The two
        alphabets are disjoint and a WAL is never mixed, so ONE chunk
        with either signature decides the format. Scan every chunk
        before deciding: judging only the oldest non-empty chunk would
        let a single damaged byte at its offset 0 misread a legacy log
        as v2 and hand it to the MUTATING v2 repair, which would
        quarantine every (intact, replayable) later chunk wholesale.
        No evidence anywhere (fresh home, or every chunk head damaged)
        = v2: its repair backs all bytes up before cutting."""
        legacy_seen = False
        for p in Group.list_chunks(self._path):
            try:
                with open(p, "rb") as f:
                    head = f.read(len(MAGIC))
            except OSError:
                continue
            if head.startswith(MAGIC):
                return False
            if head[:1] in (b"{", b"#"):
                legacy_seen = True
        return legacy_seen

    # -- clean watermark ----------------------------------------

    def _load_watermark(self) -> dict | None:
        """The persisted clean watermark, validated against the chunk
        files on disk — None (with a warning where it matters) whenever
        anything disagrees, which falls back to the full deep scan. The
        sidecar is written AFTER each covering fsync returns, so a valid
        watermark can only ever trail durability, never lead it."""
        try:
            with open(self._wm_path) as f:
                obj = json.load(f)
            idx, off, rec = obj["chunk_index"], obj["offset"], obj["records"]
        except (OSError, ValueError, KeyError):
            return None
        if not all(isinstance(v, int) and v >= 0 for v in (idx, off, rec)):
            return None
        if off < len(MAGIC):
            return None
        indices = Group._chunk_indices(self._path)
        index_to_path = {i: f"{self._path}.{i:03d}" for i in indices}
        if os.path.exists(self._path):
            index_to_path[(indices[-1] + 1) if indices else 0] = self._path
        target = index_to_path.get(idx)
        # chunks below idx must be contiguous EXCEPT for a pruned prefix:
        # retention (prune_to) deletes whole chunks from the
        # front of the group, which must not invalidate the watermark —
        # but a chunk missing from the MIDDLE means the log was mangled
        missing = [i for i in range(idx) if i not in index_to_path]
        prefix_pruned = missing == list(range(len(missing)))
        if target is None or not prefix_pruned:
            logger.warning(
                "WAL clean watermark names chunk %d which is missing; "
                "deep-scanning the full history", idx,
            )
            return None
        if os.path.getsize(target) < off:
            # fsynced bytes vanished: either the filesystem lost data or
            # the log was hand-edited — both are full-forensics territory
            logger.warning(
                "WAL clean watermark covers %d byte(s) of %s but only %d "
                "exist; deep-scanning the full history",
                off, os.path.basename(target), os.path.getsize(target),
            )
            return None
        return {"chunk_index": idx, "offset": off, "records": rec,
                "path": target}

    def _write_watermark(self, pos: tuple[int, int], records: int) -> None:
        """Persist (chunk_index, offset, records-covered) atomically. Not
        fsynced on purpose: a lost or torn sidecar only widens the next
        open's scan — JSON that fails to parse reads as 'no watermark'."""
        tmp = self._wm_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(
                    {"chunk_index": pos[0], "offset": pos[1],
                     "records": records}, f,
                )
            os.replace(tmp, self._wm_path)
            self._wm_written = pos
        except OSError:
            logger.exception("WAL clean watermark write failed")

    def _maybe_write_watermark(self, pos: tuple[int, int], records: int) -> None:
        last = self._wm_written
        if last is None or pos[0] > last[0] or (
            pos[0] == last[0] and pos[1] - last[1] >= _WATERMARK_STRIDE
        ):
            self._write_watermark(pos, records)

    def _drop_watermark(self) -> None:
        try:
            os.unlink(self._wm_path)
        except FileNotFoundError:
            pass
        self._wm_written = None

    def _repair(self) -> int:
        """Forward-scan the chunks; truncate at the first damaged record,
        backing the cut tail (and all later chunks) up to
        <wal>.corrupt-<stamp>. Returns the surviving record count.

        Chunks (and the watermark chunk's prefix) covered by the clean
        watermark skip the deep scan: those bytes were fsynced before the
        sidecar was written and a crash cannot have torn them — the scan
        that used to be O(total history) per open is now O(bytes since
        the last persisted watermark). TENDERMINT_WAL_DEEP_SCAN=1 forces
        the full-history scan for forensics (historical-chunk bit rot is
        out of the crash model, exactly like silent payload rot on
        trusted local IPC in the device plane's contract)."""
        wm = None
        if int(env_number("TENDERMINT_WAL_DEEP_SCAN", 0, cast=int)):
            logger.info("TENDERMINT_WAL_DEEP_SCAN=1: full-history WAL scan")
        else:
            wm = self._load_watermark()
        paths = Group.list_chunks(self._path)
        records = wm["records"] if wm else 0
        wm_at = paths.index(wm["path"]) if wm else -1
        for i, p in enumerate(paths):
            start = 0
            if wm is not None:
                if i < wm_at:
                    self._scan_skipped_chunks += 1
                    self._scan_skipped_bytes += os.path.getsize(p)
                    continue
                if i == wm_at:
                    start = wm["offset"]
                    self._scan_skipped_bytes += start
                    self._wm_written = (wm["chunk_index"], wm["offset"])
            try:
                with open(p, "rb") as f:
                    buf = f.read()
            except OSError:
                continue
            payloads, bad = scan_frames(buf, start=start)
            records += len(payloads)
            if bad is None:
                continue
            stamp = time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}"
            backup = _unused_path(f"{self._path}.corrupt-{stamp}")
            with open(backup, "wb") as f:
                f.write(buf[bad:])
            with open(p, "r+b") as f:
                f.truncate(bad)
            cut = len(buf) - bad
            # anything after a damaged record cannot be ordered safely:
            # later chunks leave the group's namespace wholesale (when the
            # damaged chunk is not the head, the HEAD's quarantine name is
            # exactly the tail backup's — _unused_path keeps them distinct)
            for q in paths[i + 1 :]:
                dest = _unused_path(f"{q}.corrupt-{stamp}")
                os.replace(q, dest)
                cut += os.path.getsize(dest)
            self._repairs += 1
            self._truncated_bytes += cut
            # the watermark may name bytes (or whole chunks) the cut just
            # removed; rather than reason about partial overlap, drop it —
            # the next synced flush rebuilds it over the repaired log
            self._drop_watermark()
            logger.warning(
                "WAL repair: truncated %d byte(s) at %s offset %d (backup %s)",
                cut, os.path.basename(p), bad, backup,
            )
            break
        return records

    # -- lifecycle ---------------------------------------------------------

    def on_start(self) -> None:
        # a brand-new WAL gets a height-0 boundary so the first catchup
        # replay has a marker to search from (the reference seeds #ENDHEIGHT
        # on fresh WALs via its height-0 write path)
        if self._legacy:
            if os.path.getsize(self._path) == 0:
                self.group.write_line("#ENDHEIGHT: 0")
                self.group.flush(sync=True)
        elif self._records_at_open == 0:
            self.write_end_height(0, _force=True)
        if not self._legacy and not self._sync_every:
            self._flush_stop.clear()
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True, name="wal.flusher"
            )
            self._flusher.start()
        logger.info(
            "WAL open: format=%s %s (records=%d repairs=%d)",
            "legacy-json" if self._legacy else "v2-crc32c",
            "fsync-per-record" if (self._legacy or self._sync_every)
            else f"group-commit flush_interval={self._flush_interval_s}s "
                 f"sync-on-ENDHEIGHT",
            self._records_at_open, self._repairs,
        )

    def on_stop(self) -> None:
        self._flush_stop.set()
        stuck = False
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
            stuck = self._flusher.is_alive()
            self._flusher = None
        if stuck:
            # the flusher is wedged inside os.fsync on a dying disk while
            # holding _sync_mtx — a final sync() here would block shutdown
            # forever on the same stuck device, defeating the timed join
            logger.warning(
                "WAL flusher stuck in fsync after 2s; skipping final sync "
                "(%d record(s) OS-buffered but not known durable)",
                self._pending,
            )
        else:
            self.sync()
            if not self._legacy:
                # exact watermark on clean close: the next open deep-scans
                # nothing (the final sync drained every pending record)
                with self._wmtx:
                    pos = self.group.position() if self._pending == 0 else None
                    covered = self._records_at_open + self._records
                if pos is not None:
                    self._write_watermark(pos, covered)
        self.group.close()

    def _flush_loop(self) -> None:
        while not self._flush_stop.wait(self._flush_interval_s):
            try:
                self.sync()
            except Exception:  # a dying disk must not kill the flusher
                logger.exception("WAL group-commit fsync failed")

    def sync(self) -> None:
        """Group commit: one fsync covering every record buffered since the
        last one. No-op when nothing is pending.

        The fsync runs OUTSIDE _wmtx AND outside the Group's append lock
        (flush(sync=True) dups the fd and fsyncs after releasing it): a
        save() on the consensus receive hot path must never stall behind
        the flusher's disk round trip — that latency is exactly what group
        commit exists to remove. Records landing mid-fsync are durable
        early or ride the next group; either way the batch counted below
        was fully written (and OS-flushed) before the dup was taken."""
        with self._sync_mtx:
            with self._wmtx:
                batch = self._pending
                # clean-watermark coordinate, captured while _wmtx blocks
                # writers: the group position corresponds EXACTLY to the
                # _records written so far, and the fsync below covers at
                # least these bytes
                pos = None if self._legacy else self.group.position()
                covered = self._records_at_open + self._records
            if batch == 0:
                return
            t0 = time.perf_counter()
            self.group.flush(sync=True)
            self._fsync_hist.observe(time.perf_counter() - t0)
            self._group_hist.observe(batch)
            with self._wmtx:
                self._account_sync(batch)
            if pos is not None:
                self._maybe_write_watermark(pos, covered)

    def _account_sync(self, batch: int) -> None:
        # caller holds self._wmtx
        self._fsyncs += 1
        self._pending -= batch
        self._group_last = batch
        self._group_max = max(self._group_max, batch)
        self._synced_records += batch
        self._last_sync = time.monotonic()

    # -- writing -----------------------------------------------------------

    def _write_record(self, payload: bytes, sync: bool) -> None:
        with self._wmtx:
            self._records += 1
            self._pending += 1
            if self._legacy:
                self.group.write_bytes(payload + b"\n")
            else:
                self.group.write_bytes(_frame(payload))
                if not (sync or self._sync_every):
                    # publish to the OS now (readers + rotation); fsync
                    # rides the flusher's bounded interval
                    self.group.flush(sync=False)
                    return
        # synchronous durability points — #ENDHEIGHT, sync_every mode, and
        # the legacy per-line contract — fsync outside the write lock too
        self.sync()

    def save(self, wal_msg: dict) -> None:
        """Write one input record; durable within flush_interval_s
        (consensus/wal.go:73-95 wrote+fsynced every line)."""
        if not self.is_running():
            return
        if self.light:
            # skip block parts and full proposals from peers
            if wal_msg.get("type") == "msg_info" and wal_msg.get("peer_id"):
                tag = wal_msg["msg"]["type"]
                if tag in ("block_part", "proposal"):
                    return
        line = json.dumps({"time": time.time(), **wal_msg}, sort_keys=True)
        self._write_record(line.encode(), sync=False)

    def write_end_height(self, height: int, _force: bool = False) -> None:
        """Marker: height fully committed (consensus/wal.go:97-104).
        Always fsynced — the group-commit durability contract's floor."""
        if not self.is_running() and not _force:
            return
        self._write_record(f"#ENDHEIGHT: {height}".encode(), sync=True)

    # -- retention ----------------------------------------------

    def _chunk_max_marker(self, path: str) -> int | None:
        """Largest #ENDHEIGHT height in a ROTATED chunk (None when the
        chunk carries no marker). Memoized — rotated chunks never change."""
        if path in self._chunk_marker_cache:
            return self._chunk_marker_cache[path]
        best: int | None = None
        try:
            with open(path, "rb") as f:
                payloads, _bad = scan_frames(f.read())
        except OSError:
            # transient read failure (fd pressure, NFS blip): do NOT
            # cache — a memoized None here could disable pruning for
            # the process lifetime if this chunk held the anchor marker
            return None
        for p in payloads:
            if p.startswith(b"#ENDHEIGHT:"):
                try:
                    best = int(p.split(b":", 1)[1])
                except ValueError:
                    continue
        self._chunk_marker_cache[path] = best
        return best

    def prune_to(self, retain_height: int) -> int:
        """Drop rotated chunks whose entire content precedes history the
        node still retains; returns the number of chunk files deleted.

        Replay only ever searches `#ENDHEIGHT: h` markers for heights the
        node still holds (h >= retain_height - 1, since retention keeps
        the head blocks). Markers are strictly increasing through the
        group, so every chunk OLDER than the newest chunk containing a
        marker <= retain_height - 1 can only hold records below every
        marker replay can be asked for — deletable wholesale. Chunk
        granularity keeps this a pure unlink of immutable files: the
        head and any chunk at/after the anchor are never touched, and
        the clean watermark stays valid across a pruned prefix
        (_load_watermark tolerates missing LEADING chunks)."""
        if self._legacy:
            return 0  # pre-framed logs predate retention; leave them be
        paths = self.group.chunk_paths()
        rotated = paths[:-1]  # head (last) is live, never pruned
        anchor = None
        for k in range(len(rotated) - 1, -1, -1):
            m = self._chunk_max_marker(rotated[k])
            if m is not None and m <= retain_height - 1:
                anchor = k
                break
        if anchor is None or anchor == 0:
            return 0
        pruned = 0
        for p in rotated[:anchor]:
            try:
                os.unlink(p)
            except OSError:
                # STOP at the first failure: deleting newer chunks past
                # a surviving older one would punch a mid-log hole that
                # permanently invalidates the clean watermark (its
                # pruned-prefix tolerance requires the missing indices
                # to be a LEADING run); the stuck chunk retries next pass
                break
            pruned += 1
            self._chunk_marker_cache.pop(p, None)
        self._chunks_pruned += pruned
        return pruned

    # -- replay reads ------------------------------------------------------

    def _chunk_payload_lists(self) -> list[tuple[str, list[bytes]]]:
        """(path, payloads) per chunk, oldest→newest (chunk_paths() OS-
        flushes the head under the Group lock before listing)."""
        out = []
        for p in self.group.chunk_paths():
            with open(p, "rb") as f:
                payloads, _bad = scan_frames(f.read())
            # _bad!=None post-repair means damage landed after open (or
            # the head grew mid-read); serve the clean prefix like the
            # repair pass would
            out.append((p, payloads))
        return out

    def lines_after_height(self, height: int) -> list[str] | None:
        """All lines after `#ENDHEIGHT: height`, or None if the marker is
        absent (the autofile Search, consensus/replay.go:107-126).

        Like the legacy Group search, chunks are read lazily newest-first
        and the scan STOPS at the first chunk containing the marker — a
        long multi-chunk WAL costs one chunk read on node start."""
        if self._legacy:
            return self.group.search_lines_after_marker(f"#ENDHEIGHT: {height}")
        marker = f"#ENDHEIGHT: {height}".encode()
        tail: list[str] = []
        for p in reversed(self.group.chunk_paths()):
            with open(p, "rb") as f:
                payloads, _bad = scan_frames(f.read())
            for i in range(len(payloads) - 1, -1, -1):
                if payloads[i] == marker:
                    return [
                        b.decode(errors="replace") for b in payloads[i + 1 :]
                    ] + tail
            tail = [b.decode(errors="replace") for b in payloads] + tail
        return None

    def lines_after_last_marker(self) -> tuple[int, list[str]] | None:
        """(height, lines) after the LAST #ENDHEIGHT marker of any height —
        the repair fallback when the exact boundary was cut from the tail
        (consensus/replay.py). None if no marker survives."""
        lines = self.read_all_lines()
        for i in range(len(lines) - 1, -1, -1):
            if lines[i].startswith("#ENDHEIGHT:"):
                try:
                    h = int(lines[i].split(":", 1)[1].strip())
                except ValueError:
                    continue
                return h, lines[i + 1 :]
        return None

    def read_all_lines(self) -> list[str]:
        """Every record payload as text, format-agnostic (the operator
        replay tool, consensus/replay_file.py)."""
        if self._legacy:
            return self.group.read_all_lines()
        return [
            b.decode(errors="replace")
            for _, payloads in self._chunk_payload_lists()
            for b in payloads
        ]

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._wmtx:
            synced_groups = max(self._fsyncs, 1)
            return {
                "format": 1 if self._legacy else 2,
                "records": self._records,
                "fsyncs": self._fsyncs,
                "pending": self._pending,
                "group_size": self._group_last,
                "group_size_max": self._group_max,
                "group_size_avg": round(self._synced_records / synced_groups, 2),
                "repairs": self._repairs,
                "truncated_bytes": self._truncated_bytes,
                # retention plane: rotated chunks dropped
                # below the retain horizon
                "chunks_pruned": self._chunks_pruned,
                # clean-watermark plane: how much history the
                # last open trusted without re-reading — skipped bytes at 0
                # on a long-lived home means the watermark is not landing
                "scan_skipped_chunks": self._scan_skipped_chunks,
                "scan_skipped_bytes": self._scan_skipped_bytes,
                "flush_interval_s": self._flush_interval_s,
                "sync_every_write": int(self._sync_every),
                # seconds since the last fsync: pending>0 with a growing
                # age means the flusher is stuck, not merely idle
                "sync_age_s": round(time.monotonic() - self._last_sync, 3),
            }


def read_wal_lines(wal_file: str) -> list[str]:
    """Read-only, format-aware view of a WAL's record lines — NO repair,
    no truncation, no backups, no head creation. The operator replay tool
    (consensus/replay_file.py) must never mutate the home it inspects
    (it may be damaged evidence, or a live node's open files); a damaged
    frame ends the readable stream RIGHT THERE, exactly where the node's
    own repair would cut — records in later chunks cannot be ordered
    across the hole, and repair would quarantine them, so the read-only
    view must not splice them in either. A MISSING WAL raises (like the
    open() this replaced): a typo'd --home must not read as an empty
    log."""
    chunks = Group.list_chunks(wal_file)
    if not chunks:
        raise FileNotFoundError(wal_file)
    out: list[str] = []
    for i, p in enumerate(chunks):
        with open(p, "rb") as f:
            buf = f.read()
        if not buf:
            continue
        if buf[:1] in (b"{", b"#"):  # legacy JSON lines
            out.extend(ln.decode(errors="replace") for ln in buf.splitlines())
        else:
            payloads, bad = scan_frames(buf)
            out.extend(b.decode(errors="replace") for b in payloads)
            if bad is not None:
                logger.warning(
                    "read_wal_lines: damaged frame in %s at offset %d; "
                    "stopping (%d later chunk(s) unreadable past the hole)",
                    os.path.basename(p), bad, len(chunks) - i - 1,
                )
                break
    return out


def decode_wal_line(line: str):
    """Parse one WAL line into ('msg_info', msg, peer_id) |
    ('timeout', TimeoutInfo) | ('event', height, round, step) |
    ('endheight', h) (consensus/replay.go:38-94)."""
    line = line.strip()
    if not line:
        return None
    if line.startswith("#ENDHEIGHT:"):
        return ("endheight", int(line.split(":", 1)[1].strip()))
    obj = json.loads(line)
    t = obj["type"]
    if t == "msg_info":
        return ("msg_info", msgs.msg_from_json(obj["msg"]), obj.get("peer_id", ""))
    if t == "timeout":
        return ("timeout", TimeoutInfo.from_json(obj["timeout"]))
    if t == "event":
        return ("event", obj["height"], obj["round"], obj["step"])
    raise ValueError(f"unknown WAL line type {t!r}")
