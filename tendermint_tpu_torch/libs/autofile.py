"""Rotating append-only file group with reverse marker search — equivalent of
tmlibs/autofile (Group + Search), the storage layer of the consensus WAL
(consensus/wal.go:43-104) and mempool WAL (mempool/mempool.go:111-124).

Semantics kept from the reference:
- append lines to "head"; rotate to numbered chunks (path.000, path.001, ...)
  when the head exceeds a size limit;
- `search_for_end_height` scans backwards across chunks for the last
  occurrence of a marker line (the "#ENDHEIGHT: h" convention,
  consensus/replay.go:107-126) and returns a reader positioned just after it.

For the framed WAL (consensus/wal.py v2 format, docs/crash-recovery.md):
- `write_bytes` appends raw bytes (a CRC-framed record) with no newline;
  rotation only ever happens in `flush()`, i.e. BETWEEN writes, so a
  record never spans a chunk boundary — the repair scan relies on this.
- `header`: bytes stamped at offset 0 of every freshly created chunk
  (the WAL's format magic), including each new head after a rotation.
- `crash_hooks=True` routes writes and rotation through state/fail.py's
  torture points (FAIL_TEST_MODE=torn_write / rotate_crash) so a node
  subprocess can be killed at any byte offset of the append stream.  The
  env gate is checked here so un-armed processes never even import fail.
"""

from __future__ import annotations

import os
import threading


class Group:
    def __init__(
        self,
        head_path: str,
        chunk_size: int = 10 * 1024 * 1024,
        header: bytes = b"",
        crash_hooks: bool = False,
    ):
        self._head_path = head_path
        self._chunk_size = chunk_size
        self._header = header
        self._crash_hooks = crash_hooks
        self._mtx = threading.RLock()
        os.makedirs(os.path.dirname(head_path) or ".", exist_ok=True)
        self._head = open(head_path, "ab")
        # the head's directory entry may be brand new; the first synced
        # flush must also fsync the directory or a power failure can drop
        # the file (and everything fsynced into it) wholesale
        self._dir_dirty = True
        if header and self._head.tell() == 0:
            self._write_raw(header)
            self._head.flush()

    # -- writing -----------------------------------------------------------

    def _write_raw(self, data: bytes) -> None:
        if self._crash_hooks and os.environ.get("FAIL_TEST_MODE"):
            from tendermint_tpu_torch.state import fail

            fail.wal_write(self._head, data)
        else:
            self._head.write(data)

    def write_bytes(self, data: bytes) -> None:
        """Append raw bytes to the head (no newline framing)."""
        with self._mtx:
            self._write_raw(data)

    def write_line(self, line: str) -> None:
        self.write_bytes(line.encode() + b"\n")

    def flush(self, sync: bool = False) -> None:
        fd = None
        dir_dirty = False
        with self._mtx:
            self._head.flush()
            if sync:
                # fsync OUTSIDE the lock: a concurrent writer (the
                # consensus receive hot path) must never stall behind the
                # flusher's disk round trip. dup() pins the open file so a
                # concurrent rotation closing self._head can't invalidate
                # the descriptor (a rotated-out chunk was already fsynced
                # by _rotate, so syncing the stale dup stays correct).
                # Bytes appended after the dup simply ride the next sync —
                # the WAL's group accounting already assumes that.
                fd = os.dup(self._head.fileno())
                dir_dirty, self._dir_dirty = self._dir_dirty, False
            if self._head.tell() >= self._chunk_size:
                self._rotate()
        if fd is not None:
            try:
                os.fsync(fd)
            except BaseException:
                # the obligation was consumed under the lock but never met —
                # put it back, or every later synced flush would skip the
                # directory fsync and a power failure could drop the head
                # file (with its fsynced records) wholesale
                if dir_dirty:
                    with self._mtx:
                        self._dir_dirty = True
                raise
            finally:
                os.close(fd)
            if dir_dirty:
                # file data first, then its directory entry — the head was
                # created since the last synced flush
                self._fsync_dir()

    def _fsync_dir(self) -> None:
        """fsync the chunk directory: renames (rotation) and file creation
        are durable only once the directory entry itself is journaled."""
        d = os.path.dirname(self._head_path) or "."
        try:
            dfd = os.open(d, os.O_RDONLY)
        except OSError:  # pragma: no cover - platform without dir-open
            return
        try:
            os.fsync(dfd)
        except OSError:  # pragma: no cover - fs without dir fsync
            pass
        finally:
            os.close(dfd)

    def _rotate(self) -> None:
        # the chunk being rotated out will never be written again, so make
        # it durable NOW: without this fsync a group-commit caller's later
        # sync() only covers the NEW head fd, and a power failure could
        # tear the rotated chunk's tail long after wal_pending read 0 —
        # quarantining everything after it, including fsynced #ENDHEIGHTs
        self._head.flush()
        os.fsync(self._head.fileno())
        hooked = self._crash_hooks and os.environ.get("FAIL_TEST_MODE")
        if hooked:
            from tendermint_tpu_torch.state import fail

            fail.rotate_point("pre")
        self._head.close()
        idx = self._max_index() + 1
        os.replace(self._head_path, f"{self._head_path}.{idx:03d}")
        if hooked:
            from tendermint_tpu_torch.state import fail

            fail.rotate_point("post")
        self._head = open(self._head_path, "ab")
        # the rename and the fresh head are directory mutations: the next
        # synced flush must journal the directory before claiming durability
        # (a lost rename still leaves the fsynced data under the OLD name,
        # so no synced record can vanish either way)
        self._dir_dirty = True
        if self._header and self._head.tell() == 0:
            self._write_raw(self._header)
            self._head.flush()

    def _max_index(self) -> int:
        indices = Group._chunk_indices(self._head_path)
        return indices[-1] if indices else -1

    def position(self) -> tuple[int, int]:
        """(index the head will take when it rotates, OS-flushed head
        size) — the clean-watermark coordinate (consensus/wal.py, round
        10). Captured under the append lock, so the offset always lands
        on a record boundary: writers append whole frames and rotation
        only happens between writes."""
        with self._mtx:
            self._head.flush()
            return self._max_index() + 1, self._head.tell()

    def close(self) -> None:
        with self._mtx:
            self._head.flush()
            self._head.close()

    # -- reading -----------------------------------------------------------

    @staticmethod
    def _chunk_indices(head_path: str) -> list[int]:
        """Numeric suffixes of the rotated chunk files, ascending — the ONE
        place the `<head>.NNN` naming scheme is parsed."""
        d = os.path.dirname(head_path) or "."
        base = os.path.basename(head_path)
        indices = []
        try:
            names = os.listdir(d)
        except FileNotFoundError:
            return []
        for fn in names:
            if fn.startswith(base + "."):
                suffix = fn[len(base) + 1 :]
                if suffix.isdigit():
                    indices.append(int(suffix))
        return sorted(indices)

    @staticmethod
    def list_chunks(head_path: str) -> list[str]:
        """Existing chunk files oldest→newest, head last — usable before a
        Group is constructed (the WAL's repair pass runs pre-open)."""
        paths = [f"{head_path}.{i:03d}" for i in Group._chunk_indices(head_path)]
        if os.path.exists(head_path):
            paths.append(head_path)
        return paths

    def _chunk_paths(self) -> list[str]:
        """All chunk files oldest→newest, head last."""
        return Group.list_chunks(self._head_path)

    def chunk_paths(self) -> list[str]:
        with self._mtx:
            self._head.flush()
            return self._chunk_paths()

    def read_all_lines(self) -> list[str]:
        with self._mtx:
            self._head.flush()
            lines: list[str] = []
            for p in self._chunk_paths():
                with open(p, "rb") as f:
                    for raw in f.read().splitlines():
                        lines.append(raw.decode(errors="replace"))
            return lines

    def search_lines_after_marker(self, marker: str) -> list[str] | None:
        """Lines strictly after the LAST line equal to `marker`; None if the
        marker never occurs (the caller then treats the whole log as fresh,
        matching autofile.Group.Search miss behavior).

        Scans chunks newest-to-oldest and stops at the first chunk containing
        the marker, so a long WAL only costs one chunk read in the common
        case (the reference's reverse Search, consensus/replay.go:107-126).
        tests/test_libs.py holds this to parity with a front-to-back scan.
        """
        with self._mtx:
            self._head.flush()
            tail: list[str] = []
            for p in reversed(self._chunk_paths()):
                with open(p, "rb") as f:
                    lines = [ln.decode(errors="replace") for ln in f.read().splitlines()]
                for i in range(len(lines) - 1, -1, -1):
                    if lines[i] == marker:
                        return lines[i + 1 :] + tail
                tail = lines + tail
            return None
