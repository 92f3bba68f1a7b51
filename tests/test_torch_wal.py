"""The port's consensus WAL (consensus/wal.py) and CRC-32C (libs/crc32c.py):
the cases of tests/test_wal_repair.py (framing, group commit, repair on
open, rotation, retention, the clean watermark) on the port, and crc32c
equal to the JAX package's on RFC 3720's vectors and random buffers.
"""

from __future__ import annotations

import glob
import os
import struct

import pytest

from test_torch_consensus import host_device  # noqa: F401

from tendermint_tpu_torch.consensus.ticker import TimeoutInfo
from tendermint_tpu_torch.consensus.wal import (
    MAGIC,
    WAL,
    WALMessage,
    decode_wal_line,
    scan_frames,
)


def _build_wal(path: str, n: int = 6, chunk_size: int | None = None) -> bytes:
    """A clean v2 WAL with n timeout records + ENDHEIGHT markers; returns
    the head chunk's bytes."""
    w = WAL(path, flush_interval_s=0.01, chunk_size=chunk_size)
    w.start()
    for i in range(n):
        w.save(WALMessage.timeout(TimeoutInfo(1.0 + i, 1 + i, 0, 3)))
        w.write_end_height(i + 1)
    w.stop()
    with open(path, "rb") as f:
        return f.read()


def _corrupt_backups(path: str) -> list[str]:
    return glob.glob(path + "*.corrupt-*")


class TestTornWriteSweep:
    def test_every_byte_offset_recovers(self, tmp_path):
        """Truncate the WAL image at EVERY byte offset; each opens clean,
        serves exactly the record prefix that fully survived, and backs
        up whatever was cut mid-frame."""
        base = str(tmp_path / "src" / "wal")
        raw = _build_wal(base)
        assert raw.startswith(MAGIC) and len(raw) > 200
        expected_all, bad = scan_frames(raw)
        assert bad is None and len(expected_all) >= 13  # seed marker + 12

        seen_prefix_lens = set()
        for cut in range(len(raw) + 1):
            p = str(tmp_path / f"t{cut}" / "wal")
            os.makedirs(os.path.dirname(p))
            with open(p, "wb") as f:
                f.write(raw[:cut])
            w = WAL(p)
            expected, cut_mid_frame = scan_frames(raw[:cut])
            lines = w.read_all_lines()
            assert lines == [b.decode() for b in expected], f"cut={cut}"
            for ln in lines:
                assert decode_wal_line(ln) is not None
            s = w.stats()
            if cut_mid_frame is not None:
                assert s["repairs"] == 1 and s["truncated_bytes"] == cut - cut_mid_frame
                assert _corrupt_backups(p), f"cut={cut}: no backup of the torn tail"
            else:
                assert s["repairs"] == 0
            seen_prefix_lens.add(len(expected))
            w.group.close()
        # the sweep is not vacuous: every record-prefix length occurred
        assert seen_prefix_lens == set(range(len(expected_all) + 1))

    def test_endheight_marker_never_lost_behind_tear(self, tmp_path):
        """A tear strictly after a synced #ENDHEIGHT must keep that marker
        findable — the 'never lose a height past its last synced
        ENDHEIGHT' half of the durability contract."""
        base = str(tmp_path / "src" / "wal")
        raw = _build_wal(base, n=4)
        payloads, _ = scan_frames(raw)
        # byte offset just past each ENDHEIGHT frame
        off = len(MAGIC)
        marker_ends = {}
        for pl in payloads:
            off += 8 + len(pl)
            if pl.startswith(b"#ENDHEIGHT: "):
                marker_ends[int(pl.split(b":")[1].decode())] = off
        assert set(marker_ends) == {0, 1, 2, 3, 4}
        for h, end in marker_ends.items():
            for cut in sorted({end, end + 1, min(end + 5, len(raw))}):
                p = str(tmp_path / f"h{h}c{cut}" / "wal")
                os.makedirs(os.path.dirname(p))
                with open(p, "wb") as f:
                    f.write(raw[:cut])
                w = WAL(p)
                assert w.lines_after_height(h) is not None, (h, cut)
                w.group.close()


class TestCorruptionSchedules:
    def test_bit_flip_truncates_at_flipped_record(self, tmp_path):
        """Flip one bit inside each record's payload region: repair must cut
        AT that record — everything before survives, nothing after does
        (no resync: record order is part of the safety argument)."""
        base = str(tmp_path / "src" / "wal")
        raw = _build_wal(base)
        frames = []
        off = len(MAGIC)
        while off < len(raw):
            _, length = struct.unpack_from(">II", raw, off)
            frames.append((off, 8 + length))
            off += 8 + length
        for k, (foff, flen) in enumerate(frames):
            p = str(tmp_path / f"f{k}" / "wal")
            os.makedirs(os.path.dirname(p))
            img = bytearray(raw)
            img[foff + 8 + (flen - 8) // 2] ^= 0x10  # mid-payload bit flip
            with open(p, "wb") as f:
                f.write(bytes(img))
            w = WAL(p)
            assert len(w.read_all_lines()) == k, f"record {k}"
            assert w.stats()["repairs"] == 1
            w.group.close()

    def test_garbage_suffix_cut_with_zero_record_loss(self, tmp_path):
        base = str(tmp_path / "src" / "wal")
        raw = _build_wal(base)
        n_records = len(scan_frames(raw)[0])
        for k, garbage in enumerate(
            (b"\x00" * 40, b"\xff" * 3, os.urandom(200), b"{json?")
        ):
            p = str(tmp_path / f"g{k}" / "wal")
            os.makedirs(os.path.dirname(p))
            with open(p, "wb") as f:
                f.write(raw + garbage)
            w = WAL(p)
            assert len(w.read_all_lines()) == n_records
            s = w.stats()
            assert s["repairs"] == 1 and s["truncated_bytes"] == len(garbage)
            w.group.close()

    def test_damaged_magic_drops_chunk_not_process(self, tmp_path):
        base = str(tmp_path / "src" / "wal")
        raw = _build_wal(base)
        p = str(tmp_path / "m" / "wal")
        os.makedirs(os.path.dirname(p))
        with open(p, "wb") as f:
            f.write(b"XX" + raw[2:])
        w = WAL(p)  # must not raise
        assert w.read_all_lines() == []
        assert w.stats()["repairs"] == 1
        w.group.close()


class TestRotationBoundary:
    def test_corrupt_middle_chunk_quarantines_later_chunks(
        self, tmp_path, monkeypatch
    ):
        """With a tiny chunk size the log spans several chunks; damage in a
        middle chunk truncates there AND moves every later chunk out of
        the group (ordering past a hole is unprovable).

        Bit rot in a chunk an earlier synced flush covered is outside the
        crash model the clean watermark optimizes for (round 10), so this
        runs under the forensics knob — the full-history scan whose
        quarantine semantics this test pins."""
        monkeypatch.setenv("TENDERMINT_WAL_DEEP_SCAN", "1")
        base = str(tmp_path / "rot" / "wal")
        _build_wal(base, n=12, chunk_size=256)
        from tendermint_tpu_torch.libs.autofile import Group

        chunks = Group.list_chunks(base)
        assert len(chunks) >= 3, "chunk_size=256 must force rotation"
        victim = chunks[1]
        with open(victim, "r+b") as f:
            f.seek(len(MAGIC) + 4)
            b = f.read(1)
            f.seek(len(MAGIC) + 4)
            f.write(bytes([b[0] ^ 0xFF]))
        with open(victim, "rb") as f:
            victim_bytes = f.read()
        _, bad = scan_frames(victim_bytes)
        assert bad is not None
        with open(chunks[0], "rb") as f:
            first_chunk_records = len(scan_frames(f.read())[0])

        w = WAL(base)
        assert w.stats()["repairs"] == 1
        assert len(w.read_all_lines()) == first_chunk_records
        # later chunks left the namespace wholesale, as .corrupt backups;
        # the victim itself stays, truncated to its clean prefix, and a
        # fresh head is recreated on open. One artifact PER file: the
        # damaged tail's backup plus one per quarantined chunk — the
        # head's quarantine name must not clobber the tail backup
        # (its natural name is exactly the tail backup's)
        assert len(Group.list_chunks(base)) == 3
        backups = _corrupt_backups(base)
        assert len(backups) == len(chunks) - 1, backups
        tail_backup = min(backups, key=len)  # "<wal>.corrupt-<stamp>"
        with open(tail_backup, "rb") as f:
            assert f.read() == victim_bytes[bad:], (
                "tail backup clobbered by a quarantined chunk"
            )
        w.group.close()

    def test_torn_tail_in_final_chunk_keeps_earlier_chunks(self, tmp_path):
        base = str(tmp_path / "rot2" / "wal")
        _build_wal(base, n=12, chunk_size=256)
        from tendermint_tpu_torch.libs.autofile import Group

        before = WAL(base)
        n_before = len(before.read_all_lines())
        before.group.close()
        with open(base, "r+b") as f:
            f.truncate(os.path.getsize(base) - 3)
        w = WAL(base)
        lines = w.read_all_lines()
        assert n_before - 1 <= len(lines) < n_before
        assert w.stats()["repairs"] == 1
        w.group.close()

    def test_zero_byte_chunk_is_clean_not_redamaged(self, tmp_path, monkeypatch):
        """A prior repair can truncate a chunk to 0 bytes (damage at its
        magic). Later opens must treat that empty chunk as clean — NOT
        re-flag it and quarantine every newer chunk (which would discard
        freshly fsynced records and #ENDHEIGHTs written since).

        Runs under the forensics knob: the in-place magic destruction is
        historical-chunk rot the clean watermark deliberately skips, and
        the zero-byte-chunk invariant it pins belongs to the full scan."""
        monkeypatch.setenv("TENDERMINT_WAL_DEEP_SCAN", "1")
        base = str(tmp_path / "z" / "wal")
        _build_wal(base, n=12, chunk_size=256)
        from tendermint_tpu_torch.libs.autofile import Group

        chunks = Group.list_chunks(base)
        assert len(chunks) >= 3
        with open(chunks[1], "r+b") as f:  # destroy a middle chunk's magic
            f.seek(0)
            f.write(b"XX")
        w = WAL(base)  # first open: repairs (truncates chunk 1 to 0 bytes)
        assert w.stats()["repairs"] == 1
        w.group.close()
        assert os.path.getsize(chunks[1]) == 0

        # write new durable records after the repair, then reopen twice
        w = WAL(base)
        assert w.stats()["repairs"] == 0, "empty chunk re-flagged as damage"
        w.start()
        w.write_end_height(99)
        w.stop()
        r = WAL(base)
        assert r.stats()["repairs"] == 0
        assert r.lines_after_height(99) == [], "post-repair records lost"
        r.group.close()

    def test_missing_head_after_rotation_crash(self, tmp_path):
        """Crash between os.replace and reopening the head: the group has
        numbered chunks but no head file. Open must serve the chunks and
        recreate the head."""
        base = str(tmp_path / "rot3" / "wal")
        _build_wal(base, n=12, chunk_size=256)
        n_all = len(WAL(base).read_all_lines())
        with open(base, "rb") as f:
            head_records = len(scan_frames(f.read())[0])
        os.unlink(base)
        w = WAL(base)
        assert len(w.read_all_lines()) == n_all - head_records
        assert os.path.exists(base)  # head recreated (with magic)
        w.group.close()


class TestGroupCommit:
    def test_endheight_always_fsynced_others_batched(self, tmp_path):
        w = WAL(str(tmp_path / "wal"), flush_interval_s=60.0)  # no timer help
        w.start()
        for i in range(50):
            w.save(WALMessage.timeout(TimeoutInfo(1.0, 1, 0, 3)))
        s = w.stats()
        assert s["pending"] == 50, "saves must not fsync individually"
        fsyncs_before = s["fsyncs"]
        w.write_end_height(1)
        s = w.stats()
        assert s["pending"] == 0 and s["fsyncs"] == fsyncs_before + 1
        assert s["group_size"] == 51, "one fsync covered the whole group"
        w.stop()

    def test_flusher_bounds_staleness(self, tmp_path):
        import time

        w = WAL(str(tmp_path / "wal"), flush_interval_s=0.03)
        w.start()
        w.save(WALMessage.timeout(TimeoutInfo(1.0, 1, 0, 3)))
        deadline = time.monotonic() + 2.0
        while w.stats()["pending"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert w.stats()["pending"] == 0, "flusher never fsynced the tail"
        w.stop()

    def test_sync_every_write_mode(self, tmp_path):
        w = WAL(str(tmp_path / "wal"), sync_every_write=True)
        w.start()
        base = w.stats()["fsyncs"]
        for _ in range(5):
            w.save(WALMessage.timeout(TimeoutInfo(1.0, 1, 0, 3)))
        assert w.stats()["fsyncs"] == base + 5
        w.stop()

    def test_stop_never_hangs_on_stuck_flusher(self, tmp_path, monkeypatch):
        """A flusher wedged inside os.fsync (dying disk, NFS stall) holds
        _sync_mtx indefinitely; stop() must give up after its timed join
        and skip the final sync instead of blocking shutdown forever on
        the same stuck device."""
        import os as _os
        import threading
        import time

        w = WAL(str(tmp_path / "wal"), flush_interval_s=0.02)
        w.start()  # start/seed fsyncs run with the REAL fsync

        gate = threading.Event()
        entered = threading.Event()

        def stuck_fsync(fd):
            entered.set()
            gate.wait(20)  # the hung-disk image: fsync never returns

        monkeypatch.setattr(_os, "fsync", stuck_fsync)
        try:
            w.save(WALMessage.timeout(TimeoutInfo(1.0, 1, 0, 3)))
            assert entered.wait(2.0), "flusher never reached fsync"
            t0 = time.monotonic()
            w.stop()
            elapsed = time.monotonic() - t0
            # join budget is 2s; anything near gate.wait's 20s means
            # on_stop blocked on the stuck flusher's _sync_mtx
            assert elapsed < 8.0, f"stop() hung {elapsed:.1f}s on stuck flusher"
        finally:
            gate.set()


class TestLegacyCompat:
    LEGACY = (
        '{"time": 1.0, "timeout": {"duration": 1.0, "height": 1, "round": 0,'
        ' "step": 3}, "type": "timeout"}\n'
        "#ENDHEIGHT: 1\n"
        '{"time": 2.0, "timeout": {"duration": 1.0, "height": 2, "round": 0,'
        ' "step": 3}, "type": "timeout"}\n'
    )

    def test_legacy_detected_and_replayable(self, tmp_path):
        p = str(tmp_path / "wal")
        with open(p, "w") as f:
            f.write(self.LEGACY)
        w = WAL(p)
        assert w.stats()["format"] == 1
        lines = w.lines_after_height(1)
        assert lines is not None and len(lines) == 1
        assert decode_wal_line(lines[0])[0] == "timeout"
        assert w.lines_after_last_marker()[0] == 1
        w.group.close()

    def test_legacy_appends_stay_legacy_and_fsync_per_line(self, tmp_path):
        p = str(tmp_path / "wal")
        with open(p, "w") as f:
            f.write(self.LEGACY)
        w = WAL(p)
        w.start()
        base = w.stats()["fsyncs"]
        w.save(WALMessage.timeout(TimeoutInfo(9.0, 2, 0, 3)))
        w.write_end_height(2)
        assert w.stats()["fsyncs"] == base + 2
        w.stop()
        # a reread still sees one consistent legacy log
        r = WAL(p)
        assert r.stats()["format"] == 1
        assert r.lines_after_height(2) == []
        r.group.close()

    def test_fresh_wal_is_v2(self, tmp_path):
        w = WAL(str(tmp_path / "wal"))
        w.start()
        w.stop()
        with open(str(tmp_path / "wal"), "rb") as f:
            assert f.read().startswith(MAGIC)
        r = WAL(str(tmp_path / "wal"))
        assert r.stats()["format"] == 2
        assert r.lines_after_height(0) == []
        r.group.close()


class TestReadOnlyView:
    def test_read_wal_lines_never_mutates_a_damaged_home(self, tmp_path):
        """The operator tool's reader (consensus/replay_file.py) serves the
        clean prefix of a torn WAL WITHOUT repair side effects: no
        truncation, no .corrupt backups, no file creation."""
        from tendermint_tpu_torch.consensus.wal import read_wal_lines

        base = str(tmp_path / "src" / "wal")
        raw = _build_wal(base, n=4)
        p = str(tmp_path / "damaged" / "wal")
        os.makedirs(os.path.dirname(p))
        with open(p, "wb") as f:
            f.write(raw[:-9])  # torn final frame
        dirlist = sorted(os.listdir(os.path.dirname(p)))
        lines = read_wal_lines(p)
        expect, _ = scan_frames(raw[:-9])
        assert lines == [b.decode() for b in expect]
        assert os.path.getsize(p) == len(raw) - 9, "reader truncated the file"
        assert sorted(os.listdir(os.path.dirname(p))) == dirlist, (
            "reader created/renamed files"
        )
        # legacy view too
        lp = str(tmp_path / "legacy" / "wal")
        os.makedirs(os.path.dirname(lp))
        with open(lp, "w") as f:
            f.write("#ENDHEIGHT: 0\n")
        assert read_wal_lines(lp) == ["#ENDHEIGHT: 0"]

    def test_read_wal_lines_missing_wal_raises(self, tmp_path):
        """A typo'd --home must error like the open() this replaced did —
        not read as a legitimately empty log."""
        from tendermint_tpu_torch.consensus.wal import read_wal_lines

        with pytest.raises(FileNotFoundError):
            read_wal_lines(str(tmp_path / "nope" / "wal"))

    def test_read_wal_lines_stops_at_damaged_middle_chunk(self, tmp_path):
        """Damage in a MIDDLE chunk ends the read-only stream right there —
        the node's repair quarantines every later chunk (ordering past a
        hole is unprovable), so the operator tool must not splice later
        chunks into a stream the node itself would never replay."""
        from tendermint_tpu_torch.consensus.wal import read_wal_lines
        from tendermint_tpu_torch.libs.autofile import Group

        base = str(tmp_path / "mid" / "wal")
        _build_wal(base, n=12, chunk_size=256)
        chunks = Group.list_chunks(base)
        assert len(chunks) >= 3
        with open(chunks[0], "rb") as f:
            first_chunk_payloads, bad0 = scan_frames(f.read())
        assert bad0 is None
        with open(chunks[1], "r+b") as f:
            f.seek(len(MAGIC) + 4)
            b = f.read(1)
            f.seek(len(MAGIC) + 4)
            f.write(bytes([b[0] ^ 0xFF]))
        lines = read_wal_lines(base)
        assert lines == [b.decode() for b in first_chunk_payloads], (
            "reader spliced records from beyond the damaged chunk"
        )
        # and still strictly read-only: same chunks, no artifacts
        assert Group.list_chunks(base) == chunks
        assert not _corrupt_backups(base)


class TestSearchEarlyStop:
    def test_v2_marker_search_stops_at_newest_chunk(self, tmp_path):
        """The v2 record search mirrors the legacy Group search's
        newest-first early stop: a marker in the newest chunks means
        older chunk files are never opened on node start."""
        import builtins

        base = str(tmp_path / "wal")
        _build_wal(base, n=12, chunk_size=256)
        from tendermint_tpu_torch.libs.autofile import Group

        w = WAL(base)
        chunks = Group.list_chunks(base)
        assert len(chunks) > 3
        opened = []
        real_open = builtins.open

        def spy(path, *a, **kw):
            opened.append(str(path))
            return real_open(path, *a, **kw)

        builtins.open = spy
        try:
            assert w.lines_after_height(12) == []
        finally:
            builtins.open = real_open
        read_chunks = set(p for p in opened if p in chunks)
        assert read_chunks <= set(chunks[-2:]), "older chunks were scanned"
        w.group.close()


class TestReplayFallback:
    def test_repair_that_eats_boundary_falls_back_to_last_marker(self, tmp_path):
        """Cut the WAL mid-#ENDHEIGHT-frame: the exact boundary search
        misses, but catchup must fall back to the previous surviving
        marker instead of wedging (replay.py round 9)."""
        base = str(tmp_path / "src" / "wal")
        raw = _build_wal(base, n=3)
        # find the LAST endheight frame's start
        last_marker_off = None
        payloads, _ = scan_frames(raw)
        scan_off = len(MAGIC)
        for pl in payloads:
            if pl.startswith(b"#ENDHEIGHT: 3"):
                last_marker_off = scan_off
            scan_off += 8 + len(pl)
        assert last_marker_off is not None
        p = str(tmp_path / "cut" / "wal")
        os.makedirs(os.path.dirname(p))
        with open(p, "wb") as f:
            f.write(raw[: last_marker_off + 5])  # tear inside the marker frame
        w = WAL(p)
        assert w.lines_after_height(3) is None
        h, lines = w.lines_after_last_marker()
        assert h == 2
        assert all(decode_wal_line(ln) for ln in lines)
        w.group.close()


class TestWriterInvariants:
    def test_oversize_record_rejected_at_write_not_read(self, tmp_path):
        """A record beyond MAX_RECORD_BYTES must fail LOUDLY at the
        producer: framing it would fsync fine and then read back as
        corruption on the next open, where repair would truncate there
        and quarantine everything after — retroactive data loss."""
        from tendermint_tpu_torch.consensus.wal import MAX_RECORD_BYTES, _frame

        with pytest.raises(ValueError):
            _frame(b"x" * (MAX_RECORD_BYTES + 1))
        with pytest.raises(ValueError):
            _frame(b"")  # zero-length frames read as damage too
        base = str(tmp_path / "w" / "wal")
        w = WAL(base, flush_interval_s=0.01)
        w.start()
        with pytest.raises(ValueError):
            w.save({"type": "event", "height": 1, "round": 0,
                    "step": "x" * (MAX_RECORD_BYTES + 1)})
        # the WAL stays usable and clean after the refusal
        w.save(WALMessage.timeout(TimeoutInfo(1.0, 1, 0, 3)))
        w.write_end_height(1)
        w.stop()
        with open(base, "rb") as f:
            _, bad = scan_frames(f.read())
        assert bad is None

    def test_failed_fsync_keeps_dir_fsync_obligation(self, tmp_path, monkeypatch):
        """If the data fsync of the FIRST synced flush after head creation
        fails, the pending directory-fsync obligation must survive —
        otherwise every later flush skips the dir fsync and a power
        failure can drop the whole head file (with its fsynced records)."""
        import os as _os

        from tendermint_tpu_torch.libs.autofile import Group

        base = str(tmp_path / "g" / "wal")
        g = Group(base, chunk_size=1 << 20)
        assert g._dir_dirty is True
        g.write_line("rec1")
        real_fsync = _os.fsync

        def boom(fd):
            raise OSError(5, "injected EIO")

        monkeypatch.setattr(_os, "fsync", boom)
        with pytest.raises(OSError):
            g.flush(sync=True)
        assert g._dir_dirty is True, (
            "failed fsync consumed the directory-fsync obligation"
        )
        monkeypatch.setattr(_os, "fsync", real_fsync)
        g.flush(sync=True)
        assert g._dir_dirty is False
        g.close()

    def test_pathological_knobs_clamped_not_fatal(self, tmp_path):
        """Range clamps share the parse's never-kill-startup contract:
        flush_interval<=0 would busy-spin the flusher, a chunk bound at or
        below the magic would rotate (file + fsync) on every record."""
        base = str(tmp_path / "k" / "wal")
        w = WAL(base, flush_interval_s=0.0, chunk_size=0)
        assert w._flush_interval_s > 0
        assert w.group._chunk_size >= 64
        w.start()
        for i in range(5):
            w.save(WALMessage.timeout(TimeoutInfo(1.0, 1 + i, 0, 3)))
        w.write_end_height(1)
        w.stop()
        w2 = WAL(base)
        assert len(w2.read_all_lines()) == 7 and w2.stats()["repairs"] == 0
        w2.group.close()

    def test_nonfinite_flush_interval_clamped(self, tmp_path):
        """inf would kill the flusher with an uncaught OverflowError in
        Event.wait (records then durable only at ENDHEIGHT, silently);
        nan passes a naive <=0 check and busy-spins."""
        for bad in (float("inf"), float("nan"), -1.0):
            w = WAL(str(tmp_path / repr(bad) / "wal"), flush_interval_s=bad)
            assert 0 < w._flush_interval_s <= 3600.0, bad
            w.group.close()


class TestLegacyDetection:
    def test_damaged_first_byte_does_not_misread_legacy_as_v2(self, tmp_path):
        """One corrupt byte at offset 0 of a legacy WAL's OLDEST chunk must
        not flip detection to v2 — the v2 repair MUTATES (truncates +
        quarantines every later chunk), wholesale-destroying an otherwise
        replayable legacy log. Any clean chunk head decides the format."""
        base = str(tmp_path / "leg" / "wal")
        os.makedirs(os.path.dirname(base))
        # multi-chunk legacy home: oldest rotated chunk + live head
        with open(base + ".000", "w") as f:
            f.write("#ENDHEIGHT: 0\n")
            f.write('{"time": 1.0, "type": "timeout", "timeout": '
                    '{"duration": 0.1, "height": 1, "round": 0, "step": 3}}\n')
        with open(base, "w") as f:
            f.write("#ENDHEIGHT: 1\n")
        with open(base + ".000", "r+b") as f:
            f.write(b"\xf3")  # damage exactly the first byte
        w = WAL(base)
        assert w.stats()["format"] == 1, "legacy log misdetected as v2"
        assert w.stats()["repairs"] == 0, "mutating repair ran on legacy"
        assert w.lines_after_height(1) == []
        w.group.close()
        # and the chunks are untouched on disk
        assert os.path.getsize(base + ".000") > 1
        assert not _corrupt_backups(base)

    def test_all_chunk_heads_damaged_defaults_to_v2_with_backup(self, tmp_path):
        """No readable signature anywhere: fall to v2, whose repair backs
        every byte up before cutting — nothing is destroyed."""
        base = str(tmp_path / "dmg" / "wal")
        os.makedirs(os.path.dirname(base))
        with open(base, "wb") as f:
            f.write(b"\xf3 unreadable")
        w = WAL(base)
        assert w.stats()["format"] == 2 and w.stats()["repairs"] == 1
        assert _corrupt_backups(base), "damaged bytes must survive as backup"
        w.group.close()


class TestCleanWatermark:
    """Round 10: the `<wal>.clean` sidecar bounds the open-time deep scan
    to bytes written since the last synced flush (ROADMAP's O(total
    history) open item). The watermark may only ever TRAIL durability —
    every test here checks either the skip or the fallback to the full
    scan when the sidecar and the files disagree."""

    def test_clean_close_skips_covered_history(self, tmp_path):
        base = str(tmp_path / "wm" / "wal")
        _build_wal(base, n=12, chunk_size=256)
        from tendermint_tpu_torch.libs.autofile import Group

        n_rotated = len(Group.list_chunks(base)) - 1
        assert n_rotated >= 2
        assert os.path.exists(base + ".clean")
        w = WAL(base)
        s = w.stats()
        assert s["repairs"] == 0
        assert s["scan_skipped_chunks"] == n_rotated
        assert s["scan_skipped_bytes"] > 0
        # the skipped history still serves reads and the marker search
        assert w.lines_after_height(12) == []
        w.group.close()

    def test_skipped_open_counts_records_like_a_full_scan(self, tmp_path):
        base = str(tmp_path / "cnt" / "wal")
        _build_wal(base, n=9, chunk_size=256)
        fast = WAL(base)
        fast.group.close()
        os.environ["TENDERMINT_WAL_DEEP_SCAN"] = "1"
        try:
            full = WAL(base)
            full.group.close()
        finally:
            del os.environ["TENDERMINT_WAL_DEEP_SCAN"]
        assert full.stats()["scan_skipped_chunks"] == 0
        assert fast._records_at_open == full._records_at_open

    def test_tear_past_watermark_still_repaired(self, tmp_path):
        """The crash window the watermark leaves open is bytes after the
        last synced flush — a tear there must still be found and cut,
        WITHOUT rescanning the covered chunks."""
        base = str(tmp_path / "tear" / "wal")
        _build_wal(base, n=12, chunk_size=256)
        from tendermint_tpu_torch.libs.autofile import Group

        n_rotated = len(Group.list_chunks(base)) - 1
        before = WAL(base)
        n_before = len(before.read_all_lines())
        before.group.close()
        with open(base, "ab") as f:
            f.write(b"\x00\x00\x00\x00\x00\x00\x00\x00torn post-flush bytes")
        w = WAL(base)
        s = w.stats()
        assert s["repairs"] == 1 and s["truncated_bytes"] > 0
        assert s["scan_skipped_chunks"] == n_rotated, "repair rescanned history"
        assert len(w.read_all_lines()) == n_before
        assert _corrupt_backups(base)
        # repair dropped the sidecar: the next open deep-scans until a
        # synced flush rebuilds it
        assert not os.path.exists(base + ".clean")
        w.group.close()

    def test_watermark_past_actual_size_falls_back_to_full_scan(self, tmp_path):
        """Fsynced bytes that VANISH (fs rollback, hand-edit) invalidate
        the sidecar — the open must notice and deep-scan everything."""
        base = str(tmp_path / "lost" / "wal")
        _build_wal(base, n=12, chunk_size=256)
        with open(base, "r+b") as f:
            f.truncate(max(os.path.getsize(base) - 3, 0))
        w = WAL(base)
        s = w.stats()
        assert s["scan_skipped_chunks"] == 0 and s["scan_skipped_bytes"] == 0
        assert s["repairs"] == 1  # the torn tail record was cut
        w.group.close()

    def test_garbage_sidecar_is_ignored_not_fatal(self, tmp_path):
        base = str(tmp_path / "junk" / "wal")
        _build_wal(base, n=6)
        for junk in (b"", b"not json", b'{"chunk_index": "x"}',
                     b'{"chunk_index": -1, "offset": 8, "records": 1}'):
            with open(base + ".clean", "wb") as f:
                f.write(junk)
            w = WAL(base)
            s = w.stats()
            assert s["repairs"] == 0
            assert s["scan_skipped_bytes"] == 0, junk
            w.group.close()

    def test_mid_run_crash_image_keeps_rotated_chunks_skipped(self, tmp_path):
        """Without a clean stop (the crash case) the sidecar persisted at
        the last rotation crossing still covers the rotated history; only
        the newer bytes deep-scan on restart."""
        base = str(tmp_path / "crash" / "wal")
        w = WAL(base, flush_interval_s=60.0, chunk_size=256)
        w.start()
        for i in range(12):
            w.save(WALMessage.timeout(TimeoutInfo(1.0 + i, 1 + i, 0, 3)))
            w.write_end_height(i + 1)
        n_records = len(w.read_all_lines())
        w.group.close()  # no stop(): simulates a crash
        assert os.path.exists(base + ".clean")
        r = WAL(base)
        s = r.stats()
        assert s["repairs"] == 0
        assert s["scan_skipped_chunks"] >= 1
        assert r._records_at_open == n_records
        r.group.close()


# -- crc32c against the JAX package's -----------------------------------------


# RFC 3720 appendix B.4's CRC-32C vectors (the iSCSI digests), beside the
# canonical check value
RFC3720_VECTORS = [
    (b"\x00" * 32, 0x8A9136AA),
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C),
    (b"123456789", 0xE3069283),
    (b"", 0x00000000),
]


@pytest.mark.parametrize("data,want", RFC3720_VECTORS, ids=lambda x: None)
def test_crc32c_rfc3720_vectors_equal_jax(data, want):
    from tendermint_tpu.libs.crc32c import crc32c as jcrc
    from tendermint_tpu_torch.libs.crc32c import crc32c

    assert crc32c(data) == jcrc(data) == want


def test_crc32c_random_buffers_equal_jax_and_table_fallback():
    """Random buffers of ragged lengths: the port's crc32c equals the JAX
    package's, and the port's pure-Python table (the path taken without
    the native wheel) equals both."""
    import numpy as np

    from tendermint_tpu.libs.crc32c import crc32c as jcrc
    from tendermint_tpu_torch.libs import crc32c as mod

    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)

    def by_table(data: bytes) -> int:
        crc = 0xFFFFFFFF
        for b in data:
            crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF

    rng = np.random.default_rng(3720)
    for n in [1, 2, 3, 7, 8, 63, 64, 65, 1000, 4097]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert mod.crc32c(data) == jcrc(data) == by_table(data)


@pytest.mark.parametrize("n", [4095, 4096, 4097, 65_548, 100_003, 1 << 20])
def test_crc32c_segmented_fallback_equals_jax(n):
    """The fallback's segmented path (buffers of SEGMENT_MIN bytes or more,
    a state-sync chunk among them) equals the JAX package's crc32c on
    random buffers around the cut and at chunk sizes."""
    import numpy as np

    from tendermint_tpu.libs.crc32c import crc32c as jcrc
    from tendermint_tpu_torch.libs import crc32c as mod

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert mod.crc32c_fallback(data) == jcrc(data) == mod.crc32c(data)
