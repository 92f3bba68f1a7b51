"""The port's runtime primitives (libs/clist, libs/events, libs/db,
libs/autofile) against the JAX package's, on the same inputs.

The cases of tests/test_libs.py (TestCList, TestEvents, TestDB,
TestAutofile, TestSqliteDB) run through each package, and what they
observe is equal: list contents, delivered events, DB contents, the raw
bytes of FileDB journals and autofile chunks, and the errors raised.
Beside them: stores and WAL groups written by one package open in the
other.
"""

from __future__ import annotations

import builtins
import importlib
import os
import pathlib
import random
import stat
import sys
import threading
import time
import types
from unittest import mock

import pytest


def _pkg(root: str) -> types.SimpleNamespace:
    db = importlib.import_module(f"{root}.libs.db")
    events = importlib.import_module(f"{root}.libs.events")
    return types.SimpleNamespace(
        root=root,
        CList=importlib.import_module(f"{root}.libs.clist").CList,
        EventSwitch=events.EventSwitch,
        EventCache=events.EventCache,
        MemDB=db.MemDB,
        FileDB=db.FileDB,
        SqliteDB=db.SqliteDB,
        db_provider=db.db_provider,
        Group=importlib.import_module(f"{root}.libs.autofile").Group,
    )


PORT = _pkg("tendermint_tpu_torch")
JAX = _pkg("tendermint_tpu")


def both(body, tmp_path=None):
    """Run `body(pkg, dir)` through the port and the JAX package, each in
    a directory of its own; what each observes must be equal. Returns the
    port's observation."""
    def run(p):
        if tmp_path is None:
            return body(p, None)
        d = tmp_path / p.root
        d.mkdir()
        return body(p, d)

    got = run(PORT)
    assert got == run(JAX)
    return got


def _files(d: pathlib.Path) -> dict[str, bytes]:
    """Every file under `d`, by name relative to it, with its bytes."""
    return {
        str(f.relative_to(d)): f.read_bytes() for f in sorted(d.rglob("*")) if f.is_file()
    }


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the observation is the error
        return type(e).__name__, str(e)
    return None


class TestCList:
    def test_push_iterate(self):
        def body(p, _d):
            cl = p.CList()
            els = [cl.push_back(i) for i in range(5)]
            seen = [[e.value for e in cl], len(cl)]
            cl.remove(els[2])
            # a removed element still navigates forward
            return seen + [[e.value for e in cl], len(cl), els[2].next().value,
                           els[2].removed, cl.remove(els[2])]

        assert both(body) == [[0, 1, 2, 3, 4], 5, [0, 1, 3, 4], 4, 3, True, 2]

    def test_front_wait_blocks_until_push(self):
        def body(p, _d):
            cl = p.CList()
            got = []

            def consumer():
                el = cl.front_wait(timeout=2.0)
                got.append(el.value if el else None)

            t = threading.Thread(target=consumer)
            t.start()
            time.sleep(0.05)
            cl.push_back("tx")
            t.join()
            return got

        assert both(body) == ["tx"]

    def test_next_wait(self):
        def body(p, _d):
            cl = p.CList()
            el = cl.push_back(1)
            t = threading.Thread(target=lambda: (time.sleep(0.05), cl.push_back(2)))
            t.start()
            nxt = el.next_wait(timeout=2.0)
            t.join()
            return nxt.value

        assert both(body) == 2


class TestEvents:
    def test_fire_and_remove(self):
        def body(p, _d):
            sw = p.EventSwitch()
            got = []
            sw.add_listener_for_event("l1", "ev", lambda d: got.append(("l1", d)))
            sw.add_listener_for_event("l2", "ev", lambda d: got.append(("l2", d)))
            sw.fire_event("ev", 1)
            first = sorted(got)
            sw.remove_listener("l1")
            got.clear()
            sw.fire_event("ev", 2)
            sw.remove_listener_for_event("ev", "l2")
            sw.fire_event("ev", 3)
            return first, got, sw._cells, sw._listeners

        assert both(body) == ([("l1", 1), ("l2", 1)], [("l2", 2)], {}, {})

    def test_cache_flush_order(self):
        def body(p, _d):
            sw = p.EventSwitch()
            got = []
            sw.add_listener_for_event("l", "a", lambda d: got.append(("a", d)))
            sw.add_listener_for_event("l", "b", lambda d: got.append(("b", d)))
            cache = p.EventCache(sw)
            cache.fire_event("a", 1)
            cache.fire_event("b", 2)
            before = list(got)
            cache.flush()
            once = list(got)
            cache.flush()
            return before, once, got

        assert both(body) == ([], [("a", 1), ("b", 2)], [("a", 1), ("b", 2)])


class TestDB:
    def test_memdb(self):
        def body(p, _d):
            db = p.MemDB()
            db.set(b"k1", b"v1")
            db.set(b"k2", b"v2")
            out = [db.get(b"k1"), db.get(b"missing")]
            db.delete(b"k1")
            return out + [db.has(b"k1"), list(db.iterate_prefix(b"k")), len(db)]

        assert both(body) == [b"v1", None, False, [(b"k2", b"v2")], 1]

    def test_filedb_persistence(self, tmp_path):
        def body(p, d):
            path = str(d / "test.db")
            db = p.FileDB(path)
            db.set(b"a", b"1")
            db.set_sync(b"b", b"2")
            db.delete(b"a")
            db.close()
            db2 = p.FileDB(path)
            out = [db2.get(b"a"), db2.get(b"b")]
            db2.close()
            return out, _files(d)

        got, files = both(body, tmp_path)
        assert got == [None, b"2"] and list(files) == ["test.db"]

    def test_filedb_torn_tail(self, tmp_path):
        def body(p, d):
            path = str(d / "torn.db")
            db = p.FileDB(path)
            db.set_sync(b"good", b"val")
            db.close()
            with open(path, "ab") as f:
                f.write(b"\x01\x05\x00\x00")  # truncated record
            db2 = p.FileDB(path)
            out = [db2.get(b"good")]
            # writes after torn-tail recovery survive another restart
            db2.set_sync(b"newkey", b"newval")
            db2.close()
            db3 = p.FileDB(path)
            out += [db3.get(b"newkey"), db3.get(b"good"), len(db3._index)]
            db3.close()
            return out, _files(d)

        got, _ = both(body, tmp_path)
        assert got == [b"val", b"newval", b"val", 2]

    def test_filedb_compaction(self, tmp_path):
        def body(p, d):
            path = str(d / "compact.db")
            db = p.FileDB(path, compact_threshold=2000)
            for i in range(100):
                db.set(b"key", str(i).encode() * 10)
            compactions = db._compactions
            db.close()
            db2 = p.FileDB(path)
            out = [os.path.getsize(path) < 2000, db2.get(b"key"), compactions]
            db2.close()
            return out, _files(d)

        got, _ = both(body, tmp_path)
        assert got[:2] == [True, b"99" * 10] and got[2] > 0

    def test_filedb_reads_after_compaction_and_deletes(self, tmp_path):
        """Offsets survive compaction rewriting the journal, deletes
        persist, and gets read through live appends."""

        def body(p, d):
            path = str(d / "offsets.db")
            db = p.FileDB(path, compact_threshold=1500)
            for i in range(60):
                db.set(b"k%03d" % i, b"v%03d" % i * 9)
            for i in range(0, 60, 3):
                db.delete(b"k%03d" % i)
            db.set(b"k001", b"rewritten")
            reads = [db.get(b"k%03d" % i) for i in range(60)]
            items = dict(db.iterate_prefix(b"k"))
            compactions = db._compactions
            db.close()
            db2 = p.FileDB(path)
            after = [db2.get(b"k001"), db2.get(b"k003"), db2.get(b"k002")]
            db2.close()
            return reads, items, compactions, after, _files(d)

        reads, items, compactions, after, _ = both(body, tmp_path)
        for i in range(60):
            want = None if i % 3 == 0 else b"rewritten" if i == 1 else b"v%03d" % i * 9
            assert reads[i] == want, i
        assert compactions > 0
        assert items[b"k001"] == b"rewritten" and b"k000" not in items
        assert after == [b"rewritten", None, b"v002" * 9]

    def test_filedb_memory_is_index_only(self, tmp_path):
        """The in-memory footprint is the key index, not the values."""
        big = os.urandom(64 * 1024)

        def body(p, d):
            db = p.FileDB(str(d / "big.db"))
            for i in range(16):
                db.set(b"blk%05d" % i, big)
            index_bytes = sys.getsizeof(db._index) + sum(
                sys.getsizeof(k) + sys.getsizeof(v) for k, v in db._index.items()
            )
            out = [index_bytes < 16 * 1024, db.get(b"blk00007") == big,
                   sorted(db._index.items())]
            db.close()
            return out

        assert both(body, tmp_path)[:2] == [True, True]


class TestAutofile:
    def test_write_and_search(self, tmp_path):
        def body(p, d):
            g = p.Group(str(d / "wal"))
            for line in ("msg1", "#ENDHEIGHT: 1", "msg2", "msg3"):
                g.write_line(line)
            g.flush()
            out = [g.search_lines_after_marker("#ENDHEIGHT: 1"),
                   g.search_lines_after_marker("#ENDHEIGHT: 99")]
            g.close()
            return out, _files(d)

        got, _ = both(body, tmp_path)
        assert got == [["msg2", "msg3"], None]

    def test_rotation(self, tmp_path):
        def body(p, d):
            g = p.Group(str(d / "wal"), chunk_size=100)
            for i in range(50):
                g.write_line(f"line-{i:04d}")
                g.flush()
            lines = g.read_all_lines()
            # the marker search spans chunks
            g.write_line("#M")
            g.write_line("after")
            g.flush()
            out = [lines, g.search_lines_after_marker("#M"), g.position()]
            g.close()
            return out, _files(d)

        (lines, after, _pos), files = both(body, tmp_path)
        assert lines == [f"line-{i:04d}" for i in range(50)]
        assert after == ["after"] and len(files) > 2

    def test_reopen_appends(self, tmp_path):
        def body(p, d):
            path = str(d / "wal")
            g = p.Group(path)
            g.write_line("first")
            g.close()
            g2 = p.Group(path)
            g2.write_line("second")
            g2.flush()
            out = g2.read_all_lines()
            g2.close()
            return out, _files(d)

        assert both(body, tmp_path)[0] == ["first", "second"]

    def test_marker_search_parity_with_full_scan(self, tmp_path):
        """The newest-first early-stop search agrees with a front-to-back
        scan over every chunk, for every marker position across rotated
        multi-chunk groups."""

        def full_scan(g, marker: str):
            lines = g.read_all_lines()
            best = None
            for i, ln in enumerate(lines):
                if ln == marker:
                    best = i
            return None if best is None else lines[best + 1:]

        def body(p, d):
            rng = random.Random(9)
            out = []
            for case in range(6):
                g = p.Group(str(d / f"w{case}"), chunk_size=64)
                markers = [f"#ENDHEIGHT: {h}" for h in range(4)]
                for i in range(rng.randrange(5, 60)):
                    if rng.random() < 0.3:
                        g.write_line(markers[rng.randrange(4)])
                    else:
                        g.write_line(f"case{case}-line-{i}")
                    g.flush()
                for marker in markers + ["#ENDHEIGHT: 99"]:
                    found = g.search_lines_after_marker(marker)
                    assert found == full_scan(g, marker), (case, marker)
                    out.append(found)
                g.close()
            return out, _files(d)

        both(body, tmp_path)

    def test_marker_search_stops_at_newest_chunk(self, tmp_path):
        """A marker in the newest chunk means older chunks are never
        opened."""

        def body(p, d):
            g = p.Group(str(d / "wal"), chunk_size=64)
            for i in range(30):
                g.write_line(f"old-{i}")
                g.flush()
            g.write_line("#M")
            g.write_line("after")
            g.flush()
            chunks = g.chunk_paths()
            assert len(chunks) > 2
            opened = []
            real_open = builtins.open

            def spy(path, *a, **kw):
                opened.append(str(path))
                return real_open(path, *a, **kw)

            builtins.open = spy
            try:
                found = g.search_lines_after_marker("#M")
            finally:
                builtins.open = real_open
            read_chunks = {p_ for p_ in opened if p_ in chunks}
            assert read_chunks <= set(chunks[-2:]), "older chunks were scanned"
            g.close()
            return found, [os.path.basename(c) for c in chunks]

        assert both(body, tmp_path)[0] == ["after"]

    def test_synced_flush_never_blocks_concurrent_appends(self, tmp_path):
        """flush(sync=True) runs the fsync outside the append lock."""

        def body(p, d):
            g = p.Group(str(d / "wal"))
            g.write_line("seed")
            entered, release, done = threading.Event(), threading.Event(), threading.Event()
            real_fsync = os.fsync

            def slow_fsync(fd):
                entered.set()
                assert release.wait(5)
                return real_fsync(fd)

            with mock.patch(f"{p.root}.libs.autofile.os.fsync", slow_fsync):
                syncer = threading.Thread(target=g.flush, kwargs={"sync": True})
                syncer.start()
                assert entered.wait(5)

                def append():
                    g.write_line("hot-path")
                    g.flush()
                    done.set()

                appender = threading.Thread(target=append)
                appender.start()
                stalled = not done.wait(2)
                release.set()
                syncer.join(5)
                appender.join(5)
            g.close()
            return stalled, _files(d)

        stalled, files = both(body, tmp_path)
        assert not stalled, "append stalled behind the synced flush's fsync"
        assert files == {"wal": b"seed\nhot-path\n"}

    def test_sync_journals_directory_after_creation_and_rotation(self, tmp_path):
        """The next synced flush after a head's creation or a rotation
        fsyncs the directory; an idle synced flush does not."""

        def body(p, d):
            synced_dirs = []
            real_fsync = os.fsync
            seen = []

            def spy(fd):
                if stat.S_ISDIR(os.fstat(fd).st_mode):
                    synced_dirs.append(fd)
                return real_fsync(fd)

            with mock.patch(f"{p.root}.libs.autofile.os.fsync", spy):
                g = p.Group(str(d / "wal"), chunk_size=32)
                g.write_line("a")
                g.flush(sync=True)
                seen.append(bool(synced_dirs))
                synced_dirs.clear()
                g.flush(sync=True)
                seen.append(bool(synced_dirs))
                for i in range(6):
                    g.write_line(f"row-{i}")
                    g.flush()  # rotates (chunk_size=32)
                seen.append(len(g.chunk_paths()) > 1)
                g.flush(sync=True)
                seen.append(bool(synced_dirs))
                g.close()
            return seen, _files(d)

        assert both(body, tmp_path)[0] == [True, False, True, True]

    def test_write_bytes_and_chunk_header(self, tmp_path):
        """Raw byte appends and the per-chunk header: every chunk starts
        with the magic."""

        def body(p, d):
            path = str(d / "wal")
            g = p.Group(path, chunk_size=16, header=b"HDR!")
            for i in range(10):
                g.write_bytes(b"payload-%02d" % i)
                g.flush()
            g.close()
            chunks = p.Group.list_chunks(path)
            assert len(chunks) > 2
            for c in chunks:
                with open(c, "rb") as f:
                    assert f.read(4) == b"HDR!", c
            return _files(d)

        both(body, tmp_path)


class TestSqliteDB:
    """SqliteDB, the bounded-RAM persistent backend."""

    def test_basic_ops(self, tmp_path):
        def body(p, d):
            db = p.SqliteDB(str(d / "test.sqlite"))
            db.set(b"k1", b"v1")
            db.set(b"k2", b"v2")
            out = [db.get(b"k1"), db.get(b"missing")]
            db.delete(b"k1")
            out += [db.has(b"k1"), list(db.iterate_prefix(b"k"))]
            db.close()
            return out

        assert both(body, tmp_path) == [b"v1", None, False, [(b"k2", b"v2")]]

    def test_persistence_and_set_sync(self, tmp_path):
        def body(p, d):
            path = str(d / "p.sqlite")
            db = p.SqliteDB(path)
            db.set(b"a", b"1")
            db.set_sync(b"b", b"2")
            db.delete(b"a")
            db.close()
            db2 = p.SqliteDB(path)
            out = [db2.get(b"a"), db2.get(b"b")]
            db2.close()
            return out

        assert both(body, tmp_path) == [None, b"2"]

    def test_overwrite_keeps_latest(self, tmp_path):
        def body(p, d):
            db = p.SqliteDB(str(d / "test.sqlite"))
            for i in range(50):
                db.set(b"key", b"%d" % i)
            out = db.get(b"key")
            db.close()
            return out

        assert both(body, tmp_path) == b"49"

    def test_iterate_prefix_range_bounds(self, tmp_path):
        def body(p, d):
            db = p.SqliteDB(str(d / "test.sqlite"))
            db.set(b"p\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff", b"deep")
            db.set(b"p1", b"v1")
            db.set(b"q1", b"other")
            got = dict(db.iterate_prefix(b"p"))
            # an all-0xff prefix has no upper bound
            db.set(b"\xff\xffx", b"last")
            last = dict(db.iterate_prefix(b"\xff\xff"))
            db.close()
            return got, last

        got, last = both(body, tmp_path)
        assert got == {b"p\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff": b"deep", b"p1": b"v1"}
        assert last == {b"\xff\xffx": b"last"}

    def test_provider_selects_sqlite(self, tmp_path):
        def body(p, d):
            db = p.db_provider("blockstore", "sqlite", str(d))
            out = [type(db).__name__, os.path.basename(db._path)]
            db.set(b"x", b"y")
            out.append(db.get(b"x"))
            db.close()
            out += [type(p.db_provider("s", "memdb", str(d))).__name__,
                    _error(lambda: p.db_provider("s", "leveldb", str(d)))]
            fdb = p.db_provider("f", "filedb", str(d))
            out.append(type(fdb).__name__)
            fdb.close()
            return out

        got = both(body, tmp_path)
        assert got[:3] == ["SqliteDB", "blockstore.sqlite", b"y"]
        assert got[4][0] == "ValueError" and got[5] == "FileDB"

    def test_concurrent_readers_and_writers(self, tmp_path):
        def body(p, d):
            db = p.SqliteDB(str(d / "test.sqlite"))
            errs = []

            def writer(base):
                try:
                    for i in range(200):
                        db.set(b"w%d-%d" % (base, i), b"v%d" % i)
                except Exception as e:  # noqa: BLE001
                    errs.append(e)

            def reader():
                try:
                    for _ in range(200):
                        db.get(b"w0-5")
                        list(db.iterate_prefix(b"w1-19"))
                except Exception as e:  # noqa: BLE001
                    errs.append(e)

            ts = [threading.Thread(target=writer, args=(i,)) for i in range(2)]
            ts.append(threading.Thread(target=reader))
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            out = [errs, db.get(b"w0-199"), list(db.iterate_prefix(b"w"))]
            db.close()
            return out

        errs, last, _items = both(body, tmp_path)
        assert errs == [] and last == b"v199"


# -- stores and groups carried across the packages ---------------------------


@pytest.mark.parametrize("src,dst", [(PORT, JAX), (JAX, PORT)], ids=["port->jax", "jax->port"])
@pytest.mark.parametrize("backend", ["sqlite", "filedb"])
def test_db_written_by_one_package_reads_in_the_other(src, dst, backend, tmp_path):
    db = src.db_provider("state", backend, str(tmp_path))
    for i in range(40):
        db.set(b"k%02d" % i, b"v%d" % i)
    db.set_sync(b"stateKey", b'{"h": 1}')
    db.delete(b"k07")
    want = list(db.iterate_prefix(b""))
    db.close()
    db2 = dst.db_provider("state", backend, str(tmp_path))
    assert list(db2.iterate_prefix(b"")) == want
    db2.set(b"k07", b"back")
    db2.close()
    db3 = src.db_provider("state", backend, str(tmp_path))
    assert db3.get(b"k07") == b"back" and db3.get(b"stateKey") == b'{"h": 1}'
    db3.close()


@pytest.mark.parametrize("src,dst", [(PORT, JAX), (JAX, PORT)], ids=["port->jax", "jax->port"])
def test_group_written_by_one_package_appends_in_the_other(src, dst, tmp_path):
    path = str(tmp_path / "wal")
    g = src.Group(path, chunk_size=48)
    for i in range(12):
        g.write_line(f"tx-{i:02d}")
        g.flush()
    g.close()
    g2 = dst.Group(path, chunk_size=48)
    g2.write_line("#M")
    g2.write_line("tail")
    g2.flush()
    assert g2.read_all_lines() == [f"tx-{i:02d}" for i in range(12)] + ["#M", "tail"]
    g2.close()
    g3 = src.Group(path)
    assert g3.search_lines_after_marker("#M") == ["tail"]
    g3.close()
