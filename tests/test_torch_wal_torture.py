"""WAL torture tier on the port's node: crash a REAL
`python -m tendermint_tpu_torch.cli node` subprocess at chosen byte
offsets of its WAL append stream (and at chunk-rotation boundaries), then
prove restart recovers via repair + handshake + WAL replay with the
committed chain byte-identical and the node still committing.

The crash model is state/fail.py's torn-write hook: the WAL write crossing
cumulative offset B is cut at exactly B, fsynced, and the process dies —
the on-disk image is what a power failure at that instant leaves. The
companion in-process tier (tests/test_wal_repair.py) sweeps EVERY byte
offset of the repair logic cheaply; this tier samples offsets end-to-end
through a real node (full sweep: the slow-marked test).

Per cycle, the invariants of docs/crash-recovery.md:
- restart reaches a height past the pre-crash chain and commits a fresh tx;
- every height committed before the crash is BYTE-IDENTICAL after recovery
  (block hash, part-set root, app hash, txs) — repair/replay never forks
  or rewrites history;
- no height at or below the last synced #ENDHEIGHT is lost;
- the metrics RPC reports the v2 WAL (wal_format=2) and any repair.

The port's copy of tests/test_wal_torture.py. The node processes verify
and hash through a port device daemon that accepts the CPU (`devd_sock`,
tests/test_torch_cli.py; a port node has no card here and no CPU default).
Every crash image is read by both packages: the store's fingerprints and
the WAL's last synced #ENDHEIGHT must be equal under the JAX package's
BlockStore, FileDB and WAL reader and the port's.

Scaffolding shared with tests/test_torch_persist.py via
tests/test_torch_cli.py.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time

import pytest

from tests.test_torch_cli import (  # noqa: F401 — devd_sock is a fixture
    PACKAGES,
    devd_sock,
    free_port,
    init_node_home,
    rpc,
    wait_height,
)
from tests.test_torch_cli import node_proc as _node_proc

CYCLE_DEADLINE_S = 90


# the daemon's socket, set by the autouse fixture below for node_proc
_SOCK = {}


@pytest.fixture(autouse=True)
def _route_to_daemon(devd_sock):
    _SOCK["path"] = devd_sock
    yield


def node_proc(home: str, rpc_port: int, fail_index: int | None = None, extra_env: dict | None = None):
    return _node_proc(home, rpc_port, fail_index, extra_env, devd_sock=_SOCK["path"])


def _store_fingerprints(home: str) -> dict:
    """h -> (block hash, part-set root, app hash, txs) from the on-disk
    block store, read by both packages (equal); byte-identity of these
    across a recovery is the no-fork/no-rewrite invariant."""
    got = {pkg: _store_fingerprints_of(pkg, home) for pkg in PACKAGES}
    assert got["tendermint_tpu"] == got["tendermint_tpu_torch"], home
    return got["tendermint_tpu_torch"]


def _store_fingerprints_of(pkg: str, home: str) -> dict:
    import importlib

    BlockStore = importlib.import_module(f"{pkg}.blockchain.store").BlockStore
    FileDB = importlib.import_module(f"{pkg}.libs.db").FileDB

    store = BlockStore(FileDB(os.path.join(home, "data", "blockstore.db")))
    out = {}
    for h in range(1, store.height() + 1):
        meta = store.load_block_meta(h)
        block = store.load_block(h)
        out[h] = (
            meta.block_id.hash.hex(),
            meta.block_id.parts_header.hash.hex(),
            block.header.app_hash.hex(),
            tuple(tx.hex() for tx in (block.data.txs or [])),
        )
    return out


def _wal_last_synced_endheight(home: str) -> int:
    """Last #ENDHEIGHT surviving in the crash image, read by both packages
    (equal)."""
    got = {pkg: _wal_last_synced_endheight_of(pkg, home) for pkg in PACKAGES}
    assert got["tendermint_tpu"] == got["tendermint_tpu_torch"], home
    return got["tendermint_tpu_torch"]


def _wal_last_synced_endheight_of(pkg: str, home: str) -> int:
    """Last #ENDHEIGHT surviving in the crash image, via the READ-ONLY
    view: read_wal_lines stops at a damaged frame exactly where repair
    would cut, but never mutates the image — the restarting node must run
    its OWN repair-on-open, not inherit one this helper already did."""
    import importlib

    wal_mod = importlib.import_module(f"{pkg}.consensus.wal")
    decode_wal_line, read_wal_lines = wal_mod.decode_wal_line, wal_mod.read_wal_lines

    try:
        lines = read_wal_lines(os.path.join(home, "data", "cs.wal", "wal"))
    except FileNotFoundError:
        return -1  # crash landed before the WAL head existed
    last = -1
    for line in lines:
        try:
            decoded = decode_wal_line(line)
        except Exception:
            continue
        if decoded and decoded[0] == "endheight":
            last = decoded[1]
    return last


def _wait_exit(proc, deadline_s: float):
    deadline = time.time() + deadline_s
    while proc.poll() is None and time.time() < deadline:
        time.sleep(0.2)
    return proc.poll()


def _stop(proc) -> None:
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(15)
    except subprocess.TimeoutExpired:
        proc.kill()
    if proc.stdout:
        proc.stdout.close()


def torture_cycle(tmp_path, name: str, crash_env: dict) -> str:
    """One crash/recover cycle; returns a short outcome tag."""
    home = str(tmp_path / name)
    init_node_home(home, f"torture-{name}")

    port = free_port()
    proc = node_proc(home, port, extra_env=crash_env)
    rc = _wait_exit(proc, CYCLE_DEADLINE_S)
    if rc is None:
        # offset beyond what this run wrote before the cycle deadline —
        # a sampled-sweep cycle may legitimately not reach it
        _stop(proc)
        return "offset-not-reached"
    out = proc.stdout.read().decode(errors="replace")[-2000:]
    proc.stdout.close()
    assert rc == 99, f"{name}: expected torn-write crash exit 99, got {rc}:\n{out}"

    pre = _store_fingerprints(home)
    h_sync = _wal_last_synced_endheight(home)
    # durability floor: a height whose #ENDHEIGHT fsynced can never be lost
    assert max(pre, default=0) >= h_sync, (
        f"{name}: store lost height {h_sync} behind a synced ENDHEIGHT"
    )

    port = free_port()
    proc = node_proc(home, port)
    try:
        target = max(pre, default=0) + 1
        h = wait_height(port, target, CYCLE_DEADLINE_S)
        assert h >= target, (
            f"{name}: no recovery past pre-crash height {max(pre, default=0)}"
            f" (h={h})"
        )
        res = rpc(
            port, "broadcast_tx_commit", timeout=30,
            tx=f"torture-{name}=1".encode().hex(),
        )
        assert res["deliver_tx"]["code"] == 0, res
        m = rpc(port, "metrics", timeout=10)
        assert m.get("wal_format") == 2, m.get("wal_format")
    finally:
        _stop(proc)

    post = _store_fingerprints(home)
    for height, fp in pre.items():
        assert post[height] == fp, (
            f"{name}: height {height} rewritten by recovery:\n"
            f"pre={fp}\npost={post[height]}"
        )
    assert max(post, default=0) > max(pre, default=0)
    return "recovered"


# deterministic tier-1 sample: one offset inside height-1's record stream,
# so the cycle tears REAL records and restart runs a REAL repair (tier-1
# keeps exactly one end-to-end subprocess cycle for budget — the
# in-process tests/test_wal_repair.py sweep stays exhaustive per byte,
# and the dense subprocess sweep below rides the slow tier)
TIER1_OFFSETS = (180,)
SLOW_OFFSETS = tuple(range(0, 64)) + tuple(range(64, 1200, 11))


def test_torn_write_sampled_offsets(tmp_path):
    outcomes = {}
    for b in TIER1_OFFSETS:
        outcomes[b] = torture_cycle(
            tmp_path, f"b{b}",
            {"FAIL_TEST_MODE": "torn_write", "FAIL_TEST_WAL_BYTES": b},
        )
    # small offsets land within the first height's records: every tier-1
    # cycle must actually crash and recover, not skip
    assert set(outcomes.values()) == {"recovered"}, outcomes


# -- execution-pipeline stage boundaries --------------------------------------
#
# The pipelined finalize (docs/execution-pipeline.md) writes the block +
# WAL #ENDHEIGHT SYNCHRONOUSLY, then defers apply/hook/events to the
# executor thread. The named pipeline_point() crash tier (state/fail.py)
# dies exactly at the new stage boundaries; restart must recover via the
# same WAL repair + handshake + replay path, with every pre-crash height
# byte-identical — the "marker precedes a crashed deferred apply" image
# is the handshake's store==state+1 case.


def test_pipeline_crash_before_deferred_apply(tmp_path):
    """Die on the executor thread AFTER block save + #ENDHEIGHT landed
    but BEFORE the deferred apply touched the app (the third pipelined
    height, so recovered history spans applied AND unapplied heights)."""
    tag = torture_cycle(
        tmp_path, "pipe-pre-apply",
        {
            "FAIL_TEST_MODE": "pipeline",
            "FAIL_TEST_PIPELINE_POINT": "pre_apply",
            "FAIL_TEST_PIPELINE_HITS": 2,
        },
    )
    assert tag == "recovered", tag


def test_pipeline_crash_mid_parallel_apply(tmp_path):
    """Die INSIDE the sharded kvstore apply — after the shard workers
    folded, before the deterministic merge mutates the app. Needs a
    multi-tx block, so this cycle injects a burst while the point is
    armed (the shared torture_cycle only waits for the crash)."""
    home = str(tmp_path / "pipe-mid")
    init_node_home(home, "torture-pipe-mid")
    port = free_port()
    proc = node_proc(home, port, extra_env={
        "FAIL_TEST_MODE": "pipeline",
        "FAIL_TEST_PIPELINE_POINT": "mid_parallel_apply",
        "TENDERMINT_KVSTORE_SHARDS": 2,
        "TENDERMINT_KVSTORE_SHARD_MIN": 2,
    })
    try:
        assert wait_height(port, 1, CYCLE_DEADLINE_S) >= 1
        # burst of async txs: the first block carrying >= 2 of them takes
        # the sharded path and dies at the armed point
        deadline = time.time() + CYCLE_DEADLINE_S
        i = 0
        while proc.poll() is None and time.time() < deadline:
            try:
                rpc(port, "broadcast_tx_async", timeout=2,
                    tx=f"burst{i}={i}".encode().hex())
            except Exception:
                pass  # the process may die mid-request — that's the point
            i += 1
            time.sleep(0.02)
        rc = proc.poll()
        assert rc == 99, f"expected mid-parallel-apply crash exit 99, got {rc}"
    finally:
        if proc.poll() is None:
            _stop(proc)
        elif proc.stdout:
            proc.stdout.close()

    pre = _store_fingerprints(home)
    assert pre, "crash landed before any committed height"
    h_sync = _wal_last_synced_endheight(home)
    assert max(pre, default=0) >= h_sync

    port = free_port()
    proc = node_proc(home, port)
    try:
        target = max(pre, default=0) + 1
        assert wait_height(port, target, CYCLE_DEADLINE_S) >= target
        res = rpc(port, "broadcast_tx_commit", timeout=30,
                  tx=b"post-crash=1".hex())
        assert res["deliver_tx"]["code"] == 0, res
    finally:
        _stop(proc)
    post = _store_fingerprints(home)
    for height, fp in pre.items():
        assert post[height] == fp, (
            f"height {height} rewritten after mid-parallel-apply recovery"
        )


def _rotation_cycle(tmp_path, phase: str) -> None:
    tag = torture_cycle(
        tmp_path, f"rot-{phase}",
        {
            "FAIL_TEST_MODE": "rotate_crash",
            "FAIL_TEST_ROTATE_INDEX": 0,
            "FAIL_TEST_ROTATE_PHASE": phase,
            "TENDERMINT_WAL_CHUNK_BYTES": 700,
        },
    )
    assert tag == "recovered", (phase, tag)


@pytest.mark.slow
def test_rotation_boundary_crash_post_replace(tmp_path):
    """Die right after the os.replace publishing a chunk — the nastiest
    boundary image (numbered chunks, NO head file): restart must serve
    the records across the boundary and keep committing. (Both subprocess
    rotation phases ride the slow tier for tier-1 budget; tier 1 covers
    the same disk images in-process via TestRotationBoundary, notably
    test_missing_head_after_rotation_crash.)"""
    _rotation_cycle(tmp_path, "post")


@pytest.mark.slow
def test_rotation_boundary_crash_pre_replace(tmp_path):
    _rotation_cycle(tmp_path, "pre")


@pytest.mark.slow
def test_legacy_wal_home_still_recovers(tmp_path):
    """A node home whose WAL is in the legacy JSON-line format must
    handshake + replay + keep committing."""
    home = str(tmp_path / "legacy")
    init_node_home(home, "torture-legacy")
    # run clean to height 2, stop, then rewrite the WAL as legacy lines
    port = free_port()
    proc = node_proc(home, port)
    try:
        assert wait_height(port, 2, CYCLE_DEADLINE_S) >= 2
    finally:
        _stop(proc)
    pre = _store_fingerprints(home)

    from tendermint_tpu_torch.consensus.wal import WAL

    wal_path = os.path.join(home, "data", "cs.wal", "wal")
    wal = WAL(wal_path)
    lines = wal.read_all_lines()
    wal.group.close()
    assert lines, "recorded run produced no WAL records"
    from tendermint_tpu_torch.libs.autofile import Group

    for p in Group.list_chunks(wal_path):
        os.unlink(p)
    with open(wal_path, "w") as f:
        f.write("".join(ln + "\n" for ln in lines))

    port = free_port()
    proc = node_proc(home, port)
    try:
        target = max(pre, default=0) + 1
        assert wait_height(port, target, CYCLE_DEADLINE_S) >= target
        m = rpc(port, "metrics", timeout=10)
        assert m.get("wal_format") == 1, "legacy WAL must stay legacy"
    finally:
        _stop(proc)
    post = _store_fingerprints(home)
    for height, fp in pre.items():
        assert post[height] == fp


@pytest.mark.slow
def test_torn_write_full_sweep(tmp_path):
    """Dense byte-offset sweep through a real node: step 1 across the
    deterministic head (magic + seeded ENDHEIGHT frame + first records),
    then strided through height 1-2's stream. Every reached offset must
    recover; the in-process tier already proves every-offset repair."""
    outcomes: dict[int, str] = {}
    for b in SLOW_OFFSETS:
        outcomes[b] = torture_cycle(
            tmp_path, f"s{b}",
            {"FAIL_TEST_MODE": "torn_write", "FAIL_TEST_WAL_BYTES": b},
        )
    recovered = sum(1 for v in outcomes.values() if v == "recovered")
    not_reached = [b for b, v in outcomes.items() if v == "offset-not-reached"]
    assert recovered >= len(SLOW_OFFSETS) * 0.9, (
        f"only {recovered}/{len(SLOW_OFFSETS)} offsets recovered; "
        f"unreached: {not_reached}"
    )
    assert all(v in ("recovered", "offset-not-reached") for v in outcomes.values())
