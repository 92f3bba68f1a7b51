"""Crash-injection points, the port's copy of the JAX package's
`state/fail.py` (reference dep: ebuchman/fail-test; call sites at
state/execution.go:224-243 and consensus/state.go:1284-1345, driven by
FAIL_TEST_INDEX in test/persist/test_failure_indices.sh).

Two families of injection, both armed purely by environment so a node
subprocess under test crashes exactly where the harness asked and a
production process pays one env lookup:

- FAIL_TEST_INDEX=i — the i-th `fail_point()` hit in this process aborts
  hard (os._exit), simulating a power failure at that logical boundary
  (the original crash tier, tests/test_persist.py).

- FAIL_TEST_MODE — the filesystem tier (the WAL torture harness):
    * torn_write + FAIL_TEST_WAL_BYTES=B: the WAL write that crosses
      cumulative byte offset B is cut at exactly B — the written prefix
      is fsynced so the tear is what a power failure would have left on
      disk — and the process dies.  Sweeping B over every byte offset of
      a record is the ALICE-style "any prefix of the append stream"
      crash model.
    * rotate_crash + FAIL_TEST_ROTATE_INDEX=k + FAIL_TEST_ROTATE_PHASE=
      pre|post: die immediately before / after the k-th chunk rotation's
      os.replace, covering the half-flushed rotation boundary.
    * pipeline + FAIL_TEST_PIPELINE_POINT=name [+ FAIL_TEST_PIPELINE_HITS=k]:
      the execution-pipeline tier —
      die at the k-th (default first) hit of the NAMED stage boundary:
        pre_apply           on the apply-executor thread, after the block
                            save + WAL #ENDHEIGHT landed but before the
                            deferred apply touched the app — the "marker
                            precedes a crashed apply" image;
        mid_parallel_apply  inside the kvstore sharded deliver_tx, after
                            the shard workers folded their ops but before
                            the deterministic merge mutates the app;
        post_apply          after sm.apply_block completed (state saved at
                            H) but before the snapshot hook/events fired.

FAIL_TEST_INDEX keeps its original SERIAL crash model: when it is armed,
consensus runs finalize_commit serially (ConsensusState._pipeline_enabled)
so the i-th fail_point() hit stays a deterministic, single-thread count —
the pipeline's cross-thread boundaries are covered by the named
pipeline_point() tier above instead.

All counters (fail-point index, WAL byte position, rotation count,
per-name pipeline hits) are guarded by one lock; `reset()` clears every
counter under that same lock so it can never race a concurrent
`fail_point()`/`wal_write()` caller.
"""

from __future__ import annotations

import os
import threading

_counter = 0
_wal_bytes = 0
_rotations = 0
_pipeline_hits: dict = {}
_mtx = threading.Lock()

EXIT_CODE = 99  # what the harnesses assert on: "died at the fail point"


def fail_point() -> None:
    target = os.environ.get("FAIL_TEST_INDEX")
    if target is None:
        return
    global _counter
    with _mtx:
        idx = _counter
        _counter += 1
    if idx == int(target):
        os._exit(EXIT_CODE)


def wal_write(f, data: bytes) -> None:
    """Perform a WAL write on behalf of autofile.Group, torn if armed.

    Only consulted when FAIL_TEST_MODE is set (the Group checks the env
    before importing this module, so the hot path never pays the call).
    The byte position advances for every hooked write — headers and
    rotation-surviving bytes included — so a swept offset B lands at one
    deterministic point of the append stream.
    """
    if os.environ.get("FAIL_TEST_MODE") != "torn_write":
        f.write(data)
        return
    target = int(os.environ.get("FAIL_TEST_WAL_BYTES", "-1"))
    global _wal_bytes
    with _mtx:
        start = _wal_bytes
        _wal_bytes += len(data)
    if target < 0 or not (start <= target < start + len(data)):
        f.write(data)
        return
    f.write(data[: target - start])
    # make the torn prefix durable: the crash image must be exactly
    # "every byte before B reached disk, nothing after" — without the
    # fsync the tear would depend on page-cache timing
    f.flush()
    os.fsync(f.fileno())
    os._exit(EXIT_CODE)


def rotate_point(phase: str) -> None:
    """Chunk-rotation crash boundary (phase: 'pre' = before the
    os.replace publishing the chunk, 'post' = after, before the new head
    exists). Armed by FAIL_TEST_MODE=rotate_crash."""
    if os.environ.get("FAIL_TEST_MODE") != "rotate_crash":
        return
    if phase != os.environ.get("FAIL_TEST_ROTATE_PHASE", "post"):
        return
    target = int(os.environ.get("FAIL_TEST_ROTATE_INDEX", "0"))
    global _rotations
    with _mtx:
        idx = _rotations
        _rotations += 1
    if idx == target:
        os._exit(EXIT_CODE)


def pipeline_point(name: str) -> None:
    """Execution-pipeline stage boundary. Armed by
    FAIL_TEST_MODE=pipeline + FAIL_TEST_PIPELINE_POINT=<name>; the
    optional FAIL_TEST_PIPELINE_HITS=k dies at the k-th hit (0-based,
    default 0) so a mid-chain boundary can be targeted too. Unlike
    fail_point(), hits count PER NAME — the boundaries live on different
    threads and a shared index would be racy by construction."""
    if os.environ.get("FAIL_TEST_MODE") != "pipeline":
        return
    if name != os.environ.get("FAIL_TEST_PIPELINE_POINT"):
        return
    target = int(os.environ.get("FAIL_TEST_PIPELINE_HITS", "0"))
    with _mtx:
        idx = _pipeline_hits.get(name, 0)
        _pipeline_hits[name] = idx + 1
    if idx == target:
        os._exit(EXIT_CODE)


def reset() -> None:
    global _counter, _wal_bytes, _rotations
    with _mtx:
        _counter = 0
        _wal_bytes = 0
        _rotations = 0
        _pipeline_hits.clear()
