"""Per-height consensus trace spans.

``consensus_height_seconds_last`` says a height was slow; it never said
WHERE the wall time went. Every latency-overlap lever on the ROADMAP
(big-committee batch verify, pipelined execution, sharded device plane)
needs exactly that breakdown, so the receive routine now attributes each
committed height's wall clock to named segments:

    new_height -> new_round -> propose -> prevote -> prevote_wait ->
    precommit -> precommit_wait -> commit (waiting for the full block)
    -> block_save -> apply -> snapshot_hook -> events

The step segments fall out of the existing ``new_step`` transitions (the
receive routine is the single writer, so marks are lock-free); the
finalize sub-phases are marked explicitly in ``finalize_commit``. The
segments PARTITION the height's wall time — they sum to the same clock
``height_seconds_last`` reads (the consensus_trace RPC contract asserts
within 5%). Auxiliary attributions that OVERLAP segments (part hashing
inside propose) ride ``aux`` and never enter the sum.

Device attribution: the recorder snapshots the verify/hash gateway
counters and breaker state at height start and commit, so each trace
carries the height's device-vs-CPU split — a breaker-open height
visibly attributes its verify/hash work to the CPU fallback (the chaos
tier asserts this).

Pipelined execution (docs/execution-pipeline.md): the deferred
apply of height H runs on the executor thread WHILE this recorder traces
height H+1, so the executor attributes its runtime to the height it
overlaps via ``note_overlap(H+1, "overlap_apply_s", ...)`` — a locked
side table (the lock-free single-writer rule holds for ``mark``/``note``;
overlap notes are the one cross-thread writer and pay a lock). Overlay
keys are aux attributions: reported, never summed into the partition —
the consensus thread's segments still partition its own wall clock, and
the join wait it actually pays surfaces as the ``pipeline_join_wait_s``
aux note inside whichever segment blocked (normally propose).

Completed traces land in a ring buffer (TENDERMINT_TRACE_RING, default
128) served by the ``consensus_trace`` RPC and the operator CLI
``python -m tendermint_tpu_torch.ops.trace``.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from tendermint_tpu_torch.consensus.round_state import RoundStep
from tendermint_tpu_torch.libs.envknob import env_number as _env_number

# canonical segment order (display + docs/observability.md diagram)
SEGMENTS = (
    "new_height", "new_round", "propose", "prevote", "prevote_wait",
    "precommit", "precommit_wait", "commit", "block_save", "apply",
    "snapshot_hook", "events",
)

_STEP_SEGMENTS = {
    RoundStep.NEW_HEIGHT: "new_height",
    RoundStep.NEW_ROUND: "new_round",
    RoundStep.PROPOSE: "propose",
    RoundStep.PREVOTE: "prevote",
    RoundStep.PREVOTE_WAIT: "prevote_wait",
    RoundStep.PRECOMMIT: "precommit",
    RoundStep.PRECOMMIT_WAIT: "precommit_wait",
    RoundStep.COMMIT: "commit",
}

# device-probe keys differenced per height; anything else in the probe
# dict records as <key>_start / <key>_end (state, not a counter)
_DELTA_KEYS = (
    "verify_tpu_sigs", "verify_cpu_sigs",
    "hash_tpu_leaves", "hash_cpu_leaves",
    "breaker_opens",
)


def step_segment(step: int) -> str:
    return _STEP_SEGMENTS.get(step, "new_height")


# gossip arrival marks: wall-clock instants recorded once per
# height, in canonical order. Absolute epoch seconds — the fleet
# aggregator (ops/fleet.py) compares them ACROSS nodes to reconstruct
# proposer->peer propagation lag, quorum-formation time, and commit skew
ARRIVALS = (
    "proposal",          # proposal message accepted
    "first_block_part",  # first proposal part added (build or gossip)
    "prevote_quorum",    # +2/3 prevotes for a block observed
    "precommit_quorum",  # +2/3 precommits for a block observed
    "commit",            # finalize began (quorum AND full block held)
)


def arrival_hists(reg=None) -> dict:
    """The scrape-side distributions of the arrival marks (create-or-get,
    so node/telemetry.py can materialize them per-node): seconds from
    height start to quorum formation, by phase. A partition shows up
    here as a spike — the first post-heal height carries the whole
    outage in its quorum-formation observation."""
    from tendermint_tpu_torch.libs import telemetry

    if reg is None:
        reg = telemetry.default_registry()
    return {
        "quorum": reg.histogram(
            "consensus_quorum_seconds",
            "seconds from height start to +2/3 quorum formation, by phase",
            labelnames=("phase",),
        ),
        "first_part": reg.histogram(
            "consensus_first_part_seconds",
            "seconds from height start to the first proposal part held",
        ),
    }


class HeightTrace:
    """One committed height's wall-time breakdown. Immutable once built
    (the ring hands references to RPC readers on other threads)."""

    __slots__ = ("height", "segments", "aux", "device", "total_s",
                 "wall_s", "rounds", "completed_at", "arrivals",
                 "started_at")

    def __init__(self, height, segments, aux, device, wall_s, rounds,
                 arrivals=None, started_at=None):
        self.height = height
        self.segments = segments
        self.aux = aux
        self.device = device
        self.total_s = sum(segments.values())
        self.wall_s = wall_s
        self.rounds = rounds
        self.completed_at = time.time()
        # gossip arrival marks: absolute wall-clock instants
        # the fleet aggregator aligns across nodes
        self.arrivals = dict(arrivals or {})
        self.started_at = (
            started_at if started_at is not None
            else self.completed_at - wall_s
        )

    def to_json(self) -> dict:
        return {
            "height": self.height,
            "rounds": self.rounds,
            "wall_s": round(self.wall_s, 6),
            "total_s": round(self.total_s, 6),
            "segments": {k: round(v, 6) for k, v in self.segments.items()},
            "aux": {k: round(v, 6) for k, v in self.aux.items()},
            "device": dict(self.device),
            "started_at": self.started_at,
            "arrivals": {k: round(v, 6) for k, v in self.arrivals.items()},
            "completed_at": self.completed_at,
        }


class TraceRecorder:
    """Single-writer segment clock + ring of completed HeightTraces.

    ``mark``/``note`` run only on the consensus receive routine and touch
    no lock (lock-cheap by construction); ``finish`` seals the active
    trace into the ring under the ring lock; ``last`` reads the ring from
    RPC threads under the same lock."""

    def __init__(self, device_probe=None, ring: int | None = None):
        if ring is None:
            ring = max(1, int(_env_number("TENDERMINT_TRACE_RING", 128,
                                          cast=int)))
        self._ring: deque[HeightTrace] = deque(maxlen=ring)
        self._ring_mtx = threading.Lock()
        self._device_probe = device_probe
        self._height = 0
        self._segments: dict[str, float] = {}
        self._aux: dict[str, float] = {}
        self._rounds = 0
        self._cur = "new_height"
        self._last_t = time.monotonic()
        # gossip arrival marks: wall-clock instants, set once
        # per height on the receive routine (lock-free single writer like
        # mark/note). metrics_registry scopes the quorum histograms the
        # marks feed at finish (node/telemetry.py sets the node registry)
        self._arrivals: dict[str, float] = {}
        self._started_wall = time.time()
        self.metrics_registry = None
        # finish()'s end snapshot doubles as the next begin()'s start —
        # one probe per height boundary, not two back-to-back on the
        # receive routine
        self._dev_carry: dict | None = None
        self._dev_start: dict = self._probe()
        # cross-thread overlap attributions: the apply
        # executor notes its runtime against the height it overlapped;
        # notes landing before that height's begin() park in _ov_pending
        self._ov_mtx = threading.Lock()
        self._overlay: dict[str, float] = {}
        self._ov_pending: dict[int, dict[str, float]] = {}

    def _probe(self) -> dict:
        if self._device_probe is None:
            return {}
        try:
            return dict(self._device_probe())
        except Exception:  # noqa: BLE001 — attribution must never wedge
            # the receive routine; a failed probe costs one height's
            # device split, nothing else
            return {}

    def begin(self, height: int, now: float | None = None) -> None:
        """Start the clock for `height` (fresh segment table + device
        snapshot)."""
        self._segments = {}
        self._aux = {}
        self._rounds = 0
        self._cur = "new_height"
        self._last_t = now if now is not None else time.monotonic()
        self._arrivals = {}
        self._started_wall = time.time()
        with self._ov_mtx:
            # _height moves under the overlay lock so a concurrent
            # note_overlap either parks in _ov_pending (and is adopted
            # here) or lands in the fresh overlay — never in a dict this
            # reset is about to discard
            self._height = height
            self._overlay = self._ov_pending.pop(height, {})
            # drop stale parked overlays (a restart/fast-sync jump can
            # strand entries below the new height forever otherwise)
            for h in [h for h in self._ov_pending if h < height]:
                del self._ov_pending[h]
        if self._dev_carry is not None:
            self._dev_start, self._dev_carry = self._dev_carry, None
        else:
            self._dev_start = self._probe()

    def mark(self, segment: str, now: float | None = None) -> None:
        """Close the current segment at `now` and start `segment`.
        Re-marking the current segment is a cheap no-op boundary."""
        now = now if now is not None else time.monotonic()
        dt = now - self._last_t
        if dt > 0:
            self._segments[self._cur] = self._segments.get(self._cur, 0.0) + dt
        self._last_t = now
        self._cur = segment

    def note(self, key: str, seconds: float) -> None:
        """Auxiliary overlapping attribution (e.g. part_hash_s inside
        propose) — reported, never summed into the partition."""
        self._aux[key] = self._aux.get(key, 0.0) + seconds

    def note_round(self, round_: int) -> None:
        self._rounds = max(self._rounds, round_ + 1)

    def mark_arrival(self, key: str, at: float | None = None) -> None:
        """Record a gossip arrival instant (ARRIVALS key) ONCE per
        height — later duplicates (a re-proposed round, catchup parts)
        keep the FIRST instant, which is what propagation-lag math
        wants. Wall-clock epoch seconds so the fleet aggregator can
        align instants across nodes. Single-writer like mark/note."""
        if key not in self._arrivals:
            self._arrivals[key] = at if at is not None else time.time()

    def note_overlap(self, height: int, key: str, seconds: float) -> None:
        """Cross-thread aux attribution: the apply executor
        credits work to the height it OVERLAPPED (apply of H runs under
        consensus of H+1). Notes for a height not yet begun park until
        its begin(); notes for an already-sealed height are dropped —
        attribution must never resurrect a published trace."""
        with self._ov_mtx:
            if height == self._height:
                self._overlay[key] = self._overlay.get(key, 0.0) + seconds
            elif height > self._height:
                d = self._ov_pending.setdefault(height, {})
                d[key] = d.get(key, 0.0) + seconds

    def finish(self, height: int, wall_s: float,
               now: float | None = None) -> HeightTrace:
        """Seal the active trace (closing the open segment at `now`) and
        push it onto the ring."""
        self.mark("done", now=now)
        with self._ov_mtx:
            overlay, self._overlay = self._overlay, {}
        for k, v in overlay.items():
            self._aux[k] = self._aux.get(k, 0.0) + v
        end = self._probe()
        self._dev_carry = end  # the next begin() starts from this reading
        start = self._dev_start
        device: dict = {}
        for k in _DELTA_KEYS:
            if k in end or k in start:
                device[k] = end.get(k, 0) - start.get(k, 0)
        for k in end:
            if k not in _DELTA_KEYS:
                device[f"{k}_start"] = start.get(k)
                device[f"{k}_end"] = end.get(k)
        arrivals = dict(self._arrivals)
        tr = HeightTrace(height, dict(self._segments), dict(self._aux),
                         device, wall_s, max(self._rounds, 1),
                         arrivals=arrivals, started_at=self._started_wall)
        self._observe_arrivals(arrivals)
        with self._ring_mtx:
            self._ring.append(tr)
        return tr

    def _observe_arrivals(self, arrivals: dict) -> None:
        """Feed the height's arrival marks into the scrape-side
        distributions (consensus_quorum_seconds{phase},
        consensus_first_part_seconds). Failure-proof like the device
        probe: attribution must never wedge the receive routine."""
        if not arrivals:
            return
        try:
            hists = arrival_hists(self.metrics_registry)
            start = self._started_wall
            for phase in ("prevote", "precommit"):
                at = arrivals.get(f"{phase}_quorum")
                if at is not None:
                    hists["quorum"].labels(phase=phase).observe(
                        max(0.0, at - start)
                    )
            at = arrivals.get("first_block_part")
            if at is not None:
                hists["first_part"].observe(max(0.0, at - start))
        except Exception:  # noqa: BLE001
            pass

    def last(self, n: int = 10) -> list[HeightTrace]:
        """Newest-first slice of the completed-trace ring."""
        n = max(1, int(n))
        with self._ring_mtx:
            items = list(self._ring)
        return list(reversed(items))[:n]
