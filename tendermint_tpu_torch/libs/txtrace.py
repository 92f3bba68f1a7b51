"""Transaction-lifecycle tracing (docs/observability.md).

The per-height consensus traces and the fleet timelines
answer "how is the node/fleet doing"; nothing answered
"where did MY transaction spend its time". This module is the sampled
per-tx span recorder: a traced tx is stamped with a wall-clock instant
at each lifecycle stage it crosses —

    rpc_ingress     check_tx entry (RPC submit, or gossip arrival on a
                    replica — the record carries the source)
    sig_gate        the batched signature-gate verdict landed
    mempool_admit   the app's CheckTx accepted it into the pool
    p2p_broadcast   first gossip send to any peer succeeded
    proposal        reaped into our proposal, or seen in a received
                    complete proposal block (whichever node this is)
    block_commit    the block carrying it finalized (stage 1: the WAL
                    marker is down; the record learns its height here)
    apply           the block's deferred/serial apply completed
    event_delivery  the tx's DeliverTx event flushed to subscribers

Stamps are keep-first (a re-proposed round re-stamps nothing), absolute
epoch seconds — the SAME convention as the gossip arrival
marks, so `ops/txtrace` can join instants for one tx hash ACROSS nodes
into a cross-node timeline (submitted on A, committed via B's proposal).
The tx hash (types/tx.tx_hash — the natural cross-node causal id) is
computed once, at sampling time, never on the untraced hot path.

Sampling (env knobs, libs/envknob semantics):

    TENDERMINT_TXTRACE_FIRST_K     (2)   trace the first K txs entering
                                         check_tx after each commit
    TENDERMINT_TXTRACE_SAMPLE_N    (64)  plus every Nth tx (0 = off)
    TENDERMINT_TXTRACE_MAX_ACTIVE  (256) in-flight trace bound — beyond
                                         it the oldest active trace is
                                         sealed as "evicted"
    TENDERMINT_TXTRACE_RING        (256) completed-trace ring
    TENDERMINT_TXTRACE_DISABLE     (0)   kill switch

Hot-path cost discipline (the <2% bound benches/bench_txtrace.py
asserts on the signed-burst shape — the harshest denominator in the
repo, ~16 us/tx through the batched gate): an untraced tx pays ONE
inline countdown at ingress (``rec._tick -= 1`` at the check_tx call
site — no method call; both sampling arms are folded into the one
counter, re-armed by the slow path), and the sig-gate/admit stamps run
at BATCH granularity (``stamp_gate_batch``: one set build per verified
batch, then one membership probe per in-flight trace — never per-tx
method calls). Dict keys are the tx BYTES whose hash the mempool cache
already computed and the bytes object caches. Block-granularity stamp
sites (`commit`/`stamp_present`/`delivered`) cost one dict.get per
block tx only while traces are in flight.

Metrics (materialized on the node registry by node/telemetry.py):
``tx_stage_seconds{stage}`` — span from the previous stamped stage —
plus the end-to-end ``tx_commit_latency_seconds`` (rpc_ingress ->
block_commit) and ``tx_visible_latency_seconds`` (rpc_ingress ->
event_delivery) histograms, observed once per sealed trace. The spans
TELESCOPE: for any sealed trace the stamped spans through block_commit
sum EXACTLY to its commit latency (the bench asserts within 10% to
guard the stamping sites, not the arithmetic).

Served by the ``tx_trace`` RPC (completed ring + in-flight actives —
a partition-parked tx is visible mid-flight, which is exactly what the
netchaos wedge triage needs) and the ``python -m
tendermint_tpu_torch.ops.txtrace`` cross-node CLI.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from tendermint_tpu_torch.libs.envknob import env_number as _env_number

# canonical stage order (display + docs/observability.md diagram)
STAGES = (
    "rpc_ingress", "sig_gate", "mempool_admit", "p2p_broadcast",
    "proposal", "block_commit", "apply", "event_delivery",
)

# tick value meaning "sampling disarmed": large enough that a node
# submitting a billion tx/s would take decades to count it down
_NEVER = 1 << 60

_hist_attr = "_txtrace_family_cache"


def txtrace_hists(reg=None) -> dict:
    """Create-or-get the tx-lifecycle histogram families on `reg`
    (default: the process-wide registry). Cached on the registry object
    like p2p/telemetry.peer_metrics so seals pay one attribute read."""
    from tendermint_tpu_torch.libs import telemetry

    if reg is None:
        reg = telemetry.default_registry()
    cached = getattr(reg, _hist_attr, None)
    if cached is not None:
        return cached
    fams = {
        "stage": reg.histogram(
            "tx_stage_seconds",
            "per-tx span from the previous stamped lifecycle stage to "
            "this one (sampled txs only)",
            labelnames=("stage",),
        ),
        "commit": reg.histogram(
            "tx_commit_latency_seconds",
            "sampled per-tx end-to-end latency: check_tx ingress to "
            "block commit",
        ),
        "visible": reg.histogram(
            "tx_visible_latency_seconds",
            "sampled per-tx end-to-end latency: check_tx ingress to "
            "DeliverTx event delivery",
        ),
    }
    setattr(reg, _hist_attr, fams)
    return fams


class TxTrace:
    """One sampled tx's lifecycle record. Mutated only through the
    recorder; published (RPC readers) as to_json snapshots. The tx HASH
    (the cross-node causal id) is computed lazily — at seal or first
    read, never on the ingress path."""

    __slots__ = ("tx", "hash", "source", "stamps", "height", "outcome",
                 "completed_at")

    def __init__(self, tx: bytes, source: str):
        self.tx = tx
        self.hash: bytes | None = None
        self.source = source
        self.stamps: dict[str, float] = {}
        self.height = 0
        self.outcome: str | None = None  # committed/rejected/evicted
        self.completed_at = 0.0

    def ensure_hash(self) -> bytes:
        h = self.hash
        if h is None:
            from tendermint_tpu_torch.types.tx import tx_hash

            h = self.hash = tx_hash(self.tx)
        return h

    def spans(self, stamps: dict | None = None) -> dict[str, float]:
        """Span attributed to each stamped stage: seconds since the
        PREVIOUS stamped stage. Telescoping by construction — summing
        the spans through block_commit reproduces the commit latency
        exactly."""
        if stamps is None:
            stamps = self.stamps
        out: dict[str, float] = {}
        prev = None
        for stage in STAGES:
            t = stamps.get(stage)
            if t is None:
                continue
            if prev is not None:
                out[stage] = max(0.0, t - prev)
            prev = t
        return out

    def to_json(self) -> dict:
        # snapshot FIRST: an RPC reader serializes in-flight traces
        # while stamping threads insert — dict(d) is one C-level copy
        # under the GIL, where iterating the live dict could raise
        # "changed size during iteration" mid-triage
        stamps = dict(self.stamps)
        ingress = stamps.get("rpc_ingress")
        commit = stamps.get("block_commit")
        visible = stamps.get("event_delivery")
        return {
            "hash": self.ensure_hash().hex().upper(),
            "source": self.source,
            "height": self.height,
            "outcome": self.outcome,
            "stages": stamps,
            "spans": {k: round(v, 6)
                      for k, v in self.spans(stamps).items()},
            "commit_latency_s": (
                round(commit - ingress, 6)
                if ingress is not None and commit is not None else None
            ),
            "visible_latency_s": (
                round(visible - ingress, 6)
                if ingress is not None and visible is not None else None
            ),
            "completed_at": self.completed_at or None,
        }


class TxTraceRecorder:
    """Sampled per-tx lifecycle spans keyed by tx bytes in flight and
    by tx hash at rest (the ring). One recorder per node — the mempool,
    its reactor, and the consensus state all stamp the same instance
    (node/node.py wires it; sites guard None for bare-harness tests)."""

    def __init__(self, ring: int | None = None, first_k: int | None = None,
                 sample_n: int | None = None, max_active: int | None = None):
        import os

        self._enabled = os.environ.get(
            "TENDERMINT_TXTRACE_DISABLE", "") != "1"
        self.first_k = (
            first_k if first_k is not None
            else int(_env_number("TENDERMINT_TXTRACE_FIRST_K", 2, cast=int))
        )
        self.sample_n = (
            sample_n if sample_n is not None
            else int(_env_number("TENDERMINT_TXTRACE_SAMPLE_N", 64, cast=int))
        )
        self.max_active = max(1, (
            max_active if max_active is not None
            else int(_env_number("TENDERMINT_TXTRACE_MAX_ACTIVE", 256,
                                 cast=int))
        ))
        if ring is None:
            ring = max(1, int(_env_number("TENDERMINT_TXTRACE_RING", 256,
                                          cast=int)))
        self._ring: deque[TxTrace] = deque(maxlen=ring)
        self._mtx = threading.Lock()
        # insertion-ordered (py3.7 dict): the oldest active is the
        # eviction victim when the bound is hit
        self._active: dict[bytes, TxTrace] = {}
        # THE ingress fast path: one countdown folding both sampling
        # arms. Call sites run `rec._tick -= 1` inline and only enter
        # ingress() when it hits zero; ingress() re-arms it — 0 while a
        # first-K burst is open (every tx enters), sample_n between
        # 1-in-N samples, effectively-infinite when sampling is off.
        # Benign GIL races (a lost decrement under concurrent check_tx)
        # shift WHICH tx samples, never correctness.
        self._burst_left = self.first_k if self._enabled else 0
        self._tick = _NEVER
        # external countdown holders (the mempool keeps its own
        # `_trace_tick` attribute so its check_tx fast path is a pure
        # local-attribute decrement — bind_tick registers it and _rearm
        # pushes every re-arm there too)
        self._tick_holders: list = []
        if self._enabled:
            self._rearm()
        self._seen = 0          # sampling decisions taken (stats)
        # flat stats (node/telemetry.py txtrace producer)
        self.sampled = 0
        self.completed = 0
        self.rejected = 0
        self.evicted = 0
        self.gate_batches = 0  # stamp_gate_batch calls (overhead bench)
        self.metrics_registry = None

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)
        self._burst_left = self.first_k if on else 0
        self._rearm()

    # -- sampling decision (check_tx entry) --------------------------------

    def maybe_trace(self, tx: bytes, source: str = "rpc",
                    at: float | None = None) -> bool:
        """The ingress gate: the inline countdown + the slow path. Call
        sites that can't inline the tick (tests, non-hot paths) use
        this; mempool.check_tx runs the two-line tick itself."""
        self._tick -= 1
        if self._tick <= 0:
            return self.ingress(tx, source, at)
        return False

    def bind_tick(self, holder) -> None:
        """Register an external countdown holder: `holder._trace_tick`
        mirrors this recorder's tick so the holder's hot path can run
        the decrement on its OWN attribute (no cross-object loads)."""
        self._tick_holders.append(holder)
        holder._trace_tick = self._tick

    def _rearm(self) -> None:
        """Set the countdown for the NEXT sample (callers hold no
        invariant: burst first, then 1-in-N, else never) and push it to
        every bound holder."""
        if self._burst_left > 0:
            tick = 0
        elif self.sample_n > 0:
            tick = self.sample_n
        else:
            tick = _NEVER
        self._tick = tick
        for h in self._tick_holders:
            h._trace_tick = tick

    def ingress(self, tx: bytes, source: str = "rpc",
                at: float | None = None) -> bool:
        """The tick hit zero: sample THIS tx (stamping rpc_ingress) and
        re-arm the countdown. The tx hash is computed only here — never
        on the untraced path."""
        if not self._enabled:
            self._burst_left = 0
            self._rearm()
            return False
        victim = None
        with self._mtx:
            self._seen += 1
            if self._burst_left > 0:
                self._burst_left -= 1
            self._rearm()
            if tx in self._active:
                return True  # resubmission of a tx already in flight
            self.sampled += 1
            tr = TxTrace(tx, source)
            tr.stamps["rpc_ingress"] = at if at is not None else time.time()
            if len(self._active) >= self.max_active:
                victim = self._active.pop(next(iter(self._active)))
                self.evicted += 1
            self._active[tx] = tr
        if victim is not None:
            # seal OUTSIDE the table lock (_seal appends to the ring
            # under the same mutex)
            self._seal(victim, "evicted")
        return True

    # -- stamping (hot paths: one dict.get when anything is in flight) -----

    def stamp(self, tx: bytes, stage: str, at: float | None = None) -> None:
        """Stamp one stage for one tx (keep-first). Untraced txs pay one
        dict.get; with nothing in flight, one attribute read."""
        if not self._active:
            return
        tr = self._active.get(tx)
        if tr is not None and stage not in tr.stamps:
            tr.stamps[stage] = at if at is not None else time.time()

    def stamp_present(self, txs, stage: str, at: float | None = None) -> None:
        """Stamp `stage` for every traced tx present in `txs` (a block's
        tx list) — one dict.get per block tx, only while traces are in
        flight."""
        if not self._active:
            return
        at = at if at is not None else time.time()
        for t in txs:
            self.stamp(bytes(t), stage, at=at)

    def stamp_gate_batch(self, ok_entries, at: float | None = None) -> None:
        """Batch-granular sig-gate stamping (the <2% discipline): one
        set build over the batch's admitted (tx, ctx) entries, then one
        membership probe per IN-FLIGHT trace — zero per-untraced-tx
        method calls. Stamps sig_gate AND mempool_admit at the verdict
        instant: the app dispatch is the same grouped call, and a local
        app's CheckTx ack lands within the same millisecond (an app
        REJECT later seals the trace via the mempool's reject path, so
        the approximation never leaves a wrong committed record)."""
        active = self._active
        if not active:
            return
        self.gate_batches += 1
        at = at if at is not None else time.time()
        if not ok_entries:
            return
        # C-speed transpose: one zip(*) pass + one set() over the tx
        # column — the cheapest whole-batch set build CPython offers
        ok = set(next(zip(*ok_entries)))
        for tx, tr in list(active.items()):
            if tx in ok:
                if "sig_gate" not in tr.stamps:
                    tr.stamps["sig_gate"] = at
                if "mempool_admit" not in tr.stamps:
                    tr.stamps["mempool_admit"] = at

    def reject(self, tx: bytes, reason: str = "rejected") -> None:
        """Seal a traced tx that left the lifecycle early (bad
        signature, app CheckTx reject)."""
        if not self._active:
            return
        with self._mtx:
            tr = self._active.pop(tx, None)
        if tr is not None:
            self._seal(tr, reason)
            self.rejected += 1

    # -- commit-side stamps (consensus state) ------------------------------

    def commit(self, txs, height: int, at: float | None = None) -> None:
        """block_commit for every traced tx in the finalized block; the
        record learns its height here. Also re-opens the first-K
        sampling window — called exactly once per committed height."""
        if self._enabled and self.first_k > 0:
            with self._mtx:
                self._burst_left = self.first_k
                self._rearm()
        if not self._active:
            return
        at = at if at is not None else time.time()
        for t in txs:
            b = bytes(t)
            tr = self._active.get(b)
            if tr is not None:
                if "block_commit" not in tr.stamps:
                    tr.stamps["block_commit"] = at
                tr.height = height

    def delivered(self, txs, at: float | None = None) -> None:
        """event_delivery for every traced tx in the block, then seal —
        the trace is complete (called after the event flush, serial and
        pipelined modes both)."""
        if not self._active:
            return
        at = at if at is not None else time.time()
        done = []
        with self._mtx:
            for t in txs:
                tr = self._active.pop(bytes(t), None)
                if tr is not None:
                    if "event_delivery" not in tr.stamps:
                        tr.stamps["event_delivery"] = at
                    done.append(tr)
        for tr in done:
            self._seal(tr, "committed")
            self.completed += 1

    # -- sealing + metrics -------------------------------------------------

    def _seal(self, tr: TxTrace, outcome: str) -> None:
        tr.outcome = outcome
        tr.completed_at = time.time()
        tr.ensure_hash()  # off the ingress path by design; pin it now
        self._observe(tr)
        with self._mtx:
            self._ring.append(tr)

    def _observe(self, tr: TxTrace) -> None:
        """Feed the sealed trace into the scrape-side distributions.
        Failure-proof like the consensus trace probes — attribution must
        never break the path that sealed the trace."""
        try:
            hists = txtrace_hists(self.metrics_registry)
            for stage, span in tr.spans().items():
                hists["stage"].labels(stage=stage).observe(span)
            ingress = tr.stamps.get("rpc_ingress")
            if ingress is None:
                return
            commit = tr.stamps.get("block_commit")
            if commit is not None:
                hists["commit"].observe(max(0.0, commit - ingress))
            visible = tr.stamps.get("event_delivery")
            if visible is not None:
                hists["visible"].observe(max(0.0, visible - ingress))
        except Exception:  # noqa: BLE001
            pass

    # -- reads (RPC threads) -----------------------------------------------

    def active(self) -> list[dict]:
        """In-flight traces, oldest first — a partition-parked tx shows
        up HERE, stages frozen at wherever it stalled."""
        with self._mtx:
            return [tr.to_json() for tr in self._active.values()]

    def last(self, n: int = 20) -> list[dict]:
        """Newest-first slice of the completed ring (sliced BEFORE
        serialization — fleets poll this)."""
        n = max(1, int(n))
        with self._mtx:
            items = list(self._ring)
        return [tr.to_json() for tr in list(reversed(items))[:n]]

    def stats(self) -> dict:
        """Flat gauges for the canonical map (txtrace_* families)."""
        with self._mtx:
            active = len(self._active)
        return {
            "sampled": self.sampled,
            "completed": self.completed,
            "rejected": self.rejected,
            "evicted": self.evicted,
            "active": active,
        }
