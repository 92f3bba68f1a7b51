"""Concurrent transaction pool (reference: mempool/mempool.go).

Good txs live in a CList walked concurrently by the reactor's per-peer
broadcast routines; an LRU cache (100k entries, mempool/mempool.go:51)
dedups everything ever seen; CheckTx goes to the app over the async ABCI
mempool connection; after each commit the surviving txs are re-checked
(mempool/mempool.go:331-357,379); `txs_available` fires once per height
when the pool first becomes non-empty (no-empty-blocks mode).

Consensus holds lock()/unlock() around app-Commit + update so no CheckTx
interleaves with state transition (state/execution.py commit path).

The port's copy of the JAX package's `mempool/mempool.py`: the same
admission, lanes, WAL bytes and env knobs. The `SigBatcher` takes the
verifier it is given; the mempool has no default one. One deliberate
difference: a device error (ops.gateway.DeviceError) from the gate's
verify refuses the batch's txs and is kept in `SigBatcher.device_error`,
where the JAX package fails open; any other exception still fails open.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict

from tendermint_tpu_torch.abci.types import (
    CODE_MEMPOOL_FULL,
    CODE_UNAUTHORIZED,
    ResponseCheckTx,
)
from tendermint_tpu_torch.libs.autofile import Group
from tendermint_tpu_torch.libs.clist import CList
from tendermint_tpu_torch.libs.envknob import env_number
from tendermint_tpu_torch.ops.gateway import DeviceError

CACHE_SIZE = 100_000

# Priority lanes (docs/serving.md): reap drains in this order,
# FIFO within a lane. Gossip stays lane-blind — one CList in arrival
# order is what the reactor walks, so the wire format is unchanged and
# byte-identical blocks stay byte-identical.
LANES = ("priority", "default", "bulk")
# load-shed ladder levels (mirrored in node/health.py; duplicated here so
# the mempool has no node-package import)
PRESSURE_SHED_WRITES = 2


def lane_for_priority(priority: int) -> str:
    """App CheckTx priority hint -> lane name (>0 priority, <0 bulk)."""
    if priority > 0:
        return LANES[0]
    if priority < 0:
        return LANES[2]
    return LANES[1]

logger = logging.getLogger("mempool")


class SigBatcher:
    """Batch signature pre-verification gate ahead of app CheckTx
    (BASELINE config 5). The reference mempool hands every tx straight to
    the app, which verifies one signature at a time on CPU
    (mempool/mempool.go:166-205); here a CheckTx burst's sig-carrying txs
    accumulate for up to `max_wait_s` (or `max_batch`), the collected
    signatures verify in ONE gateway batch — B1 on the card when wide —
    and only txs whose signature held are dispatched to the app at all.

    `parse(tx) -> (pubkey, msg, sig) | None`; txs parsing to None bypass
    the gate (the app decides). Runs its own drain thread; submit() is
    called under the mempool lock and never blocks on the device.

    Results are delivered BATCHED: `on_results([(ctx, ok), ...])` is
    called once per verified batch on the drain thread, so the consumer
    can amortize its own per-item costs (the mempool admits a whole
    batch through one app-lock round trip — check_tx_many_async; per-tx
    callbacks measured ~15us each, capping a 4k burst at ~67k tx/s
    regardless of verify speed). `on_results` defaults unset; the
    Mempool wires itself in at construction.

    The intake queue is BOUNDED (`max_backlog`): a peer flooding unique
    signed txs faster than the verifier drains must get refusals, not an
    unbounded in-memory backlog — the same end-to-end-bound rule the
    consensus peer ingress follows (consensus/state._enqueue_peer_msg;
    the tx cache's FIFO eviction means fresh floods are never refused
    there). submit() returns False on overflow and the caller rejects
    the tx retriably."""

    def __init__(self, verifier, parse, max_batch: int = 512,
                 max_wait_s: float = 0.002, max_backlog: int = 8192,
                 on_results=None, max_inflight: int = 2):
        self.verifier = verifier
        self.parse = parse
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_backlog = max_backlog
        self.on_results = on_results
        # pipelined pre-verify: up to max_inflight batches are
        # dispatched via verify_batch_async — batch k's verdicts resolve
        # while batch k+1's txs are already marshaling toward the device
        # (streamed chunks on the devd backend), so intake never idles
        # behind one synchronous verify round trip
        self.max_inflight = max(1, max_inflight)
        self.dropped = 0
        # exactly-once accounting (chaos coverage): every
        # submitted item is delivered to on_results exactly once — on
        # daemon death between the in-flight batches the verifier's
        # fallback re-verifies (or the gate fails open), but an item is
        # never dropped or double-delivered. delivered counts results
        # handed to the sink; the chaos tests assert
        # delivered == submitted - refused.
        self.delivered = 0
        self.fail_open = 0  # batches delivered un-verified (see _deliver)
        # the first device error of a verify (ops.gateway.DeviceError):
        # its batch and every later failed one are refused, not admitted
        self.device_error: BaseException | None = None
        # gate verdicts that failed — the mempool-flood
        # adversary's garbage signatures, shed here without ever
        # reaching the app (p2p_adversary_flood_txs_rejected)
        self.bad_sigs = 0
        # per-batch gate latency distribution (dispatch ->
        # verdicts delivered) — scrape-only; the flat mempool_sig_gate_*
        # gauges stay the legacy metrics-RPC surface. One observe per
        # BATCH, so the burst hot path pays nothing per tx (the <2%
        # overhead floor benches/bench_telemetry.py asserts).
        from tendermint_tpu_torch.libs import telemetry

        self._batch_hist = telemetry.default_registry().histogram(
            "mempool_sig_gate_batch_seconds",
            "sig-gate batch wall time: verify dispatch to verdicts "
            "delivered",
        )
        # Intake is a plain list under a condition variable, swapped out
        # wholesale by the drain thread — NOT a queue.Queue: at burst
        # rates the per-item timed gets (one condition wait each) cost
        # more than the verification they feed (measured ~40 ms of a
        # 119 ms 4k-tx gated burst). submit() is one append under the
        # lock; the drain thread takes the whole buffer in one swap and
        # sleeps at most once per linger window.
        self._buf: list = []
        self._cv = threading.Condition()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="mempool.sigbatch"
        )
        self._thread.start()

    def submit(self, item, ctx) -> bool:
        """Enqueue for the next batch (ctx rides to on_results with the
        verdict); False if the gate is saturated (caller must reject the
        tx without app dispatch)."""
        with self._cv:
            if len(self._buf) >= self.max_backlog:
                self.dropped += 1
                return False
            self._buf.append((item, ctx))
            # wake the drain thread when work appears or a full batch is
            # ready; intermediate appends don't pay a notify
            if len(self._buf) == 1 or len(self._buf) == self.max_batch:
                self._cv.notify()
        return True

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()

    def _take_batch(self, wait: bool = True) -> list | None:
        """Swap out up to max_batch items. wait=True blocks until work or
        stop, lingering up to max_wait_s for the burst to fill a batch;
        wait=False (a verify batch is already in flight) grabs whatever
        accumulated during the last device round trip and returns [] if
        nothing did. None means stopped AND drained."""
        with self._cv:
            if wait:
                while not self._buf and not self._stopped:
                    self._cv.wait()
            if not self._buf:
                return None if self._stopped else []
            if wait and len(self._buf) < self.max_batch and not self._stopped:
                deadline = time.monotonic() + self.max_wait_s
                while len(self._buf) < self.max_batch and not self._stopped:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
            batch = self._buf[: self.max_batch]
            del self._buf[: self.max_batch]
            return batch

    def _run(self) -> None:
        from collections import deque

        pending: deque = deque()  # (batch, resolver|None) FIFO
        while True:
            batch = self._take_batch(wait=not pending)
            if batch is None and not pending:
                return
            if batch:
                try:
                    resolver = self.verifier.verify_batch_async(
                        [b[0] for b in batch]
                    )
                except DeviceError as exc:
                    resolver = self._refuse(exc)
                except Exception:  # noqa: BLE001 — fail OPEN at delivery
                    # (see _deliver); dispatch failures must not stall
                    # the intake side of the pipeline
                    logger.exception("sig gate dispatch failed")
                    resolver = None
                pending.append((batch, resolver))
            if pending and (not batch or len(pending) >= self.max_inflight):
                self._deliver(*pending.popleft())

    def _refuse(self, exc: DeviceError):
        """A resolver that raises `exc` where the batch's verdicts are
        read; the first device error is kept and logged."""
        if self.device_error is None:
            self.device_error = exc
            logger.error("sig gate: device error; refusing the batch: %s", exc, exc_info=exc)

        def raise_it():
            raise exc

        return raise_it

    def _deliver(self, batch: list, resolver) -> None:
        t0 = time.perf_counter()
        verified = True
        try:
            oks = resolver() if resolver is not None else None
        except DeviceError as exc:
            # a failed device is no verdict: the batch is refused, so no
            # unverified tx enters the pool and the mempool reactor
            # never gossips one (the JAX package fails open here)
            self._refuse(exc)
            oks, verified = [False] * len(batch), False
        except Exception:  # noqa: BLE001 — fail OPEN (latch
            # sweep: genuinely unconditional, NOT breaker business — the
            # verifier underneath already did the breaker accounting and
            # its own CPU re-verify; only a bug that escapes ALL of that
            # lands here). The gate is an optimization, not the security
            # boundary (DeliverTx re-verifies unconditionally —
            # apps/signedkv.py), so a verifier bug may admit junk to the
            # pool but never to a block; failing closed would drop valid
            # txs instead
            logger.exception("sig gate resolve failed; delivering un-verified")
            oks = None
        if oks is None:
            self.fail_open += 1
        results = [
            (ctx, bool(ok))
            for (_item, ctx), ok in zip(
                batch, oks if oks is not None else [True] * len(batch)
            )
        ]
        self._batch_hist.observe(time.perf_counter() - t0)
        self.delivered += len(results)
        if verified:
            self.bad_sigs += sum(1 for _ctx, ok in results if not ok)
        try:
            self.on_results(results)
        except Exception:  # noqa: BLE001 — a bad sink must not stall the gate
            logger.exception("sig gate result sink failed")


class TxInCacheError(Exception):
    """Tx already seen (mempool/mempool.go:162)."""


class MempoolFullError(Exception):
    """Pool at the sum of its lane caps: shed at intake, before any app
    dispatch. Stable reason string for the RPC layer."""


class MempoolSourceLimitError(Exception):
    """One source (rpc IP / peer id) holds its full in-pool tx budget —
    shed ITS txs so it can't crowd out other clients' lanes."""


class MemTx:
    """A good tx in the pool, tagged with the height it was checked at
    (mempool/mempool.go:407-410) plus its lane and admitting source
    (lane accounting)."""

    __slots__ = ("counter", "height", "tx", "lane", "source")

    def __init__(self, counter: int, height: int, tx: bytes,
                 lane: str = "default", source: str = ""):
        self.counter = counter
        self.height = height
        self.tx = tx
        self.lane = lane
        self.source = source


class TxCache:
    """Bounded FIFO-evicting dedup set (mempool/mempool.go:412-471)."""

    def __init__(self, size: int = CACHE_SIZE):
        self._size = size
        self._map: OrderedDict[bytes, None] = OrderedDict()
        self._mtx = threading.Lock()

    def exists(self, tx: bytes) -> bool:
        with self._mtx:
            return tx in self._map

    def push(self, tx: bytes) -> bool:
        with self._mtx:
            if tx in self._map:
                return False
            if len(self._map) >= self._size:
                self._map.popitem(last=False)
            self._map[tx] = None
            return True

    def remove(self, tx: bytes) -> None:
        with self._mtx:
            self._map.pop(tx, None)

    def reset(self) -> None:
        with self._mtx:
            self._map.clear()


class Mempool:
    def __init__(self, config, proxy_app_conn, sig_batcher: SigBatcher | None = None):
        self.config = config
        self.proxy_app_conn = proxy_app_conn
        self.sig_batcher = sig_batcher
        if sig_batcher is not None and sig_batcher.on_results is None:
            # the mempool is the gate's result sink: whole batches admit
            # through one lock round trip (see SigBatcher docstring)
            sig_batcher.on_results = self._sig_gate_results
        self.txs = CList()
        self.counter = 0
        self.height = 0
        self.cache = TxCache()
        # already-seen txs shed at the dedup cache — the
        # valid-but-DUPLICATE arm of a mempool flood (one int += on the
        # dup path only; the clean path pays nothing)
        self.cache_dups = 0
        # -- priority lanes + per-source accounting ----------
        # lane caps from config with TENDERMINT_MEMPOOL_LANE_* env twins
        # (env wins — the DeviceConfig precedence rule)
        self.lane_caps: dict[str, tuple[int, int]] = {}
        for lane in LANES:
            self.lane_caps[lane] = (
                int(env_number(
                    f"TENDERMINT_MEMPOOL_LANE_{lane.upper()}_MAX_TXS",
                    getattr(config, f"lane_{lane}_max_txs", 0), cast=int)),
                int(env_number(
                    f"TENDERMINT_MEMPOOL_LANE_{lane.upper()}_MAX_BYTES",
                    getattr(config, f"lane_{lane}_max_bytes", 0), cast=int)),
            )
        # whole-pool intake cap = sum of lane tx caps; any uncapped
        # (0) lane uncaps the pool too — 0 always means "no limit"
        caps = [c for c, _b in self.lane_caps.values()]
        self.pool_cap = sum(caps) if all(caps) else 0
        self.source_max_txs = int(env_number(
            "TENDERMINT_MEMPOOL_SOURCE_MAX_TXS",
            getattr(config, "source_max_txs", 0), cast=int))
        self.lane_counts = {lane: 0 for lane in LANES}
        self.lane_bytes = {lane: 0 for lane in LANES}
        self.lane_full = {lane: 0 for lane in LANES}  # rejects per lane
        self.pool_full_rejects = 0
        self.source_limited = 0
        self.shed_writes = 0
        # in-pool txs per source key ("rpc:<ip>" / "peer:<id>"); entries
        # drop at 0 so cardinality is bounded by pool size
        self.source_counts: dict[str, int] = {}
        # tx -> source for in-flight CheckTx (popped at every terminal)
        self._pending_source: dict[bytes, str] = {}
        # load-shed ladder probe, wired by the node to
        # OverloadMonitor.level; None (bare harnesses) = never shed
        self.pressure_fn = None
        self.wal: Group | None = None
        # recheck cursor: txs in [recheck_cursor, recheck_end] are being
        # re-validated post-commit (mempool/mempool.go:72-75)
        self.recheck_cursor = None
        self.recheck_end = None
        self.notified_txs_available = False
        self._txs_available_cb = None
        # tx-lifecycle tracing (libs/txtrace.py): the node
        # wires one recorder across mempool/reactor/consensus; None in
        # bare harnesses — every stamp site guards it. _admit_rec is the
        # precomputed per-tx admit-stamp seam: only the UNGATED path
        # stamps admit from the per-tx response callback (the sig-gate
        # path stamps it batch-granularly in _sig_gate_results), so the
        # gated burst hot path pays zero per-tx tracing there.
        self._txtrace = None
        self._admit_rec = None
        # the recorder-bound sampling countdown (libs/txtrace.bind_tick):
        # check_tx's fast path is a pure local-attribute decrement; with
        # no recorder it counts down from 2^60 — never fires
        self._trace_tick = 1 << 60
        self._mtx = threading.RLock()  # the proxy mtx (mempool/mempool.go:58)
        proxy_app_conn.set_response_callback(self._res_cb)

    @property
    def txtrace(self):
        return self._txtrace

    @txtrace.setter
    def txtrace(self, rec) -> None:
        self._txtrace = rec
        self._admit_rec = rec if self.sig_batcher is None else None
        if rec is not None:
            rec.bind_tick(self)

    # -- wal ---------------------------------------------------------------

    def init_wal(self) -> None:
        """Append-only log of every tx entering CheckTx
        (mempool/mempool.go:111-124)."""
        import os

        path = self.config.wal_dir()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.wal = Group(path)

    def close_wal(self) -> None:
        with self._mtx:
            if self.wal is not None:
                self.wal.close()
                self.wal = None

    # -- locking around commit --------------------------------------------

    def lock(self) -> None:
        self._mtx.acquire()

    def unlock(self) -> None:
        self._mtx.release()

    def size(self) -> int:
        return len(self.txs)

    def flush_app_conn(self) -> None:
        self.proxy_app_conn.flush_sync()

    def flush(self) -> None:
        """Drop everything (unsafe_flush_mempool RPC)."""
        with self._mtx:
            self.cache.reset()
            el = self.txs.front()
            while el is not None:
                nxt = el.next()
                self.txs.remove(el)
                el = nxt
            self.lane_counts = {lane: 0 for lane in LANES}
            self.lane_bytes = {lane: 0 for lane in LANES}
            self.source_counts.clear()

    def txs_front(self):
        return self.txs.front()

    def txs_front_wait(self, timeout: float | None = None):
        return self.txs.front_wait(timeout)

    # -- checktx -----------------------------------------------------------

    def check_tx(self, tx: bytes, cb=None, source: str = "rpc",
                 source_id: str = "") -> None:
        """Validate tx against the app; good txs enter the pool when the
        async response lands (mempool/mempool.go:166-205). With a
        SigBatcher wired, sig-carrying txs first pass the batched
        signature gate — invalid signatures are rejected here without
        ever reaching the app. `source` tags the tx-lifecycle trace:
        "rpc" for a client submit, "peer" for gossip. `source_id`
        narrows it to the specific client IP / peer id for per-source
        admission accounting; intake sheds raise
        typed errors (MempoolFullError / MempoolSourceLimitError) with
        stable reason strings the RPC layer forwards verbatim."""
        src_key = f"{source}:{source_id}" if source_id else source
        with self._mtx:
            if not self.cache.push(tx):
                self.cache_dups += 1
                raise TxInCacheError(tx.hex()[:16])
            if self.pool_cap and len(self.txs) >= self.pool_cap:
                # pool at the sum of its lane caps: fail fast at intake,
                # before WAL/gate/app work. Cache entry dropped so the tx
                # can resubmit once the pool drains.
                self.pool_full_rejects += 1
                self.cache.remove(tx)
                raise MempoolFullError(
                    f"mempool_full: {len(self.txs)} txs >= cap {self.pool_cap}")
            if (self.source_max_txs
                    and self.source_counts.get(src_key, 0) >= self.source_max_txs):
                self.source_limited += 1
                self.cache.remove(tx)
                raise MempoolSourceLimitError(
                    f"mempool_source_limit: {src_key} holds "
                    f">={self.source_max_txs} txs")
            self._pending_source[tx] = src_key
            # lifecycle ingress, inlined (the <2% discipline): an
            # untraced tx pays ONE local-attribute countdown decrement;
            # only the sampled tx enters the recorder (which re-arms
            # this tick through the bind_tick mirror)
            self._trace_tick -= 1
            if self._trace_tick <= 0:
                if self._txtrace is not None:
                    self._txtrace.ingress(tx, source)
                else:
                    self._trace_tick = 1 << 60
            if self.wal is not None:
                self.wal.write_line(tx.hex())
                self.wal.flush()
            if self.sig_batcher is not None:
                item = self.sig_batcher.parse(tx)
                if item is not None:
                    if not self.sig_batcher.submit(item, (tx, cb)):
                        # gate saturated: refuse retriably, never grow an
                        # unbounded backlog off a peer-driven path
                        self.cache.remove(tx)
                        self._pending_source.pop(tx, None)
                        if self._txtrace is not None:
                            # a traced tx leaving the lifecycle here
                            # must seal, not linger as a false PARKED
                            self._txtrace.reject(tx, "gate_saturated")
                        if cb is not None:
                            cb(ResponseCheckTx(
                                code=CODE_UNAUTHORIZED,
                                log="signature gate saturated; retry",
                            ))
                    return
                if self._txtrace is not None and tx in self._txtrace._active:
                    # gate-BYPASSING traced tx (no parseable signature,
                    # off the gated hot path): the batch-granular admit
                    # stamp won't cover it — stamp on its own response
                    rec, orig_cb = self._txtrace, cb

                    def cb(res, _tx=tx, _orig=orig_cb, _rec=rec):
                        if res.is_ok:
                            _rec.stamp(_tx, "mempool_admit")
                        else:
                            _rec.reject(_tx, "checktx_reject")
                        if _orig is not None:
                            _orig(res)
            reqres = self.proxy_app_conn.check_tx_async(tx)
            if cb is not None:
                reqres.set_callback(lambda res: cb(res))

    def _sig_gate_results(self, results) -> None:
        """Gate verdicts for one verified batch (batcher thread).
        Signature-held txs admit to the app in ONE grouped dispatch
        (check_tx_many_async — one mempool-lock and one app-lock round
        trip for the whole batch); failures reject without app dispatch,
        same cache semantics as an app-rejected tx
        (mempool/mempool.go:231)."""
        rec = self._txtrace
        ok_entries = [ctx for ctx, ok in results if ok]
        if rec is not None and rec._active:
            # batch-granular stamping (the <2% discipline): one set
            # build for the whole verdict batch, zero per-tx calls
            rec.stamp_gate_batch(ok_entries)
        for tx, cb in (ctx for ctx, ok in results if not ok):
            if rec is not None:
                rec.reject(tx, "bad_sig")
            try:
                self._reject_bad_sig(tx, cb)
            except Exception:  # noqa: BLE001 — one raising reject callback
                # (e.g. a dead RPC response writer) must not abort the
                # batch: the remaining verdicts still have to be
                # delivered or their txs are stranded in the dedup cache
                logger.exception("bad-sig reject callback failed")
        if not ok_entries:
            return
        with self._mtx:
            rrs = self.proxy_app_conn.check_tx_many_async(
                [tx for tx, _cb in ok_entries]
            )
        for (_tx, cb), rr in zip(ok_entries, rrs):
            if cb is not None:
                try:
                    rr.set_callback(cb)
                except Exception:  # noqa: BLE001 — same isolation rule
                    logger.exception("check_tx callback failed")

    def _reject_bad_sig(self, tx: bytes, cb) -> None:
        """Signature failed the batch gate: reject without app dispatch —
        same cache semantics as an app-rejected tx (allow resubmission,
        mempool/mempool.go:231)."""
        self.cache.remove(tx)
        self._pending_source.pop(tx, None)
        if cb is not None:
            cb(ResponseCheckTx(code=CODE_UNAUTHORIZED,
                               log="invalid signature (batch pre-verify)"))

    def _res_cb(self, req_type: str, tx, res) -> None:
        """Routed to normal or recheck mode by cursor state
        (mempool/mempool.go:208-214)."""
        if req_type != "check_tx":
            return
        if self.recheck_cursor is None:
            self._res_cb_normal(tx, res)
        else:
            self._res_cb_recheck(tx, res)

    def _res_cb_normal(self, tx: bytes, res: ResponseCheckTx) -> None:
        src = self._pending_source.pop(tx, "")
        if res.is_ok:
            # lane admission: the app's priority hint picks
            # the lane; a full lane or a shed-writes ladder level rejects
            # by MUTATING the response — the ABCI clients fire this
            # global callback before per-request completion, so every
            # broadcast_tx waiter sees the typed rejection.
            lane = lane_for_priority(getattr(res, "priority", 0))
            cap_txs, cap_bytes = self.lane_caps[lane]
            if (cap_txs and self.lane_counts[lane] >= cap_txs) or (
                    cap_bytes and self.lane_bytes[lane] + len(tx) > cap_bytes):
                self.lane_full[lane] += 1
                self.cache.remove(tx)
                if self._txtrace is not None:
                    self._txtrace.reject(tx, "lane_full")
                res.code = CODE_MEMPOOL_FULL
                res.log = f"mempool_lane_full:{lane}"
                return
            pressure = self.pressure_fn() if self.pressure_fn is not None else 0
            if pressure >= PRESSURE_SHED_WRITES and lane != LANES[0]:
                # ladder at shed-writes: only the priority lane still
                # admits (reads were already shed at the RPC edge)
                self.shed_writes += 1
                self.cache.remove(tx)
                if self._txtrace is not None:
                    self._txtrace.reject(tx, "shed_writes")
                res.code = CODE_MEMPOOL_FULL
                res.log = f"mempool_shed_writes:{lane}"
                return
            if self._admit_rec is not None:
                # ungated path only: the sig-gate path already stamped
                # admit batch-granularly (_sig_gate_results)
                self._admit_rec.stamp(tx, "mempool_admit")
            self.counter += 1
            self.txs.push_back(MemTx(self.counter, self.height, tx, lane, src))
            self.lane_counts[lane] += 1
            self.lane_bytes[lane] += len(tx)
            if src:
                self.source_counts[src] = self.source_counts.get(src, 0) + 1
            self._notify_txs_available()
        else:
            # bad tx: allow future resubmission (mempool/mempool.go:231)
            if self._txtrace is not None:
                self._txtrace.reject(tx, "checktx_reject")
            self.cache.remove(tx)

    def _res_cb_recheck(self, tx: bytes, res: ResponseCheckTx) -> None:
        cursor = self.recheck_cursor
        assert cursor is not None
        memtx: MemTx = cursor.value
        if memtx.tx != tx:
            raise RuntimeError(
                f"recheck response for unexpected tx {tx.hex()[:16]} != {memtx.tx.hex()[:16]}"
            )
        if not res.is_ok:
            # tx invalidated by the last block: evict from the pool AND the
            # cache — it might become good again later (mempool.go:258-259)
            self.txs.remove(cursor)
            self._forget(memtx)
            self.cache.remove(tx)
        if cursor is self.recheck_end:
            self.recheck_cursor = None
            self.recheck_end = None
            if self.size() > 0:
                self._notify_txs_available()
        else:
            self.recheck_cursor = cursor.next()

    # -- txs-available signal ---------------------------------------------

    def enable_txs_available(self, cb) -> None:
        """cb() fires at most once per height when the pool goes non-empty
        (mempool/mempool.go:280-297)."""
        self._txs_available_cb = cb

    def _notify_txs_available(self) -> None:
        if self._txs_available_cb is not None and not self.notified_txs_available:
            self.notified_txs_available = True
            self._txs_available_cb()

    # -- consensus interface ----------------------------------------------

    def reap(self, max_txs: int) -> list[bytes]:
        """Up to max_txs good txs, lanes drained in priority order
        (priority -> default -> bulk, FIFO within a lane; -1 = all).
        With every tx in the default lane this is exactly the reference's
        FIFO reap (mempool/mempool.go:300-327). Waits for outstanding
        CheckTx responses first."""
        with self._mtx:
            if self.height > 0:
                self.proxy_app_conn.flush_sync()
            by_lane: dict[str, list[bytes]] = {lane: [] for lane in LANES}
            el = self.txs.front()
            while el is not None:
                # unknown lane tag (hand-built MemTx) rides the default lane
                by_lane.get(el.value.lane, by_lane["default"]).append(el.value.tx)
                el = el.next()
            out: list[bytes] = []
            for lane in LANES:
                out.extend(by_lane[lane])
            if max_txs >= 0:
                del out[max_txs:]
            return out

    def update(self, height: int, txs: list[bytes]) -> None:
        """Remove committed txs; recheck survivors against the new app
        state. Caller must hold lock() (mempool/mempool.go:331-357)."""
        self.proxy_app_conn.flush_sync()
        self.height = height
        self.notified_txs_available = False
        committed = set(txs)
        good = self._filter_txs(committed)
        # Recheck && (RecheckEmpty || block had txs) — mempool/mempool.go:351
        if good and self.config.recheck and (self.config.recheck_empty or txs):
            self._recheck_txs(good)
            # fires _res_cb_recheck for each in-flight response
            self.proxy_app_conn.flush_async()

    def _forget(self, memtx: MemTx) -> None:
        """Reverse the lane/source accounting of one pool departure."""
        lane = memtx.lane
        if lane in self.lane_counts:
            self.lane_counts[lane] = max(0, self.lane_counts[lane] - 1)
            self.lane_bytes[lane] = max(0, self.lane_bytes[lane] - len(memtx.tx))
        src = memtx.source
        if src:
            left = self.source_counts.get(src, 0) - 1
            if left > 0:
                self.source_counts[src] = left
            else:
                # entries drop at zero: per-source cardinality stays
                # bounded by the pool, not by client-IP churn
                self.source_counts.pop(src, None)

    def _filter_txs(self, block_txs: set[bytes]) -> list:
        good = []
        el = self.txs.front()
        while el is not None:
            nxt = el.next()
            if el.value.tx in block_txs:
                self.txs.remove(el)
                self._forget(el.value)
            else:
                good.append(el)
            el = nxt
        return good

    def _recheck_txs(self, good_elements: list) -> None:
        self.recheck_cursor = good_elements[0]
        self.recheck_end = good_elements[-1]
        # grouped dispatch: one app-lock round trip for the whole
        # survivor set; responses arrive in order, which the recheck
        # cursor depends on (both the local client's many-path and the
        # base per-tx loop preserve submission order)
        self.proxy_app_conn.check_tx_many_async(
            [el.value.tx for el in good_elements]
        )
