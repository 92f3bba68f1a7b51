"""Pipelined execution plane (docs/execution-pipeline.md).

``finalize_commit`` used to run save -> WAL marker -> apply -> snapshot
hook -> events INLINE on the consensus receive routine, so the whole node
idled through the ABCI apply of every block before the next height could
start. The header contract never required that: header H+1 carries block
H's app hash, so apply(H) only has to finish by the first point of H+1
that actually reads ``app_hash``/the applied validator set — propose, or
validating a received proposal — not before H+1's NewHeight/vote gossip
begins (the deferred-app-hash design Tendermint later shipped as ABCI++).

This module holds the moving parts consensus/state.py stages onto:

- ``ApplyExecutor``: ONE daemon worker thread applying blocks strictly in
  submission order.  A single worker is a correctness feature, not a
  limitation — apply(H+1) must observe the app exactly at H, and the
  statesync snapshot hook (which runs here, off the consensus thread)
  keeps its "app is quiesced at H" guarantee because the next DeliverTx
  can only come from the next queued apply.  The thread is a daemon on
  purpose: a wedged ABCI app must not block process exit (the
  dead-disk shutdown rule, applied to the app plane).

- ``DeferredApply``: the join handle for one height's stage-2 work.  The
  consensus thread parks on ``result()`` at the first H+1 step that needs
  the applied state; the wait is the ``pipeline_join_wait_seconds``
  histogram, and ``apply_s - wait`` — the portion of the apply that ran
  hidden under consensus — is ``pipeline_overlap_seconds``.

- the process-wide latency instruments (create-or-get, like the WAL and
  devd histograms): ``consensus_height_seconds`` (the liveness gauge pair
  ``height_seconds_last/max`` grown into a real log-bucket distribution),
  ``pipeline_join_wait_seconds`` and ``pipeline_overlap_seconds``.

Durability/ordering invariants live in consensus/state.py and
docs/execution-pipeline.md: the block save and the WAL ``#ENDHEIGHT``
marker are written SYNCHRONOUSLY before the apply is submitted, so a
crash with the marker on disk but the deferred apply unfinished is a
legal image — the restart handshake replays the saved block against the
app (the same store==state+1 case the serial design already recovered).
"""

from __future__ import annotations

import logging
import threading
import time

from tendermint_tpu_torch.libs import telemetry

logger = logging.getLogger("consensus.pipeline")

_hist_mtx = threading.Lock()
_hist_cache: dict = {}


def pipeline_hists() -> dict:
    """Materialize (create-or-get) the pipeline's process-wide latency
    histograms on the default registry. Called from node telemetry
    wiring so a scrape's family set is stable from the first height."""
    with _hist_mtx:
        if not _hist_cache:
            reg = telemetry.default_registry()
            _hist_cache["height"] = reg.histogram(
                "consensus_height_seconds",
                "wall seconds per committed height (the "
                "height_seconds_last/max gauges as a distribution)",
            )
            _hist_cache["join_wait"] = reg.histogram(
                "pipeline_join_wait_seconds",
                "seconds the consensus thread blocked joining the "
                "deferred apply of the previous height",
            )
            _hist_cache["overlap"] = reg.histogram(
                "pipeline_overlap_seconds",
                "deferred-apply seconds hidden under consensus of the "
                "next height (apply wall time minus join wait)",
            )
        return dict(_hist_cache)


class DeferredApply:
    """Join handle for one height's stage-2 (executor-side) work.

    ``result()`` returns ``(applied_state, apply_s)`` or re-raises the
    executor-side exception; ``wait()`` is the non-raising shutdown
    variant."""

    __slots__ = ("height", "_evt", "_value", "_exc")

    def __init__(self, height: int):
        self.height = height
        self._evt = threading.Event()
        self._value = None
        self._exc: BaseException | None = None

    # executor side -------------------------------------------------------

    def _finish(self, value=None, exc: BaseException | None = None) -> None:
        self._value = value
        self._exc = exc
        self._evt.set()

    # consensus side ------------------------------------------------------

    def done(self) -> bool:
        return self._evt.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._evt.wait(timeout)

    def result(self, timeout: float | None = None):
        if not self._evt.wait(timeout):
            raise TimeoutError(
                f"deferred apply of height {self.height} did not complete"
            )
        if self._exc is not None:
            raise self._exc
        return self._value


class ApplyExecutor:
    """Single daemon worker applying submitted thunks strictly in order.

    Not a thread pool: ordering IS the contract (see module docstring).
    concurrent.futures is deliberately not used — its workers are
    non-daemon since py3.9 and atexit-joined, so a wedged apply would
    hang interpreter shutdown."""

    def __init__(self, name: str = "cs.applyExecutor"):
        self._queue: list[tuple[DeferredApply, object]] = []
        self._cond = threading.Condition()
        self._stopping = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=name
        )
        self._thread.start()

    def submit(self, pending: DeferredApply, fn) -> DeferredApply:
        with self._cond:
            if self._stopping:
                raise RuntimeError("apply executor stopped")
            self._queue.append((pending, fn))
            self._cond.notify()
        return pending

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait()
                if self._stopping and not self._queue:
                    return
                pending, fn = self._queue.pop(0)
            try:
                value = fn()
                if not pending.done():
                    pending._finish(value=value)
            except BaseException as exc:  # noqa: BLE001 — delivered at join
                if pending.done():
                    # the thunk resolved the join early (apply landed)
                    # and then its post-apply tail (hook/events) failed —
                    # same severity as a serial-mode subscriber error,
                    # log-only: the applied state is already consistent
                    logger.exception(
                        "post-apply tail of height %d failed", pending.height
                    )
                else:
                    logger.exception(
                        "deferred apply of height %d failed", pending.height
                    )
                    pending._finish(exc=exc)

    def stop(self, timeout: float = 5.0) -> None:
        """Drain-and-stop: queued applies still run (state/app land on a
        consistent height for the restart handshake), then the worker
        exits. A wedged apply is abandoned after `timeout` — shutdown
        never blocks on a stuck app (the thread is a daemon)."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():
            logger.warning("apply executor did not drain in %.1fs", timeout)
