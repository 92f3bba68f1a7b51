"""Black-box flight recorder (docs/observability.md).

A wedge in a live net is otherwise debugged by manual repro, because
the node keeps no record of its recent past: by the time an operator looks, the scrape
shows the wedged END STATE and the 30 seconds that caused it are gone.
This module is the aircraft-style recorder: a lock-cheap bounded ring of
structured recent events, served live on ``GET /debug/flight`` and
auto-dumped to the node home when the node goes visibly wrong — so the
next wedge is diagnosable from the dump alone.

Event catalog (kind -> fields; sites guard a None recorder, so bare
harnesses pay nothing):

    step          height, round, step      consensus step transitions
                                           (consensus/state.new_step)
    vote_reject   height, round, type,     a vote add raised VoteError
                  err, peer                (try_add_vote)
    vote_dup      peer                     sampled already-seen-vote
                                           event (1 in 256; the full
                                           count is the
                                           consensus_vote_duplicates /
                                           p2p_peer_vote_duplicates_total
                                           counters)
    gossip_send_fail  peer                 a picked vote's send failed —
                                           picks-without-sends is the
                                           gossip-stall signature
    peer_add      peer, outbound           switch admitted a peer
    peer_drop     peer, reason             switch dropped a peer
    breaker       state                    device-plane breaker moved
    wal_endheight height                   the WAL #ENDHEIGHT fsync mark
    health        status                   health verdict CHANGED
    fastsync      event, ...               catchup-path milestones
                                           (invalid block, redo,
                                           switch-to-consensus)
    exception     thread, err              unhandled consensus-thread
                                           exception (also dumps)
    overload      level, prev, score,      load-shed ladder level
                  frac_*                   transition
                                           (node/health.OverloadMonitor)
                                           with the per-input fill
                                           fractions that drove it

Auto-dump triggers (each exactly once per episode; the latch re-arms
when the condition clears):

- health verdict transition to FAILING (note_health — driven by every
  health_report call: scrapes, probes, and the watchdog below)
- height-age wedge: the watchdog sees height_age_s past
  TENDERMINT_FLIGHTREC_WEDGE_S (default 60; waived during fast sync)
- an unhandled exception escaping the consensus receive routine

Dumps are JSON files under ``<node home>/flightrec/`` named
``dump-<utc>-<reason>.json``: the event ring, the trigger, and a
counter snapshot (p2p gossip totals + consensus position via
``counters_fn``, wired by node/node.py) so picks-vs-sends is readable
without a second artifact.

``record()`` is one enabled-check + one deque.append (GIL-atomic) — the
TENDERMINT_FLIGHTREC_DISABLE kill switch makes it a single attribute
test, which tests/test_flightrec.py asserts costs nothing on the step
path.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

from tendermint_tpu_torch.libs.envknob import env_number as _env_number

logger = logging.getLogger("node.flightrec")


class FlightRecorder:
    def __init__(self, home: str | None = None, ring: int | None = None):
        self._enabled = os.environ.get(
            "TENDERMINT_FLIGHTREC_DISABLE", "") != "1"
        if ring is None:
            ring = max(16, int(_env_number("TENDERMINT_FLIGHTREC_RING", 4096,
                                           cast=int)))
        self._ring: deque[tuple] = deque(maxlen=ring)
        self._mtx = threading.Lock()  # dump/read snapshots; record is lock-free
        self.dump_dir = os.path.join(home, "flightrec") if home else None
        self.recorded = 0
        self.dumps = 0
        self.dump_failures = 0
        # per-reason episode latches: dump once per transition INTO the
        # bad state; re-arm when it clears
        self._latched: set[str] = set()
        self._last_health: str | None = None
        self._last_breaker: int | None = None
        self._last_endpoint_breaker: dict[str, int] = {}
        self._dup_sample = 0
        # optional counter-snapshot provider for dumps (node/node.py
        # wires p2p gossip totals + consensus position)
        self.counters_fn = None
        self._watch_stop: threading.Event | None = None

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    # -- recording (hot paths) ---------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """Append one event. Lock-free: deque.append with maxlen is
        atomic under the GIL, and readers snapshot under the lock."""
        if not self._enabled:
            return
        self.recorded += 1
        self._ring.append((time.time(), kind, fields))

    def note_vote_dup(self, peer: str) -> None:
        """Sampled duplicate-vote event: the 2Nx2 gossip redundancy at
        committee scale would evict every other event from the ring if
        each duplicate recorded — 1 in 256 lands as an event, the exact
        totals ride the counters."""
        if not self._enabled:
            return
        self._dup_sample += 1
        if self._dup_sample % 256 == 1:
            self.record("vote_dup", peer=peer)

    # -- change-driven notes + auto-dump latches ---------------------------

    def note_health(self, status: str) -> None:
        """Health verdict observation (every health_report call lands
        here). Records CHANGES only; the transition into failing dumps
        exactly once per episode."""
        if not self._enabled or status == self._last_health:
            return
        self._last_health = status
        self.record("health", status=status)
        if status == "failing":
            self._dump_once("health_failing")
        else:
            self._rearm("health_failing")

    def note_breaker(self, state: int) -> None:
        if not self._enabled or state == self._last_breaker:
            return
        if self._last_breaker is not None:
            self.record("breaker", state=int(state))
        self._last_breaker = state

    def note_endpoint_breaker(self, endpoint: str, state: int) -> None:
        """Per-endpoint breaker transition (sharded device
        plane): change-driven like note_breaker, keyed by socket path —
        a sick chip's open/half-open/close sequence reads straight off
        the ring (kind ``endpoint_breaker``)."""
        if not self._enabled:
            return
        last = self._last_endpoint_breaker.get(endpoint)
        if state == last:
            return
        if last is not None:
            self.record("endpoint_breaker", endpoint=endpoint,
                        state=int(state))
        self._last_endpoint_breaker[endpoint] = state

    def note_height_age(self, age_s: float, wedge_s: float,
                        waived: bool = False) -> None:
        """Height-age wedge trigger (watchdog-driven): one dump per
        wedge episode; commits re-arm it by shrinking the age."""
        if not self._enabled:
            return
        if not waived and age_s >= wedge_s:
            self._dump_once("height_wedge")
        elif age_s < wedge_s:
            self._rearm("height_wedge")

    def note_exception(self, thread: str, exc: BaseException) -> None:
        """An unhandled exception escaped a critical thread: record and
        dump (every such crash is its own episode). The kill switch
        silences this too — a disabled recorder must write nothing."""
        if not self._enabled:
            return
        self.record("exception", thread=thread,
                    err=f"{type(exc).__name__}: {exc}")
        self.dump(f"exception_{thread}")

    def _dump_once(self, reason: str) -> None:
        with self._mtx:
            if reason in self._latched:
                return
            self._latched.add(reason)
        self.dump(reason)

    def _rearm(self, reason: str) -> None:
        with self._mtx:
            self._latched.discard(reason)

    # -- reads + dumps -----------------------------------------------------

    def events(self, last: int | None = None) -> list[dict]:
        with self._mtx:
            items = list(self._ring)
        if last is not None:
            items = items[-max(1, int(last)):]
        return [{"t": t, "kind": kind, **fields} for t, kind, fields in items]

    def _snapshot_counters(self) -> dict:
        if self.counters_fn is None:
            return {}
        try:
            return dict(self.counters_fn())
        except Exception:  # noqa: BLE001 — a counter provider bug must
            # never cost the dump itself
            logger.exception("flightrec counter snapshot failed")
            return {}

    def dump(self, reason: str) -> str | None:
        """Write the ring + counter snapshot to the node home. Returns
        the path (None when no home is configured or the write failed —
        the recorder itself must never take its caller down)."""
        payload = {
            "reason": reason,
            "dumped_at": time.time(),
            "recorded_total": self.recorded,
            "ring_size": self._ring.maxlen,
            "counters": self._snapshot_counters(),
            "events": self.events(),
        }
        self.dumps += 1
        if self.dump_dir is None:
            return None
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            path = os.path.join(
                self.dump_dir, f"dump-{stamp}-{reason}.json"
            )
            # distinct path even for two dumps in one second
            i = 0
            while os.path.exists(path):
                i += 1
                path = os.path.join(
                    self.dump_dir, f"dump-{stamp}-{reason}.{i}.json"
                )
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1)
                f.write("\n")
            os.replace(tmp, path)
            logger.warning("flight record dumped: %s (%d events)",
                           path, len(payload["events"]))
            return path
        except OSError:
            self.dump_failures += 1
            logger.exception("flight record dump failed (%s)", reason)
            return None

    def stats(self) -> dict:
        """Flat gauges for the canonical map (flightrec_* families)."""
        with self._mtx:
            size = len(self._ring)
        return {
            "events": size,
            "recorded": self.recorded,
            "dumps": self.dumps,
            "dump_failures": self.dump_failures,
            "enabled": int(self._enabled),
        }

    # -- watchdog ----------------------------------------------------------

    def start_watchdog(self, node, interval_s: float | None = None) -> None:
        """Periodic trigger scan: breaker transitions, the health
        verdict (driving the failing-transition dump even when nothing
        scrapes), and the height-age wedge. Daemon thread; every check
        is failure-proof — a mid-shutdown attribute error costs one
        tick, never the node."""
        if not self._enabled or self._watch_stop is not None:
            return
        if interval_s is None:
            interval_s = float(_env_number("TENDERMINT_FLIGHTREC_WATCH_S",
                                           2.0))
        wedge_s = float(_env_number("TENDERMINT_FLIGHTREC_WEDGE_S", 60.0))
        stop = self._watch_stop = threading.Event()

        def watch():
            from tendermint_tpu_torch.node.health import health_report
            from tendermint_tpu_torch.ops import gateway

            while not stop.is_set():
                try:
                    self.note_breaker(
                        gateway.devd_breaker().stats()["breaker_state"]
                    )
                except Exception:  # noqa: BLE001
                    pass
                try:
                    # sharded plane: every endpoint breaker that EXISTS
                    # (never instantiates one — a single-socket node has
                    # only the primary above)
                    for path, st in gateway.devd_breaker_states().items():
                        self.note_endpoint_breaker(path, st)
                except Exception:  # noqa: BLE001
                    pass
                try:
                    # health_report routes through note_health itself
                    health_report(node)
                except Exception:  # noqa: BLE001
                    pass
                try:
                    cs = node.consensus_state
                    self.note_height_age(
                        cs.height_age_s(), wedge_s,
                        waived=bool(node.blockchain_reactor.fast_sync),
                    )
                except Exception:  # noqa: BLE001
                    pass
                stop.wait(interval_s)

        threading.Thread(target=watch, daemon=True,
                         name="node.flightwatch").start()

    def stop_watchdog(self) -> None:
        if self._watch_stop is not None:
            self._watch_stop.set()
            self._watch_stop = None
