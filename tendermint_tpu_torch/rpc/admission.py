"""RPC ingress admission (docs/serving.md).

The serving edge of the overload-control plane: every HTTP/WS request
passes one AdmissionController before it reaches a handler. The
controller enforces

  * a connection cap (bounds the one-thread-per-connection server),
  * an in-flight request cap (bounds concurrently-executing handlers),
  * per-source token-bucket rate limits keyed by client IP — unix-socket
    peers (the node's own operator surface) are exempt,
  * per-request deadline budgets (handlers with waits consult
    `deadline_remaining()` and fail typed instead of holding a thread),
  * the load-shed ladder (node/health.OverloadMonitor): at shed-reads,
    read and subscribe traffic is refused at this edge; writes are never
    refused here — at shed-writes the MEMPOOL still admits the priority
    lane, so refusing writes wholesale at the door would shed exactly
    the traffic the ladder promises to protect.

Sheds are typed (HTTP 429/503 + Retry-After + a stable reason string)
and counted per reason — `rpc_shed_total{reason}` on the scrape surface.
Every knob has a TENDERMINT_RPC_* env twin; env wins over config and is
read per request, so limits are live-tunable under fire.

The WS half: the controller is also the registry of live WSConnections
(per-client bounded send queues live in rpc/server.py) — it caps
subscriber count, aggregates queue depths for the pressure signal, and
owns the eviction/drop counters.
"""

from __future__ import annotations

import math
import threading
import time

from tendermint_tpu_torch.libs.envknob import env_number

# stable shed reasons — the rpc_shed_total{reason} label set
SHED_CONN_CAP = "conn_cap"
SHED_INFLIGHT = "inflight_cap"
SHED_RATE_LIMITED = "rate_limited"
SHED_READS = "shed_reads"
SHED_WS_CAP = "ws_cap"
SHED_DEADLINE = "deadline"
SHED_REASONS = (
    SHED_CONN_CAP,
    SHED_INFLIGHT,
    SHED_RATE_LIMITED,
    SHED_READS,
    SHED_WS_CAP,
    SHED_DEADLINE,
)

# ladder levels, mirrored from node/health.py (no node-package import
# from the rpc layer)
PRESSURE_OK = 0
PRESSURE_SHED_READS = 1
PRESSURE_SHED_WRITES = 2

_UNIX_PEER = "unix"  # client_address[0] of a unix-socket connection

# idle token buckets older than this are pruned (bounds per-IP state)
_BUCKET_IDLE_S = 120.0
_BUCKET_PRUNE_LEN = 4096

_tls = threading.local()


def set_deadline(budget_s: float) -> None:
    _tls.deadline = (time.monotonic() + budget_s) if budget_s > 0 else None


def clear_deadline() -> None:
    _tls.deadline = None


def deadline_remaining() -> float | None:
    """Seconds left in this request's budget; None = no deadline armed.
    Handlers with waits bound them by this (rpc/core/handlers.py)."""
    dl = getattr(_tls, "deadline", None)
    return None if dl is None else dl - time.monotonic()


def request_source() -> str:
    """Client IP of the request running on this thread ("" outside a
    request). Keys the mempool's per-source admission counters so one
    spamming IP hits its own ceiling, not everyone's."""
    return getattr(_tls, "source_ip", "")


class Admit:
    """One admission verdict. Truthy when admitted; a shed carries the
    HTTP status, stable reason, and Retry-After seconds."""

    __slots__ = ("ok", "status", "reason", "retry_after")

    def __init__(self, ok: bool, status: int = 200, reason: str = "",
                 retry_after: float = 0.0):
        self.ok = ok
        self.status = status
        self.reason = reason
        self.retry_after = retry_after

    def __bool__(self) -> bool:
        return self.ok


_ADMITTED = Admit(True)


class AdmissionController:
    """Shared ingress state for one RPC server (rpc/server.py holds one;
    the node wires its own so telemetry and the pressure ladder see it)."""

    def __init__(self, config=None):
        self.config = config
        self._mtx = threading.Lock()
        self.connections = 0
        self.inflight = 0
        # ip -> [tokens, last_refill_monotonic]
        self._buckets: dict[str, list[float]] = {}
        self.sheds = {reason: 0 for reason in SHED_REASONS}
        self.sheds_total = 0
        # wired by the node to OverloadMonitor.level; None = ladder off
        self.pressure_fn = None
        # -- WS subscriber registry ------------------------------------
        self._ws_mtx = threading.Lock()
        self._ws: set = set()
        self.ws_evictions = 0
        self.ws_dropped_events = 0

    # -- knobs (env wins over config, read per call: live-tunable) -------

    def _knob(self, env: str, attr: str, default: float) -> float:
        return env_number(env, getattr(self.config, attr, default))

    def max_connections(self) -> int:
        return int(self._knob("TENDERMINT_RPC_MAX_CONNECTIONS",
                              "max_connections", 512))

    def max_inflight(self) -> int:
        return int(self._knob("TENDERMINT_RPC_MAX_INFLIGHT",
                              "max_inflight", 256))

    def rate_limit(self) -> float:
        return float(self._knob("TENDERMINT_RPC_RATE_LIMIT", "rate_limit", 0.0))

    def rate_burst(self) -> float:
        burst = float(self._knob("TENDERMINT_RPC_RATE_BURST", "rate_burst", 0.0))
        return burst if burst > 0 else 2.0 * self.rate_limit()

    def deadline_s(self) -> float:
        return float(self._knob("TENDERMINT_RPC_DEADLINE_S", "deadline_s", 0.0))

    def ws_send_queue(self) -> int:
        return int(self._knob("TENDERMINT_RPC_WS_QUEUE", "ws_send_queue", 256))

    def ws_max_clients(self) -> int:
        return int(self._knob("TENDERMINT_RPC_WS_MAX_CLIENTS",
                              "ws_max_clients", 200))

    def ws_max_overflows(self) -> int:
        """Queue overflows (each dropping the oldest N events) a slow
        subscriber survives before eviction."""
        return int(env_number("TENDERMINT_RPC_WS_MAX_OVERFLOWS", 4))

    def ws_sndbuf(self) -> int:
        """Server-side SO_SNDBUF for WS sockets, bytes (0 = kernel
        default). The kernel's multi-megabyte send buffer can hide a
        slow consumer from the bounded-queue plane for minutes;
        bounding it moves the backlog into the send queue, where the
        drop/evict accounting lives."""
        return int(env_number("TENDERMINT_RPC_WS_SNDBUF", 0, cast=int))

    # -- counting --------------------------------------------------------

    def shed(self, reason: str) -> None:
        with self._mtx:
            self.sheds[reason] = self.sheds.get(reason, 0) + 1
            self.sheds_total += 1

    # -- connection budget ----------------------------------------------

    def conn_acquire(self) -> Admit:
        cap = self.max_connections()
        with self._mtx:
            if cap and self.connections >= cap:
                pass  # shed below, outside the lock
            else:
                self.connections += 1
                return _ADMITTED
        self.shed(SHED_CONN_CAP)
        return Admit(False, 503, SHED_CONN_CAP, 1.0)

    def conn_release(self) -> None:
        with self._mtx:
            self.connections = max(0, self.connections - 1)

    # -- per-request admission -------------------------------------------

    def admit_request(self, client_ip: str, kind: str) -> Admit:
        """kind: "read" | "write" | "ws" | "ops". Admitted non-ops
        requests hold an in-flight slot and an armed deadline until
        `request_done()`. "ops" (/metrics, /health, /debug) is always
        admitted and never counted — an overloaded node must stay
        observable from scrapes alone (the docs/serving.md runbook)."""
        if kind == "ops":
            return _ADMITTED
        level = self.pressure_fn() if self.pressure_fn is not None else 0
        if level >= PRESSURE_SHED_READS and kind in ("read", "ws"):
            # the ladder's first rung: reads and subscriptions shed at
            # the edge while writes still reach the mempool's lanes
            self.shed(SHED_READS)
            return Admit(False, 503, SHED_READS, 1.0)
        rate = self.rate_limit()
        if rate > 0 and client_ip != _UNIX_PEER:
            wait = self._bucket_take(client_ip, rate, self.rate_burst())
            if wait > 0:
                self.shed(SHED_RATE_LIMITED)
                return Admit(False, 429, SHED_RATE_LIMITED, wait)
        cap = self.max_inflight()
        with self._mtx:
            if cap and self.inflight >= cap:
                over = True
            else:
                over = False
                self.inflight += 1
        if over:
            self.shed(SHED_INFLIGHT)
            return Admit(False, 503, SHED_INFLIGHT, 1.0)
        set_deadline(self.deadline_s())
        _tls.source_ip = client_ip
        return _ADMITTED

    def request_done(self) -> None:
        with self._mtx:
            self.inflight = max(0, self.inflight - 1)
        clear_deadline()
        _tls.source_ip = ""

    def _bucket_take(self, ip: str, rate: float, burst: float) -> float:
        """Take one token from ip's bucket; 0.0 = taken, else seconds
        until a token is available (the Retry-After value)."""
        now = time.monotonic()
        with self._mtx:
            b = self._buckets.get(ip)
            if b is None:
                if len(self._buckets) >= _BUCKET_PRUNE_LEN:
                    self._buckets = {
                        k: v for k, v in self._buckets.items()
                        if now - v[1] < _BUCKET_IDLE_S
                    }
                b = self._buckets[ip] = [burst, now]
            tokens = min(burst, b[0] + (now - b[1]) * rate)
            b[1] = now
            if tokens < 1.0:
                b[0] = tokens
                return (1.0 - tokens) / rate
            b[0] = tokens - 1.0
            return 0.0

    # -- WS subscriber registry ------------------------------------------

    def ws_register(self, conn) -> bool:
        cap = self.ws_max_clients()
        with self._ws_mtx:
            if cap and len(self._ws) >= cap:
                full = True
            else:
                full = False
                self._ws.add(conn)
        if full:
            self.shed(SHED_WS_CAP)
        return not full

    def ws_unregister(self, conn) -> None:
        with self._ws_mtx:
            self._ws.discard(conn)

    def ws_clients(self) -> int:
        with self._ws_mtx:
            return len(self._ws)

    def ws_evicted(self) -> None:
        with self._ws_mtx:
            self.ws_evictions += 1

    def ws_dropped(self, n: int) -> None:
        with self._ws_mtx:
            self.ws_dropped_events += n

    def ws_queue_frac(self) -> float:
        """Max send-queue fill fraction across live subscribers — the WS
        input to the pressure signal (node/health.OverloadMonitor)."""
        qmax = self.ws_send_queue() or 1
        with self._ws_mtx:
            conns = list(self._ws)
        depth = 0
        for c in conns:
            depth = max(depth, c.sendq_depth())
        return min(1.0, depth / qmax)

    # -- telemetry view ---------------------------------------------------

    def snapshot(self) -> dict:
        """Flat instantaneous view (node/telemetry.py "rpc" producer)."""
        with self._mtx:
            out = {
                "inflight": self.inflight,
                "connections": self.connections,
                "sheds": self.sheds_total,
                "deadline_rejects": self.sheds.get(SHED_DEADLINE, 0),
            }
        out["ws_clients"] = self.ws_clients()
        with self._ws_mtx:
            out["ws_evictions"] = self.ws_evictions
            out["ws_dropped_events"] = self.ws_dropped_events
        return out


def retry_after_header(seconds: float) -> str:
    """Retry-After is whole seconds (RFC 7231 §7.1.3); never "0"."""
    return str(max(1, math.ceil(seconds)))
