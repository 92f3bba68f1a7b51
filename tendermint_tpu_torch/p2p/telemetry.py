"""Per-peer / per-channel p2p instrumentation.

Before this module, ``p2p_*`` exported three aggregate peer counts — and
two vote-gossip liveness wedges had to be found by staring at
frozen height vectors, because no per-peer gossip counter existed to
alarm on. These are the labeled ``p2p_peer_*`` families that make the
gossip plane observable per link:

    p2p_peer_send_bytes_total{peer,channel}      frame bytes written
    p2p_peer_recv_bytes_total{peer,channel}      packet bytes read
    p2p_peer_send_msgs_total{peer,channel}       whole messages sent
    p2p_peer_recv_msgs_total{peer,channel}       whole messages received
    p2p_peer_send_failures_total{peer,channel}   full-queue send/try_send
                                                 rejections at the mconn
    p2p_peer_send_queue{peer,channel}            queue depth at last enqueue
    p2p_peer_send_queue_high_water{peer,channel} max depth seen
    p2p_peer_ping_rtt_seconds{peer}              ping->pong round trip
    p2p_peer_last_recv_age_seconds{peer}         seconds since any packet
                                                 (refreshed at collect by
                                                 node/telemetry.py)
    p2p_peer_vote_gossip_picks_total{peer}       votes picked for a peer
    p2p_peer_vote_gossip_sends_total{peer}       ... that actually sent
    p2p_peer_vote_gossip_send_failures_total{peer}  ... that did NOT —
        picks persistently > sends is the exact signal that would have
        caught a pick-marks-before-send wedge
    p2p_peer_catchup_commits_total{peer}         catchup-commit tracking
                                                 arrays engaged for a
                                                 lagging peer
    p2p_peer_vote_duplicates_total{peer}         gossiped votes already
                                                 seen (the
                                                 2NxN redundancy before-
                                                 number for gossip dedup)

Label cardinality rides the registry's ``_other`` collapse
(libs/telemetry.py): peer churn past the per-family bound
(TENDERMINT_TELEMETRY_MAX_SERIES, or the per-family
TENDERMINT_TELEMETRY_MAX_SERIES_<FAMILY> override) folds into one
overflow series — totals survive, memory stays bounded, and this holds
for the labeled HISTOGRAM exactly like the counters (tests/test_telemetry.py
asserts it under 100-peer churn).

Registry scoping: families are created on the registry passed in —
node/telemetry.py passes the NODE registry, so two nodes in one test
process (the netchaos harness) keep separate per-peer counters and each
node's scrape shows only its own links. Callers without a node (unit
tests, bare switches) default to the process-wide registry.
"""

from __future__ import annotations

import threading
import time

from tendermint_tpu_torch.libs import telemetry

_CACHE_ATTR = "_p2p_peer_family_cache"


class RttEwma:
    """Registry-scoped EWMA over every peer's ping RTT samples: the one-number RTT summary the RTT-adaptive lazy-relay hold
    reads (consensus/reactor.adaptive_relay_delay). Not an instrument —
    the per-peer distribution already rides the ping_rtt histogram; this
    is the cheap cross-peer smoother the hot relay path polls."""

    ALPHA = 0.2

    __slots__ = ("_mtx", "_value", "_samples")

    def __init__(self):
        self._mtx = threading.Lock()
        self._value = 0.0
        self._samples = 0

    def observe(self, rtt_s: float) -> None:
        with self._mtx:
            self._samples += 1
            if self._samples == 1:
                self._value = rtt_s
            else:
                self._value += self.ALPHA * (rtt_s - self._value)

    def value(self) -> float | None:
        """The smoothed RTT in seconds; None before any sample (the
        relay hold then keeps its constant fallback)."""
        with self._mtx:
            return self._value if self._samples else None


def peer_metrics(reg: "telemetry.Registry | None" = None) -> dict:
    """Create-or-get the p2p_peer_* families on `reg` (default: the
    process-wide registry). The built dict is cached on the registry
    object so hot paths pay one attribute read, not N create-or-get
    lookups (a racing double-build is idempotent — create-or-get returns
    the same instruments)."""
    if reg is None:
        reg = telemetry.default_registry()
    cached = getattr(reg, _CACHE_ATTR, None)
    if cached is not None:
        return cached
    pc = ("peer", "channel")
    p = ("peer",)
    fams = {
        "send_bytes": reg.counter(
            "p2p_peer_send_bytes_total",
            "mconn frame bytes written, per peer and channel",
            labelnames=pc,
        ),
        "recv_bytes": reg.counter(
            "p2p_peer_recv_bytes_total",
            "mconn packet bytes read, per peer and channel",
            labelnames=pc,
        ),
        "send_msgs": reg.counter(
            "p2p_peer_send_msgs_total",
            "whole messages sent, per peer and channel",
            labelnames=pc,
        ),
        "recv_msgs": reg.counter(
            "p2p_peer_recv_msgs_total",
            "whole messages received, per peer and channel",
            labelnames=pc,
        ),
        "send_failures": reg.counter(
            "p2p_peer_send_failures_total",
            "sends rejected by a full channel queue, per peer and channel",
            labelnames=pc,
        ),
        "send_queue": reg.gauge(
            "p2p_peer_send_queue",
            "channel send-queue depth sampled at last enqueue",
            labelnames=pc,
        ),
        "send_queue_high_water": reg.gauge(
            "p2p_peer_send_queue_high_water",
            "max channel send-queue depth seen",
            labelnames=pc,
        ),
        "ping_rtt": reg.histogram(
            "p2p_peer_ping_rtt_seconds",
            "mconn ping->pong round trip per peer",
            labelnames=p,
        ),
        "last_recv_age": reg.gauge(
            "p2p_peer_last_recv_age_seconds",
            "seconds since the last packet from the peer (refreshed at "
            "collect time)",
            labelnames=p,
        ),
        "vote_gossip_picks": reg.counter(
            "p2p_peer_vote_gossip_picks_total",
            "votes picked for a peer by the gossip routine",
            labelnames=p,
        ),
        "vote_gossip_sends": reg.counter(
            "p2p_peer_vote_gossip_sends_total",
            "picked votes whose send succeeded (the peer is then marked)",
            labelnames=p,
        ),
        "vote_gossip_send_failures": reg.counter(
            "p2p_peer_vote_gossip_send_failures_total",
            "picked votes whose send FAILED — the vote stays retryable "
            "(the pick-marks-before-send wedge signal)",
            labelnames=p,
        ),
        "catchup_commits": reg.counter(
            "p2p_peer_catchup_commits_total",
            "catchup-commit tracking arrays engaged for a lagging peer",
            labelnames=p,
        ),
        "vote_duplicates": reg.counter(
            "p2p_peer_vote_duplicates_total",
            "gossiped votes from this peer already seen (begin_add "
            "screen) — the 2NxN redundancy the gossip-dedup work "
            "targets",
            labelnames=p,
        ),
    }
    # not an instrument: the cross-peer RTT smoother rides the same
    # cache so reactors sharing the registry read one EWMA
    fams["ping_rtt_ewma"] = RttEwma()
    setattr(reg, _CACHE_ATTR, fams)
    return fams


def family_totals(reg: "telemetry.Registry | None" = None) -> dict:
    """Flat per-node aggregates over the labeled families (sum across
    children, the ``_other`` overflow series included) — what the legacy
    p2p producer exports beside the three peer counts."""
    fams = peer_metrics(reg)

    def total(key: str) -> int:
        return sum(child.value for _k, child in fams[key]._items())

    return {
        "peer_send_failures": total("send_failures"),
        "peer_vote_gossip_picks": total("vote_gossip_picks"),
        "peer_vote_gossip_sends": total("vote_gossip_sends"),
        "peer_vote_gossip_send_failures": total("vote_gossip_send_failures"),
        "peer_catchup_commits": total("catchup_commits"),
        "peer_vote_duplicates": total("vote_duplicates"),
    }


def _ch_label(ch_id: int) -> str:
    return f"{ch_id:#x}"


class PeerConnMetrics:
    """Per-connection handle bundle: child series resolved ONCE at
    handshake (labels never change for a live connection), so the
    send/recv routines pay one attribute read + one child inc per event
    — no registry lookups on the hot path."""

    __slots__ = ("peer_id", "_send_bytes", "_recv_bytes", "_send_msgs",
                 "_recv_msgs", "_send_failures", "_send_queue",
                 "_send_queue_hw", "_hw", "_hw_mtx", "_ping_rtt",
                 "_rtt_ewma", "_ping_sent_at")

    def __init__(self, peer_id: str, channel_ids, reg=None):
        fams = peer_metrics(reg)
        self.peer_id = peer_id

        def children(key):
            return {
                ch: fams[key].labels(peer=peer_id, channel=_ch_label(ch))
                for ch in channel_ids
            }

        self._send_bytes = children("send_bytes")
        self._recv_bytes = children("recv_bytes")
        self._send_msgs = children("send_msgs")
        self._recv_msgs = children("recv_msgs")
        self._send_failures = children("send_failures")
        self._send_queue = children("send_queue")
        self._send_queue_hw = children("send_queue_high_water")
        self._hw = {ch: 0 for ch in channel_ids}
        self._hw_mtx = threading.Lock()
        self._ping_rtt = fams["ping_rtt"].labels(peer=peer_id)
        self._rtt_ewma = fams["ping_rtt_ewma"]
        self._ping_sent_at = 0.0

    # -- send side ---------------------------------------------------------

    def sent_frame(self, ch_id: int, nbytes: int, eof: bool) -> None:
        c = self._send_bytes.get(ch_id)
        if c is None:
            return
        c.inc(nbytes)
        if eof:
            self._send_msgs[ch_id].inc()

    def send_failure(self, ch_id: int) -> None:
        c = self._send_failures.get(ch_id)
        if c is not None:
            c.inc()

    def queue_sample(self, ch_id: int, depth: int) -> None:
        g = self._send_queue.get(ch_id)
        if g is None:
            return
        g.set(depth)
        # max-under-lock, gauge write included: concurrent senders
        # racing a check-then-set (or writing the gauge after releasing)
        # could regress the high-water gauge below the true maximum
        with self._hw_mtx:
            if depth <= self._hw[ch_id]:
                return
            self._hw[ch_id] = depth
            self._send_queue_hw[ch_id].set(depth)

    # -- recv side ---------------------------------------------------------

    def recv_packet(self, ch_id: int, nbytes: int, eof: bool) -> None:
        c = self._recv_bytes.get(ch_id)
        if c is None:
            return
        c.inc(nbytes)
        if eof:
            self._recv_msgs[ch_id].inc()

    # -- liveness ----------------------------------------------------------

    def ping_sent(self) -> None:
        self._ping_sent_at = time.monotonic()

    def pong_received(self) -> None:
        if self._ping_sent_at > 0:
            rtt = time.monotonic() - self._ping_sent_at
            self._ping_rtt.observe(rtt)
            self._rtt_ewma.observe(rtt)
            self._ping_sent_at = 0.0
