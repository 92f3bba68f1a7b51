"""Network faults for real testnets: the port's copy of the JAX package's
`ops/netfaults.py`, the ops/faults idea one layer up, on the TCP links
between nodes.

A `LinkProxy` fronts one directed p2p link: the dialing node is given the
proxy's address instead of the listener's, and both directions of the
connection relay through it. On the relay sit the network's faults:

- `partition()` / `heal()`: live connections are reset (shutdown, then
  close: close() alone never wakes a blocked recv) and new connects are
  refused until healed; a dialer's persistent-peer loop re-peers after.
- `set_delay(c2s_s=, s2c_s=)`: latency a direction, each relayed chunk
  held before it is forwarded, so a link can be slow one way only.
- `set_wan(profile, seed=)`: seeded WAN shaping from a named `WanProfile`
  (`lan`, `continental`, `intercontinental`, `lossy-mobile`): a base
  latency sampled once a direction, jitter a chunk, loss as a retransmit
  stall (a TCP relay cannot drop stream bytes), bandwidth pacing, and
  connection resets for the lossiest; counted in `netfaults_wan_*`.
- `set_reorder(n)`: swap the next n pairs of adjacent chunks. The secret
  connection's counter-nonce AEAD detects each swap as tampering.
- an optional `FaultPlan` (ops/faults' taxonomy) fires refuse and stall on
  connects and stall, drop, corrupt and truncate on relayed chunks. A
  `corrupt` here flips a byte inside the encrypted stream, which the AEAD
  must flag.

`NetFabric` owns the directed links of an N-node testnet and maps group
operations (partition {0, 1} | {2, 3, 4}, heal_all, a link's delay, WAN and
geo topologies) onto them. Every link counts connections, refusals, bytes
and injected faults in flat `stats()`, summed over registered fabrics into
the scrape-only `netfaults_*` telemetry family.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import signal
import socket
import threading
import time
from dataclasses import dataclass

from tendermint_tpu_torch.libs import telemetry as _telemetry
from tendermint_tpu_torch.ops.faults import FaultPlan, _kill_sock

logger = logging.getLogger("ops.netfaults")

_CHUNK = 65536

_COUNTER_KEYS = (
    "conns", "conns_refused", "bytes_c2s", "bytes_s2c",
    "partitions", "heals", "partition_drops",
    "delays_injected", "reorders_injected", "plan_faults",
    # WAN tier: per-chunk latency/jitter actually applied,
    # cumulative sleep injected, retransmit-stall hits from the loss
    # model, bytes paced through the bandwidth cap, and severe-loss
    # connection resets
    "wan_delays_applied", "wan_delay_seconds", "wan_loss_stalls",
    "wan_bytes_shaped", "wan_resets",
)


# -- WAN profiles --------------------------------------------------
#
# A LinkProxy is a TCP byte relay, so byte LOSS cannot be modeled by
# dropping bytes (the AEAD layer above would read it as tamper, and real
# TCP never loses stream bytes anyway — loss shows up as retransmit
# latency). The loss model here is therefore a per-chunk retransmit
# STALL (an RTO-shaped delay spike) plus, for the severely lossy
# profiles, a small per-chunk probability of a full connection reset
# (the carrier-grade-NAT / cell-handoff failure mode; the dialing
# switch's persistent reconnect loop rides through it). Bandwidth caps
# pace each chunk by its serialization delay.


@dataclass(frozen=True)
class WanProfile:
    """A named distribution of link behavior. `delay_range_s` is sampled
    ONCE per link direction with a seeded RNG (links differ, runs with
    the same seed do not); jitter/loss/reset draw per chunk from the
    same seeded stream."""

    name: str
    delay_range_s: tuple[float, float]  # one-way base latency range
    jitter_s: float = 0.0               # uniform [0, jitter) per chunk
    loss: float = 0.0                   # P(chunk pays a retransmit stall)
    loss_stall_s: float = 0.0           # the stall (TCP RTO analogue)
    bandwidth_bps: float = 0.0          # 0 = uncapped
    reset_prob: float = 0.0             # P(connection reset per chunk)


WAN_PROFILES: dict[str, WanProfile] = {
    "lan": WanProfile("lan", (0.0002, 0.001), jitter_s=0.0005),
    "continental": WanProfile(
        "continental", (0.012, 0.035), jitter_s=0.004,
        loss=0.004, loss_stall_s=0.05, bandwidth_bps=8e6,
    ),
    "intercontinental": WanProfile(
        "intercontinental", (0.04, 0.09), jitter_s=0.012,
        loss=0.01, loss_stall_s=0.1, bandwidth_bps=4e6,
    ),
    "lossy-mobile": WanProfile(
        "lossy-mobile", (0.03, 0.08), jitter_s=0.03,
        loss=0.05, loss_stall_s=0.12, bandwidth_bps=2e6,
        reset_prob=0.0003,
    ),
}


def wan_profile(profile: "WanProfile | str") -> WanProfile:
    """Resolve a profile by name (the scenario-matrix spelling) or pass
    a custom WanProfile through."""
    if isinstance(profile, WanProfile):
        return profile
    try:
        return WAN_PROFILES[profile]
    except KeyError:
        raise KeyError(
            f"unknown WAN profile {profile!r}; "
            f"known: {sorted(WAN_PROFILES)}"
        ) from None


def geo_clusters(n: int, k: int) -> list[list[int]]:
    """Contiguous split of nodes 0..n-1 into k geo clusters — the
    "k clusters x m nodes" declaration scenarios use instead of hand-set
    delays (NetFabric.apply_geo maps intra/inter profiles onto it)."""
    if k <= 0:
        raise ValueError("need at least one cluster")
    base, extra = divmod(n, k)
    out, start = [], 0
    for c in range(k):
        size = base + (1 if c < extra else 0)
        out.append(list(range(start, start + size)))
        start += size
    return [c for c in out if c]


class LinkProxy:
    """One directed p2p link (dialer -> listener) as a TCP byte relay
    with injectable network faults. Thread-per-connection-direction; all
    control mutations are lock-guarded and take effect on the next chunk
    (delay/reorder) or immediately (partition)."""

    def __init__(self, upstream: tuple[str, int],
                 plan: FaultPlan | None = None, name: str = ""):
        self.upstream = upstream
        self.plan = plan
        self.name = name or f"link->{upstream[0]}:{upstream[1]}"
        self._mtx = threading.Lock()
        self._partitioned = False
        self._delay = {"c2s": 0.0, "s2c": 0.0}
        self._reorder_budget = 0
        # WAN shaping: (profile, per-direction sampled base
        # delay, seeded per-chunk RNG) or None. Armed by set_wan.
        self._wan: tuple[WanProfile, dict, random.Random] | None = None
        self._counters = {k: 0 for k in _COUNTER_KEYS}
        self._conns: list[socket.socket] = []
        self._stop = threading.Event()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(64)
        srv.settimeout(0.3)
        self._srv = srv
        self.addr = srv.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"netfault-accept:{self.name}",
        )
        self._accept_thread.start()

    # -- addressing ---------------------------------------------------------

    @property
    def laddr(self) -> str:
        """host:port the DIALING node should be pointed at (seeds /
        persistent_peers entry)."""
        return f"{self.addr[0]}:{self.addr[1]}"

    # -- chaos controls -----------------------------------------------------

    def partition(self) -> None:
        """Sever the link: refuse new connects, reset live connections.
        Reset (not blackhole) keeps test wall-clock bounded; the slow-
        link failure mode is modeled by set_delay instead."""
        with self._mtx:
            already = self._partitioned
            self._partitioned = True
            if not already:
                self._counters["partitions"] += 1
        self._drop_all(count_as="partition_drops")

    def heal(self) -> None:
        with self._mtx:
            if self._partitioned:
                self._counters["heals"] += 1
            self._partitioned = False

    def partitioned(self) -> bool:
        with self._mtx:
            return self._partitioned

    def set_delay(self, c2s_s: float = 0.0, s2c_s: float = 0.0) -> None:
        """Asymmetric one-way latency, applied per relayed chunk."""
        with self._mtx:
            self._delay["c2s"] = max(0.0, float(c2s_s))
            self._delay["s2c"] = max(0.0, float(s2c_s))

    def set_wan(self, profile: "WanProfile | str | None",
                seed: int = 0) -> None:
        """Arm (or clear, profile=None) a WAN profile on this link. The
        per-direction base latency is sampled HERE, once, from a RNG
        seeded by (seed, link name, profile name) — deterministic across
        runs, different across links — so a fabric-wide apply_wan gives
        every link its own stable place in the distribution. Per-chunk
        jitter/loss/reset draws continue from the same stream."""
        if profile is None:
            with self._mtx:
                self._wan = None
            return
        p = wan_profile(profile)
        rng = random.Random(f"{seed}:{self.name}:{p.name}")
        base = {
            "c2s": rng.uniform(*p.delay_range_s),
            "s2c": rng.uniform(*p.delay_range_s),
        }
        with self._mtx:
            self._wan = (p, base, rng)

    def wan_profile_name(self) -> str | None:
        with self._mtx:
            return self._wan[0].name if self._wan is not None else None

    def set_reorder(self, swaps: int) -> None:
        """Swap the next `swaps` pairs of adjacent relayed chunks
        (either direction claims from the shared budget). The AEAD layer
        detects each swap as tampering — the assertion the scenario
        matrix makes."""
        with self._mtx:
            self._reorder_budget = max(0, int(swaps))

    def drop_all(self) -> None:
        """Reset live connections without partitioning (peer-churn
        support: the next dial succeeds)."""
        self._drop_all(count_as=None)

    def retarget(self, upstream: tuple[str, int]) -> None:
        """Point the link at a new upstream (rolling-restart support:
        a restarted node binds a fresh listener port; the fabric's
        inbound links re-aim so the dialers' persistent reconnect loops
        re-peer without test intervention). Live connections keep their
        old upstream until dropped."""
        with self._mtx:
            self.upstream = tuple(upstream)

    def stats(self) -> dict:
        with self._mtx:
            out = {f"netfaults_{k}": v for k, v in self._counters.items()}
            out["netfaults_partitioned"] = int(self._partitioned)
            out["netfaults_wan_profiled"] = int(self._wan is not None)
            return out

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._drop_all(count_as=None)
        if self._accept_thread.is_alive():
            self._accept_thread.join(timeout=5.0)

    # -- internals ----------------------------------------------------------

    def _note(self, key: str, v: int = 1) -> None:
        with self._mtx:
            self._counters[key] += v

    def _drop_all(self, count_as: str | None) -> None:
        with self._mtx:
            conns, self._conns = self._conns, []
            if count_as and conns:
                self._counters[count_as] += len(conns)
        for c in conns:
            _kill_sock(c)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._mtx:
                dark = self._partitioned
            f = None
            if not dark and self.plan is not None:
                f = self.plan.pick("connect", supported=("refuse", "stall"))
                if f is not None:
                    self._note("plan_faults")
            if dark or (f is not None and f.kind == "refuse"):
                self._note("conns_refused")
                _kill_sock(conn)
                continue
            if f is not None and f.kind == "stall":
                time.sleep(f.stall_s)
            try:
                up = socket.create_connection(self.upstream, timeout=5.0)
                # the connect timeout must NOT linger as an IO timeout: a
                # relay direction that idles 5 s (vote channel between
                # rounds) would raise and kill the whole link
                up.settimeout(None)
            except OSError:
                # upstream listener down (churn window): the dialer sees
                # exactly what a dead node produces
                self._note("conns_refused")
                _kill_sock(conn)
                continue
            self._note("conns")
            with self._mtx:
                self._conns += [conn, up]
            for src, dst, direction in ((conn, up, "c2s"), (up, conn, "s2c")):
                threading.Thread(
                    target=self._relay, args=(src, dst, direction),
                    daemon=True, name=f"netfault-{direction}:{self.name}",
                ).start()

    def _relay(self, src: socket.socket, dst: socket.socket,
               direction: str) -> None:
        held: bytes | None = None
        try:
            while not self._stop.is_set():
                try:
                    data = src.recv(_CHUNK)
                except socket.timeout:
                    # only armed while a chunk is held for reordering: an
                    # idle stream must not blackhole the held bytes (the
                    # peer may be WAITING on them — nothing else would
                    # ever arrive to trigger the swap)
                    if held is not None:
                        dst.sendall(held)
                        held = None
                    src.settimeout(None)
                    continue
                if not data:
                    return
                self._note(f"bytes_{direction}", len(data))
                if self.plan is not None:
                    f = self.plan.pick(
                        direction,
                        supported=("stall", "drop", "truncate", "corrupt"),
                    )
                    if f is not None:
                        self._note("plan_faults")
                        if f.kind == "stall":
                            time.sleep(f.stall_s)
                        elif f.kind == "drop":
                            return
                        elif f.kind == "truncate":
                            dst.sendall(data[: max(1, len(data) // 2)])
                            return
                        elif f.kind == "corrupt":
                            # inside the ENCRYPTED stream: the AEAD must
                            # flag it (in-contract, unlike devd IPC)
                            buf = bytearray(data)
                            buf[self.plan.corrupt_offset(0, len(buf))] ^= 0xFF
                            data = bytes(buf)
                with self._mtx:
                    delay = self._delay["c2s" if direction == "c2s" else "s2c"]
                    want_reorder = self._reorder_budget > 0 and held is None
                    if want_reorder:
                        self._reorder_budget -= 1
                    wan = self._wan
                    wan_sleep, wan_stalled, wan_reset = 0.0, False, False
                    if wan is not None:
                        # per-chunk draws under the link lock: both relay
                        # directions share the seeded RNG stream
                        p, base, rng = wan
                        wan_sleep = base[direction]
                        if p.jitter_s:
                            wan_sleep += rng.uniform(0.0, p.jitter_s)
                        if p.bandwidth_bps:
                            # bandwidth_bps is BITS per second (the
                            # profile table says Mbps): 8 bits/byte
                            wan_sleep += len(data) * 8 / p.bandwidth_bps
                        if p.loss and rng.random() < p.loss:
                            wan_sleep += p.loss_stall_s
                            wan_stalled = True
                        if p.reset_prob and rng.random() < p.reset_prob:
                            wan_reset = True
                if wan is not None:
                    self._note("wan_delays_applied")
                    self._note("wan_delay_seconds", wan_sleep)
                    if p.bandwidth_bps:
                        self._note("wan_bytes_shaped", len(data))
                    if wan_stalled:
                        self._note("wan_loss_stalls")
                    if wan_reset:
                        # severe-loss model: the connection dies (the
                        # finally clause resets both sides); the dialing
                        # switch's persistent reconnect loop recovers
                        self._note("wan_resets")
                        return
                    time.sleep(wan_sleep)
                if delay > 0:
                    self._note("delays_injected")
                    time.sleep(delay)
                if want_reorder:
                    held = data  # hold this chunk, release after the next
                    src.settimeout(0.25)  # idle flush bound (see above)
                    continue
                dst.sendall(data)
                if held is not None:
                    self._note("reorders_injected")
                    dst.sendall(held)
                    held = None
                    src.settimeout(None)
        except (ConnectionError, OSError):
            pass
        finally:
            if held is not None:
                try:
                    dst.sendall(held)
                except OSError:
                    pass
            for s in (src, dst):
                _kill_sock(s)


class NetFabric:
    """The directed links of one testnet: link (i, j) carries the
    connection node i DIALED to node j (the harness gives i the proxy's
    laddr as its seed for j). Group operations map onto per-link
    controls; everything heals."""

    def __init__(self, name: str = "netfabric"):
        self.name = name
        self._links: dict[tuple[int, int], LinkProxy] = {}
        self._mtx = threading.Lock()
        register_fabric(self)

    def add_link(self, i: int, j: int, upstream: tuple[int, int] | tuple,
                 plan: FaultPlan | None = None) -> LinkProxy:
        link = LinkProxy(tuple(upstream), plan=plan, name=f"{self.name}:{i}->{j}")
        with self._mtx:
            self._links[(i, j)] = link
        return link

    def link(self, i: int, j: int) -> LinkProxy | None:
        with self._mtx:
            return self._links.get((i, j))

    def links(self) -> dict:
        with self._mtx:
            return dict(self._links)

    def links_of(self, node: int) -> list[LinkProxy]:
        with self._mtx:
            return [
                l for (i, j), l in self._links.items() if node in (i, j)
            ]

    # -- group chaos --------------------------------------------------------

    def partition_groups(self, group_a) -> None:
        """Sever every link crossing the {group_a} | {rest} boundary."""
        ga = set(group_a)
        for (i, j), link in self.links().items():
            if (i in ga) != (j in ga):
                link.partition()

    def heal_all(self) -> None:
        for link in self.links().values():
            link.heal()

    # -- WAN tier ------------------------------------------------

    def apply_wan(self, profile: "WanProfile | str | None",
                  seed: int = 0) -> None:
        """One WAN profile across every link (per-link latencies still
        differ: each samples its own base delay from the seeded
        distribution). None clears."""
        for link in self.links().values():
            link.set_wan(profile, seed=seed)

    def clear_wan(self) -> None:
        self.apply_wan(None)

    def apply_geo(self, clusters: list[list[int]],
                  intra: "WanProfile | str" = "lan",
                  inter: "WanProfile | str" = "intercontinental",
                  seed: int = 0) -> None:
        """Geo-cluster topology: low latency inside a cluster, high
        between clusters — "k clusters x m nodes" declared as data
        (geo_clusters(n, k) builds the cluster lists) instead of
        hand-set per-link delays. Links touching a node outside every
        cluster get the inter profile (conservative)."""
        member = {
            node: ci for ci, cl in enumerate(clusters) for node in cl
        }
        for (i, j), link in self.links().items():
            same = (
                i in member and j in member and member[i] == member[j]
            )
            link.set_wan(intra if same else inter, seed=seed)

    def set_delay(self, i: int, j: int, c2s_s: float = 0.0,
                  s2c_s: float = 0.0) -> None:
        link = self.link(i, j)
        if link is None:
            raise KeyError(f"no link {i}->{j}")
        link.set_delay(c2s_s=c2s_s, s2c_s=s2c_s)

    def stats(self) -> dict:
        """Aggregate flat counters over every link (the scrape surface)."""
        out = {f"netfaults_{k}": 0 for k in _COUNTER_KEYS}
        out["netfaults_partitioned"] = 0
        out["netfaults_wan_profiled"] = 0
        out["netfaults_links"] = 0
        for link in self.links().values():
            out["netfaults_links"] += 1
            for k, v in link.stats().items():
                out[k] = out.get(k, 0) + v
        return out

    def stop(self) -> None:
        for link in self.links().values():
            link.stop()
        unregister_fabric(self)


# -- telemetry (scrape-only, the ops/faults convention) -----------------------

_fabrics: list[NetFabric] = []
_reg_mtx = threading.Lock()


def register_fabric(fabric: NetFabric) -> NetFabric:
    with _reg_mtx:
        if fabric not in _fabrics:
            _fabrics.append(fabric)
    return fabric


def unregister_fabric(fabric: NetFabric) -> None:
    with _reg_mtx:
        if fabric in _fabrics:
            _fabrics.remove(fabric)


def telemetry_counters() -> dict:
    out = {f"netfaults_{k}": 0 for k in _COUNTER_KEYS}
    out["netfaults_partitioned"] = 0
    out["netfaults_wan_profiled"] = 0
    out["netfaults_links"] = 0
    with _reg_mtx:
        fabrics = list(_fabrics)
    for fabric in fabrics:
        for k, v in fabric.stats().items():
            out[k] = out.get(k, 0) + v
    return out


def _install_telemetry(reg) -> None:
    # scrape-only: the flat metrics map's key set stays as it is. The
    # producer registers under its own prefix: producers are keyed by
    # prefix, so a second ""-prefixed one would replace ops/faults'. The
    # netfaults_ names come back by stripping the stats() prefix and
    # letting the registry add it again
    def produce() -> dict:
        return {
            k[len("netfaults_"):]: v
            for k, v in telemetry_counters().items()
        }

    reg.register_producer("netfaults", produce, legacy=False)


_telemetry.on_default_registry(_install_telemetry)


# -- standalone shim process --------------------------------------------------


def main(argv=None) -> int:
    """Run one LinkProxy as its own process (multi-process harnesses:
    point a node's seed entry at --listen-report's printed address).
    Counters print as ONE json line on SIGTERM/SIGINT."""
    ap = argparse.ArgumentParser(description=LinkProxy.__doc__)
    ap.add_argument("--upstream", required=True, help="host:port of the listener")
    ap.add_argument("--delay-c2s", type=float, default=0.0)
    ap.add_argument("--delay-s2c", type=float, default=0.0)
    ap.add_argument("--reorder", type=int, default=0,
                    help="swap the next N adjacent chunk pairs")
    ap.add_argument("--wan-profile", default="",
                    help=f"WAN shaping profile: one of {sorted(WAN_PROFILES)}")
    ap.add_argument("--wan-seed", type=int, default=0,
                    help="seed for the per-link WAN latency sample")
    args = ap.parse_args(argv)

    host, port = args.upstream.rsplit(":", 1)
    proxy = LinkProxy((host, int(port)))
    proxy.set_delay(c2s_s=args.delay_c2s, s2c_s=args.delay_s2c)
    if args.reorder:
        proxy.set_reorder(args.reorder)
    if args.wan_profile:
        proxy.set_wan(args.wan_profile, seed=args.wan_seed)
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    logging.basicConfig(level=logging.INFO)
    # parseable: harnesses read the first line for the dial address
    print(proxy.laddr, flush=True)
    logger.info("link proxy %s -> %s", proxy.laddr, args.upstream)
    done.wait()
    stats = proxy.stats()
    proxy.stop()
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
