"""Node health plane: GET /health + node_health_* gauges.

Before this, netchaos scenarios and probes asserted liveness by reaching
into harness objects (frozen height vectors, peer sets). This module
folds the node's existing liveness signals into ONE ok/degraded/failing
verdict served on the RPC listener (rpc/server.py GET /health), so
k8s-style probes and the fleet aggregator (ops/fleet.py) assert on the
observable surface:

    height age      seconds since the current height opened vs the
                    consensus_height_seconds liveness budget (a stalled
                    chain is a growing age) — waived while fast sync is
                    active (catching up is not a stall)
    peers           connected peer count vs TENDERMINT_HEALTH_MIN_PEERS
                    (default 0 = not gated: a sole-validator devnode is
                    healthy with zero peers)
    breaker         the shared device-plane circuit breaker — OPEN means
                    the node runs on the CPU fallback (degraded, alive)
    wal             pending records with a growing sync age = the group-
                    commit flusher is stuck, not merely idle
    pipeline        a poisoned deferred apply wedges the join = FAILING
    mempool         depth beyond the backlog knob = ingress pressure

Verdict: failing if any check fails, degraded if any degrades, else ok.
HTTP: 200 for ok/degraded, 503 for failing (probes key off the status
code; the body is machine-readable either way). Every threshold is an
env knob (libs/envknob — a typo'd value keeps the default):

    TENDERMINT_HEALTH_HEIGHT_AGE_DEGRADED_S   (30)
    TENDERMINT_HEALTH_HEIGHT_AGE_FAILING_S    (120)
    TENDERMINT_HEALTH_MIN_PEERS               (0)
    TENDERMINT_HEALTH_WAL_SYNC_AGE_S          (30)
    TENDERMINT_HEALTH_MEMPOOL_DEGRADED        (50000)

The load-shed ladder (OverloadMonitor below,
docs/serving.md): one pressure score folded from mempool depth, RPC
in-flight, WS queue depths, and the apply backlog, mapped to
ok -> shed-reads -> shed-writes and consulted by rpc/admission and the
mempool's lane admission. Ladder knobs:

    TENDERMINT_OVERLOAD_SHED_READS_AT         (0.75)
    TENDERMINT_OVERLOAD_SHED_WRITES_AT        (0.90)
    TENDERMINT_OVERLOAD_APPLY_BACKLOG_CAP     (8)

The flat ``node_health_*`` gauges (node/telemetry.py wires the producer)
export the same verdict numerically: status 0=ok / 1=degraded /
2=failing, so alerting needs no JSON endpoint.
"""

from __future__ import annotations

import time

from tendermint_tpu_torch.libs.envknob import env_number

OK, DEGRADED, FAILING = "ok", "degraded", "failing"
_CODE = {OK: 0, DEGRADED: 1, FAILING: 2}


def _knobs() -> dict:
    """Read per call: the netchaos tier tightens these live via env."""
    return {
        "height_age_degraded_s": float(
            env_number("TENDERMINT_HEALTH_HEIGHT_AGE_DEGRADED_S", 30.0)
        ),
        "height_age_failing_s": float(
            env_number("TENDERMINT_HEALTH_HEIGHT_AGE_FAILING_S", 120.0)
        ),
        "min_peers": int(env_number("TENDERMINT_HEALTH_MIN_PEERS", 0,
                                    cast=int)),
        "wal_sync_age_s": float(
            env_number("TENDERMINT_HEALTH_WAL_SYNC_AGE_S", 30.0)
        ),
        "mempool_degraded": int(
            env_number("TENDERMINT_HEALTH_MEMPOOL_DEGRADED", 50_000,
                       cast=int)
        ),
    }


def _worst(a: str, b: str) -> str:
    return a if _CODE[a] >= _CODE[b] else b


def health_report(node) -> dict:
    """The /health body. Direct attribute reads (the loud-wiring
    convention): a renamed producer field raises here and surfaces as a
    500 probe failure — which monitoring alerts on — never as a
    healthy-looking 200 with a silently missing check."""
    k = _knobs()
    cs = node.consensus_state
    checks: dict[str, dict] = {}
    status = OK

    # -- height age (liveness) --------------------------------------------
    age = cs.height_age_s()
    fast_sync = bool(node.blockchain_reactor.fast_sync)
    if fast_sync:
        hstatus = OK  # catching up, not stalled; fastsync_* gauges cover it
    elif age >= k["height_age_failing_s"]:
        hstatus = FAILING
    elif age >= k["height_age_degraded_s"]:
        hstatus = DEGRADED
    else:
        hstatus = OK
    checks["height_age"] = {
        "status": hstatus, "age_s": round(age, 3),
        "height": cs.get_round_state().height,
        "fast_sync": fast_sync,
        "degraded_at_s": k["height_age_degraded_s"],
        "failing_at_s": k["height_age_failing_s"],
    }
    status = _worst(status, hstatus)

    # -- peers -------------------------------------------------------------
    outbound, inbound, dialing = node.sw.num_peers()
    peers = outbound + inbound
    pstatus = DEGRADED if peers < k["min_peers"] else OK
    checks["peers"] = {
        "status": pstatus, "peers": peers, "dialing": dialing,
        "min_peers": k["min_peers"],
    }
    status = _worst(status, pstatus)

    # -- device-plane breaker ----------------------------------------------
    from tendermint_tpu_torch.ops import gateway

    br = gateway.devd_breaker().stats()
    bstatus = DEGRADED if br["breaker_state"] == 2 else OK
    # sharded device plane: any OPEN endpoint breaker means
    # the fleet runs at reduced capacity — degraded, alive. Reads only
    # breakers that EXIST (devd_breaker_states never instantiates), so a
    # single-socket node sees exactly the primary-breaker check above.
    ep_states = gateway.devd_breaker_states()
    ep_open = sum(1 for s in ep_states.values() if s == 2)
    if ep_open and len(ep_states) > 1:
        bstatus = _worst(bstatus, DEGRADED)
    checks["breaker"] = {"status": bstatus, "state": br["breaker_state"],
                         "opens": br["breaker_opens"],
                         "device_endpoints": len(ep_states),
                         "device_endpoints_open": ep_open}
    status = _worst(status, bstatus)

    # -- WAL flusher -------------------------------------------------------
    wal = cs.wal
    if wal is None:
        checks["wal"] = {"status": OK, "open": False}
    else:
        ws = wal.stats()
        wstatus = (
            DEGRADED
            if ws["pending"] > 0 and ws["sync_age_s"] > k["wal_sync_age_s"]
            else OK
        )
        checks["wal"] = {
            "status": wstatus, "open": True, "pending": ws["pending"],
            "sync_age_s": ws["sync_age_s"],
        }
        status = _worst(status, wstatus)

    # -- execution pipeline ------------------------------------------------
    poisoned = cs.pipeline_poisoned()
    checks["pipeline"] = {"status": FAILING if poisoned else OK,
                          "poisoned": poisoned}
    status = _worst(status, checks["pipeline"]["status"])

    # -- mempool backlog ---------------------------------------------------
    depth = node.mempool.size()
    mstatus = DEGRADED if depth >= k["mempool_degraded"] else OK
    checks["mempool"] = {"status": mstatus, "size": depth,
                         "degraded_at": k["mempool_degraded"]}
    status = _worst(status, mstatus)

    # flight recorder: every health evaluation — scrape,
    # probe, or the watchdog — feeds the verdict to the recorder, which
    # records CHANGES and auto-dumps the event ring exactly once per
    # transition into failing (node/flightrec.py)
    fr = getattr(node, "flightrec", None)
    if fr is not None:
        fr.note_health(status)

    return {
        "status": status,
        "code": _CODE[status],
        "time": time.time(),
        "checks": checks,
    }


def health_gauges(node) -> dict:
    """Flat numeric view for the telemetry registry (node_health_*
    families on both surfaces): the verdict, the liveness age, and how
    many checks sit at each severity."""
    report = health_report(node)
    checks = report["checks"].values()
    return {
        "status": report["code"],
        "height_age_s": report["checks"]["height_age"]["age_s"],
        "peers": report["checks"]["peers"]["peers"],
        "mempool_size": report["checks"]["mempool"]["size"],
        "checks_degraded": sum(1 for c in checks if c["status"] == DEGRADED),
        "checks_failing": sum(1 for c in checks if c["status"] == FAILING),
    }


# -- load-shed ladder (docs/serving.md) ---------------------------

PRESSURE_OK = 0
PRESSURE_SHED_READS = 1
PRESSURE_SHED_WRITES = 2
PRESSURE_NAMES = {PRESSURE_OK: "ok", PRESSURE_SHED_READS: "shed_reads",
                  PRESSURE_SHED_WRITES: "shed_writes"}


def _ladder_knobs() -> dict:
    """Read per call (live-tunable). The score is the max fill fraction
    across the pressure inputs; the rungs are fractions of saturation."""
    return {
        "shed_reads_at": float(
            env_number("TENDERMINT_OVERLOAD_SHED_READS_AT", 0.75)),
        "shed_writes_at": float(
            env_number("TENDERMINT_OVERLOAD_SHED_WRITES_AT", 0.90)),
        "apply_backlog_cap": int(
            env_number("TENDERMINT_OVERLOAD_APPLY_BACKLOG_CAP", 8, cast=int)),
    }


class OverloadMonitor:
    """ONE pressure signal for every ingress layer (the tentpole's
    ladder): folds mempool depth, RPC in-flight, WS send-queue depth and
    the apply-executor backlog into a saturation score, maps the score
    to a level (ok -> shed-reads -> shed-writes), and records a
    flight-recorder ``overload`` event on every level transition.

    Consulted per request by rpc/admission and per admit by the mempool,
    so the evaluation is cached for `ttl_s` — attribute reads only, but
    thousands of requests/s shouldn't each walk the WS registry.
    Consensus lanes (p2p vote/part channels, the apply executor) never
    consult it: the ladder sheds edge traffic, never the core."""

    def __init__(self, node, ttl_s: float = 0.25):
        self.node = node
        self.ttl_s = ttl_s
        self._mtx = None  # plain attrs; races only re-evaluate the cache
        self._cached_at = 0.0
        self._level = PRESSURE_OK
        self._score = 0.0
        self._inputs: dict = {}
        self.transitions = 0

    def level(self) -> int:
        now = time.monotonic()
        if now - self._cached_at >= self.ttl_s:
            self._evaluate(now)
        return self._level

    def snapshot(self) -> dict:
        """Flat view for the node_overload_* telemetry producer."""
        self.level()
        out = {"level": self._level, "score": round(self._score, 4),
               "transitions": self.transitions}
        for k, v in self._inputs.items():
            out[f"frac_{k}"] = round(v, 4)
        return out

    def _evaluate(self, now: float) -> None:
        k = _ladder_knobs()
        node = self.node
        inputs: dict[str, float] = {}

        mp = node.mempool
        cap = mp.pool_cap
        inputs["mempool"] = (mp.size() / cap) if cap else 0.0

        admission = getattr(node, "rpc_admission", None)
        if admission is not None:
            max_inflight = admission.max_inflight()
            inputs["rpc_inflight"] = (
                admission.inflight / max_inflight if max_inflight else 0.0)
            inputs["ws_queue"] = admission.ws_queue_frac()

        cs = node.consensus_state
        backlog = (len(cs._apply_executor._queue)
                   if cs._apply_executor is not None else 0)
        inputs["apply_backlog"] = min(
            1.0, backlog / max(1, k["apply_backlog_cap"]))

        score = max(inputs.values()) if inputs else 0.0
        if score >= k["shed_writes_at"]:
            level = PRESSURE_SHED_WRITES
        elif score >= k["shed_reads_at"]:
            level = PRESSURE_SHED_READS
        else:
            level = PRESSURE_OK
        prev = self._level
        self._score = score
        self._inputs = inputs
        self._level = level
        self._cached_at = now
        if level != prev:
            self.transitions += 1
            fr = getattr(node, "flightrec", None)
            if fr is not None:
                fr.record(
                    "overload",
                    level=PRESSURE_NAMES[level],
                    prev=PRESSURE_NAMES[prev],
                    score=round(score, 4),
                    **{f"frac_{k_}": round(v, 4) for k_, v in inputs.items()},
                )
