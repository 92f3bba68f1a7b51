"""The port's node health plane (tendermint_tpu_torch/node/health.py)
against the JAX package's.

`health_report`, `health_gauges` and the load-shed ladder
(`OverloadMonitor`) of both packages read equal stub nodes — healthy,
fast-syncing, stalled, the device daemon's breaker open, a stuck WAL, a
poisoned pipeline, a mempool backlog — and give equal verdicts and
checks. The port's RPCServer serves the report on GET /health: 200 for ok
and degraded, 503 for failing, and a node-less context's note.
"""

from __future__ import annotations

import importlib
import json
import types
import urllib.error
import urllib.request

import pytest


def _pkg(root: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        health=importlib.import_module(f"{root}.node.health"),
        gateway=importlib.import_module(f"{root}.ops.gateway"),
    )


PORT = _pkg("tendermint_tpu_torch")
JAX = _pkg("tendermint_tpu")


class _Wal:
    def __init__(self, pending: int, sync_age_s: float):
        self._stats = {"pending": pending, "sync_age_s": sync_age_s}

    def stats(self):
        return dict(self._stats)


class _Executor:
    def __init__(self, backlog: int):
        self._queue = [None] * backlog


def stub_node(age_s=1.0, fast_sync=False, peers=(2, 1, 0), wal=(0, 0.0), poisoned=False,
              mempool=10, pool_cap=1000, backlog=0):
    """A node-shaped object holding what health_report and OverloadMonitor
    read: the consensus state's height age, round state, WAL, pipeline and
    apply executor; the fast-sync flag; the switch's peer counts; the
    mempool's depth and cap."""
    cs = types.SimpleNamespace(
        height_age_s=lambda: age_s,
        get_round_state=lambda: types.SimpleNamespace(height=12),
        wal=None if wal is None else _Wal(*wal),
        pipeline_poisoned=lambda: poisoned,
        _apply_executor=_Executor(backlog) if backlog else None,
    )
    return types.SimpleNamespace(
        consensus_state=cs,
        blockchain_reactor=types.SimpleNamespace(fast_sync=fast_sync),
        sw=types.SimpleNamespace(num_peers=lambda: peers),
        mempool=types.SimpleNamespace(size=lambda: mempool, pool_cap=pool_cap),
        flightrec=None,
    )


@pytest.fixture(autouse=True)
def fresh_breakers():
    for p in (PORT, JAX):
        p.gateway.reset_devd_breaker()
    yield
    for p in (PORT, JAX):
        p.gateway.reset_devd_breaker()


def _report(p, node) -> dict:
    out = p.health.health_report(node)
    assert isinstance(out.pop("time"), float)
    return out


CASES = {
    "healthy": (dict(), "ok"),
    "fast_syncing": (dict(age_s=500.0, fast_sync=True), "ok"),
    "slow_height": (dict(age_s=45.0), "degraded"),
    "stalled": (dict(age_s=200.0), "failing"),
    "wal_stuck": (dict(wal=(3, 60.0)), "degraded"),
    "wal_closed": (dict(wal=None), "ok"),
    "pipeline_poisoned": (dict(poisoned=True), "failing"),
    "mempool_backlog": (dict(mempool=60_000, pool_cap=100_000), "degraded"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_health_report_equal_jax(case):
    kw, want = CASES[case]
    port, jax = _report(PORT, stub_node(**kw)), _report(JAX, stub_node(**kw))
    assert port == jax
    assert port["status"] == want
    assert port["code"] == {"ok": 0, "degraded": 1, "failing": 2}[want]
    assert PORT.health.health_gauges(stub_node(**kw)) == JAX.health.health_gauges(stub_node(**kw))


def test_device_down_degrades_equal_jax(monkeypatch):
    """The device daemon's breaker open (the daemon's socket failing past
    the threshold) degrades the node in both packages, and the min-peers
    knob degrades a node with too few peers."""
    reports = []
    for p in (PORT, JAX):
        br = p.gateway.devd_breaker()
        while not br.record_failure():
            pass
        reports.append(_report(p, stub_node()))
    assert reports[0] == reports[1]
    assert reports[0]["status"] == "degraded"
    assert reports[0]["checks"]["breaker"]["state"] == 2
    monkeypatch.setenv("TENDERMINT_HEALTH_MIN_PEERS", "5")
    assert _report(PORT, stub_node()) == _report(JAX, stub_node())
    assert _report(PORT, stub_node())["checks"]["peers"]["status"] == "degraded"


@pytest.mark.parametrize("fill", [(10, 0), (800, 0), (950, 0), (10, 7)])
def test_overload_ladder_equal_jax(fill):
    """OverloadMonitor's level and snapshot from the mempool's fill and the
    apply backlog: ok, shed-reads, shed-writes, equal in both packages."""
    depth, backlog = fill
    snaps = [p.health.OverloadMonitor(stub_node(mempool=depth, backlog=backlog)).snapshot()
             for p in (PORT, JAX)]
    assert snaps[0] == snaps[1]


def _get(port: int, path: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.mark.parametrize("case", ["healthy", "slow_height", "stalled"])
def test_health_route(case):
    """GET /health on the port's RPCServer serves health_report of the
    context's node: 200 for ok and degraded, 503 for failing."""
    from tendermint_tpu_torch.rpc.core import RPCContext
    from tendermint_tpu_torch.rpc.server import RPCServer

    kw, want = CASES[case]
    srv = RPCServer("127.0.0.1:0", RPCContext(node=stub_node(**kw)))
    srv.start()
    try:
        status, body = _get(srv.port, "/health")
    finally:
        srv.stop()
    assert status == (503 if want == "failing" else 200)
    body.pop("time")
    assert body == _report(JAX, stub_node(**kw))


def test_health_route_without_a_node():
    from tendermint_tpu_torch.rpc.core import RPCContext
    from tendermint_tpu_torch.rpc.server import RPCServer

    srv = RPCServer("127.0.0.1:0", RPCContext())
    srv.start()
    try:
        status, body = _get(srv.port, "/health")
    finally:
        srv.stop()
    assert status == 200
    assert body == {"status": "ok", "code": 0, "checks": {}, "note": "no node in RPC context"}
