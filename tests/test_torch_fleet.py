"""The port's fleet observability plane (tendermint_tpu_torch/ops/fleet.py
with p2p/telemetry.py, consensus/trace.py's arrival marks and
node/health.py), on the cases of tests/test_fleet.py: per-peer p2p
instrumentation through a real MConnection, trace gossip-arrival marks,
the cross-node timeline math and the health verdict, everything
chip-free and harness-local. Beside them, both packages on the same
inputs: the same scrape parses, timelines and renders, the same channel
accounting for the same messages, and the same health verdicts."""

from __future__ import annotations

import io
import time

import pytest

from tendermint_tpu_torch.libs.telemetry import Registry
from tendermint_tpu_torch.p2p.conn import ChannelDescriptor, MConnConfig, MConnection
from tendermint_tpu_torch.p2p.stream import pipe_pair
from tendermint_tpu_torch.p2p.telemetry import PeerConnMetrics, peer_metrics


def wait_until(cond, timeout=10.0, tick=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


# -- p2p/telemetry through a real MConnection ----------------------------------


def _labeled_value(counter, **labels):
    return counter.labels(**labels).value


def test_mconn_per_peer_channel_accounting():
    """Messages over a real mconn pair land in the labeled send/recv
    families of the registry each side was armed with — per channel,
    bytes and whole messages both."""
    reg_a, reg_b = Registry(), Registry()
    descs = [ChannelDescriptor(id=0x01, priority=1, send_queue_capacity=4)]
    a, b = pipe_pair()
    recv_b, err = [], []
    ma = MConnection(a, descs, lambda ch, m: None, err.append, MConnConfig())
    mb = MConnection(b, descs, lambda ch, m: recv_b.append((ch, m)),
                     err.append, MConnConfig())
    ma.set_peer_label("peerB", reg_a)
    mb.set_peer_label("peerA", reg_b)
    ma.start()
    mb.start()
    try:
        msg = b"x" * 3000  # 3 packets
        assert ma.send(0x01, msg)
        assert wait_until(lambda: recv_b and recv_b[0] == (0x01, msg))
        fams_a, fams_b = peer_metrics(reg_a), peer_metrics(reg_b)
        lbl = {"peer": "peerB", "channel": "0x1"}
        assert wait_until(
            lambda: _labeled_value(fams_a["send_msgs"], **lbl) == 1
        )
        assert _labeled_value(fams_a["send_bytes"], **lbl) >= len(msg)
        lbl_b = {"peer": "peerA", "channel": "0x1"}
        assert _labeled_value(fams_b["recv_msgs"], **lbl_b) == 1
        assert _labeled_value(fams_b["recv_bytes"], **lbl_b) >= len(msg)
        # queue gauges sampled at enqueue
        assert fams_a["send_queue_high_water"].labels(**lbl).value >= 1
        # registries are independent: a's families never saw b's side
        assert _labeled_value(fams_a["recv_msgs"], **lbl) == 0
        assert not err
    finally:
        ma.stop()
        mb.stop()


def test_mconn_full_queue_send_failures_counted():
    """try_send against a full channel queue is counted on the per-peer
    send-failure series — the burst-load moment a wedge hides in."""
    reg = Registry()
    descs = [ChannelDescriptor(id=0x01, priority=1, send_queue_capacity=1)]
    a, _b = pipe_pair()
    mconn = MConnection(a, descs, lambda ch, m: None, lambda e: None,
                        MConnConfig())
    mconn.set_peer_label("victim", reg)
    # not started: nothing drains the queue, so the second try_send hits
    # a full queue deterministically — but try_send requires running
    mconn._started = True
    assert mconn.try_send(0x01, b"first")
    assert not mconn.try_send(0x01, b"second")
    assert not mconn.try_send(0x01, b"third")
    fams = peer_metrics(reg)
    child = fams["send_failures"].labels(peer="victim", channel="0x1")
    assert child.value == 2
    mconn._started = False


def test_peer_conn_metrics_ping_rtt():
    pm = PeerConnMetrics("p1", [0x01], Registry())
    pm.ping_sent()
    time.sleep(0.01)
    pm.pong_received()
    assert pm._ping_rtt.count == 1
    assert pm._ping_rtt.sum >= 0.009
    pm.pong_received()  # unsolicited pong: no double observation
    assert pm._ping_rtt.count == 1


# -- trace arrival marks -------------------------------------------------------


def test_trace_recorder_arrival_marks_first_wins_and_feed_hists():
    from tendermint_tpu_torch.consensus.trace import TraceRecorder

    reg = Registry()
    rec = TraceRecorder(device_probe=None, ring=4)
    rec.metrics_registry = reg
    rec.begin(7, now=100.0)
    rec._started_wall = 1000.0  # pin the wall clock for the math below
    rec.mark_arrival("first_block_part", at=1000.2)
    rec.mark_arrival("first_block_part", at=1000.9)  # duplicate: first wins
    rec.mark_arrival("prevote_quorum", at=1000.5)
    rec.mark_arrival("precommit_quorum", at=1000.8)
    rec.mark_arrival("commit", at=1000.9)
    tr = rec.finish(7, wall_s=1.0, now=101.0)
    assert tr.arrivals["first_block_part"] == 1000.2
    assert tr.started_at == 1000.0
    assert tr.to_json()["arrivals"]["prevote_quorum"] == 1000.5
    # the scrape-side distributions got exactly one observation each
    from tendermint_tpu_torch.consensus.trace import arrival_hists

    hists = arrival_hists(reg)
    assert hists["quorum"].labels(phase="prevote").count == 1
    assert hists["quorum"].labels(phase="prevote").sum == pytest.approx(0.5)
    assert hists["quorum"].labels(phase="precommit").sum == pytest.approx(0.8)
    assert hists["first_part"].count == 1
    # the next height starts with a clean slate
    rec.begin(8, now=101.0)
    tr2 = rec.finish(8, wall_s=0.5, now=101.5)
    assert tr2.arrivals == {}
    assert hists["quorum"].labels(phase="prevote").count == 1


# -- ops/fleet: scrape parsing + timeline math ---------------------------------


def test_parse_prometheus_and_metric_value():
    from tendermint_tpu_torch.ops.fleet import metric_value, parse_prometheus

    text = "\n".join([
        "# HELP consensus_height position",
        "# TYPE consensus_height gauge",
        "consensus_height 42",
        'p2p_peer_vote_gossip_sends_total{peer="aa"} 3',
        'p2p_peer_vote_gossip_sends_total{peer="bb"} 4',
        'consensus_quorum_seconds_bucket{phase="precommit",le="+Inf"} 9',
        'consensus_quorum_seconds_sum{phase="precommit"} 1.25',
        "weird_line_that_should_be_ignored{",
    ])
    m = parse_prometheus(text)
    assert metric_value(m, "consensus_height") == 42
    # several series, no label filter: the sum
    assert metric_value(m, "p2p_peer_vote_gossip_sends_total") == 7
    assert metric_value(m, "p2p_peer_vote_gossip_sends_total",
                        {"peer": "bb"}) == 4
    assert metric_value(m, "consensus_quorum_seconds_sum",
                        {"phase": "precommit"}) == 1.25
    assert metric_value(
        m, "consensus_quorum_seconds_bucket",
        {"phase": "precommit", "le": "+Inf"},
    ) == 9
    assert metric_value(m, "missing", default=-1) == -1


def _trace(height, start, first_part=None, prevote=None, precommit=None,
           commit=None):
    arr = {}
    if first_part is not None:
        arr["first_block_part"] = start + first_part
    if prevote is not None:
        arr["prevote_quorum"] = start + prevote
    if precommit is not None:
        arr["precommit_quorum"] = start + precommit
    if commit is not None:
        arr["commit"] = start + commit
    return {
        "height": height, "started_at": start, "arrivals": arr,
        "wall_s": (commit or 1.0), "rounds": 1,
        "completed_at": start + (commit or 1.0),
    }


def test_build_timeline_cross_node_math():
    """Three nodes' traces join into per-height rows: propagation lag is
    the first-part spread, quorum time the per-node max, commit skew the
    finalize spread — and absent marks degrade to None, not crashes."""
    from tendermint_tpu_torch.ops.fleet import build_timeline

    per_node = {
        "n0": [_trace(10, 1000.0, first_part=0.00, prevote=0.10,
                      precommit=0.20, commit=0.25),
               _trace(11, 1001.0, first_part=0.00, precommit=0.30,
                      commit=0.40)],
        "n1": [_trace(10, 1000.0, first_part=0.05, prevote=0.12,
                      precommit=0.22, commit=0.30)],
        "n2": [_trace(10, 1000.0, first_part=0.15, prevote=0.18,
                      precommit=0.28, commit=0.45),
               # catchup height: no quorum marks at all
               _trace(11, 1001.0, commit=0.60)],
    }
    rows = build_timeline(per_node, last=10)
    assert [r["height"] for r in rows] == [11, 10]
    r10 = rows[1]
    assert r10["nodes_reporting"] == 3
    assert r10["propagation_lag_s"] == pytest.approx(0.15)
    assert r10["prevote_quorum_s_max"] == pytest.approx(0.18)
    assert r10["precommit_quorum_s_max"] == pytest.approx(0.28)
    assert r10["precommit_quorum_s_min"] == pytest.approx(0.20)
    assert r10["commit_skew_s"] == pytest.approx(0.20)
    r11 = rows[0]
    assert r11["nodes_reporting"] == 2
    assert r11["propagation_lag_s"] is None  # one first-part mark only
    assert r11["prevote_quorum_s_max"] is None
    assert r11["commit_skew_s"] == pytest.approx(0.20)
    # per-node detail survives for the renderer
    assert r10["per_node"]["n2"]["precommit_quorum_s"] == pytest.approx(0.28)

    # the `last` window keeps the newest heights
    assert [r["height"] for r in build_timeline(per_node, last=1)] == [11]


def test_fleet_render_handles_partial_fleet():
    from tendermint_tpu_torch.ops.fleet import build_timeline, render

    snapshot = {
        "up:46657": {
            "metrics": {"consensus_height": [({}, 5.0)],
                        "p2p_peers_outbound": [({}, 2.0)],
                        "p2p_peers_inbound": [({}, 1.0)]},
            "health": {"status": "ok"},
            "traces": [_trace(5, 1000.0, first_part=0.0, commit=0.2)],
        },
        "down:46657": {"error": "URLError: refused"},
    }
    rows = build_timeline(
        {u: e.get("traces", []) for u, e in snapshot.items()}
    )
    buf = io.StringIO()
    render(snapshot, rows, out=buf)
    out = buf.getvalue()
    assert "UNREACHABLE" in out
    assert "health ok" in out
    assert "5" in out


# -- node/health verdict -------------------------------------------------------


class _FakeWal:
    def __init__(self, pending=0, age=0.0):
        self._pending, self._age = pending, age

    def stats(self):
        return {"pending": self._pending, "sync_age_s": self._age}


class _FakeCS:
    def __init__(self, age=0.5, poisoned=False, wal=None):
        self._age, self._poisoned = age, poisoned
        self.wal = wal if wal is not None else _FakeWal()

    def height_age_s(self):
        return self._age

    def pipeline_poisoned(self):
        return self._poisoned

    def get_round_state(self):
        class _RS:
            height = 9

        return _RS()


class _FakeSwitch:
    def __init__(self, peers=3):
        self._peers = peers

    def num_peers(self):
        return self._peers, 0, 0


class _FakeMempool:
    def __init__(self, n=1):
        self._n = n

    def size(self):
        return self._n


class _FakeBC:
    fast_sync = False


class _FakeNode:
    def __init__(self, **kw):
        self.consensus_state = kw.get("cs", _FakeCS())
        self.sw = kw.get("sw", _FakeSwitch())
        self.mempool = kw.get("mempool", _FakeMempool())
        self.blockchain_reactor = kw.get("bc", _FakeBC())


def test_health_verdict_ok_degraded_failing(monkeypatch):
    from tendermint_tpu_torch.node.health import health_gauges, health_report

    report = health_report(_FakeNode())
    assert report["status"] == "ok" and report["code"] == 0

    # stalled height -> degraded, then failing at the bigger budget
    monkeypatch.setenv("TENDERMINT_HEALTH_HEIGHT_AGE_DEGRADED_S", "10")
    monkeypatch.setenv("TENDERMINT_HEALTH_HEIGHT_AGE_FAILING_S", "100")
    assert health_report(_FakeNode(cs=_FakeCS(age=11)))["status"] == "degraded"
    assert health_report(_FakeNode(cs=_FakeCS(age=101)))["status"] == "failing"
    # ... unless fast sync is active (catching up, not stalled)
    class _Syncing(_FakeBC):
        fast_sync = True

    assert health_report(
        _FakeNode(cs=_FakeCS(age=101), bc=_Syncing())
    )["checks"]["height_age"]["status"] == "ok"

    # a poisoned pipeline is FAILING no matter what else says
    report = health_report(_FakeNode(cs=_FakeCS(poisoned=True)))
    assert report["status"] == "failing"
    assert report["checks"]["pipeline"]["status"] == "failing"

    # the peers gate only engages when the knob says so
    assert health_report(_FakeNode(sw=_FakeSwitch(0)))["status"] == "ok"
    monkeypatch.setenv("TENDERMINT_HEALTH_MIN_PEERS", "2")
    report = health_report(_FakeNode(sw=_FakeSwitch(0)))
    assert report["status"] == "degraded"
    assert report["checks"]["peers"]["status"] == "degraded"

    # stuck WAL flusher: pending records with a growing sync age
    monkeypatch.setenv("TENDERMINT_HEALTH_WAL_SYNC_AGE_S", "5")
    report = health_report(
        _FakeNode(cs=_FakeCS(wal=_FakeWal(pending=3, age=9.0)))
    )
    assert report["checks"]["wal"]["status"] == "degraded"

    # mempool backlog
    monkeypatch.setenv("TENDERMINT_HEALTH_MEMPOOL_DEGRADED", "10")
    report = health_report(_FakeNode(mempool=_FakeMempool(50)))
    assert report["checks"]["mempool"]["status"] == "degraded"

    # the flat gauge view mirrors the verdict
    monkeypatch.delenv("TENDERMINT_HEALTH_MIN_PEERS")
    monkeypatch.delenv("TENDERMINT_HEALTH_MEMPOOL_DEGRADED")
    g = health_gauges(_FakeNode(cs=_FakeCS(age=11)))
    assert g["status"] == 1 and g["checks_degraded"] == 1
    assert g["checks_failing"] == 0


# -- against the JAX package ----------------------------------------------------


SCRAPE = "\n".join([
    "# HELP consensus_height position",
    "# TYPE consensus_height gauge",
    "consensus_height 42",
    "p2p_peers_outbound 2",
    "p2p_peers_inbound 1",
    'p2p_peer_vote_gossip_sends_total{peer="aa",channel="0x22"} 3',
    'p2p_peer_vote_gossip_sends_total{peer="bb",channel="0x22"} 4',
    'p2p_peer_vote_gossip_send_failures_total{peer="bb",channel="0x22"} 1',
    'consensus_quorum_seconds_bucket{phase="precommit",le="+Inf"} 9',
    'consensus_quorum_seconds_bucket{phase="precommit",le="0.5"} 7',
    'consensus_quorum_seconds_sum{phase="precommit"} 1.25',
    'weird_label{note="a \\"quoted\\" \\\\ slash\\nline"} -Inf',
    "odd_nan NaN",
    "weird_line_that_should_be_ignored{",
    "",
])


def _snapshot():
    return {
        "a:46657": {
            "metrics": None,  # filled per package by its own parser
            "health": {"status": "ok"},
            "traces": [_trace(10, 1000.0, first_part=0.00, prevote=0.10, precommit=0.20, commit=0.25),
                       _trace(11, 1001.0, first_part=0.00, precommit=0.30, commit=0.40)],
        },
        "b:46657": {
            "metrics": None,
            "health": {"status": "degraded"},
            "traces": [_trace(10, 1000.0, first_part=0.05, prevote=0.12, precommit=0.22, commit=0.30),
                       _trace(11, 1001.0, commit=0.60)],
        },
        "c:46657": {"error": "URLError: refused"},
    }


def _fleet_outputs(fleet) -> dict:
    parsed = fleet.parse_prometheus(SCRAPE)
    snapshot = _snapshot()
    for entry in snapshot.values():
        if "error" not in entry:
            entry["metrics"] = parsed
    rows = {last: fleet.build_timeline({u: e.get("traces", []) for u, e in snapshot.items()}, last=last)
            for last in (1, 2, 10)}
    buf = io.StringIO()
    fleet.render(snapshot, rows[10], out=buf)
    empty = io.StringIO()
    fleet.render({}, [], out=empty)
    queries = [("consensus_height", None), ("p2p_peer_vote_gossip_sends_total", None),
               ("p2p_peer_vote_gossip_sends_total", {"peer": "bb"}),
               ("consensus_quorum_seconds_bucket", {"phase": "precommit", "le": "0.5"}),
               ("weird_label", None), ("missing", None)]
    return {
        "parsed": {k: [(lbl, repr(v)) for lbl, v in s] for k, s in parsed.items()},
        "values": [repr(fleet.metric_value(parsed, n, lbl, default=-1)) for n, lbl in queries],
        "rows": rows,
        "summary": fleet.fleet_summary(snapshot),
        "render": buf.getvalue(),
        "render_empty": empty.getvalue(),
    }


def test_scrape_timeline_and_render_equal_across_packages():
    """The same scrape text and traces through both packages' ops/fleet:
    equal parses (escaped labels, +/-Inf and NaN), metric reads,
    timelines at each window, fleet summaries and rendered tables."""
    from tendermint_tpu.ops import fleet as jfleet
    from tendermint_tpu_torch.ops import fleet

    port, jax = _fleet_outputs(fleet), _fleet_outputs(jfleet)
    assert port == jax
    assert port["parsed"]["weird_label"][0][0] == {"note": 'a "quoted" \\ slash\nline'}
    assert [r["height"] for r in port["rows"][10]] == [11, 10]
    assert "UNREACHABLE" in port["render"] and "health degraded" in port["render"]


def _mconn_accounting(p) -> dict:
    """One package's MConnection pair carrying the same messages on two
    channels: the labeled send/recv families of each side's registry."""
    reg_a, reg_b = p["Registry"](), p["Registry"]()
    descs = [p["ChannelDescriptor"](id=0x01, priority=1, send_queue_capacity=4),
             p["ChannelDescriptor"](id=0x22, priority=5, send_queue_capacity=8)]
    a, b = p["pipe_pair"]()
    recv_b, err = [], []
    ma = p["MConnection"](a, descs, lambda ch, m: None, err.append, p["MConnConfig"]())
    mb = p["MConnection"](b, descs, lambda ch, m: recv_b.append((ch, m)), err.append, p["MConnConfig"]())
    ma.set_peer_label("peerB", reg_a)
    mb.set_peer_label("peerA", reg_b)
    ma.start()
    mb.start()
    msgs = [(0x01, b"x" * 3000), (0x22, b"vote"), (0x01, b"y" * 10), (0x22, bytes(range(256)) * 9)]
    try:
        for ch, m in msgs:
            assert ma.send(ch, m)
        assert wait_until(lambda: len(recv_b) == len(msgs))
        fams_a, fams_b = p["peer_metrics"](reg_a), p["peer_metrics"](reg_b)
        assert wait_until(lambda: sum(fams_a["send_msgs"].labels(peer="peerB", channel=c).value
                                      for c in ("0x1", "0x22")) == len(msgs))
        out = {}
        for ch in ("0x1", "0x22"):
            for fam in ("send_msgs", "send_bytes"):
                out[(fam, ch)] = fams_a[fam].labels(peer="peerB", channel=ch).value
            for fam in ("recv_msgs", "recv_bytes"):
                out[(fam, ch)] = fams_b[fam].labels(peer="peerA", channel=ch).value
            out[("recv_msgs_on_a", ch)] = fams_a["recv_msgs"].labels(peer="peerB", channel=ch).value
        return {"families": out, "received": sorted(recv_b), "errors": [repr(e) for e in err]}
    finally:
        ma.stop()
        mb.stop()


def _pkg_p2p(root: str) -> dict:
    import importlib

    conn = importlib.import_module(f"{root}.p2p.conn")
    return {"Registry": importlib.import_module(f"{root}.libs.telemetry").Registry,
            "ChannelDescriptor": conn.ChannelDescriptor, "MConnConfig": conn.MConnConfig,
            "MConnection": conn.MConnection, "pipe_pair": importlib.import_module(f"{root}.p2p.stream").pipe_pair,
            "peer_metrics": importlib.import_module(f"{root}.p2p.telemetry").peer_metrics}


def test_mconn_channel_accounting_equal_across_packages():
    """The same messages over each package's MConnection pair: the same
    per-peer, per-channel message and byte counts on both sides."""
    port = _mconn_accounting(_pkg_p2p("tendermint_tpu_torch"))
    jax = _mconn_accounting(_pkg_p2p("tendermint_tpu"))
    assert port == jax
    assert port["families"][("send_msgs", "0x1")] == 2 and port["families"][("recv_msgs", "0x22")] == 2
    assert not port["errors"]


class _Syncing(_FakeBC):
    fast_sync = True


AGE_KNOBS = {"TENDERMINT_HEALTH_HEIGHT_AGE_DEGRADED_S": "10", "TENDERMINT_HEALTH_HEIGHT_AGE_FAILING_S": "100"}
HEALTH_CASES = {  # name: (env knobs, the fake node)
    "ok": ({}, lambda: _FakeNode()),
    "stalled_degraded": (AGE_KNOBS, lambda: _FakeNode(cs=_FakeCS(age=11))),
    "stalled_failing": (AGE_KNOBS, lambda: _FakeNode(cs=_FakeCS(age=101))),
    "fast_syncing": (AGE_KNOBS, lambda: _FakeNode(cs=_FakeCS(age=101), bc=_Syncing())),
    "poisoned": ({}, lambda: _FakeNode(cs=_FakeCS(poisoned=True))),
    "too_few_peers": ({"TENDERMINT_HEALTH_MIN_PEERS": "2"}, lambda: _FakeNode(sw=_FakeSwitch(0))),
    "stuck_wal": ({"TENDERMINT_HEALTH_WAL_SYNC_AGE_S": "5"},
                  lambda: _FakeNode(cs=_FakeCS(wal=_FakeWal(pending=3, age=9.0)))),
    "mempool_backlog": ({"TENDERMINT_HEALTH_MEMPOOL_DEGRADED": "10"}, lambda: _FakeNode(mempool=_FakeMempool(50))),
}


@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_health_verdicts_equal_across_packages(case, monkeypatch):
    """The same node state and thresholds through both packages'
    node/health: equal reports and equal flat gauges."""
    from tendermint_tpu.node import health as jhealth
    from tendermint_tpu_torch.node import health

    env, node = HEALTH_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def verdict(h):
        report = h.health_report(node())
        assert report.pop("time") > 0  # the instant of the report
        return report, h.health_gauges(node())

    assert verdict(health) == verdict(jhealth)
