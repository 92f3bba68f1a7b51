"""The gateway's breaker plane on the devd route, the port's telemetry
registry, and the devd route's edges: the port's CircuitBreaker against
the JAX package's under one injected clock, a daemon killed and restarted
under a live Verifier and Hasher, exposition text against the JAX
package's, the aggregate op, the round-trip probe, and the multi-daemon
plane's route. Daemons as in test_torch_devd."""

from __future__ import annotations

import shutil
import time
import types

import pytest

from test_torch_devd import SIM_DAEMON_S, DevdProc, signed_items
from tendermint_tpu.libs import telemetry as jtelemetry
from tendermint_tpu.ops import gateway as jgateway
from tendermint_tpu_torch import devd
from tendermint_tpu_torch.crypto.hashing import ripemd160
from tendermint_tpu_torch.libs import telemetry
from tendermint_tpu_torch.ops import devd_backend, gateway

SIM = {"TENDERMINT_DEVD_SIM_RATE": "100000"}


class Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


def _fake_time(clock: Clock):
    return types.SimpleNamespace(monotonic=clock.monotonic, perf_counter=time.perf_counter,
                                 time=time.time, sleep=time.sleep)


# each step: ("fail",), ("ok",), ("allow", probe answer or None), ("tick", seconds)
SEQUENCES = {
    "probe_recovers": [("fail",), ("fail",), ("allow", None), ("fail",), ("allow", None),
                       ("tick", 0.1), ("allow", None), ("tick", 2.0), ("allow", False),
                       ("allow", None), ("tick", 0.5), ("allow", None), ("tick", 5.0),
                       ("allow", True), ("allow", None), ("fail",), ("ok",), ("fail",)],
    "probe_raises_then_recovers": [("fail",), ("fail",), ("fail",), ("tick", 1.0),
                                   ("allow", "raise"), ("tick", 3.0), ("allow", "raise"),
                                   ("tick", 9.0), ("allow", True), ("fail",), ("fail",),
                                   ("fail",), ("tick", 0.3), ("ok",)],
    "trial_mode": [("fail",), ("fail",), ("fail",), ("allow", None), ("tick", 1.0),
                   ("trial",), ("allow", None), ("fail",), ("tick", 2.5), ("trial",), ("ok",),
                   ("allow", None), ("fail",)],
}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_breaker_states_and_stats_equal_jax(monkeypatch, seq):
    """Fed the same failures, successes and probe answers under one
    injected clock and jitter seed, the two breakers give the same
    states, allow() answers and stats() after every step."""
    clock = Clock()
    monkeypatch.setattr(gateway, "time", _fake_time(clock))
    monkeypatch.setattr(jgateway, "time", _fake_time(clock))
    answers: dict[str, list] = {"port": [], "jax": []}

    def probe_of(name):
        def probe():
            answer = answers[name].pop(0)
            if answer == "raise":
                raise ConnectionError("probe failed")
            return answer
        return probe

    trial = seq == "trial_mode"
    closes = {"port": 0, "jax": 0}
    made = {}
    for name, mod in (("port", gateway), ("jax", jgateway)):
        made[name] = mod.CircuitBreaker(
            threshold=3, base_backoff_s=0.5, max_backoff_s=4.0, seed=7,
            probe=None if trial else probe_of(name),
            on_close=lambda name=name: closes.__setitem__(name, closes[name] + 1))
    for step in SEQUENCES[seq]:
        out = {}
        for name, br in made.items():
            if step[0] == "fail":
                out[name] = br.record_failure()
            elif step[0] == "ok":
                out[name] = br.record_success()
            elif step[0] in ("allow", "trial"):
                if step[0] == "allow" and step[1] is not None:
                    answers[name].append(step[1])
                out[name] = br.allow()
            else:
                out[name] = None
            answers[name].clear()  # an answer no probe asked for is dropped
        if step[0] == "tick":
            clock.now += step[1]
        assert out["port"] == out["jax"], step
        assert made["port"].state == made["jax"].state, step
        assert made["port"].stats() == made["jax"].stats(), step
    assert closes["port"] == closes["jax"] >= 1


def test_breaker_knobs_read_as_in_jax(monkeypatch):
    monkeypatch.setenv("TENDERMINT_TPU_BREAKER_FAILURES", "5")
    monkeypatch.setenv("TENDERMINT_TPU_BREAKER_BACKOFF_S", "oops")
    monkeypatch.setenv("TENDERMINT_TPU_BREAKER_BACKOFF_CAP_S", "2.5")
    mine, theirs = gateway.CircuitBreaker(), jgateway.CircuitBreaker()
    assert (mine.threshold, mine.base_backoff_s, mine.max_backoff_s) == \
        (theirs.threshold, theirs.base_backoff_s, theirs.max_backoff_s) == (5, 0.5, 2.5)


@pytest.fixture
def fast_breaker(monkeypatch):
    monkeypatch.setenv("TENDERMINT_TPU_BREAKER_BACKOFF_S", "0.05")
    monkeypatch.setenv("TENDERMINT_TPU_BREAKER_BACKOFF_CAP_S", "0.2")
    monkeypatch.delenv("TENDERMINT_TPU_KERNEL", raising=False)
    monkeypatch.delenv("TENDERMINT_TPU_HASHES", raising=False)
    monkeypatch.delenv("TENDERMINT_TPU_DISABLE", raising=False)
    monkeypatch.setattr(gateway, "_rtt_cache", {})

    def point(sock: str) -> None:
        monkeypatch.setenv("TENDERMINT_DEVD_SOCK", sock)
        monkeypatch.setattr(devd_backend, "_client", None)
        devd.bust_avail_cache()
        gateway.reset_devd_breaker()
        devd_backend.reset_stream_latches()

    yield point
    if devd_backend._client is not None:
        devd_backend._client.close()
    monkeypatch.setattr(devd_backend, "_client", None)
    devd.bust_avail_cache()
    gateway.reset_devd_breaker()


def test_killed_daemon_opens_the_breaker_and_a_restart_closes_it(fast_breaker):
    """Kill the daemon under a live Verifier and Hasher: the breaker opens
    after its threshold, the lanes verify on the CPU floor (counted in
    cpu_sigs, the verdicts still right) and the leaves hash on the host;
    restart it, and a probe re-closes the breaker and the route comes
    back."""
    first = DevdProc(env=SIM)
    sock = first.sock
    second = None
    items = signed_items(7, tag=b"brk")
    items[2] = (items[2][0], items[2][1], items[0][2])  # a wrong signature
    want = [i != 2 for i in range(len(items))]
    try:
        first.wait_held(SIM_DAEMON_S)
        fast_breaker(sock)
        v = gateway.Verifier(min_tpu_batch=1)
        h = gateway.Hasher(min_tpu_batch=1)
        assert (v.kernel, h._route) == ("devd", "devd")
        assert v.verify_batch(items[:2]) == [True, True]
        first.kill()
        assert v.verify_batch(items) == want  # three failed attempts, then the floor
        stats = v.stats()
        assert stats["cpu_sigs"] == len(items) and stats["tpu_sigs"] == 2
        assert stats["breaker_state"] == gateway.CircuitBreaker.OPEN and stats["breaker_opens"] == 1
        assert gateway.devd_breaker_states() == {sock: gateway.CircuitBreaker.OPEN}
        assert h.part_leaf_hashes([b"a", b"b"]) == [gateway.ripemd160(b"a"), gateway.ripemd160(b"b")]
        assert h.stats()["cpu_leaves"] == 2 and h.stats()["breaker_state"] == gateway.CircuitBreaker.OPEN

        second = DevdProc(env=SIM, sock=sock)
        second.wait_held(SIM_DAEMON_S)
        deadline = time.monotonic() + 30.0
        while gateway.devd_breaker().state != gateway.CircuitBreaker.CLOSED:
            assert time.monotonic() < deadline, "breaker never re-closed"
            # valid lanes only: the sim daemon's verdicts are structural
            assert all(v.verify_batch(items[:2]))
            time.sleep(0.05)
        before = v.stats()["tpu_sigs"]
        assert all(v.verify_batch(items[:2]))
        stats = v.stats()
        assert stats["tpu_sigs"] == before + 2 and stats["breaker_closes"] == 1
        assert h.part_leaf_hashes([b"c", b"d"]) == [gateway.ripemd160(b"c"), gateway.ripemd160(b"d")]
        assert h.stats()["tpu_part_batches"] == 1
    finally:
        if second is not None:
            second.stop()
        first.stop()


def test_aggregate_rides_the_agg_op(fast_breaker):
    """verify_aggregate on the devd route sends its dual scalar
    multiplications through the agg op (the sim daemon runs the dsm
    kernel's plain version), and refuses a forged aggregate."""
    from tendermint_tpu_torch.crypto import ed25519_agg

    d = DevdProc(env=SIM)
    try:
        d.wait_held(SIM_DAEMON_S)
        fast_breaker(d.sock)
        v = gateway.Verifier(min_tpu_batch=1)
        items = [it for it in signed_items(4, tag=b"agg")]
        rs, s_agg = ed25519_agg.aggregate(items)
        pubs, msgs = [it[0] for it in items], [it[1] for it in items]
        assert v.verify_aggregate(pubs, msgs, rs, s_agg) is True
        assert v.verify_aggregate(pubs, msgs[::-1], rs, s_agg) is False
        stats = v.stats()
        assert (stats["agg_batches"], stats["agg_lanes_device"], stats["agg_lanes_cpu"]) == (2, 10, 0)
    finally:
        d.stop()


def test_daemon_without_the_agg_op_takes_the_floor_unpenalised(monkeypatch):
    from tendermint_tpu_torch.crypto import ed25519_agg

    class OldClient:
        def agg_batch(self, terms):
            raise devd.DevdError("unknown op 'agg'")

        def stream_stats(self):
            return {}

    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", "devd")
    monkeypatch.setattr(devd_backend, "_client", OldClient())
    monkeypatch.setattr(devd_backend, "_agg_ok", True)
    gateway.reset_devd_breaker()
    v = gateway.Verifier(min_tpu_batch=1)
    items = signed_items(3, tag=b"old")
    rs, s_agg = ed25519_agg.aggregate(items)
    assert v.verify_aggregate([it[0] for it in items], [it[1] for it in items], rs, s_agg) is True
    assert v.stats()["agg_lanes_cpu"] == 4 and devd_backend._agg_ok is False
    assert gateway.devd_breaker().stats()["breaker_consecutive_failures"] == 0
    gateway.reset_devd_breaker()
    devd_backend.reset_stream_latches()


@pytest.mark.parametrize("build", ["Verifier", "Hasher"])
def test_multi_daemon_plane_routes_through_devd_shard(monkeypatch, build):
    """TENDERMINT_DEVD_SOCKS naming two daemons: a default Verifier or
    Hasher takes the devd route and its batches split over both daemons
    (ops/devd_shard), each endpoint's breaker CLOSED."""
    import tempfile

    from tendermint_tpu_torch.ops import devd_shard
    from tendermint_tpu_torch.ops.faults import DaemonFleet

    sock_dir = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
    fleet = DaemonFleet(2, sock_dir=sock_dir, extra_env=SIM)
    for k in ("TENDERMINT_TPU_KERNEL", "TENDERMINT_DEVD_SOCK", "TENDERMINT_DEVD_STREAM_MIN"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TENDERMINT_TPU_HASHES", "1")
    monkeypatch.setenv("TENDERMINT_TPU_MIN_BATCH", "8")
    monkeypatch.setenv("TENDERMINT_TPU_HASH_MIN_BATCH", "8")
    monkeypatch.setattr(devd_backend, "_client", None)
    gateway.reset_devd_breaker()
    devd_shard.reset()
    try:
        fleet.start()
        monkeypatch.setenv("TENDERMINT_DEVD_SOCKS", fleet.socks_env)
        devd.bust_avail_cache()
        assert devd_shard.enabled()
        if build == "Verifier":
            v = gateway.Verifier()
            assert v.kernel == "devd" and v.device is None
            # valid lanes only: a sim daemon verifies structurally
            items = signed_items(8, tag=b"fleet")[:2] * 24

            def run():
                assert v.verify_batch(items) == [True] * 48
        else:
            h = gateway.Hasher()
            assert h._route == "devd"
            parts = [bytes([i]) * 900 for i in range(32)]

            def run():
                assert h.part_leaf_hashes(parts) == [ripemd160(p) for p in parts]
        # one batch can leave an endpoint idle (its worker may start after
        # the other took every slice): a few batches, bounded
        for batches in range(1, 11):
            run()
            served = [d["dispatched_slices"] for d in devd_shard.endpoint_stats().values()]
            if len(served) == 2 and all(served):
                break
        assert len(served) == 2 and all(served), devd_shard.endpoint_stats()
        if build == "Verifier":
            assert v.stats()["tpu_sigs"] == 48 * batches and v.stats()["cpu_sigs"] == 0
        else:
            assert h.stats()["tpu_part_batches"] == batches and h.stats()["cpu_leaves"] == 0
        assert set(gateway.devd_breaker_states().values()) == {gateway.CircuitBreaker.CLOSED}
    finally:
        fleet.stop()
        gateway.reset_devd_breaker()
        devd_shard.reset()
        devd_backend.reset_stream_latches()
        devd.bust_avail_cache()
        shutil.rmtree(sock_dir, ignore_errors=True)


def test_round_trip_probe(monkeypatch):
    """In process on the named device; through the daemon when a socket is
    there and no device is named; None when a socket is there and nothing
    serves, which a default Hasher refuses rather than hash on the host."""
    monkeypatch.setattr(gateway, "_rtt_cache", {})
    monkeypatch.delenv("TENDERMINT_TPU_HASHES", raising=False)
    monkeypatch.delenv("TENDERMINT_TPU_DISABLE", raising=False)
    rtt = gateway.device_rtt_ms("cpu")
    assert rtt is not None and 0 < rtt < gateway.HASH_RTT_MS_MAX
    assert gateway.device_rtt_ms("cpu") == rtt  # cached
    d = DevdProc(env=SIM)
    try:
        d.wait_held(SIM_DAEMON_S)
        monkeypatch.setenv("TENDERMINT_DEVD_SOCK", d.sock)
        devd.bust_avail_cache()
        daemon_rtt = gateway.device_rtt_ms()
        assert daemon_rtt is not None and 0 < daemon_rtt < gateway.HASH_RTT_MS_MAX
        d.kill()
        monkeypatch.setattr(gateway, "_rtt_cache", {})
        devd.bust_avail_cache()
        assert gateway.device_rtt_ms() is None
        with pytest.raises(RuntimeError, match="round trip could not be measured"):
            gateway.Hasher()
    finally:
        d.stop()
        devd.bust_avail_cache()


def test_slow_round_trip_hashes_on_the_host(monkeypatch):
    monkeypatch.delenv("TENDERMINT_TPU_HASHES", raising=False)
    monkeypatch.setattr(gateway, "_rtt_cache", {"cpu": 2 * gateway.HASH_RTT_MS_MAX})
    h = gateway.Hasher(device="cpu", min_tpu_batch=1)
    assert h.device is None and h._route is None
    monkeypatch.setenv("TENDERMINT_TPU_HASHES", "1")
    assert gateway.Hasher(device="cpu", min_tpu_batch=1).device.type == "cpu"


def _observe(tel):
    reg = tel.Registry()
    hist = reg.histogram("devd_stream_chunk_seconds", "per-chunk result wait", labelnames=("op",))
    for v in (0.0004, 0.003, 0.003, 0.02, 1.7):
        hist.labels(op="verify").observe(v)
    hist.labels(op="hash").observe(0.05)
    plain = reg.histogram("gateway_hash_batch_seconds", "hash-offload batch wall time")
    plain.observe(0.012)
    reg.counter("devd_frames_total", "frames", labelnames=("kind",)).labels(kind="chunk").inc(3)
    reg.gauge("devd_inflight", "chunks in flight").set(2)
    reg.register_producer("gateway_verify", lambda: {"tpu_sigs": 7, "breaker_state": 0,
                                                     "stream_lanes": 12.5})
    return reg


def test_exposition_text_equals_jax():
    mine, theirs = _observe(telemetry), _observe(jtelemetry)
    assert mine.render_prometheus() == theirs.render_prometheus()
    assert mine.flatten() == theirs.flatten()
    assert telemetry.default_latency_buckets() == jtelemetry.default_latency_buckets()


def test_hasher_and_client_histograms_on_the_default_registry():
    reg = telemetry.reset_default_registry()
    h = gateway.Hasher(device="cpu", min_tpu_batch=1)
    h.part_leaf_hashes([b"x" * 100, b"y" * 70])
    text = reg.render_prometheus()
    assert "gateway_hash_batch_seconds_count 1" in text
    chunk, single = devd._latency_hists()
    single.labels(op="verify").observe(0.002)
    assert 'devd_single_shot_seconds_count{op="verify"} 1' in reg.render_prometheus()
