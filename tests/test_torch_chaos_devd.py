"""Chaos on the port's device plane (ops/faults.py): the JAX test file's
cases (tests/test_chaos_devd.py). Seeded fault schedules, the breaker's
trial mode, faults in process and through a FaultProxy in front of a real
sim daemon (verdicts and digests equal the CPU's throughout), a blackout
that opens the breaker and re-closes it, the multi-daemon plane's kill,
all-open and flapping rows, the mempool's signature gate delivering every
verdict exactly once across a daemon's death, and a port ConsensusState
committing through the daemon's churn (and, in the slow tier, a 20-block
soak under churn and corrupted frames). Beside them: the same seeded
FaultPlan picks the same schedule in both packages, and clients of either
package through either package's proxy get the same answers from a port
daemon.

Sim daemons hash for real and verify structurally, so the signatures here
are real (every verdict True on the device route and on the CPU floor
alike) and forged lanes are wrong-length lanes. Sockets live in a short
directory under /tmp (AF_UNIX stops at 108 bytes)."""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time

import pytest

from tendermint_tpu import devd as jdevd
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto import ed25519_agg as jagg
from tendermint_tpu.crypto.hashing import ripemd160 as jripemd160
from tendermint_tpu.ops import faults as jfaults
from tendermint_tpu_torch import devd
from tendermint_tpu_torch.crypto.hashing import ripemd160
from tendermint_tpu_torch.ops import devd_backend, devd_shard, faults, gateway
from tendermint_tpu_torch.ops.faults import DaemonFleet, DaemonSupervisor, Fault, FaultPlan, FaultProxy

SIM_ENV = {"TENDERMINT_DEVD_SIM_RATE": "200000"}


def _reset() -> None:
    gateway.reset_devd_breaker()
    devd_shard.reset()
    devd_backend.reset_stream_latches()
    devd.bust_avail_cache()


@pytest.fixture()
def sock_dir():
    d = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture()
def chaos_env(monkeypatch, sock_dir):
    """A devd-routed gateway with fast breaker windows and fresh shared
    state (breakers, backend client, skew latches, probe cache, default
    instances); yields the test's daemon socket path."""
    sock = os.path.join(sock_dir, "devd.sock")
    monkeypatch.setenv("TENDERMINT_DEVD_SOCK", sock)
    monkeypatch.delenv("TENDERMINT_DEVD_SOCKS", raising=False)
    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", "devd")
    monkeypatch.setenv("TENDERMINT_TPU_BREAKER_BACKOFF_S", "0.05")
    monkeypatch.setenv("TENDERMINT_TPU_BREAKER_BACKOFF_CAP_S", "0.25")
    monkeypatch.setenv("TENDERMINT_DEVD_STREAM_MIN", "8")
    monkeypatch.setenv("TENDERMINT_DEVD_CLAIM_TIMEOUT_S", "10")
    monkeypatch.setenv("TENDERMINT_DEVD_STREAM_TIMEOUT_S", "10")
    monkeypatch.setattr(devd_backend, "_client", None)
    monkeypatch.setattr(gateway, "_default_verifier", None)
    monkeypatch.setattr(gateway, "_default_hasher", None)
    _reset()
    yield sock
    devd.set_socket_wrapper(None)
    _reset()


def _items(n: int, tag: bytes = b"chaos"):
    seeds = [bytes([7, k]) + b"\x07" * 30 for k in range(8)]
    out = []
    for i in range(n):
        seed = seeds[i % 8]
        msg = tag + b"-%d" % i
        out.append((jed.public_key(seed), msg, jed.sign(seed, msg)))
    return out


def _wait_breaker_closed(verify_once, breaker, deadline_s: float = 10.0):
    """Drive traffic until a probe re-closes the breaker (bounded)."""
    deadline = time.monotonic() + deadline_s
    while breaker.state != breaker.CLOSED:
        assert time.monotonic() < deadline, "breaker never re-closed"
        verify_once()
        time.sleep(0.05)


# -- schedule and breaker units (no daemon) ---------------------------------------


def test_fault_plan_schedule_is_deterministic():
    plan = FaultPlan(seed=7).add("corrupt", "s2c", first=3, every=3, limit=2)
    fired = [plan.pick("s2c") is not None for _ in range(10)]
    assert fired == [False, False, True, False, False, True, False, False, False, False]
    assert plan.stats()["faults_corrupt"] == 2
    assert plan.stats()["faults_total"] == 2
    assert all(plan.pick("c2s") is None for _ in range(10))
    a, b = FaultPlan(seed=9), FaultPlan(seed=9)
    assert [a.corrupt_offset(0, 100) for _ in range(8)] == [b.corrupt_offset(0, 100) for _ in range(8)]
    with pytest.raises(ValueError):
        Fault("melt", "s2c")
    with pytest.raises(ValueError):
        Fault("corrupt", "sideways")
    # a due fault the injection point cannot inject is neither consumed nor
    # counted
    p2 = FaultPlan(seed=1).add("truncate", "s2c", first=1, every=1, limit=3)
    assert p2.pick("s2c", supported=("stall", "drop")) is None
    assert p2.stats()["faults_truncate"] == 0
    assert p2.wants("truncate", "s2c")
    assert p2.pick("s2c") is not None
    assert p2.stats()["faults_truncate"] == 1


def _schedule(mod, seed: int) -> dict:
    """A mixed seeded plan driven through a fixed event sequence: the kinds
    picked, the corrupt offsets drawn, wants() along the way and stats()."""
    plan = mod.FaultPlan(seed=seed)
    plan.add("corrupt", "s2c", first=2, every=3, limit=5)
    plan.add("truncate", "c2s", first=4, every=0, limit=1)
    plan.add("stall", "s2c", first=5, every=4, limit=3, stall_s=0.0)
    plan.add("skew", "c2s", first=1, every=2, limit=4)
    plan.add("refuse", "connect", first=2, every=2, limit=2)
    plan.add("drop", "c2s", first=6, every=1, limit=2)
    supports = [None, ("stall", "drop", "truncate", "corrupt"), ("refuse", "stall"), ("skew",)]
    picks, offsets, wants = [], [], []
    for i in range(60):
        event = mod.FAULT_EVENTS[(i * 7) % 3]
        f = plan.pick(event, supported=supports[i % 4])
        picks.append(None if f is None else (f.kind, f.on, f.fired))
        if f is not None and f.kind == "corrupt":
            offsets.append(plan.corrupt_offset(0, 9 + i))
        wants.append(plan.wants("skew", "c2s"))
        if i % 11 == 0:
            plan.note("kill")
    return {"picks": picks, "offsets": offsets, "wants": wants, "stats": plan.stats(),
            "repr": [repr(f) for f in plan.faults]}


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_fault_schedules_equal_jax(seed):
    assert _schedule(faults, seed) == _schedule(jfaults, seed)
    assert faults.FAULT_KINDS == jfaults.FAULT_KINDS and faults.FAULT_EVENTS == jfaults.FAULT_EVENTS


def test_breaker_trial_mode_backoff_and_stats():
    br = gateway.CircuitBreaker(threshold=2, base_backoff_s=0.05, max_backoff_s=0.2, probe=None, seed=3)
    assert br.allow() and br.state == br.CLOSED
    br.record_failure()
    assert br.state == br.CLOSED
    br.record_failure()
    assert br.state == br.OPEN
    assert not br.allow()
    time.sleep(0.3)  # past the largest jittered window
    assert br.allow()
    assert br.state == br.HALF_OPEN
    br.record_failure()  # the trial failed: open again, backoff doubled
    assert br.state == br.OPEN
    time.sleep(0.45)
    assert br.allow()
    br.record_success()
    assert br.state == br.CLOSED
    st = br.stats()
    assert st["breaker_opens"] == 1 and st["breaker_closes"] == 1
    assert st["breaker_probes"] == 2 and st["breaker_probe_failures"] == 1
    assert st["breaker_fallback_s"] > 0
    assert st["breaker_state"] == 0


def test_writer_abandonment_counts_fault_and_closes_conn(monkeypatch):
    """A writer thread that outlives its reap budget is counted
    (`writer_abandoned`) and its connection shut down, then closed."""
    monkeypatch.setattr(devd, "WRITER_REAP_S", 0.05)
    client = devd.DevdClient("/nonexistent/sock")
    gate = threading.Event()
    writer = threading.Thread(target=gate.wait, daemon=True)
    writer.start()
    closed = []

    class Conn:
        def shutdown(self, how):
            closed.append("shutdown")

        def close(self):
            closed.append("close")

    try:
        assert client._reap_writer(writer, client._stream_stats, Conn())
        assert client.stream_stats()["writer_abandoned"] == 1
        assert closed == ["shutdown", "close"]
        gate.set()
        assert not client._reap_writer(writer, client._stream_stats, Conn())
        assert client.stream_stats()["writer_abandoned"] == 1
    finally:
        gate.set()


# -- in process -------------------------------------------------------------------


def test_inprocess_faults_gateway_serves_correct_verdicts(chaos_env):
    """Corrupt, drop and refuse on the production client path: every batch
    answers the right verdicts, the plan's counters show the schedule
    fired, and the faults_* gauges show in Verifier.stats()."""
    sup = DaemonSupervisor(chaos_env, SIM_ENV)
    sup.start()
    plan = FaultPlan(seed=11)
    plan.add("corrupt", "c2s", first=3, every=7, limit=3)
    plan.add("drop", "s2c", first=5, every=0, limit=1)
    plan.add("refuse", "connect", first=2, every=0, limit=1)
    try:
        faults.install_client_faults(plan)
        v = gateway.Verifier(min_tpu_batch=1)
        items = _items(64)
        for _ in range(12):
            assert v.verify_batch(items) == [True] * 64
        st = plan.stats()
        assert st["faults_corrupt"] >= 1
        assert st["faults_total"] >= 3, st
        vstats = v.stats()
        assert vstats["faults_corrupt"] == st["faults_corrupt"]
        assert {"breaker_state", "breaker_opens"} <= set(vstats)
        faults.uninstall_client_faults(plan)
        br = gateway.devd_breaker()
        _wait_breaker_closed(lambda: v.verify_batch(items), br)
        before = v.stats()["tpu_sigs"]
        assert v.verify_batch(items) == [True] * 64
        assert v.stats()["tpu_sigs"] == before + 64
    finally:
        faults.uninstall_client_faults(plan)
        sup.stop()


def test_stalled_daemon_hits_stream_budget_not_io_timeout(chaos_env, sock_dir, monkeypatch):
    """A read starved on an active stream (the proxy holds every result
    frame 5 s) surfaces within the per-frame stream budget, not the flat io
    timeout, and raises to the caller's fallback."""
    monkeypatch.setenv("TENDERMINT_DEVD_STREAM_TIMEOUT_S", "0.5")
    upstream = os.path.join(sock_dir, "real.sock")
    sup = DaemonSupervisor(upstream, SIM_ENV)
    sup.start()
    plan = FaultPlan(seed=2)
    proxy = FaultProxy(chaos_env, upstream, plan).start()
    try:
        client = devd.DevdClient(chaos_env)
        assert client.stream_timeout == 0.5
        items = _items(32)
        # warm the daemon's stream path (its first stream imports the chunk
        # decoder's numpy, ~0.3 s idle and more than the 0.5 s budget on a
        # loaded host) through the proxy on a client with a long budget, so
        # the daemon's first-stream cost cannot spend the budget with no
        # frame relayed and the stall never firing
        warm = devd.DevdClient(chaos_env, stream_timeout=30.0)
        assert warm.verify_stream(items, chunk=8) == [True] * 32
        warm.close()
        # warm the relay (the proxy's accept and its upstream dial) before
        # the stall is armed, so a slow first accept cannot spend the budget
        # with no frame relayed; the rule fires from the first frame after
        client.ping()
        plan.add("stall", "s2c", first=1, every=1, limit=1 << 30, stall_s=5.0)
        t0 = time.monotonic()
        with pytest.raises(Exception):
            client.verify_stream(items, chunk=8)
        elapsed = time.monotonic() - t0
        assert elapsed < 8.0, f"stalled read took {elapsed:.1f}s to surface"
        assert plan.stats()["faults_stall"] >= 1
        client.close()
    finally:
        proxy.stop()
        sup.stop()


def test_proxy_skew_latches_single_shot_until_breaker_reset(chaos_env, sock_dir):
    """The proxy answers stream headers as a daemon without streaming: the
    backend latches single-shot (verdicts right) until its latches are
    re-armed, as a breaker's re-close does."""
    upstream = os.path.join(sock_dir, "real.sock")
    sup = DaemonSupervisor(upstream, SIM_ENV)
    sup.start()
    plan = FaultPlan(seed=4)
    plan.add("skew", "c2s", first=1, every=1, limit=1 << 30)
    proxy = FaultProxy(chaos_env, upstream, plan).start()
    try:
        v = gateway.Verifier(min_tpu_batch=1)
        items = _items(32)
        assert v.verify_batch(items) == [True] * 32
        assert devd_backend._stream_ok is False, "skew must latch single-shot"
        assert plan.stats()["faults_skew"] >= 1
        assert v.verify_batch(items) == [True] * 32
        devd_backend.reset_stream_latches()
        assert devd_backend._stream_ok and devd_backend._hash_stream_ok
    finally:
        proxy.stop()
        sup.stop()


# -- through a proxy (real wire bytes) -------------------------------------------------


def test_proxy_faults_both_planes_parity_and_skew(chaos_env, sock_dir, monkeypatch):
    """Corrupt and truncate on the wire in front of a real daemon: verdicts
    and digests equal the CPU's throughout, and the plan's counters show
    the schedule fired."""
    upstream = os.path.join(sock_dir, "real.sock")
    sup = DaemonSupervisor(upstream, SIM_ENV)
    sup.start()
    plan = FaultPlan(seed=5)
    plan.add("corrupt", "s2c", first=4, every=6, limit=4)
    plan.add("truncate", "c2s", first=9, every=0, limit=1)
    proxy = FaultProxy(chaos_env, upstream, plan).start()
    try:
        devd.bust_avail_cache()
        monkeypatch.setenv("TENDERMINT_TPU_HASHES", "1")
        v = gateway.Verifier(min_tpu_batch=1)
        h = gateway.Hasher(min_tpu_batch=1)
        assert h._route == "devd"
        items = _items(48)
        parts = [bytes([i]) * 700 for i in range(24)]
        want_digests = [jripemd160(p) for p in parts]
        for _ in range(10):
            assert v.verify_batch(items) == [True] * 48
            assert h.part_leaf_hashes(parts) == want_digests
        st = plan.stats()
        assert st["faults_corrupt"] >= 2, st
        assert st["faults_truncate"] >= 1, st
        assert h.stats()["faults_corrupt"] == st["faults_corrupt"]
    finally:
        proxy.stop()
        sup.stop()


def test_proxy_blackout_opens_breaker_then_recovers(chaos_env, sock_dir):
    """A blackout refuses connects and drops live ones: the breaker opens,
    the CPU floor serves right verdicts, and after the window the breaker
    re-closes and the daemon serves again."""
    upstream = os.path.join(sock_dir, "real.sock")
    sup = DaemonSupervisor(upstream, SIM_ENV)
    sup.start()
    proxy = FaultProxy(chaos_env, upstream).start()
    try:
        devd.bust_avail_cache()
        v = gateway.Verifier(min_tpu_batch=1)
        items = _items(32)
        assert v.verify_batch(items) == [True] * 32
        proxy.blackout(0.6)
        br = gateway.devd_breaker()
        deadline = time.monotonic() + 5.0
        while br.state != br.OPEN and time.monotonic() < deadline:
            assert v.verify_batch(items) == [True] * 32
        assert br.state == br.OPEN
        assert proxy.plan.stats()["faults_kill"] == 1
        time.sleep(0.7)  # the blackout is over
        _wait_breaker_closed(lambda: v.verify_batch(items), br)
        before = v.stats()["tpu_sigs"]
        assert v.verify_batch(items) == [True] * 32
        assert v.stats()["tpu_sigs"] == before + 32
    finally:
        proxy.stop()
        sup.stop()


def _client_answers(client, items, parts, terms) -> dict:
    return {
        "verify": list(client.verify_batch(items)),
        "verify_stream": list(client.verify_stream(items, chunk=8)),
        "hash": list(client.hash_batch(parts)),
        "hash_stream_tree": client.hash_stream(parts, mode="part", tree=True, chunk=4),
        "leaf_tree": client.hash_batch(parts[:7], mode="leaf", tree=True),
        "agg": [tuple(p) for p in client.agg_batch(terms)],
    }


@pytest.mark.parametrize("proxy_pkg", ["port", "jax"])
def test_clients_of_both_packages_through_a_proxy_agree(chaos_env, sock_dir, proxy_pkg):
    """A JAX client and a port client, each through the port's (or the JAX
    package's) FaultProxy in front of a port sim daemon, get the same
    verdicts, digests, trees and points: the proxy relays either package's
    frames byte for byte."""
    upstream = os.path.join(sock_dir, "real.sock")
    sup = DaemonSupervisor(upstream, SIM_ENV)
    sup.start()
    mod = faults if proxy_pkg == "port" else jfaults
    proxy = mod.FaultProxy(chaos_env, upstream).start()
    items = _items(40, tag=b"cross")
    parts = [bytes([i]) * (300 + 97 * i) for i in range(18)]
    signed = _items(5, tag=b"agg")
    rs, s_agg = jagg.aggregate(signed)
    terms = jagg.aggregate_terms([it[0] for it in signed], [it[1] for it in signed], rs, s_agg)
    clients = {"port": devd.DevdClient(chaos_env), "jax": jdevd.DevdClient(chaos_env)}
    try:
        got = {name: _client_answers(c, items, parts, terms) for name, c in clients.items()}
        assert got["port"] == got["jax"]
        assert got["port"]["verify"] == got["port"]["verify_stream"] == [True] * 40
        assert got["port"]["hash"] == [ripemd160(p) for p in parts] == [jripemd160(p) for p in parts]
        assert got["port"]["hash_stream_tree"][0] == got["port"]["hash"]
        assert jagg.finish_from_points(got["jax"]["agg"])
        assert proxy.plan.stats()["faults_total"] == 0
    finally:
        for c in clients.values():
            c.close()
        proxy.stop()
        sup.stop()


# -- the multi-daemon plane ---------------------------------------------------------
#
# Wrong-length signatures mark forged lanes, and the stream floor is raised
# so slices ride the single-shot op (the stream's fixed-width frames reject
# malformed lanes with an error instead of a verdict).


def _forge_len(items, idx):
    for i in idx:
        p, m, s = items[i]
        items[i] = (p, m, s[:10])
    return items


def test_shard_kill_one_of_n_mid_burst(chaos_env, sock_dir, monkeypatch):
    """SIGKILL one of 3 endpoints during a burst: every batch answers the
    CPU's verdicts, the dead endpoint's slices re-dispatch, and the plane
    never takes the floor."""
    monkeypatch.setenv("TENDERMINT_DEVD_STREAM_MIN", "100000")
    monkeypatch.setenv("TENDERMINT_TPU_MIN_BATCH", "8")
    fleet = DaemonFleet(3, sock_dir=sock_dir, extra_env=SIM_ENV)
    fleet.start()
    monkeypatch.setenv("TENDERMINT_DEVD_SOCKS", fleet.socks_env)
    try:
        items = _forge_len(_items(96, tag=b"kill1"), [13, 71])
        want = [jed.verify(*it) for it in items]
        assert want == [i not in (13, 71) for i in range(96)]
        for _ in range(3):
            assert devd_shard.verify_batch(items) == want
        fleet.kill(0)
        dead = fleet.sock_paths[0]
        for _ in range(6):
            assert devd_shard.verify_batch(items) == want
        # a batch can leave a live endpoint idle (its worker may start after
        # the other has taken every slice, home and stolen): bounded more
        for _ in range(10):
            st = devd_shard.endpoint_stats()
            if all(st[path]["dispatched_slices"] >= 1 for path in fleet.sock_paths[1:]):
                break
            assert devd_shard.verify_batch(items) == want
        st = devd_shard.endpoint_stats()
        assert st[dead]["redispatches"] >= 1, st
        assert gateway.devd_plane_allow()
        for path in fleet.sock_paths[1:]:
            assert st[path]["breaker_state"] == 0, st
            assert st[path]["dispatched_slices"] >= 1, st
    finally:
        fleet.stop()


def test_shard_all_breakers_open_falls_to_host_floor(chaos_env, sock_dir, monkeypatch):
    """The plane serves sharded, then the whole fleet dies: every breaker
    opens, and the hash plane serves the host's digests and the verify plane
    the CPU's verdicts, both counted."""
    monkeypatch.setenv("TENDERMINT_DEVD_STREAM_MIN", "100000")
    monkeypatch.setenv("TENDERMINT_TPU_MIN_BATCH", "8")
    monkeypatch.setenv("TENDERMINT_TPU_BREAKER_FAILURES", "1")
    monkeypatch.setenv("TENDERMINT_TPU_HASHES", "1")
    monkeypatch.delenv("TENDERMINT_DEVD_SOCK", raising=False)
    fleet = DaemonFleet(2, sock_dir=sock_dir, extra_env=SIM_ENV)
    fleet.start()
    monkeypatch.setenv("TENDERMINT_DEVD_SOCKS", fleet.socks_env)
    devd.bust_avail_cache()
    try:
        v = gateway.Verifier(min_tpu_batch=1)
        h = gateway.Hasher(min_tpu_batch=1)
        assert h._route == "devd"
        items = _forge_len(_items(24, tag=b"floor"), [4])
        parts = [bytes([i]) * 600 for i in range(20)]
        want_digests = [jripemd160(p) for p in parts]
        assert v.verify_batch(items) == [i != 4 for i in range(24)]
        assert h.part_leaf_hashes(parts) == want_digests
        assert devd_shard.plane_stats()["dispatched_slices"] >= 1

        fleet.kill(0)
        fleet.kill(1)
        assert v.verify_batch(items) == [i != 4 for i in range(24)]
        assert h.part_leaf_hashes(parts) == want_digests
        states = gateway.devd_breaker_states()
        assert all(states[s] == 2 for s in fleet.sock_paths), states
        assert not gateway.devd_plane_allow()
        assert v.verify_batch(items) == [i != 4 for i in range(24)]
        assert v.stats()["cpu_sigs"] >= 24
        assert h.part_leaf_hashes(parts) == want_digests
        assert h.stats()["cpu_leaves"] >= len(parts)
    finally:
        fleet.stop()


def test_shard_flapping_endpoint_breaker_storm(chaos_env, sock_dir, monkeypatch):
    """One endpoint flaps beside a healthy one under tight breaker windows:
    verdicts stay right through every flap, the flapper's breaker opened
    and probed, and once the flapping stops it re-closes and serves
    slices again."""
    monkeypatch.setenv("TENDERMINT_DEVD_STREAM_MIN", "100000")
    monkeypatch.setenv("TENDERMINT_TPU_MIN_BATCH", "8")
    monkeypatch.setenv("TENDERMINT_TPU_BREAKER_FAILURES", "1")
    fleet = DaemonFleet(2, sock_dir=sock_dir, extra_env=SIM_ENV)
    fleet.start()
    monkeypatch.setenv("TENDERMINT_DEVD_SOCKS", fleet.socks_env)
    flapper = fleet.sock_paths[0]
    try:
        items = _forge_len(_items(64, tag=b"flap"), [31])
        want = [i != 31 for i in range(64)]
        assert devd_shard.verify_batch(items) == want
        fleet.supervisors[0].churn(down_s=0.15, up_s=0.25, cycles=3)
        deadline = time.monotonic() + 20.0
        br = gateway.devd_breaker(flapper)
        while fleet.supervisors[0].kills < 3:
            assert time.monotonic() < deadline, "churn never completed"
            assert devd_shard.verify_batch(items) == want
            time.sleep(0.02)
        fleet.supervisors[0].stop_churn(ensure_up=True)
        st = br.stats()
        assert st["breaker_opens"] >= 1, st
        assert st["breaker_probes"] >= 1, st
        deadline = time.monotonic() + 10.0
        while br.state != br.CLOSED:
            assert time.monotonic() < deadline, "flapper never re-closed"
            assert devd_shard.verify_batch(items) == want
            time.sleep(0.05)
        before = devd_shard.endpoint_stats()[flapper]["dispatched_slices"]
        deadline = time.monotonic() + 10.0
        while devd_shard.endpoint_stats()[flapper]["dispatched_slices"] == before:
            assert time.monotonic() < deadline, "flapper never re-served"
            assert devd_shard.verify_batch(items) == want
    finally:
        fleet.stop()


def test_labeled_reconnect_counters_split_paths(chaos_env):
    """The two reconnect paths count apart (a stale pooled socket found at
    first use, a death under an active exchange) and sum to the total."""
    sup = DaemonSupervisor(chaos_env, SIM_ENV)
    sup.start()
    client = devd.DevdClient(chaos_env)
    items = _items(32)
    try:
        assert all(client.verify_stream(items, chunk=8))
        sup.restart()  # the pool now holds dead sockets
        assert all(client.verify_stream(items, chunk=8))
        st = client.stream_stats()
        assert st["reconnects"] >= 1
        assert st["reconnects"] == st["reconnects_connect"] + st["reconnects_midstream"]
        assert st["writer_abandoned"] == 0
    finally:
        client.close()
        sup.stop()


def test_supervisor_refuses_a_card_daemon(sock_dir):
    """Only ACCEPT_CPU daemons may be supervised: an environment that would
    claim a card is refused before anything is spawned."""
    for env in ({"TENDERMINT_DEVD_ACCEPT_CPU": ""}, {"TENDERMINT_DEVD_ACCEPT_CPU": "0"}):
        with pytest.raises(ValueError, match="ACCEPT_CPU"):
            DaemonSupervisor(os.path.join(sock_dir, "card.sock"), env)
        with pytest.raises(ValueError, match="ACCEPT_CPU"):
            DaemonFleet(2, sock_dir=sock_dir, extra_env=env)


def test_fault_proxy_as_its_own_process(chaos_env, sock_dir):
    """`python -m tendermint_tpu_torch.ops.faults` relays a client to the
    daemon, corrupts on its schedule (the client still gets right verdicts
    through the gateway), and prints its counters as one JSON line on
    SIGTERM."""
    import json
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    upstream = os.path.join(sock_dir, "real.sock")
    sup = DaemonSupervisor(upstream, SIM_ENV)
    sup.start()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tendermint_tpu_torch.ops.faults", "--listen", chaos_env,
         "--upstream", upstream, "--seed", "3", "--corrupt-every", "3"],
        cwd=repo, env={**os.environ, "PYTHONPATH": repo}, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        deadline = time.monotonic() + 60
        while not os.path.exists(chaos_env):
            assert proc.poll() is None and time.monotonic() < deadline, "proxy never listened"
            time.sleep(0.05)
        v = gateway.Verifier(min_tpu_batch=1)
        items = _items(32)
        for _ in range(4):
            assert v.verify_batch(items) == [True] * 32
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        stats = json.loads(out.strip().splitlines()[-1])
        assert stats["faults_corrupt"] >= 1 and stats["faults_total"] == stats["faults_corrupt"]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        sup.stop()


# -- the mempool's sig gate: exactly once across a daemon's death --------------


def test_sigbatcher_exactly_once_across_daemon_death(chaos_env):
    """The daemon dying between the gate's two in-flight batches neither
    drops nor doubles a tx verdict: every accepted submission is delivered
    exactly once, and no valid signature is reported invalid (the
    verifier's CPU floor re-verifies; the gate fails open only when the
    verifier itself fails)."""
    from tendermint_tpu_torch.mempool.mempool import SigBatcher

    sup = DaemonSupervisor(chaos_env, SIM_ENV)
    sup.start()
    delivered: list = []
    dmtx = threading.Lock()

    def on_results(results):
        with dmtx:
            delivered.extend(results)

    v = gateway.Verifier(min_tpu_batch=1)
    assert v.kernel == "devd"
    items = _items(512, tag=b"gate")
    sb = SigBatcher(v, parse=lambda tx: tx, max_batch=64,
                    max_wait_s=0.001, on_results=on_results, max_inflight=2)
    try:
        accepted = []
        for i, it in enumerate(items):
            if sb.submit(it, i):
                accepted.append(i)
            if i == 128:
                sup.kill()  # mid-burst, batches in flight
            elif i == 320:
                sup.restart()
            if i % 64 == 0:
                time.sleep(0.01)  # let batches go in flight mid-churn
    finally:
        sb.stop()
        sb._thread.join(timeout=30.0)
        sup.stop()
    assert not sb._thread.is_alive()
    with dmtx:
        got = sorted(ctx for ctx, _ok in delivered)
        oks = {ctx: ok for ctx, ok in delivered}
    assert got == accepted, "dropped or duplicated tx verdicts"
    assert sb.delivered == len(accepted) == len(items)
    # every submission was validly signed: none may be reported invalid
    assert all(oks.values())
    st = v.stats()
    assert st["tpu_sigs"] + st["cpu_sigs"] >= len(items)


# -- consensus liveness under churn -------------------------------------------


def _run_consensus_run(n_blocks: int, txs: list[bytes], hasher=None,
                       budget_s: float = 20.0, during=None, until=None):
    """Commit `n_blocks` on a single-validator KVStore chain, feeding
    txs strictly sequentially (tx k+1 enters the pool only after tx k
    committed, so the committed ORDER is deterministic across runs).
    Returns (new-block event list, consensus state). `during(height_events)`
    runs once after start (chaos hookup)."""
    import tendermint_tpu_torch.types.events as tev
    from test_torch_consensus import EventCollector, make_cs_and_stubs
    from tendermint_tpu_torch.abci.apps.kvstore import KVStoreApp

    cs, _stubs, _ = make_cs_and_stubs(1, app=KVStoreApp())
    if hasher is not None:
        cs.part_hasher = hasher
    blocks = EventCollector(cs.evsw, tev.EVENT_NEW_BLOCK)
    cs.start()
    try:
        if during is not None:
            during(blocks)
        next_tx = 0
        if txs:
            cs.mempool.check_tx(txs[0])
            next_tx = 1
        deadline = time.monotonic() + budget_s + 1.5 * n_blocks
        while True:
            events = list(blocks.items)
            # done: enough blocks AND every tx landed AND one block
            # after the last tx's block (so its app-hash effect is
            # bound into a committed header — app_hash lags one height)
            if len(events) >= n_blocks and next_tx == len(txs) and (
                not txs or _fingerprint_ready(events, txs)
            ) and (until is None or until()):
                return events, cs
            assert time.monotonic() < deadline, (
                f"liveness lost: {len(events)} blocks, tx {next_tx}/"
                f"{len(txs)} (height_seconds_max="
                f"{cs.height_seconds_max:.2f})"
            )
            if next_tx < len(txs):
                landed = {t for d in events for t in d.block.data.txs}
                if txs[next_tx - 1] in landed:
                    cs.mempool.check_tx(txs[next_tx])
                    next_tx += 1
            time.sleep(0.02)
    finally:
        cs.stop()


def _last_tx_height(block_events, txs) -> int | None:
    for d in block_events:
        if txs[-1] in d.block.data.txs:
            return d.block.header.height
    return None


def _fingerprint_ready(block_events, txs) -> bool:
    h = _last_tx_height(block_events, txs)
    return h is not None and any(
        d.block.header.height == h + 1 for d in block_events
    )


def _committed_fingerprint(block_events, txs):
    """(ordered committed txs, app hash with every tx applied) — the
    deterministic commit fingerprint two runs of the same sequential tx
    schedule must share. header.app_hash lags one height, so the
    post-all-txs hash is read from the block AFTER the one carrying the
    last tx (heights may differ across runs; the hash may not)."""
    committed = [t for d in block_events for t in d.block.data.txs]
    if not txs:
        return committed, b""
    h = _last_tx_height(block_events, txs)
    post = next(
        d.block.header.app_hash for d in block_events
        if d.block.header.height == h + 1
    )
    return committed, post


def _assert_partset_parity(cs, block_events) -> int:
    """Every committed block's part-set root (produced by the devd-routed
    hasher, possibly under faults) must equal a pure-CPU recompute —
    the 'zero digests wrong' assertion. Returns blocks checked."""
    checked = 0
    for d in block_events:
        blk = d.block
        meta = cs.block_store.load_block_meta(blk.header.height)
        if meta is None:
            continue
        cpu = blk.make_part_set(65536).header()
        assert meta.block_id.parts_header == cpu, (
            f"height {blk.header.height}: part-set root diverged"
        )
        checked += 1
    return checked


def _chaos_hasher(sock: str):
    from tendermint_tpu_torch.ops import gateway

    devd.bust_avail_cache()
    h = gateway.Hasher(min_tpu_batch=1)
    assert h._route == "devd", "hasher must ride the daemon for the soak"
    return h


def test_consensus_commits_through_daemon_churn(chaos_env):
    """Fast tier-1 chaos subset: a single-validator chain keeps
    committing while the daemon serving its part-set hash plane is
    SIGKILLed and restarted; the commit fingerprint matches a fault-free
    run, part-set roots recompute byte-identically on CPU, and the
    breaker re-closes with devd routing restored."""
    from tendermint_tpu_torch.ops import gateway

    n_blocks, txs = 6, [b"k%d=v%d" % (i, i) for i in range(4)]
    sup = DaemonSupervisor(chaos_env, SIM_ENV, plan=FaultPlan(seed=3))
    sup.start()
    try:
        # fault-free reference run first (daemon healthy throughout)
        ref_blocks, ref_cs = _run_consensus_run(
            n_blocks, txs, hasher=_chaos_hasher(chaos_env)
        )
        ref_print = _committed_fingerprint(ref_blocks, txs)
        assert ref_print[0] == txs, "reference run must commit every tx"

        # chaos run: kill/restart churn while committing
        hasher = _chaos_hasher(chaos_env)

        def start_churn(_blocks):
            sup.churn(down_s=0.5, up_s=1.0, cycles=2)

        # keep committing until the churn has restarted the daemon once (a
        # chain faster than the churn's down time otherwise ends before
        # any restart, and the restart counter below goes timing-dependent)
        chaos_blocks, chaos_cs = _run_consensus_run(
            n_blocks, txs, hasher=hasher, during=start_churn,
            until=lambda: sup.restarts >= 1,
        )
        sup.stop_churn(ensure_up=True)
        assert sup.kills >= 1 and sup.plan.stats()["faults_kill"] >= 1
        assert _committed_fingerprint(chaos_blocks, txs) == ref_print
        assert _assert_partset_parity(chaos_cs, chaos_blocks) >= n_blocks - 1
        # liveness: no height stalled past its budget
        assert chaos_cs.height_seconds_max < 10.0, chaos_cs.height_seconds_max
        # recovery: breaker closed against the healthy daemon, and the
        # hash plane demonstrably routes devd again
        br = gateway.devd_breaker()
        parts = [bytes([i]) * 512 for i in range(16)]
        _wait_breaker_closed(lambda: hasher.part_leaf_hashes(parts), br)
        before = hasher.stats()["tpu_part_batches"]
        hasher.part_leaf_hashes(parts)
        assert hasher.stats()["tpu_part_batches"] == before + 1

        # breaker-open heights visibly attribute their hash
        # work to the CPU fallback in the per-height traces
        # (consensus/trace.py) — kill the daemon FOR GOOD and commit a
        # few more heights on the open breaker
        dead_hasher = _chaos_hasher(chaos_env)  # resolved while serving
        dead_blocks, dead_cs = _run_consensus_run(
            3, [], hasher=dead_hasher, during=lambda _blocks: sup.kill(),
        )
        assert len(dead_blocks) >= 3
        newest = dead_cs.trace.last(1)[0].to_json()
        dev = newest["device"]
        assert dev["hash_cpu_leaves"] > 0, dev
        assert dev["hash_tpu_leaves"] == 0, dev
        assert dev["breaker_state_end"] != gateway.CircuitBreaker.CLOSED, dev
        # the segment partition holds under chaos too
        tol = max(0.05 * newest["wall_s"], 0.005)
        total = sum(newest["segments"].values())
        assert abs(total - newest["wall_s"]) <= tol, (total, newest["wall_s"])
        # the same attribution is scrape-visible: the supervisor's churn
        # registered into the telemetry plane (ops/faults satellite),
        # asserting on metrics instead of reaching into the harness
        from tendermint_tpu_torch.libs import telemetry

        fams = {
            f.name: f for f in telemetry.default_registry().collect()
        }
        assert fams["faults_supervisor_kills"].samples[0][2] >= 1
        assert fams["faults_supervisor_restarts"].samples[0][2] >= 1
    finally:
        sup.stop()


@pytest.mark.slow
def test_chaos_soak_20_blocks_with_corruption(chaos_env, sock_dir):
    """The acceptance soak: >= 20 blocks commit while a seeded schedule
    SIGKILLs/restarts the daemon AND corrupts wire frames through the
    FaultProxy, with a concurrent streamed verify load sharing the same
    breaker. Asserts: commit fingerprint byte-identical to a fault-free
    run, per-block part-set roots CPU-identical, zero wrong verify
    verdicts, no height past its timeout budget, breaker re-closed with
    devd routing restored, and the fault counters prove the schedule
    actually fired."""
    from tendermint_tpu_torch.ops import gateway

    n_blocks, txs = 22, [b"s%d=w%d" % (i, i) for i in range(12)]
    # sockets under sock_dir: a pytest tmp_path can pass the 108-byte
    # AF_UNIX limit
    upstream = os.path.join(sock_dir, "real.sock")
    plan = FaultPlan(seed=17)
    plan.add("corrupt", "s2c", first=6, every=9, limit=1 << 30)
    plan.add("corrupt", "c2s", first=11, every=13, limit=1 << 30)
    sup = DaemonSupervisor(upstream, SIM_ENV, plan=plan)
    sup.start()
    proxy = FaultProxy(chaos_env, upstream, plan).start()
    try:
        ref_blocks, _ref_cs = _run_consensus_run(
            n_blocks, txs, hasher=_chaos_hasher(chaos_env), budget_s=40.0
        )
        ref_print = _committed_fingerprint(ref_blocks, txs)
        assert ref_print[0] == txs

        hasher = _chaos_hasher(chaos_env)
        v = gateway.Verifier(min_tpu_batch=1)
        load_stop = threading.Event()
        wrong = []

        def verify_load():
            items = _items(96, tag=b"soak")
            while not load_stop.is_set():
                try:
                    if v.verify_batch(items) != [True] * 96:
                        wrong.append("wrong verdicts")
                        return
                except Exception as exc:  # noqa: BLE001 — must not happen:
                    # the gateway's contract is fallback, never raise
                    wrong.append(f"verify raised: {exc}")
                    return
                time.sleep(0.05)

        load = threading.Thread(target=verify_load, daemon=True)
        load.start()

        def start_churn(_blocks):
            sup.churn(down_s=0.6, up_s=1.6, cycles=4)

        # keep committing past n_blocks until the kill schedule really
        # ran (a fast chain otherwise outruns the churn and the
        # faults_kill assertion goes timing-dependent)
        chaos_blocks, chaos_cs = _run_consensus_run(
            n_blocks, txs, hasher=hasher, during=start_churn, budget_s=60.0,
            until=lambda: sup.kills >= 3,
        )
        sup.stop_churn(ensure_up=True)
        load_stop.set()
        load.join(timeout=30.0)

        assert not wrong, wrong
        assert _committed_fingerprint(chaos_blocks, txs) == ref_print
        assert _assert_partset_parity(chaos_cs, chaos_blocks) >= n_blocks - 1
        assert chaos_cs.height_seconds_max < 15.0, chaos_cs.height_seconds_max
        st = plan.stats()
        assert st["faults_kill"] >= 3, st      # churn really killed it
        assert st["faults_corrupt"] >= 2, st   # frames really corrupted
        br = gateway.devd_breaker()
        assert br.stats()["breaker_opens"] >= 1  # degradation was real
        parts = [bytes([i % 251]) * 600 for i in range(20)]
        _wait_breaker_closed(lambda: hasher.part_leaf_hashes(parts), br,
                             deadline_s=20.0)
        # routing restored: devd-routed batches flow again on BOTH
        # planes within a bounded window. Retry-loop, not next-batch:
        # the proxy's corruption schedule never stops, so any single
        # batch may legitimately eat a fault and take the CPU fallback
        # for that batch — recovery means the plane keeps coming back
        deadline = time.monotonic() + 20.0
        before = hasher.stats()["tpu_part_batches"]
        while hasher.stats()["tpu_part_batches"] == before:
            assert time.monotonic() < deadline, "hash plane never re-routed"
            hasher.part_leaf_hashes(parts)
        vbefore = v.stats()["tpu_sigs"]
        while v.stats()["tpu_sigs"] == vbefore:
            assert time.monotonic() < deadline, "verify plane never re-routed"
            assert v.verify_batch(_items(16)) == [True] * 16
    finally:
        proxy.stop()
        sup.stop()
