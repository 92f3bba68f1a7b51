"""The port's network faults (ops/netfaults.py) against the JAX package's,
on loopback TCP: a LinkProxy in front of an echo server partitions and
heals, delays one direction, reorders chunks, and fires a FaultPlan's
refuse, stall and corrupt; the corrupted bytes, the WAN samples, the geo
clusters, a NetFabric's group partitions and the netfaults_* scrape keys
equal the JAX package's. (The node-level scenarios of
tests/test_netchaos.py need a node of the port.)"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from tendermint_tpu.libs import telemetry as jtelemetry
from tendermint_tpu.ops import faults as jfaults
from tendermint_tpu.ops import netfaults as jnet
from tendermint_tpu_torch.libs import telemetry
from tendermint_tpu_torch.ops import faults
from tendermint_tpu_torch.ops import netfaults as net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = {"port": (net, faults), "jax": (jnet, jfaults)}


class Echo:
    """A loopback TCP server echoing every byte back, a thread a connection."""

    def __init__(self):
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(16)
        self.srv.settimeout(0.2)
        self.addr = self.srv.getsockname()[:2]
        self.stop_evt = threading.Event()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while not self.stop_evt.is_set():
            try:
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._echo, args=(conn,), daemon=True).start()

    @staticmethod
    def _echo(conn) -> None:
        try:
            while data := conn.recv(65536):
                conn.sendall(data)
        except OSError:
            pass
        finally:
            conn.close()

    def stop(self) -> None:
        self.stop_evt.set()
        self.srv.close()


@pytest.fixture()
def echo():
    e = Echo()
    yield e
    e.stop()


def _dial(link, timeout: float = 5.0) -> socket.socket:
    s = socket.create_connection(link.addr, timeout=timeout)
    s.settimeout(timeout)
    return s


def _recv_n(s, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def _roundtrip(link, payload: bytes) -> bytes:
    s = _dial(link)
    try:
        s.sendall(payload)
        return _recv_n(s, len(payload))
    finally:
        s.close()


def _closed_by_proxy(s) -> bool:
    """The far end closed (or reset) the connection."""
    try:
        s.sendall(b"x")
        return s.recv(1) == b""
    except OSError:
        return True


def _wait(cond, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_relay_partition_and_heal(echo):
    link = net.LinkProxy(echo.addr, name="t:0->1")
    try:
        assert _roundtrip(link, b"hello") == b"hello"
        live = _dial(link)
        live.sendall(b"ping")
        assert _recv_n(live, 4) == b"ping"
        link.partition()
        assert link.partitioned()
        assert _closed_by_proxy(live)
        live.close()
        refused = _dial(link)
        assert _closed_by_proxy(refused)
        refused.close()
        link.heal()
        assert not link.partitioned()
        assert _roundtrip(link, b"again") == b"again"
        st = link.stats()
        assert st["netfaults_partitions"] == 1 and st["netfaults_heals"] == 1
        assert st["netfaults_partition_drops"] >= 2 and st["netfaults_conns_refused"] >= 1
        assert st["netfaults_conns"] >= 3
        assert st["netfaults_bytes_c2s"] >= len(b"hellopingagain")
        assert set(st) == set(jnet.LinkProxy(echo.addr).stats())
    finally:
        link.stop()


def test_asymmetric_delay(echo):
    link = net.LinkProxy(echo.addr, name="t:delay")
    try:
        assert _roundtrip(link, b"warm") == b"warm"
        for c2s, s2c in ((0.25, 0.0), (0.0, 0.25)):
            link.set_delay(c2s_s=c2s, s2c_s=s2c)
            t0 = time.monotonic()
            assert _roundtrip(link, b"slow") == b"slow"
            assert time.monotonic() - t0 >= 0.25
        link.set_delay()
        assert link.stats()["netfaults_delays_injected"] >= 2
    finally:
        link.stop()


def test_reorder_swaps_adjacent_chunks(echo):
    link = net.LinkProxy(echo.addr, name="t:reorder")
    try:
        s = _dial(link)
        s.sendall(b"x")  # a connection up before the budget is armed
        assert _recv_n(s, 1) == b"x"
        link.set_reorder(1)
        s.sendall(b"A")
        time.sleep(0.05)  # two chunks, not one
        s.sendall(b"B")
        assert _recv_n(s, 2) == b"BA"
        s.close()
        assert link.stats()["netfaults_reorders_injected"] == 1
        # a held chunk with nothing after it is flushed when the stream idles
        link.set_reorder(1)
        assert _roundtrip(link, b"C") == b"C"
    finally:
        link.stop()


def _plan_run(pkg: str, echo, payload: bytes) -> dict:
    """The same FaultPlan schedule through either package's LinkProxy:
    refuse the first connect, stall the first c2s chunk, corrupt the first
    s2c chunk; what the client saw and the counters."""
    mod, fmod = PAIRS[pkg]
    plan = fmod.FaultPlan(seed=23)
    plan.add("refuse", "connect", first=1)
    plan.add("stall", "c2s", first=1, stall_s=0.2)
    plan.add("corrupt", "s2c", first=1)
    link = mod.LinkProxy(echo.addr, plan=plan, name="t:plan")
    try:
        first = _dial(link)
        refused = _closed_by_proxy(first)
        first.close()
        s = _dial(link)
        t0 = time.monotonic()
        s.sendall(payload)
        got = _recv_n(s, len(payload))
        dt = time.monotonic() - t0
        s.close()
        assert _wait(lambda: link.stats()["netfaults_conns"] >= 1)
        return {"refused": refused, "got": got, "stalled": dt >= 0.2, "plan": plan.stats(),
                "plan_faults": link.stats()["netfaults_plan_faults"]}
    finally:
        link.stop()


def test_fault_plan_refuse_stall_corrupt_equal_jax(echo):
    payload = bytes(range(64))
    port, jax = _plan_run("port", echo, payload), _plan_run("jax", echo, payload)
    assert port == jax
    assert port["refused"] and port["stalled"]
    diff = [i for i, (a, b) in enumerate(zip(port["got"], payload)) if a != b]
    assert len(diff) == 1 and port["got"][diff[0]] == payload[diff[0]] ^ 0xFF
    assert port["plan"]["faults_refuse"] == port["plan"]["faults_stall"] == port["plan"]["faults_corrupt"] == 1
    assert port["plan_faults"] == 3


def test_wan_profiles_and_clusters_equal_jax():
    assert set(net.WAN_PROFILES) == set(jnet.WAN_PROFILES)
    for name in net.WAN_PROFILES:
        assert dataclasses.asdict(net.wan_profile(name)) == dataclasses.asdict(jnet.wan_profile(name))
    custom = net.WanProfile("custom", (0.01, 0.02), jitter_s=0.001)
    assert net.wan_profile(custom) is custom
    with pytest.raises(KeyError, match="unknown WAN profile"):
        net.wan_profile("moon")
    for n in range(0, 13):
        for k in range(1, 6):
            assert net.geo_clusters(n, k) == jnet.geo_clusters(n, k)
    with pytest.raises(ValueError):
        net.geo_clusters(4, 0)


@pytest.mark.parametrize("profile", sorted(jnet.WAN_PROFILES))
def test_seeded_wan_samples_equal_jax(echo, profile):
    """The same profile, seed and link name sample the same base latencies
    and continue the same per-chunk stream in both packages."""
    links = {pkg: mod.LinkProxy(echo.addr, name=f"fab:{profile}:0->1") for pkg, (mod, _) in PAIRS.items()}
    try:
        for link in links.values():
            link.set_wan(profile, seed=42)
        (p1, base1, rng1), (p2, base2, rng2) = links["port"]._wan, links["jax"]._wan
        assert p1.name == p2.name == profile
        assert base1 == base2
        assert [rng1.random() for _ in range(32)] == [rng2.random() for _ in range(32)]
        assert links["port"].wan_profile_name() == profile
        links["port"].set_wan(None)
        assert links["port"].wan_profile_name() is None
    finally:
        for link in links.values():
            link.stop()


def test_wan_shaping_counts_on_the_relay(echo):
    link = net.LinkProxy(echo.addr, name="t:wan")
    try:
        link.set_wan("lan", seed=1)
        assert _roundtrip(link, b"shaped") == b"shaped"
        st = link.stats()
        assert st["netfaults_wan_profiled"] == 1
        assert st["netfaults_wan_delays_applied"] >= 2
        assert st["netfaults_wan_delay_seconds"] > 0
    finally:
        link.stop()


def _fabric_run(pkg: str, echo) -> dict:
    mod, _ = PAIRS[pkg]
    fab = mod.NetFabric(name=f"fab-{pkg}")
    try:
        for i in range(4):
            for j in range(i):
                fab.add_link(i, j, echo.addr)
        fab.partition_groups([0, 1])
        cut = sorted(k for k, link in fab.links().items() if link.partitioned())
        stats_cut = fab.stats()
        fab.heal_all()
        healed = not any(link.partitioned() for link in fab.links().values())
        fab.apply_geo(mod.geo_clusters(4, 2), seed=5)
        geo = {k: (link.wan_profile_name(), link._wan[1]) for k, link in sorted(fab.links().items())}
        fab.clear_wan()
        fab.set_delay(2, 0, c2s_s=0.01)
        with pytest.raises(KeyError):
            fab.set_delay(0, 2)
        of_3 = sorted(f"{link.name}" for link in fab.links_of(3))
        return {"cut": cut, "stats_cut": stats_cut, "healed": healed, "geo": geo, "of_3": of_3,
                "stats": fab.stats()}
    finally:
        fab.stop()


def test_fabric_groups_equal_jax(echo):
    port, jax = _fabric_run("port", echo), _fabric_run("jax", echo)
    port["of_3"] = [n.replace("fab-port", "fab") for n in port["of_3"]]
    jax["of_3"] = [n.replace("fab-jax", "fab") for n in jax["of_3"]]
    # the geo samples are seeded by the link's name, which holds the fabric's
    assert [p for p, _ in port["geo"].values()] == [p for p, _ in jax["geo"].values()]
    port.pop("geo"), jax.pop("geo")
    assert port == jax
    assert port["cut"] == [(2, 0), (2, 1), (3, 0), (3, 1)]
    assert port["stats_cut"]["netfaults_partitioned"] == 4 and port["stats_cut"]["netfaults_links"] == 6
    assert port["healed"]


def test_netfaults_scrape_keys_equal_jax(echo):
    """The netfaults_* producer, registered under its own prefix beside the
    faults_* one, gives the JAX package's family names, and a live fabric's
    counters reach the scrape."""
    fab = net.NetFabric(name="scrape")
    link = fab.add_link(1, 0, echo.addr)
    try:
        assert _roundtrip(link, b"count me") == b"count me"

        def names(tel) -> set[str]:
            return {f.name for f in tel.default_registry().collect()
                    if f.name.startswith(("netfaults_", "faults_"))}

        assert names(telemetry) == names(jtelemetry)
        assert any(n.startswith("faults_supervisor") for n in names(telemetry))
        assert set(net.telemetry_counters()) == set(jnet.telemetry_counters())
        assert _wait(lambda: net.telemetry_counters()["netfaults_bytes_s2c"] >= 8)
        fams = {f.name: f for f in telemetry.default_registry().collect()}
        assert fams["netfaults_links"].samples[0][2] >= 1
    finally:
        fab.stop()
    assert fab not in net._fabrics


def test_link_proxy_as_its_own_process(echo):
    """`python -m tendermint_tpu_torch.ops.netfaults` prints the address to
    dial, relays, and prints its counters as one JSON line on SIGTERM."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "tendermint_tpu_torch.ops.netfaults",
         "--upstream", f"{echo.addr[0]}:{echo.addr[1]}", "--delay-c2s", "0.01"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        laddr = proc.stdout.readline().strip()
        host, port = laddr.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=10)
        s.settimeout(10)
        s.sendall(b"via a process")
        assert _recv_n(s, 13) == b"via a process"
        s.close()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        stats = json.loads(out.strip().splitlines()[-1])
        assert stats["netfaults_conns"] == 1 and stats["netfaults_delays_injected"] >= 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
