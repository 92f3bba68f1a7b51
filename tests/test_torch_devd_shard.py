"""The port's multi-daemon device plane (ops/devd_shard.py) against the JAX
package's: the JAX test file's cases (tests/test_devd_shard.py) on a port
DaemonFleet of sim daemons, and the slice planners against JAX's on a grid
of shapes.

Sim daemons verify structurally (a 32-byte key with a 64-byte signature is
accepted), so forged lanes are wrong-length lanes, which the CPU verifier
refuses too: every verdict here equals the CPU's whichever route served
it. Sim hashing is real, so digests and trees are held against the JAX
package's hashing. Sockets live in a short directory under /tmp (AF_UNIX
stops at 108 bytes)."""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import pytest

from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto.hashing import ripemd160 as jripemd160
from tendermint_tpu.merkle.simple import flat_tree_from_leaf_digests as jflat_tree
from tendermint_tpu.ops import devd_shard as jshard
from tendermint_tpu_torch import devd
from tendermint_tpu_torch.crypto.hashing import ripemd160
from tendermint_tpu_torch.merkle.simple import flat_tree_from_leaf_digests
from tendermint_tpu_torch.ops import devd_backend, devd_shard, gateway
from tendermint_tpu_torch.ops.faults import DaemonFleet

SIM_ENV = {"TENDERMINT_DEVD_SIM_RATE": "200000"}


@pytest.fixture()
def sock_dir():
    d = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _reset() -> None:
    gateway.reset_devd_breaker()
    devd_shard.reset()
    devd_backend.reset_stream_latches()
    devd.bust_avail_cache()


@pytest.fixture()
def shard_env(monkeypatch):
    """Fast breaker windows, an 8-lane floor, no inherited endpoints; the
    endpoint table, the breakers, the backend's client and latches, the
    probe cache and the default gateway instances fresh around the test.
    TENDERMINT_DEVD_STREAM_MIN stays at its 256: slices here ride the
    single-shot op, whose sim verdicts are structural, so wrong-length
    lanes mark forgeries (the stream's fixed-width frames reject them)."""
    for k in ("TENDERMINT_DEVD_SOCKS", "TENDERMINT_DEVD_SOCK", "TENDERMINT_DEVD_STREAM_MIN"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", "devd")
    monkeypatch.setenv("TENDERMINT_TPU_MIN_BATCH", "8")
    monkeypatch.setenv("TENDERMINT_TPU_BREAKER_BACKOFF_S", "0.05")
    monkeypatch.setenv("TENDERMINT_TPU_BREAKER_BACKOFF_CAP_S", "0.25")
    monkeypatch.setattr(devd_backend, "_client", None)
    monkeypatch.setattr(gateway, "_default_verifier", None)
    monkeypatch.setattr(gateway, "_default_hasher", None)
    _reset()
    yield monkeypatch
    _reset()


def _items(n: int, tag: bytes = b"shard"):
    seed = b"\x2a" * 32
    pub = jed.public_key(seed)
    return [(pub, tag + b"-%d" % i, jed.sign(seed, tag + b"-%d" % i)) for i in range(n)]


def _forge(items, idx):
    """Wrong-length signatures: refused by the sim verifier and the CPU."""
    for i in idx:
        p, m, s = items[i]
        items[i] = (p, m, s[:10])
    return items


def _cpu(items) -> list[bool]:
    return [jed.verify(*it) for it in items]


def _until_both_serve(run, tries: int = 10, key: str = "dispatched_slices") -> int:
    """Run a batch until every endpoint's `key` counter is at least 1
    (bounded). One batch can leave an endpoint idle: its worker may start
    after the other has taken every slice, home and stolen. Returns the
    batches run."""
    for k in range(1, tries + 1):
        run()
        if all(d[key] >= 1 for d in devd_shard.endpoint_stats().values()):
            return k
    pytest.fail(f"an endpoint served nothing in {tries} batches: {devd_shard.endpoint_stats()}")


# -- units ----------------------------------------------------------------------


def test_endpoint_paths_parsing(shard_env):
    mp = shard_env
    mp.setenv("TENDERMINT_DEVD_SOCKS", " /a.sock , /b.sock,/a.sock,, ")
    assert devd_shard.endpoint_paths() == ["/a.sock", "/b.sock"] == jshard.endpoint_paths()
    assert devd_shard.enabled()
    mp.setenv("TENDERMINT_DEVD_SOCKS", "/only.sock")
    assert devd_shard.endpoint_paths() == ["/only.sock"]
    assert not devd_shard.enabled()
    assert devd.sock_path() == "/only.sock"
    mp.setenv("TENDERMINT_DEVD_SOCK", "/pinned.sock")
    assert devd.sock_path() == "/pinned.sock"
    mp.delenv("TENDERMINT_DEVD_SOCKS", raising=False)
    mp.delenv("TENDERMINT_DEVD_SOCK", raising=False)
    assert devd_shard.endpoint_paths() == [devd.DEFAULT_SOCK]
    assert not devd_shard.enabled()


def test_plan_slices_respects_floor_and_balance():
    plan = devd_shard._plan_slices
    assert plan(64, 2, 8) == [(0, 16), (16, 32), (32, 48), (48, 64)]
    assert plan(20, 2, 8) == [(0, 10), (10, 20)]
    assert plan(5, 4, 8) == [(0, 5)]
    slices = plan(67, 3, 4)
    assert slices[0] == (0, 12) and slices[-1][1] == 67
    assert all(b == c for (_, b), (c, _) in zip(slices, slices[1:]))
    assert all(stop - start >= 4 for start, stop in slices)


# n < 2 * floor, floors of 0 and 1, zero-history endpoints, equal weights
# (largest-remainder ties), shares below one slice, one endpoint
PLAN_NS = (0, 1, 5, 7, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 101, 401, 1000, 4000, 10_000)
PLAN_FLOORS = (0, 1, 8, 16, 32)
PLAN_WEIGHTS = (
    [0.0, 0.0], [1.0, 0.0], [0.0, 5.0], [1.0, 1.0], [1.0, 1.0, 1.0], [3.0, 1.0],
    [1.0, 2.0, 3.0], [0.0, 2.5, 0.0], [1e-9, 1.0], [1e6, 1.0, 1.0, 1.0], [7.0],
    [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
)


@pytest.mark.parametrize("planner", ["equal", "weighted"])
def test_slice_plans_equal_jax(planner):
    for n in PLAN_NS:
        for floor in PLAN_FLOORS:
            if planner == "equal":
                for workers in (1, 2, 3, 4, 7):
                    assert devd_shard._plan_slices(n, workers, floor) == \
                        jshard._plan_slices(n, workers, floor), (n, workers, floor)
            else:
                for w in PLAN_WEIGHTS:
                    got = devd_shard._plan_slices_weighted(n, list(w), floor)
                    assert got == jshard._plan_slices_weighted(n, list(w), floor), (n, w, floor)
                    if got is not None:
                        assert [s for s, _, _ in got] == [0] + [e for _, e, _ in got[:-1]]
                        assert got[-1][1] == n


def test_breaker_registry_keyed_and_backcompat(shard_env):
    assert gateway.devd_breaker() is gateway.devd_breaker(devd.sock_path())
    a = gateway.devd_breaker("/a.sock")
    b = gateway.devd_breaker("/b.sock")
    assert a is not b and a is gateway.devd_breaker("/a.sock")
    a.record_failure()
    states = gateway.devd_breaker_states()
    assert set(states) >= {"/a.sock", "/b.sock"}
    assert states["/b.sock"] == 0
    gateway.reset_devd_breaker()
    assert gateway.devd_breaker_states() == {}


# -- a real fleet ---------------------------------------------------------------------


@pytest.fixture()
def fleet2(shard_env, sock_dir):
    fleet = DaemonFleet(2, sock_dir=sock_dir, extra_env=SIM_ENV)
    fleet.start()
    shard_env.setenv("TENDERMINT_DEVD_SOCKS", fleet.socks_env)
    yield fleet
    fleet.stop()


def test_sharded_verify_per_lane_attribution(fleet2):
    assert devd_shard.enabled()
    items = _forge(_items(64), [5, 17, 40, 63])
    want = _cpu(items)
    assert [i for i, ok in enumerate(want) if not ok] == [5, 17, 40, 63]

    def run():
        assert devd_shard.verify_batch(items) == want

    batches = _until_both_serve(run)
    st = devd_shard.endpoint_stats()
    assert len(st) == 2
    assert sum(d["dispatched_slices"] for d in st.values()) >= 2
    assert sum(d["sigs"] for d in st.values()) == 64 * batches


def test_work_stealing_from_slow_endpoint(shard_env, sock_dir):
    """One endpoint 4000x slower than the other: the fast one drains its own
    slices and steals the slow one's, and the batch finishes at the fleet's
    speed."""
    slow = DaemonFleet(1, sock_dir=sock_dir, extra_env={"TENDERMINT_DEVD_SIM_RATE": "50"})
    fast = DaemonFleet(1, sock_dir=sock_dir, extra_env={"TENDERMINT_DEVD_SIM_RATE": "200000"})
    slow.start()
    fast.start()
    try:
        shard_env.setenv("TENDERMINT_DEVD_SOCKS", ",".join([slow.sock_paths[0], fast.sock_paths[0]]))
        # floor 8, 64 lanes, 2 workers: 4 slices of 16; the slow endpoint's
        # first alone takes 16 / 50 = 0.32 s
        items = _forge(_items(64), [9])
        t0 = time.monotonic()
        got = devd_shard.verify_batch(items)
        dt = time.monotonic() - t0
        assert [i for i, ok in enumerate(got) if not ok] == [9]
        st = devd_shard.endpoint_stats()
        assert st[fast.sock_paths[0]]["stolen_slices"] >= 1, st
        # 64 lanes at rate 50 would take 1.28 s on the slow daemon alone
        assert dt < 1.2, f"batch gated on the slow endpoint ({dt:.2f}s)"
        assert devd_shard.plane_stats()["stolen_slices"] >= 1
    finally:
        slow.stop()
        fast.stop()


def test_sharded_hash_parity_and_tree(fleet2):
    parts = [bytes([i % 251]) * 700 for i in range(32)]
    want = [jripemd160(p) for p in parts]
    assert want == [ripemd160(p) for p in parts]

    def run():
        assert devd_shard.hash_batch(parts) == want
        digests, internal = devd_shard.hash_tree(parts)
        assert digests == want
        assert internal == jflat_tree(want).internal_nodes() == flat_tree_from_leaf_digests(want).internal_nodes()

    # one call can leave an endpoint idle under load: repeat until both
    # have hashed
    _until_both_serve(run, key="hash_bytes")
    st = devd_shard.endpoint_stats()
    assert all(d["hash_bytes"] > 0 for d in st.values()), st


def test_gateway_verifier_rides_sharded_plane(fleet2):
    """A devd-routed Verifier's batches shard over the fleet, in order, and
    the prime / pop pipeline works unchanged."""
    v = gateway.Verifier(min_tpu_batch=1)
    assert v.kernel == "devd"
    items = _forge(_items(48, tag=b"gw"), [7, 33])
    want = [i not in (7, 33) for i in range(48)]
    assert want == _cpu(items)

    def run():
        assert v.verify_batch(items) == want

    batches = _until_both_serve(run)
    st = devd_shard.endpoint_stats()
    # the gateway sends the 2 wrong-length lanes to the CPU; the 46
    # well-formed ones shard
    assert sum(d["sigs"] for d in st.values()) == 46 * batches

    primed = _forge(_items(32, tag=b"prime"), [3])
    v.prime_cache_async(primed)
    assert v.pop_primed(primed[3]) is False
    assert v.pop_primed(primed[4]) is True
    assert v.pop_primed(primed[4]) is None  # single use

    vs = v.stats()
    assert vs["tpu_sigs"] >= 48
    assert any(k.startswith("stream") for k in vs), sorted(vs)


def test_kill_one_endpoint_mid_batch_redispatches(fleet2):
    """SIGKILL one daemon and dispatch: its slices re-dispatch to the healthy
    endpoint, every lane keeps the CPU's verdict, and the dead endpoint's
    breaker took the failure."""
    items = _forge(_items(64, tag=b"kill"), [11, 50])
    want = _cpu(items)
    assert want == [i not in (11, 50) for i in range(64)]
    assert devd_shard.verify_batch(items) == want
    fleet2.kill(0)
    dead = fleet2.sock_paths[0]
    assert devd_shard.verify_batch(items) == want
    st = devd_shard.endpoint_stats()
    assert st[dead]["redispatches"] >= 1, st
    assert gateway.devd_breaker(dead).stats()["breaker_consecutive_failures"] >= 1
    assert gateway.devd_plane_allow()


def test_all_endpoints_dead_raises_to_cpu_floor(shard_env, sock_dir):
    """Every breaker open: the dispatcher refuses (DevdShardError) and the
    Verifier serves the CPU floor's verdicts."""
    socks = [os.path.join(sock_dir, "gone-0.sock"), os.path.join(sock_dir, "gone-1.sock")]
    shard_env.setenv("TENDERMINT_DEVD_SOCKS", ",".join(socks))
    shard_env.setenv("TENDERMINT_TPU_BREAKER_FAILURES", "1")
    items = _forge(_items(24, tag=b"floor"), [2])
    v = gateway.Verifier(min_tpu_batch=1)
    assert v.verify_batch(items) == [i != 2 for i in range(24)]
    states = gateway.devd_breaker_states()
    assert all(states[s] == 2 for s in socks), states
    assert not gateway.devd_plane_allow()
    with pytest.raises(devd_shard.DevdShardError):
        devd_shard.verify_batch(items)
    assert v.verify_batch(items) == [i != 2 for i in range(24)]
    assert v.stats()["cpu_sigs"] >= 24


def test_kill_during_a_batch_keeps_every_verdict(shard_env, sock_dir):
    """SIGKILL one daemon while a batch is on both: its slice in flight
    fails, re-dispatches to the survivor, and every lane keeps the CPU's
    verdict."""
    fleet = DaemonFleet(2, sock_dir=sock_dir, extra_env={"TENDERMINT_DEVD_SIM_RATE": "100"})
    fleet.start()
    try:
        shard_env.setenv("TENDERMINT_DEVD_SOCKS", fleet.socks_env)
        items = _forge(_items(64, tag=b"mid"), [1, 30, 62])
        # 4 slices of 16 lanes, 0.16 s each at 100 lanes/s: the kill lands
        # while endpoint 0 holds its first
        resolve = devd_shard.verify_batch_async(items)
        time.sleep(0.05)
        fleet.kill(0)
        assert resolve() == _cpu(items)
        st = devd_shard.endpoint_stats()
        assert st[fleet.sock_paths[0]]["redispatches"] >= 1, st
        assert st[fleet.sock_paths[1]]["sigs"] + st[fleet.sock_paths[0]]["sigs"] == 64
        assert gateway.devd_breaker(fleet.sock_paths[1]).state == 0
    finally:
        fleet.stop()
