"""The port's process tier (tendermint_tpu_torch/ops/localnet.py and the
port's copy of test/p2p/{localnet,scenarios}.py) against the JAX
package's.

- Generation: one `LocalnetSpec` gives equal keys, genesis (all but the
  timestamp), config.toml (all but the paths), dial edges and consensus
  timeouts from both packages' `Localnet.generate`.
- A mixed fleet: four node processes from one generated root, two of
  the JAX package's CLI and two of the port's, on kvstore, peered through
  the port's link proxies, commit the same blocks byte for byte.
- The device rule in processes: a port `LocalNode` or `ReplicaProc`
  passes no TENDERMINT_TPU_DISABLE and no JAX_PLATFORMS to its child
  (not even from this process's environment), runs the port's CLI, and
  routes to a daemon only through `extra_env`.
- The six test/p2p scenarios (basic, atomic_broadcast, fast_sync,
  kill_all, seeds, pex) on port node processes, slow-marked as the JAX
  tier's are.

Port node processes verify and hash through a port device daemon that
accepts the CPU (`devd_sock`, tests/test_torch_cli.py): a port node has
no card here and no CPU default.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from tendermint_tpu.ops import localnet as jlocalnet
from tendermint_tpu_torch.ops import localnet
from chip_smoke import free_port_range
from tests.test_torch_cli import devd_sock, node_env  # noqa: F401 — devd_sock is a fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXED_S = 90.0  # the mixed fleet's own bound: start, 3 heights, the byte checks
MIXED_HEIGHTS = 3


# -- generation parity -------------------------------------------------------------

SPECS = {
    "full4": dict(n=4, proxy_app="signedkv", db_backend="sqlite", upgrade_height=3),
    "ring20_wan": dict(n=20, wan="continental", seed=7, gossip_dedup=False),
    "star6_pex": dict(n=6, topology="star", pex=True, max_block_txs=150, chain_id="star-net",
                      commit_format="full", upgrade_height=5, timeout_commit=0.5),
    "geo9": dict(n=9, geo=3, ring_k=2, topology="ring"),
}


def _read_home(home: str) -> dict:
    with open(os.path.join(home, "genesis.json")) as f:
        genesis = json.load(f)
    genesis.pop("genesis_time")
    with open(os.path.join(home, "priv_validator.json")) as f:
        pv = json.load(f)
    with open(os.path.join(home, "config.toml")) as f:
        toml = f.read().replace(home, "<home>")
    return {"genesis": genesis, "pv": pv, "toml": toml}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_generation_equal_to_jax(name, tmp_path):
    """Both packages' Localnet.generate from one spec write equal homes:
    keys, genesis (all but the timestamp), config.toml (all but the
    paths); and the spec's dial edges and consensus timeouts are equal."""
    homes = {}
    for tag, mod in (("jax", jlocalnet), ("port", localnet)):
        spec = mod.LocalnetSpec(root=str(tmp_path / tag), **SPECS[name])
        net = mod.Localnet(spec)
        try:
            net.generate()
            homes[tag] = [_read_home(spec.home(i)) for i in range(spec.n)]
            homes[tag + "_shape"] = (spec.resolved_topology(), spec.dial_edges(), spec.consensus_timeouts(),
                                     [spec.p2p_port(i) for i in range(spec.n)],
                                     [spec.rpc_port(i) for i in range(spec.n)])
        finally:
            net.fabric.stop()
    assert homes["port"] == homes["jax"]
    assert homes["port_shape"] == homes["jax_shape"]
    assert len({json.dumps(h["genesis"]) for h in homes["port"]}) == 1
    assert len({h["pv"]["address"] for h in homes["port"]}) == SPECS[name]["n"]


def test_seeded_address_book_equal_to_jax(tmp_path):
    """seed_addr_book writes the same hearsay book (entries and the
    per-node bucket key) from both packages."""
    from tendermint_tpu.config import load_config as jload_config
    from tendermint_tpu_torch.config import load_config

    books = {}
    for tag, mod, load in (("jax", jlocalnet, jload_config), ("port", localnet, load_config)):
        spec = mod.LocalnetSpec(n=3, root=str(tmp_path / tag), seed=3)
        net = mod.Localnet(spec).generate()
        try:
            assert net.seed_addr_book(1, [f"10.0.{i}.1:26656" for i in range(5)]) == 5
            with open(load(spec.home(1)).p2p.addr_book()) as f:
                books[tag] = json.load(f)
        finally:
            net.fabric.stop()
    assert books["port"] == books["jax"] and len(books["port"]["addrs"]) == 5


# -- the device rule in processes --------------------------------------------------


class _Captured:
    """subprocess.Popen stand-in that records a member's command and env."""

    calls: list = []

    def __init__(self, cmd, cwd=None, env=None, stdout=None, stderr=None):
        _Captured.calls.append({"cmd": cmd, "cwd": cwd, "env": env})
        if stdout is not None and hasattr(stdout, "close"):
            stdout.close()

    def poll(self):
        return 0

    def send_signal(self, sig):
        pass

    def wait(self, timeout=None):
        return 0


def test_member_env_has_no_host_fallback(tmp_path, monkeypatch):
    """A port LocalNode and ReplicaProc run the port's CLI and pass no
    TENDERMINT_TPU_DISABLE and no JAX_PLATFORMS to the child, though this
    process sets both; TENDERMINT_DEVD_SOCK defaults to a path no daemon
    serves, and extra_env (applied after the defaults) routes the member
    to a daemon."""
    monkeypatch.setenv("TENDERMINT_TPU_DISABLE", "1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("TENDERMINT_DEVD_SOCK", raising=False)
    _Captured.calls = []
    monkeypatch.setattr(localnet.subprocess, "Popen", _Captured)
    spec = localnet.LocalnetSpec(n=2, root=str(tmp_path / "net"))
    net = localnet.Localnet(spec).generate()
    try:
        net.nodes[0].start()
        routed = localnet.LocalnetSpec(n=2, root=spec.root, extra_env={"TENDERMINT_DEVD_SOCK": "/tmp/x.sock"})
        localnet.LocalNode(routed, 1).start()
        localnet.ReplicaProc(str(tmp_path / "rep"), net.nodes[0].rpc_url, 47999).start()
        localnet.ReplicaProc(str(tmp_path / "rep2"), net.nodes[0].rpc_url, 47998,
                             extra_env={"TENDERMINT_DEVD_SOCK": "/tmp/y.sock"}).start()
    finally:
        net.fabric.stop()
    assert len(_Captured.calls) == 4
    for call in _Captured.calls:
        assert call["cmd"][1:3] == ["-m", "tendermint_tpu_torch.cli"]
        assert "TENDERMINT_TPU_DISABLE" not in call["env"] and "JAX_PLATFORMS" not in call["env"]
        assert call["env"]["PYTHONPATH"] == REPO and call["cwd"] == REPO
    socks = [c["env"]["TENDERMINT_DEVD_SOCK"] for c in _Captured.calls]
    assert socks == ["/nonexistent/devd.sock", "/tmp/x.sock", "/nonexistent/devd.sock", "/tmp/y.sock"]
    assert [c["cmd"][5] for c in _Captured.calls] == ["node", "node", "replica", "replica"]
    # a tool run beside the fleet (the smoke's `replay`) gets a member's env
    tool = localnet.member_env()
    assert "TENDERMINT_TPU_DISABLE" not in tool and "JAX_PLATFORMS" not in tool
    assert tool["TENDERMINT_DEVD_SOCK"] == "/nonexistent/devd.sock" and tool["PYTHONPATH"] == REPO


# -- a mixed fleet: JAX and port node processes ------------------------------------


def test_mixed_fleet_converges(tmp_path, devd_sock):
    """Four node processes from one root generated by the port's Localnet
    (kvstore, full topology through the port's link proxies): nodes 0 and
    1 run the JAX package's CLI (its LocalNode), 2 and 3 the port's
    (routed to the CPU daemon). Within MIXED_S all reach height
    MIXED_HEIGHTS and every height up to it is byte-identical (block hash,
    part-set root, app hash) across the four."""
    t0 = time.monotonic()
    fields = dict(n=4, root=str(tmp_path / "mixed"), base_port=free_port_range(2 * 4), chain_id="mixed-net",
                  log_level="warning")
    spec = localnet.LocalnetSpec(**fields, extra_env={"TENDERMINT_DEVD_SOCK": devd_sock})
    jspec = jlocalnet.LocalnetSpec(**fields)
    net = localnet.Localnet(spec).generate()
    net.nodes[0] = jlocalnet.LocalNode(jspec, 0)
    net.nodes[1] = jlocalnet.LocalNode(jspec, 1)
    try:
        net.start()
        reached = net.wait_height(MIXED_HEIGHTS, timeout=max(1.0, MIXED_S - 15 - (time.monotonic() - t0)))
        logs = {}
        if not reached:
            for i in range(4):
                with open(os.path.join(spec.home(i), "node.log"), "rb") as f:
                    logs[i] = f.read()[-600:].decode(errors="replace")
        assert reached, (net.heights(), logs)
        assert net.assert_converged(MIXED_HEIGHTS) == MIXED_HEIGHTS
        versions = {i: net.nodes[i].rpc("status")["node_info"]["moniker"] for i in range(4)}
        assert versions == {i: f"node{i}" for i in range(4)}
    finally:
        net.stop()
    assert time.monotonic() - t0 < MIXED_S


# -- test/p2p's scenarios on port node processes (slow, as tests/test_localnet.py) ----


class P2PNode:
    """test/p2p/localnet.py's Node, with the CLI's package as a parameter."""

    def __init__(self, home: str, index: int, p2p_port: int, rpc_port: int, pkg: str, devd_sock: str):
        self.home = home
        self.index = index
        self.p2p_port = p2p_port
        self.rpc_port = rpc_port
        self.pkg = pkg
        self.devd_sock = devd_sock
        self.proc: subprocess.Popen | None = None

    def start(self, seeds: str = "", extra: list[str] | None = None) -> None:
        cmd = [
            sys.executable, "-m", f"{self.pkg}.cli",
            "--home", self.home, "node",
            "--proxy_app", "kvstore",
            "--p2p.laddr", f"tcp://127.0.0.1:{self.p2p_port}",
            "--rpc.laddr", f"tcp://127.0.0.1:{self.rpc_port}",
            "--log_level", "warning",
        ]
        if seeds:
            cmd += ["--seeds", seeds]
        cmd += extra or []
        self.proc = subprocess.Popen(
            cmd, cwd=REPO, env=node_env(self.pkg, self.devd_sock),
            stdout=open(os.path.join(self.home, "node.log"), "ab"), stderr=subprocess.STDOUT,
        )

    def rpc(self, method: str, params: dict | None = None, timeout: float = 30):
        body = json.dumps({"jsonrpc": "2.0", "id": "ln", "method": method, "params": params or {}}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{self.rpc_port}/", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = json.loads(resp.read())
        if out.get("error"):
            raise RuntimeError(f"node{self.index} {method}: {out['error']}")
        return out["result"]

    def height(self) -> int:
        try:
            return int(self.rpc("status")["latest_block_height"])
        except Exception:  # noqa: BLE001 — down/starting counts as -1
            return -1

    def kill(self, sig=signal.SIGKILL) -> None:
        if self.proc is None:
            return
        try:
            self.proc.send_signal(sig)
            self.proc.wait(timeout=10)
        except Exception:  # noqa: BLE001 — a wedged shutdown escalates
            try:
                self.proc.kill()
                self.proc.wait(timeout=10)
            except Exception:  # noqa: BLE001
                pass
        self.proc = None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class P2PLocalnet:
    """test/p2p/localnet.py's Localnet (homes from the CLI's own `testnet`),
    with the CLI's package as a parameter."""

    def __init__(self, n: int, root: str, base_port: int, pkg: str, devd_sock: str):
        self.root = root
        subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli", "testnet", "--n", str(n), "--dir", root,
             "--chain-id", "localnet"],
            cwd=REPO, env=node_env(pkg, devd_sock), check=True, capture_output=True,
        )
        self.nodes = [P2PNode(os.path.join(root, f"mach{i}"), i, base_port + 2 * i, base_port + 2 * i + 1,
                              pkg, devd_sock) for i in range(n)]

    def seeds_for(self, index: int) -> str:
        return ",".join(f"127.0.0.1:{nd.p2p_port}" for nd in self.nodes if nd.index != index)

    def start_all(self) -> None:
        for nd in self.nodes:
            nd.start(seeds=self.seeds_for(nd.index))

    def stop_all(self) -> None:
        for nd in self.nodes:
            nd.kill(signal.SIGTERM)

    def wait_height(self, h: int, timeout: float = 120, nodes=None) -> bool:
        nodes = nodes if nodes is not None else self.nodes
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(nd.height() >= h for nd in nodes):
                return True
            time.sleep(0.5)
        return False

    def heights(self) -> list[int]:
        return [nd.height() for nd in self.nodes]

    def block_hash(self, index: int, height: int) -> str:
        return self.nodes[index].rpc("block", {"height": height})["block_meta"]["block_id"]["hash"]

    def assert_chains_agree(self, upto: int) -> None:
        for h in range(1, upto + 1):
            hashes = {self.block_hash(i, h) for i in range(len(self.nodes))}
            assert len(hashes) == 1, f"nodes disagree at height {h}: {hashes}"


def basic(net) -> None:
    """Every node makes progress and the chains are identical
    (test/p2p/basic/test.sh)."""
    net.start_all()
    assert net.wait_height(3), f"no progress: {net.heights()}"
    net.assert_chains_agree(3)


def atomic_broadcast(net) -> None:
    """A tx sent to one node commits on every node
    (test/p2p/atomic_broadcast/test.sh)."""
    net.start_all()
    assert net.wait_height(1), net.heights()
    res = net.nodes[0].rpc("broadcast_tx_commit", {"tx": b"atomic=broadcast".hex()}, timeout=60)
    assert res["deliver_tx"]["code"] == 0, res
    key = b"atomic".hex()
    deadline = time.monotonic() + 60
    missing = set(range(len(net.nodes)))
    while time.monotonic() < deadline and missing:
        for i in list(missing):
            try:
                q = net.nodes[i].rpc("abci_query", {"data": key})
                if bytes.fromhex(q["response"]["value"] or "") == b"broadcast":
                    missing.discard(i)
            except Exception:  # noqa: BLE001 — still syncing
                pass
        time.sleep(0.5)
    assert not missing, f"nodes {missing} never saw the tx"


def fast_sync(net) -> None:
    """Kill one node, let the others advance, restart it, it catches up
    (test/p2p/fast_sync/test.sh)."""
    net.start_all()
    assert net.wait_height(2), net.heights()
    straggler = net.nodes[-1]
    straggler.kill()  # SIGKILL: a crash, not a clean stop
    others = net.nodes[:-1]
    target = max(nd.height() for nd in others) + 6
    assert net.wait_height(target, nodes=others), net.heights()
    straggler.start(seeds=net.seeds_for(straggler.index))
    assert net.wait_height(target, nodes=[straggler], timeout=120), (
        f"straggler at {straggler.height()}, target {target}"
    )
    net.assert_chains_agree(target)


def kill_all(net) -> None:
    """Kill every node, restart, the chain continues from persisted state
    (test/p2p/kill_all/test.sh)."""
    net.start_all()
    assert net.wait_height(3), net.heights()
    pre = max(net.heights())
    for nd in net.nodes:
        nd.kill()  # SIGKILL across the board
    time.sleep(1)
    for nd in net.nodes:
        nd.start(seeds=net.seeds_for(nd.index))
    assert net.wait_height(pre + 3, timeout=180), f"no post-restart progress past {pre}: {net.heights()}"
    net.assert_chains_agree(pre + 3)


def seeds(net) -> None:
    """Star bootstrap: every node dials ONLY node 0 as its seed; gossip
    relays through the hub and the whole net still commits identical
    chains (test/p2p/seeds.sh)."""
    hub = net.nodes[0]
    hub.start()
    for nd in net.nodes[1:]:
        nd.start(seeds=f"127.0.0.1:{hub.p2p_port}")
    assert net.wait_height(3, timeout=180), f"star net stuck: {net.heights()}"
    net.assert_chains_agree(3)


def pex(net) -> None:
    """Peer discovery: same star seeding, but with the PEX reactor on —
    nodes must LEARN the other peers through the hub and form a denser
    mesh (> 1 peer each), and the chain advances (test/p2p/pex/test.sh)."""
    hub = net.nodes[0]
    pex_args = ["--pex", "--p2p.addr_book_strict", "false"]
    hub.start(extra=pex_args)
    for nd in net.nodes[1:]:
        nd.start(seeds=f"127.0.0.1:{hub.p2p_port}", extra=pex_args)
    assert net.wait_height(2, timeout=180), f"pex net stuck: {net.heights()}"
    deadline = time.monotonic() + 120
    dense = set()
    while time.monotonic() < deadline and len(dense) < len(net.nodes) - 1:
        for nd in net.nodes[1:]:
            try:
                if len(nd.rpc("net_info")["peers"]) > 1:
                    dense.add(nd.index)
            except Exception:  # noqa: BLE001 — still starting
                pass
        time.sleep(1)
    assert len(dense) >= len(net.nodes) - 1, (
        f"pex never densified the mesh: {sorted(dense)} of {[nd.index for nd in net.nodes[1:]]}"
    )


SCENARIOS = {
    "basic": basic,
    "atomic_broadcast": atomic_broadcast,
    "fast_sync": fast_sync,
    "kill_all": kill_all,
    "seeds": seeds,
    "pex": pex,
}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario(name, tmp_path_factory, devd_sock):
    net = P2PLocalnet(4, str(tmp_path_factory.mktemp(f"localnet-{name}")), free_port_range(2 * 4), "tendermint_tpu_torch",
                      devd_sock)
    try:
        SCENARIOS[name](net)
    finally:
        net.stop_all()


def test_spec_fields_equal_to_jax():
    """The two packages' LocalnetSpec carry the same fields and defaults."""
    j = {f.name: (f.default, f.default_factory) for f in dataclasses.fields(jlocalnet.LocalnetSpec)}
    p = {f.name: (f.default, f.default_factory) for f in dataclasses.fields(localnet.LocalnetSpec)}
    assert p == j
    assert localnet.FULL_MESH_MAX == jlocalnet.FULL_MESH_MAX and localnet.DEFAULT_RING_K == jlocalnet.DEFAULT_RING_K
    assert localnet.OVERLOAD_ENV_DEFAULTS == jlocalnet.OVERLOAD_ENV_DEFAULTS
