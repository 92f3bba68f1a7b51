"""Hundreds-of-nodes localnet tier (docs/localnet.md).

The netchaos harness (tests/netchaos_common.py) runs N full nodes
IN-PROCESS — perfect for white-box assertions, but every node shares
one interpreter, one GIL, one crash domain. This module is the same
scenario vocabulary one tier up: N real node PROCESSES (the existing
CLI node, `python -m tendermint_tpu_torch.cli node`) on loopback, each with
its own home/keys/DBs/WAL, peered through `ops/netfaults` LinkProxy
relays so the WHOLE chaos vocabulary — partitions, seeded WAN profiles,
geo-cluster topologies, rolling restarts — applies unchanged to a
process fleet. Everything is read back through the public scrape
surface (`ops/fleet`: GET /metrics + /health + consensus_trace), never
by reaching into harness objects: what a scenario asserts here is what
an operator of a real deployment could assert.

One seeded `LocalnetSpec` generates the entire net: N homes under one
root (privval keys derived from `(chain_id, index)`, one shared
genesis, per-home config.toml written through the real TOML round-trip
so the CLI node loads EXACTLY what a production home would carry).
Ports are explicit (`base_port + 2i` p2p, `+2i+1` RPC) — the fabric's
links can be strung before any process exists.

Topology is part of the spec, because a single box cannot carry a
50-node FULL mesh (1225 proxied links ≈ 5k fds and 2.5k relay
threads): `full` (node i dials every j < i — the netchaos shape,
default up to 16 nodes), `ring` (i dials (i+1..i+k) mod n — bounded
degree, diameter n/2k; the default beyond 16), `star` (everyone dials
node 0 — the seeds-node shape). Every directed dial edge gets its own
LinkProxy, so group chaos maps exactly as in the in-process tier.

Scheduling reality check: the nodes are Python processes sharing this
box's cores. The consensus timeout schedule baked into each config.toml
scales with fleet size (a 50-process net on few cores needs wider
propose windows than a 4-process one) and with the WAN profile (the
netchaos lesson: a 100 ms propose window can never cover a 40-90 ms
per-chunk link). Baked in — not mutated live — because these are real
processes: there is no shared config object to poke.

The port's device rule in processes: a node or replica process of the
fleet runs on the card, as the port's every entry point does. Its
environment carries neither JAX_PLATFORMS nor TENDERMINT_TPU_DISABLE (the
port's host-hashing fallback), not even from the parent's
(HOST_FALLBACK_ENV), where the JAX package's fleet sets both;
TENDERMINT_DEVD_SOCK defaults to a path no daemon serves, so each member
holds the card itself. A caller routes the fleet to a serving device
daemon through `LocalnetSpec.extra_env` (or `ReplicaProc`'s `extra_env`),
applied after the defaults: the CPU tests point it at a daemon that
accepts the CPU. With neither a card nor a daemon, a member exits
non-zero before it binds. The kernels are built before the fleet starts
(`ops/kernels.build` replaces each library atomically), so the members
load the built libraries from the same build directory. A member whose
node or follower a device error stops exits 1 (the CLI's wait loop).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from dataclasses import dataclass, field

from tendermint_tpu_torch.ops import fleet
from tendermint_tpu_torch.ops.netfaults import NetFabric, geo_clusters, wan_profile

logger = logging.getLogger("ops.localnet")

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# dial-degree ceiling where full mesh hands over to the ring (links grow
# O(n^2) vs O(n*k); at 16 the mesh is 120 links — still one box's worth)
FULL_MESH_MAX = 16
DEFAULT_RING_K = 4


# what a fleet member never inherits from its parent: the JAX package's
# platform pin, and the port's host-hashing fallback (a caller that wants
# either names it in extra_env)
HOST_FALLBACK_ENV = ("JAX_PLATFORMS", "TENDERMINT_TPU_DISABLE")


def member_env(extra_env: dict | None = None) -> dict:
    """A port process's environment beside the fleet (a member, or a tool
    run on a member's home): this process's less HOST_FALLBACK_ENV, no
    daemon unless `extra_env` names one, `extra_env` over the rest, and
    the repo on PYTHONPATH."""
    env = dict(os.environ)
    for k in HOST_FALLBACK_ENV:
        env.pop(k, None)
    env.update({k: str(v) for k, v in (extra_env or {}).items()})
    # never probe a live devd daemon from a fleet member: 50 nodes
    # hammering one accelerator socket is not this tier's scenario
    # (extra_env routes the fleet to one on purpose)
    env.setdefault("TENDERMINT_DEVD_SOCK", "/nonexistent/devd.sock")
    env["PYTHONPATH"] = REPO
    return env


@dataclass
class LocalnetSpec:
    """Everything that defines one localnet, seeded: two runs from the
    same spec generate identical keys, genesis (bar the timestamp),
    configs, and link fabric."""

    n: int = 4
    root: str = ""
    chain_id: str = "localnet"
    seed: int = 0
    # full | ring | star | "" (auto: full up to FULL_MESH_MAX, then ring)
    topology: str = ""
    ring_k: int = DEFAULT_RING_K
    base_port: int = 47100
    proxy_app: str = "kvstore"
    db_backend: str = "memdb"
    tx_index: str = "kv"
    gossip_dedup: bool = True
    # netfaults WAN profile name baked into the timeout schedule and
    # applied to every link at start ("" = clean loopback)
    wan: str = ""
    # >0: geo-cluster net (k clusters, lan inside / `wan` — or
    # intercontinental — between)
    geo: int = 0
    log_level: str = "error"
    # commit pacing: real timeout_commit (not the test preset's skipped
    # one) so the fleet's skew/byte-per-height readouts are meaningful
    timeout_commit: float = 0.1
    # commit-format schedule baked into the shared genesis:
    # heights >= upgrade_height carry upgrade_format last-commits,
    # heights below stay on commit_format forever (docs/upgrade.md).
    # upgrade_height=0 = no flip scheduled.
    commit_format: str = "full"
    upgrade_height: int = 0
    upgrade_format: str = "aggregate"
    # peer discovery: run the PEX reactor + address book on every node
    # (the pex_churn scenario's subject)
    pex: bool = False
    # block tx cap baked into every config.toml (0 = the config default;
    # the overload scenario shrinks it so a bulk backlog spans blocks)
    max_block_txs: int = 0
    extra_args: list = field(default_factory=list)
    # extra environment for every node process — how scenarios arm the
    # TENDERMINT_RPC_* / TENDERMINT_MEMPOOL_LANE_* overload knobs
    # (rpc/admission.py, mempool lanes) without touching config.toml
    extra_env: dict = field(default_factory=dict)

    def resolved_topology(self) -> str:
        if self.topology:
            return self.topology
        return "full" if self.n <= FULL_MESH_MAX else "ring"

    def p2p_port(self, i: int) -> int:
        return self.base_port + 2 * i

    def rpc_port(self, i: int) -> int:
        return self.base_port + 2 * i + 1

    def home(self, i: int) -> str:
        return os.path.join(self.root, f"node{i}")

    def dial_edges(self) -> list[tuple[int, int]]:
        """The directed dial edges (i dials j) of the topology. One
        direction per pair everywhere — inbound/outbound dedup never
        races, exactly the netchaos invariant."""
        topo = self.resolved_topology()
        n = self.n
        if topo == "full":
            return [(i, j) for i in range(n) for j in range(i)]
        if topo == "star":
            return [(i, 0) for i in range(1, n)]
        if topo == "ring":
            k = max(1, min(self.ring_k, n - 1))
            edges = set()
            for i in range(n):
                for d in range(1, k + 1):
                    j = (i + d) % n
                    if (j, i) not in edges and i != j:
                        edges.add((i, j))
            return sorted(edges)
        raise ValueError(
            f"unknown topology {topo!r}; known: full, ring, star"
        )

    def consensus_timeouts(self) -> dict:
        """The schedule baked into every config.toml: sized for N
        Python processes sharing this box's cores, floored for the WAN
        profile when one is armed (the netchaos _WAN_TIMEOUT_FLOOR
        lesson, applied at generation time because processes can't be
        poked live)."""
        cores = os.cpu_count() or 1
        # how oversubscribed the box is: 50 processes on 1 core need
        # ~their whole schedule stretched; 4 on 8 cores need nothing
        crowd = max(1.0, self.n / max(cores, 1) / 4.0)
        t = {
            "timeout_propose": 0.5 * crowd,
            "timeout_propose_delta": 0.25,
            "timeout_prevote": 0.1 * crowd,
            "timeout_prevote_delta": 0.1,
            "timeout_precommit": 0.1 * crowd,
            "timeout_precommit_delta": 0.1,
            "timeout_commit": self.timeout_commit,
        }
        heavy = self.wan and wan_profile(self.wan).name != "lan"
        if heavy or self.geo > 0:
            floors = {
                "timeout_propose": 1.0, "timeout_propose_delta": 0.25,
                "timeout_prevote": 0.4, "timeout_prevote_delta": 0.2,
                "timeout_precommit": 0.4, "timeout_precommit_delta": 0.2,
            }
            for k, floor in floors.items():
                t[k] = max(t[k], floor)
        return t


class LocalNode:
    """One node process of the fleet. RPC/metrics via loopback HTTP —
    the same surface ops/fleet scrapes."""

    def __init__(self, spec: LocalnetSpec, index: int):
        self.spec = spec
        self.index = index
        self.home = spec.home(index)
        self.p2p_port = spec.p2p_port(index)
        self.rpc_port = spec.rpc_port(index)
        self.proc: subprocess.Popen | None = None

    @property
    def rpc_url(self) -> str:
        return f"127.0.0.1:{self.rpc_port}"

    def start(self, seeds: str = "") -> None:
        env = member_env(self.spec.extra_env)
        # tight reconnect cadence (the netchaos value): a healed
        # partition must re-peer in ~a second, and a rolling restart's
        # peers must survive the whole outage window
        env.setdefault("TENDERMINT_P2P_RECONNECT_INTERVAL_S", "0.5")
        env.setdefault("TENDERMINT_P2P_RECONNECT_ATTEMPTS", "600")
        if self.spec.pex:
            # whole discovery->dial->evict cycles inside a scenario
            # window (production default is 30 s between ensure rounds)
            env.setdefault("TENDERMINT_PEX_ENSURE_PERIOD_S", "2")
        cmd = [
            sys.executable, "-m", "tendermint_tpu_torch.cli",
            "--home", self.home, "node",
            "--p2p.laddr", f"tcp://127.0.0.1:{self.p2p_port}",
            "--rpc.laddr", f"tcp://127.0.0.1:{self.rpc_port}",
            "--p2p.addr_book_strict", "false",
            "--log_level", self.spec.log_level,
        ]
        if seeds:
            cmd += ["--seeds", seeds]
        cmd += list(self.spec.extra_args)
        self.proc = subprocess.Popen(
            cmd, cwd=REPO, env=env,
            stdout=open(os.path.join(self.home, "node.log"), "ab"),
            stderr=subprocess.STDOUT,
        )

    def rpc(self, method: str, params: dict | None = None,
            timeout: float = 10.0):
        body = json.dumps({
            "jsonrpc": "2.0", "id": "localnet", "method": method,
            "params": params or {},
        }).encode()
        req = urllib.request.Request(
            f"http://{self.rpc_url}/", data=body,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = json.loads(resp.read())
        if out.get("error"):
            raise RuntimeError(f"node{self.index} {method}: {out['error']}")
        return out["result"]

    def height(self) -> int:
        try:
            return int(self.rpc("status", timeout=5)["latest_block_height"])
        except Exception:  # noqa: BLE001 — down/starting counts as -1
            return -1

    def metrics_height(self) -> int:
        """Height via GET /metrics — the admission-exempt ops surface
        (rpc/admission "ops" kind), so it reads true even while this
        node's RPC ingress is rate-limiting or shedding reads."""
        try:
            m = self.metrics()
            return int(fleet.metric_value(m, "consensus_height",
                                          default=-1) or -1)
        except Exception:  # noqa: BLE001
            return -1

    def flight_events(self, kind: str | None = None) -> list[dict]:
        """The flight-recorder ring via GET /debug/flight (ops-exempt)."""
        with urllib.request.urlopen(
            f"http://{self.rpc_url}/debug/flight", timeout=10
        ) as resp:
            events = json.loads(resp.read()).get("events", [])
        if kind is not None:
            events = [e for e in events if e.get("kind") == kind]
        return events

    def metrics(self) -> dict:
        return fleet.fetch_metrics(self.rpc_url)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self, sig=signal.SIGTERM) -> None:
        if self.proc is None:
            return
        try:
            self.proc.send_signal(sig)
            self.proc.wait(timeout=15)
        except Exception:  # noqa: BLE001 — a wedged shutdown escalates:
            # dropping the handle would orphan a process on bound ports
            try:
                self.proc.kill()
                self.proc.wait(timeout=15)
            except Exception:  # noqa: BLE001
                pass
        self.proc = None


class ReplicaProc:
    """One verified read-replica process (`cli replica`,
    docs/serving.md § Read replicas) following an upstream node's RPC.
    The replica_flood scenario scales these out in front of node 0 and
    points the read flood at them instead of the validator."""

    def __init__(self, home: str, upstream: str, rpc_port: int,
                 extra_env: dict | None = None):
        self.home = home
        self.upstream = upstream
        self.rpc_port = rpc_port
        self.extra_env = dict(extra_env or {})
        self.proc: subprocess.Popen | None = None

    @property
    def rpc_url(self) -> str:
        return f"127.0.0.1:{self.rpc_port}"

    def start(self) -> None:
        os.makedirs(self.home, exist_ok=True)
        env = member_env(self.extra_env)
        cmd = [
            sys.executable, "-m", "tendermint_tpu_torch.cli",
            "--home", self.home, "replica",
            "--upstream", self.upstream,
            "--rpc.laddr", f"tcp://127.0.0.1:{self.rpc_port}",
            "--log_level", "error",
        ]
        self.proc = subprocess.Popen(
            cmd, cwd=REPO, env=env,
            stdout=open(os.path.join(self.home, "replica.log"), "ab"),
            stderr=subprocess.STDOUT,
        )

    def rpc(self, method: str, params: dict | None = None,
            timeout: float = 10.0):
        body = json.dumps({
            "jsonrpc": "2.0", "id": "localnet", "method": method,
            "params": params or {},
        }).encode()
        req = urllib.request.Request(
            f"http://{self.rpc_url}/", data=body,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = json.loads(resp.read())
        if out.get("error"):
            raise RuntimeError(f"replica:{self.rpc_port} {method}: "
                               f"{out['error']}")
        return out["result"]

    def metrics(self) -> dict:
        return fleet.fetch_metrics(self.rpc_url)

    def lag(self) -> int:
        """replica_lag_heights off /status; -1 while down/warming.
        Raises if the process EXITED: a dead replica must never read
        as merely-warming — a zombie from a prior run squatting the
        port would answer /status in its place and the caller's wait
        loop would bind the flood to stale state."""
        if self.proc is not None and self.proc.poll() is not None:
            tail = b""
            try:
                with open(os.path.join(self.home, "replica.log"), "rb") as f:
                    tail = f.read()[-400:]
            except OSError:
                pass
            raise RuntimeError(
                f"replica :{self.rpc_port} exited "
                f"rc={self.proc.returncode}: ...{tail.decode(errors='replace')}"
            )
        try:
            st = self.rpc("status", timeout=5)
            if not st.get("replica", {}).get("connected"):
                return -1
            if int(st.get("latest_block_height") or 0) < 2:
                return -1
            return int(st["replica_lag_heights"])
        except Exception:  # noqa: BLE001 — down/starting counts as -1
            return -1

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self, sig=signal.SIGTERM) -> None:
        if self.proc is None:
            return
        try:
            self.proc.send_signal(sig)
            self.proc.wait(timeout=15)
        except Exception:  # noqa: BLE001 — escalate a wedged shutdown
            try:
                self.proc.kill()
                self.proc.wait(timeout=15)
            except Exception:  # noqa: BLE001
                pass
        self.proc = None


class Localnet:
    """The process fleet: generate -> start -> drive/chaos -> read."""

    def __init__(self, spec: LocalnetSpec):
        if not spec.root:
            raise ValueError("LocalnetSpec.root is required")
        self.spec = spec
        self.fabric = NetFabric(
            name=f"localnet-{os.path.basename(spec.root)}"
        )
        self.nodes = [LocalNode(spec, i) for i in range(spec.n)]
        self._edges = spec.dial_edges()

    # -- generation ---------------------------------------------------------

    def generate(self) -> "Localnet":
        """N homes + shared genesis + per-home config.toml, all from
        the spec. Keys are seeded from (chain_id, seed, index) so two
        runs of the same spec produce the same validator set."""
        from tendermint_tpu_torch.config import load_config
        from tendermint_tpu_torch.config.toml import config_to_toml, ensure_root
        from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
        from tendermint_tpu_torch.types import (
            GenesisDoc,
            GenesisValidator,
            PrivValidatorFS,
        )

        spec = self.spec
        os.makedirs(spec.root, exist_ok=True)
        pvs = []
        for i in range(spec.n):
            ensure_root(spec.home(i))
            pv = PrivValidatorFS(
                gen_priv_key_ed25519(
                    f"{spec.chain_id}-{spec.seed}-val-{i}".encode()
                ),
                None,
            )
            pvs.append(pv)
        genesis = GenesisDoc(
            genesis_time_ns=time.time_ns(),
            chain_id=spec.chain_id,
            validators=[
                GenesisValidator(pv.get_pub_key(), 10, f"node{i}")
                for i, pv in enumerate(pvs)
            ],
            commit_format=spec.commit_format,
            upgrade_height=spec.upgrade_height,
            upgrade_format=spec.upgrade_format if spec.upgrade_height else "",
        )
        genesis.validate_and_complete()
        timeouts = spec.consensus_timeouts()
        for i, pv in enumerate(pvs):
            home = spec.home(i)
            cfg = load_config(home)
            cfg.base.chain_id = spec.chain_id
            cfg.base.moniker = f"node{i}"
            cfg.base.proxy_app = spec.proxy_app
            cfg.base.db_backend = spec.db_backend
            cfg.base.tx_index = spec.tx_index
            cfg.consensus.gossip_dedup = spec.gossip_dedup
            cfg.p2p.pex_reactor = spec.pex
            for k, v in timeouts.items():
                setattr(cfg.consensus, k, v)
            cfg.consensus.skip_timeout_commit = False
            if spec.max_block_txs:
                cfg.consensus.max_block_size_txs = spec.max_block_txs
            with open(os.path.join(home, "config.toml"), "w") as f:
                f.write(config_to_toml(cfg))
            pv.file_path = cfg.base.priv_validator_file()
            pv.save()
            genesis.save_as(cfg.base.genesis_file())
        return self

    def seed_addr_book(self, idx: int, addrs: list[str]) -> int:
        """Pre-seed node idx's on-disk address book (before start: the
        node loads it at boot). Entries are "ip:port" strings; each is
        written as a new-bucket address sourced from itself — exactly
        what a PEX flood of hearsay addresses leaves behind. Returns
        entries written."""
        import hashlib as _hashlib

        from tendermint_tpu_torch.config import load_config

        cfg = load_config(self.spec.home(idx))
        path = cfg.p2p.addr_book()
        entries = [
            {"addr": a, "src": a, "attempts": 0, "bucket_type": "new"}
            for a in addrs
        ]
        # deterministic per-node bucket salt: two runs of one spec place
        # the same addresses in the same buckets
        key = _hashlib.sha256(
            f"{self.spec.chain_id}-{self.spec.seed}-book-{idx}".encode()
        ).hexdigest()[:48]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"key": key, "addrs": entries}, f)
        return len(entries)

    # -- lifecycle ----------------------------------------------------------

    def _seeds_for(self, i: int) -> str:
        """Node i's seed list: one LinkProxy laddr per outgoing dial
        edge (created on first use, reused across restarts so armed
        chaos — WAN shaping, delays — rides through)."""
        seeds = []
        for (a, b) in self._edges:
            if a != i:
                continue
            link = self.fabric.link(a, b)
            if link is None:
                link = self.fabric.add_link(
                    a, b, ("127.0.0.1", self.spec.p2p_port(b))
                )
            seeds.append(link.laddr)
        return ",".join(seeds)

    def start(self) -> "Localnet":
        for node in self.nodes:
            node.start(seeds=self._seeds_for(node.index))
        if self.spec.geo > 0:
            self.apply_geo(self.spec.geo)
        elif self.spec.wan:
            self.apply_wan(self.spec.wan)
        return self

    def restart_node(self, idx: int, sig=signal.SIGKILL) -> None:
        """Kill node idx (SIGKILL by default — the crash arm; pass
        SIGTERM for a graceful roll) and boot it again on the SAME
        ports and home. Its links drop live connections so peers see a
        dead node immediately; their persistent reconnect loops re-peer
        through the same proxies once it's back."""
        node = self.nodes[idx]
        node.kill(sig)
        for link in self.fabric.links_of(idx):
            link.drop_all()
        node.start(seeds=self._seeds_for(idx))

    def stop(self, keep_root: bool = False) -> None:
        for node in self.nodes:
            node.kill(signal.SIGTERM)
        self.fabric.stop()
        if not keep_root:
            shutil.rmtree(self.spec.root, ignore_errors=True)

    # -- chaos verbs (the netchaos vocabulary, process tier) ----------------

    def partition(self, group_a) -> None:
        self.fabric.partition_groups(set(group_a))

    def heal(self) -> None:
        self.fabric.heal_all()

    def apply_wan(self, profile, seed: int | None = None) -> None:
        self.fabric.apply_wan(
            profile, seed=self.spec.seed if seed is None else seed
        )

    def apply_geo(self, k: int, intra="lan", inter=None,
                  seed: int | None = None) -> list[list[int]]:
        clusters = geo_clusters(self.spec.n, k)
        self.fabric.apply_geo(
            clusters, intra=intra,
            inter=inter or (self.spec.wan or "intercontinental"),
            seed=self.spec.seed if seed is None else seed,
        )
        return clusters

    def clear_wan(self) -> None:
        self.fabric.clear_wan()

    # -- readout (the public scrape surface only) ---------------------------

    def fleet_urls(self, nodes: list[int] | None = None) -> list[str]:
        idxs = nodes if nodes is not None else range(len(self.nodes))
        return [self.nodes[i].rpc_url for i in idxs]

    def heights(self) -> list[int]:
        return [n.height() for n in self.nodes]

    def wait_height(self, h: int, timeout: float = 180.0,
                    nodes: list[int] | None = None) -> bool:
        idxs = list(nodes if nodes is not None else range(len(self.nodes)))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(self.nodes[i].height() >= h for i in idxs):
                return True
            time.sleep(0.5)
        return all(self.nodes[i].height() >= h for i in idxs)

    def timeline(self, last: int = 10, nodes: list[int] | None = None):
        """ops/fleet cross-node height rows (propagation lag, quorum
        formation, commit skew) off live scrapes."""
        snapshot = fleet.collect(self.fleet_urls(nodes), last=last)
        return fleet.build_timeline(
            {u: e.get("traces", []) for u, e in snapshot.items()}, last=last
        )

    def scrape_totals(self, names: list[str],
                      nodes: list[int] | None = None) -> dict:
        """Sum each metric across the fleet (label series summed per
        node by fleet.metric_value). A dead node contributes nothing."""
        out = {name: 0.0 for name in names}
        for url in self.fleet_urls(nodes):
            try:
                m = fleet.fetch_metrics(url)
            except Exception:  # noqa: BLE001 — partial fleets still read
                continue
            for name in names:
                out[name] += fleet.metric_value(m, name, default=0) or 0
        return out

    def duplicate_vote_ratio(self, nodes: list[int] | None = None) -> float:
        """The redundancy number gossip dedup engineers down: fleet-wide
        duplicate votes per accepted vote (the vote plane's counters; the
        2N*N-redundancy literature's measurable)."""
        t = self.scrape_totals(
            ["consensus_vote_duplicates", "consensus_vote_accepted"], nodes
        )
        accepted = t["consensus_vote_accepted"]
        return (t["consensus_vote_duplicates"] / accepted) if accepted else 0.0

    def gossip_bytes(self, nodes: list[int] | None = None) -> float:
        """Fleet-total p2p bytes written (all channels)."""
        return self.scrape_totals(
            ["p2p_peer_send_bytes_total"], nodes
        )["p2p_peer_send_bytes_total"]

    # -- convergence --------------------------------------------------------

    def fingerprint(self, idx: int, height: int) -> tuple:
        """(block hash, part-set root, app hash) at `height` via RPC —
        the byte-identity surface, read as an operator would."""
        res = self.nodes[idx].rpc("block", {"height": height})
        meta, block = res["block_meta"], res["block"]
        return (
            meta["block_id"]["hash"],
            meta["block_id"]["parts"]["hash"],
            block["header"]["app_hash"],
        )

    def last_commit_is_aggregate(self, idx: int, height: int) -> bool:
        """Wire-format probe: does the block at `height` carry an
        aggregate last-commit? Read off the public RPC block JSON (the
        "s_agg" key is the aggregate's signature scalar — full commits
        have "precommits" instead), the same way an operator would
        confirm the cutover actually happened on the wire."""
        res = self.nodes[idx].rpc("block", {"height": height})
        lc = (res["block"] or {}).get("last_commit") or {}
        return "s_agg" in lc

    def assert_converged(self, upto: int, from_height: int = 1,
                         nodes: list[int] | None = None) -> int:
        """Per-height byte identity across `nodes` for every height in
        [from_height, upto]. Returns heights compared."""
        idxs = list(nodes if nodes is not None else range(len(self.nodes)))
        compared = 0
        for h in range(from_height, upto + 1):
            prints = {i: self.fingerprint(i, h) for i in idxs}
            distinct = set(prints.values())
            assert len(distinct) == 1, (
                f"fleet diverges at height {h}: {prints}"
            )
            compared += 1
        return compared


# -- overload scenario helpers ------------------------------------------------

# knobs the overload scenario arms on every node (spec.extra_env wins):
# a per-IP rate limit the flood address must trip, a tiny WS send queue
# with fast eviction, a bulk lane small enough to fill inside the
# scenario window, and a request deadline so no handler wait outlives
# the flood
OVERLOAD_ENV_DEFAULTS = {
    "TENDERMINT_RPC_RATE_LIMIT": "40",
    "TENDERMINT_RPC_RATE_BURST": "80",
    "TENDERMINT_RPC_WS_QUEUE": "8",
    "TENDERMINT_RPC_WS_MAX_OVERFLOWS": "2",
    "TENDERMINT_RPC_WS_SNDBUF": "8192",
    "TENDERMINT_RPC_DEADLINE_S": "10",
    "TENDERMINT_MEMPOOL_LANE_BULK_MAX_TXS": "150",
}
# distinct loopback source addresses: the per-IP token buckets throttle
# each flood plane separately, and neither touches the 127.0.0.1
# control-plane bucket the scenario driver uses
OVERLOAD_WRITE_IP = "127.0.0.2"
OVERLOAD_READ_IP = "127.0.0.3"


def _flood_loop(port: int, method: str, make_params, stop, statuses: dict,
                source_ip: str) -> None:
    """One flood client pinned to `source_ip` via source_address.
    Typed sheds (429/503) are the scenario working, not failures:
    each HTTP status is tallied and the loop keeps pressing."""
    import http.client

    conn = None
    i = 0
    while not stop.is_set():
        i += 1
        try:
            if conn is None:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", port, timeout=5,
                    source_address=(source_ip, 0))
            body = json.dumps({
                "jsonrpc": "2.0", "id": i, "method": method,
                "params": make_params(i),
            }).encode()
            conn.request("POST", "/", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            statuses[resp.status] = statuses.get(resp.status, 0) + 1
        except Exception:  # noqa: BLE001 — refused/dropped connections
            # under load are expected; reconnect and keep the pressure on
            statuses["err"] = statuses.get("err", 0) + 1
            try:
                if conn is not None:
                    conn.close()
            except Exception:  # noqa: BLE001
                pass
            conn = None


def _slow_ws_subscribe(port: int):
    """A deliberately-slow NewBlock subscriber: tiny receive buffer,
    subscribes, then never reads a byte again. The server's bounded
    send queue must absorb, drop-oldest, and finally evict it — without
    the event bus ever blocking on this socket."""
    import base64
    import socket

    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    s.settimeout(10.0)
    s.connect(("127.0.0.1", port))
    key = base64.b64encode(os.urandom(16)).decode()
    s.sendall((
        f"GET /websocket HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
        "Upgrade: websocket\r\nConnection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
    ).encode())
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = s.recv(4096)
        if not chunk:
            raise ConnectionError("ws handshake failed")
        buf += chunk
    if b"101" not in buf.split(b"\r\n", 1)[0]:
        raise ConnectionError(f"ws handshake rejected: {buf[:120]!r}")
    payload = json.dumps({
        "jsonrpc": "2.0", "id": 1, "method": "subscribe",
        "params": {"event": "NewBlock"},
    }).encode()
    mask = os.urandom(4)
    frame = bytearray([0x81, 0x80 | len(payload)]) + mask + bytes(
        c ^ mask[i % 4] for i, c in enumerate(payload))
    s.sendall(bytes(frame))
    return s


# -- the scenario matrix ------------------------------------------------------


def run_scenario(spec: LocalnetSpec, scenario: str = "converge",
                 heights: int = 5, keep_root: bool = False) -> dict:
    """One named netchaos-style scenario against a process fleet.

    converge        — boot, reach `heights`, assert per-height byte
                      identity across ALL nodes (under the spec's WAN /
                      geo shaping, if any)
    partition_heal  — converge, sever a 1/3 minority, prove the 2/3
                      majority keeps committing while the minority is
                      frozen, heal, prove the minority catches up and
                      the whole fleet is byte-identical
    rolling_restart — converge, SIGKILL-and-restart a third of the
                      fleet one node at a time, prove each rejoins and
                      the fleet converges byte-identically
    upgrade         — rolling-upgrade a live net across the genesis
                      commit-format flip (docs/upgrade.md): converge
                      below upgrade_height H, SIGKILL a laggard BEFORE
                      the flip, prove the rest cross H without missing
                      a height, roll one survivor through the boundary,
                      restart the laggard and prove it catches up
                      THROUGH both formats; per-height byte identity on
                      both sides of H; upgrade_* scrape asserts (the
                      flip is visible on the public surface)
    pex_churn       — star + PEX: pre-seed every spoke's address book
                      with ~500 hearsay addresses dominated by one
                      subnet, run real discovery dials, prove the book
                      contains the domination (max_group bounded by
                      bucket hashing), evicts under pressure, and the
                      real net stays peered and committing
    overload        — the overload-control proof: measure the
                      unloaded cadence, then flood node 0 with bulk
                      writes + hot reads from throttled source IPs and
                      two deliberately-slow WS subscribers, while
                      asserting consensus cadence stays within 1.5x the
                      baseline, sheds are scrape-visible
                      (rpc_shed_total / mempool_lane_full_total /
                      ws_evictions_total), a priority probe tx commits
                      AHEAD of a bulk marker submitted before it, the
                      ladder transition landed in the flight ring, and
                      per-height byte identity holds across the fleet
    replica_flood   — the read-replica proof: boot verified
                      replica processes behind node 0, point a hot
                      verified-read flood + WS subscribers at THEM, and
                      assert the validator's commit cadence stays flat,
                      replica-served blocks are byte-identical to the
                      validator's, the replica_* scrape rows move, and
                      a TENDERMINT_REPLICA_TAMPER replica is rejected
                      by 100% of verifying clients

    Returns a flat JSON-able result row (heights/s, duplicate-vote
    ratio, fleet bytes — the bench's raw material)."""
    if scenario == "upgrade" and spec.upgrade_height == 0:
        # default flip far enough in that the net demonstrably runs the
        # old format first, near enough that the scenario stays short
        spec.upgrade_height = max(4, heights)
    if scenario == "pex_churn":
        spec.topology = spec.topology or "star"
        spec.pex = True
    if scenario == "overload":
        # small blocks so the bulk backlog spans several heights (the
        # priority-ordering proof needs the marker to wait its turn)
        spec.max_block_txs = spec.max_block_txs or 10
        for k, v in OVERLOAD_ENV_DEFAULTS.items():
            spec.extra_env.setdefault(k, v)
    net = Localnet(spec)
    try:
        net.generate()
        injected = 0
        if scenario == "pex_churn":
            # one deterministic hearsay set, the same on every node (so
            # hub-side gossip re-adds known keys and bucket pressure is
            # real): ~420 addresses inside ONE dominating subnet, ~80
            # spread across distinct groups. 127.x.y.z is all loopback
            # on Linux — dials fail instantly (refused), which is what
            # drives is_bad/eviction inside the scenario window.
            dominated = [f"127.66.6.{i}:26656" for i in range(1, 251)]
            dominated += [f"127.66.7.{i}:26656" for i in range(1, 171)]
            spread = [f"127.{70 + i}.1.1:26656" for i in range(80)]
            for i in range(spec.n):
                injected = net.seed_addr_book(i, dominated + spread)
        t0 = time.monotonic()
        net.start()
        if not net.wait_height(1, timeout=180.0):
            raise AssertionError(
                f"fleet never reached height 1: {net.heights()}"
            )
        result: dict = {
            "scenario": scenario,
            "n": spec.n,
            "topology": spec.resolved_topology(),
            "wan": spec.wan or None,
            "geo": spec.geo or None,
            "gossip_dedup": spec.gossip_dedup,
        }
        if scenario == "converge":
            ok = net.wait_height(heights, timeout=60.0 * heights)
            assert ok, f"no convergence at {heights}: {net.heights()}"
            elapsed = time.monotonic() - t0
            result["heights"] = heights
            result["heights_per_s"] = heights / elapsed
            result["converged_heights"] = net.assert_converged(heights)
        elif scenario == "partition_heal":
            assert spec.n >= 4, "partition_heal needs n >= 4"
            ok = net.wait_height(heights, timeout=60.0 * heights)
            assert ok, f"no convergence at {heights}: {net.heights()}"
            minority = list(range(spec.n // 3))
            majority = [i for i in range(spec.n) if i not in minority]
            net.partition(minority)
            h0 = max(net.heights())
            ok = net.wait_height(h0 + 3, timeout=120.0, nodes=majority)
            assert ok, (
                f"majority stalled during partition: {net.heights()}"
            )
            frozen = [net.nodes[i].height() for i in minority]
            net.heal()
            target = max(net.heights()) + 2
            ok = net.wait_height(target, timeout=180.0)
            assert ok, f"minority never healed: {net.heights()}"
            result["heights"] = target
            result["minority_frozen_at"] = frozen
            result["converged_heights"] = net.assert_converged(target)
        elif scenario == "rolling_restart":
            ok = net.wait_height(heights, timeout=60.0 * heights)
            assert ok, f"no convergence at {heights}: {net.heights()}"
            victims = list(range(max(1, spec.n // 3)))
            for idx in victims:
                net.restart_node(idx)
                back = net.wait_height(
                    max(net.heights()) + 1, timeout=180.0, nodes=[idx]
                )
                assert back, f"node{idx} never rejoined: {net.heights()}"
            target = max(net.heights())
            ok = net.wait_height(target, timeout=120.0)
            assert ok, f"fleet lost a node after the roll: {net.heights()}"
            result["heights"] = target
            result["restarted"] = victims
            result["converged_heights"] = net.assert_converged(target)
        elif scenario == "upgrade":
            assert spec.n >= 4, "upgrade needs n >= 4 (laggard down at flip)"
            H = spec.upgrade_height
            assert H >= 2, "upgrade scenario needs a scheduled flip"
            # converge on the OLD format first
            ok = net.wait_height(max(2, H - 2), timeout=60.0 * H)
            assert ok, f"no pre-flip convergence: {net.heights()}"
            # the laggard goes down BEFORE the flip and sleeps through it
            laggard = spec.n - 1
            killed_at = net.nodes[laggard].height()
            assert killed_at < H, (
                f"laggard already past the flip ({killed_at} >= {H}); "
                "raise upgrade_height"
            )
            net.nodes[laggard].kill(signal.SIGKILL)
            survivors = [i for i in range(spec.n) if i != laggard]
            # the live net crosses H without missing a height: +2/3 of
            # the validator set keeps committing straight through the
            # format boundary (this wait stalling IS a missed height)
            ok = net.wait_height(H + 2, timeout=120.0 + 30.0 * H,
                                 nodes=survivors)
            assert ok, f"net stalled at the flip: {net.heights()}"
            # roll one survivor across the boundary (the rolling-upgrade
            # arm proper: its WAL replay spans both formats)
            net.restart_node(survivors[0])
            ok = net.wait_height(
                max(net.nodes[i].height() for i in survivors[1:]) + 1,
                timeout=180.0, nodes=[survivors[0]],
            )
            assert ok, f"rolled node never rejoined: {net.heights()}"
            # the laggard wakes up post-flip and catches up THROUGH both
            # formats (full blocks below H, aggregate from H on)
            net.restart_node(laggard)
            target = max(
                h for h in net.heights() if h >= 0
            ) + 2
            ok = net.wait_height(target, timeout=240.0)
            assert ok, f"laggard never caught up: {net.heights()}"
            # byte identity on BOTH sides of the boundary, every node
            result["converged_heights"] = net.assert_converged(target)
            # wire-format proof off the public RPC: the block AT the
            # flip carries an aggregate last-commit, the one below it a
            # full one — on the laggard, which fetched both via catchup
            if H >= 3:
                assert not net.last_commit_is_aggregate(laggard, H - 1), (
                    f"height {H - 1} (below flip) carries an aggregate"
                )
            assert net.last_commit_is_aggregate(laggard, H), (
                f"height {H} (at flip) does not carry an aggregate"
            )
            totals = net.scrape_totals([
                "upgrade_agg_commits_proposed", "upgrade_active",
                "upgrade_agg_commit_rejects",
                "p2p_adversary_schedule_refused",
            ])
            assert totals["upgrade_agg_commits_proposed"] >= 1, (
                f"no proposer ever built an aggregate: {totals}"
            )
            assert totals["upgrade_active"] == spec.n, (
                f"some node does not report the flip active: {totals}"
            )
            assert totals["p2p_adversary_schedule_refused"] == 0, (
                f"schedule refusals inside a homogeneous net: {totals}"
            )
            result["upgrade_height"] = H
            result["heights"] = target
            result["laggard"] = laggard
            result["laggard_killed_at"] = killed_at
            result["agg_commits_proposed"] = int(
                totals["upgrade_agg_commits_proposed"]
            )
            result["agg_commit_rejects"] = int(
                totals["upgrade_agg_commit_rejects"]
            )
        elif scenario == "pex_churn":
            # the real net must form and commit THROUGH the churn
            ok = net.wait_height(2, timeout=120.0)
            assert ok, f"star net never formed: {net.heights()}"
            # loading the dominated book already evicted down to the
            # group's bucket capacity; the RUNTIME proof is that real
            # discovery (failed dials + gossip re-offers) keeps the
            # churn going — evictions must GROW past the boot baseline
            base = net.scrape_totals(["p2p_addrbook_evictions"])[
                "p2p_addrbook_evictions"]
            deadline = time.monotonic() + 90.0
            evictions = base
            while time.monotonic() < deadline:
                evictions = net.scrape_totals(["p2p_addrbook_evictions"])[
                    "p2p_addrbook_evictions"]
                if evictions > base:
                    break
                time.sleep(2.0)
            assert evictions > base, (
                f"no address-book eviction under live churn "
                f"(boot baseline {base})"
            )
            # domination containment: bucket hashing caps any one group
            # at NEW_BUCKETS_PER_ADDRESS * BUCKET_SIZE bucket slots, so
            # no book is owned by the flooding subnet
            sizes, max_groups = [], []
            for node in net.nodes:
                m = node.metrics()
                sizes.append(fleet.metric_value(m, "p2p_addrbook_size",
                                                default=0) or 0)
                mg = fleet.metric_value(m, "p2p_addrbook_max_group",
                                        default=0) or 0
                max_groups.append(mg)
                assert mg <= 256, (
                    f"node{node.index} book dominated: max_group={mg}"
                )
            # and the net is still alive: commits advanced during churn
            h0 = max(net.heights())
            ok = net.wait_height(h0 + 2, timeout=120.0)
            assert ok, f"net stalled under address churn: {net.heights()}"
            result["heights"] = h0 + 2
            result["addrs_injected"] = injected
            result["book_sizes"] = [int(s) for s in sizes]
            result["book_max_groups"] = [int(g) for g in max_groups]
            result["book_evictions"] = int(evictions)
        elif scenario == "overload":
            assert spec.n >= 2, "overload needs n >= 2 (byte identity)"
            target_node = net.nodes[0]
            # unloaded baseline cadence, measured AFTER boot settles so
            # genesis/dial time doesn't pollute the denominator
            ok = net.wait_height(2, timeout=120.0)
            assert ok, f"net never settled: {net.heights()}"
            b0 = target_node.metrics_height()
            t_b = time.monotonic()
            ok = net.wait_height(b0 + heights, timeout=60.0 * heights)
            assert ok, f"no unloaded convergence: {net.heights()}"
            baseline_hps = heights / (time.monotonic() - t_b)
            port = target_node.rpc_port
            stop = threading.Event()
            write_stats = [{} for _ in range(4)]
            read_stats = [{} for _ in range(4)]
            floods = [
                threading.Thread(
                    target=_flood_loop, daemon=True,
                    args=(port, "broadcast_tx_async",
                          lambda i, w=w: {
                              "tx": f"bulk:f{w}-{i}=x".encode().hex()},
                          stop, write_stats[w], OVERLOAD_WRITE_IP),
                ) for w in range(4)
            ] + [
                threading.Thread(
                    target=_flood_loop, daemon=True,
                    args=(port, "status", lambda i: {}, stop, st,
                          OVERLOAD_READ_IP),
                ) for st in read_stats
            ]
            slow_socks: list = []
            try:
                for th in floods:
                    th.start()
                # phase 1 — build a multi-block bulk backlog, read off
                # the scrape surface (ops-exempt even under the flood)
                want = 5 * spec.max_block_txs
                deadline = time.monotonic() + 90.0
                depth = 0
                while time.monotonic() < deadline:
                    depth = fleet.metric_value(
                        target_node.metrics(), "mempool_lane_bulk_size",
                        default=0) or 0
                    if depth >= want:
                        break
                    time.sleep(0.25)
                assert depth >= want, (
                    f"bulk backlog never built: {depth} < {want}")
                # ordering probe: bulk marker FIRST (behind the
                # backlog), priority probe SECOND — the probe must
                # still commit at a strictly lower height. Retries
                # because the driver shares node-side pressure sheds.
                marker_hash = ""
                deadline = time.monotonic() + 60.0
                while not marker_hash and time.monotonic() < deadline:
                    try:
                        marker_hash = target_node.rpc(
                            "broadcast_tx_async",
                            {"tx": b"bulk:marker=1".hex()})["hash"]
                    except Exception:  # noqa: BLE001 — lane-full/shed
                        time.sleep(0.2)
                assert marker_hash, "bulk marker never admitted"
                probe_hash = ""
                deadline = time.monotonic() + 60.0
                while not probe_hash and time.monotonic() < deadline:
                    try:
                        probe_hash = target_node.rpc(
                            "broadcast_tx_async",
                            {"tx": b"pri:probe=1".hex()})["hash"]
                    except Exception:  # noqa: BLE001
                        time.sleep(0.2)
                assert probe_hash, "priority probe never admitted"
                # phase 2 — add the slow subscribers and measure the
                # loaded cadence over a window long enough for their
                # queues to fill, overflow, and evict
                slow_socks = [_slow_ws_subscribe(port) for _ in range(2)]
                flood_heights = max(heights, 8)
                h0 = target_node.metrics_height()
                t_f = time.monotonic()
                deadline = t_f + 120.0 * flood_heights
                while time.monotonic() < deadline:
                    if target_node.metrics_height() >= h0 + flood_heights:
                        break
                    time.sleep(0.25)
                h1 = target_node.metrics_height()
                assert h1 >= h0 + flood_heights, (
                    f"consensus stalled under flood: {h0} -> {h1}")
                flood_hps = flood_heights / (time.monotonic() - t_f)
                # the slow subscribers must get EVICTED, not merely
                # lag. Their sockets stay OPEN here — closing them
                # would read as dead clients (plain teardown), never
                # as evictions. Empty blocks keep firing NewBlock
                # after the floods stop, so keep scraping (ops-exempt)
                # until the overflow ladder ejects at least one.
                stop.set()
                for th in floods:
                    th.join(timeout=10)
                deadline = time.monotonic() + 120.0
                evictions = 0
                while time.monotonic() < deadline:
                    evictions = net.scrape_totals(["ws_evictions_total"])[
                        "ws_evictions_total"]
                    if evictions >= 1:
                        break
                    time.sleep(1.0)
                assert evictions >= 1, (
                    "no slow-subscriber eviction recorded")
            finally:
                stop.set()
                for th in floods:
                    th.join(timeout=10)
                for s in slow_socks:
                    try:
                        s.close()
                    except OSError:
                        pass
            # the tentpole promise: the ladder shed reads and bulk
            # writes BEFORE it let consensus slow past 1.5x baseline
            assert flood_hps >= baseline_hps / 1.5, (
                f"cadence degraded past 1.5x: {flood_hps:.2f} hps under "
                f"flood vs {baseline_hps:.2f} unloaded")

            def _tx_height(tx_hash: str, what: str) -> int:
                # post-flood the node keeps committing (draining the
                # backlog), so retry until the tx lands; also rides out
                # any residual shed-reads window at the driver's edge
                deadline = time.monotonic() + 180.0
                while time.monotonic() < deadline:
                    try:
                        return int(target_node.rpc(
                            "tx", {"hash": tx_hash})["height"])
                    except Exception:  # noqa: BLE001 — not yet committed
                        time.sleep(0.5)
                raise AssertionError(f"{what} never committed")

            probe_h = _tx_height(probe_hash, "priority probe")
            marker_h = _tx_height(marker_hash, "bulk marker")
            assert probe_h < marker_h, (
                f"priority probe (h{probe_h}) did not beat the bulk "
                f"marker (h{marker_h})")
            # every shed is scrape-visible
            totals = net.scrape_totals([
                "rpc_shed_total", "mempool_lane_full_total",
                "ws_dropped_events_total", "mempool_shed_writes_rejects",
            ])
            assert totals["rpc_shed_total"] > 0, totals
            assert totals["mempool_lane_full_total"] > 0, totals
            assert totals["ws_dropped_events_total"] > 0, totals
            # the ladder transition landed in the flight ring
            overload_events = target_node.flight_events("overload")
            assert overload_events, "no overload event in the flight ring"
            # per-height byte identity through the flood window —
            # lanes reorder WITHIN a block's reap, never across nodes
            target = min(h for h in net.heights() if h >= 0)
            result["converged_heights"] = net.assert_converged(target)
            result["heights"] = target
            result["baseline_heights_per_s"] = round(baseline_hps, 3)
            result["flood_heights_per_s"] = round(flood_hps, 3)
            result["cadence_ratio"] = round(flood_hps / baseline_hps, 3)
            result["probe_height"] = probe_h
            result["marker_height"] = marker_h
            result["rpc_sheds"] = int(totals["rpc_shed_total"])
            result["lane_full_rejects"] = int(
                totals["mempool_lane_full_total"])
            result["shed_writes_rejects"] = int(
                totals["mempool_shed_writes_rejects"])
            result["ws_evictions"] = int(evictions)
            result["ws_dropped_events"] = int(
                totals["ws_dropped_events_total"])
            result["overload_transitions"] = len(overload_events)
            agg: dict = {}
            for st in write_stats + read_stats:
                for k, v in st.items():
                    agg[str(k)] = agg.get(str(k), 0) + v
            result["flood_statuses"] = agg
        elif scenario == "replica_flood":
            # the read-replica proof: verified replicas absorb a
            # hot read flood while the validator's commit cadence stays
            # flat, replica-served blocks are byte-identical to the
            # validator's, and a tampering replica is rejected by every
            # verifying client
            assert spec.n >= 2, "replica_flood needs n >= 2 (byte identity)"
            from tendermint_tpu_torch.rpc.client import HTTPClient, WSClient
            from tendermint_tpu_torch.rpc.light import (
                LightClient,
                LightClientError,
            )

            target_node = net.nodes[0]
            ok = net.wait_height(2, timeout=120.0)
            assert ok, f"net never settled: {net.heights()}"
            # commit content for the replicas to serve before measuring
            keys = [f"rk{i}".encode() for i in range(8)]
            for i, k in enumerate(keys):
                deadline = time.monotonic() + 60.0
                sent = False
                while not sent and time.monotonic() < deadline:
                    try:
                        target_node.rpc("broadcast_tx_async",
                                        {"tx": (k + b"=rv%d" % i).hex()})
                        sent = True
                    except Exception:  # noqa: BLE001 — mempool backoff
                        time.sleep(0.2)
                assert sent, f"seed key {k!r} never admitted"
            # unloaded baseline cadence
            b0 = target_node.metrics_height()
            t_b = time.monotonic()
            ok = net.wait_height(b0 + heights, timeout=60.0 * heights)
            assert ok, f"no unloaded convergence: {net.heights()}"
            baseline_hps = heights / (time.monotonic() - t_b)
            # two honest replicas + one tampering one behind node 0
            rep_base = spec.base_port + 2 * spec.n + 10
            replicas = [
                ReplicaProc(os.path.join(spec.root, f"replica{i}"),
                            target_node.rpc_url, rep_base + i)
                for i in range(2)
            ]
            tamper_rep = ReplicaProc(
                os.path.join(spec.root, "replica-tamper"),
                target_node.rpc_url, rep_base + 2,
                extra_env={"TENDERMINT_REPLICA_TAMPER": "value"},
            )
            procs = replicas + [tamper_rep]
            stop = threading.Event()
            read_stats: list[dict] = [{} for _ in range(4)]
            floods: list[threading.Thread] = []
            subs: list = []
            try:
                for r in procs:
                    r.start()
                for r in procs:
                    deadline = time.monotonic() + 120.0
                    while r.lag() != 0 and time.monotonic() < deadline:
                        time.sleep(0.25)
                    assert r.lag() == 0, (
                        f"replica :{r.rpc_port} never caught up")

                # the read flood lands on the REPLICAS only: verified
                # hot-key reads plus relayed-event subscribers — the
                # validator serves none of it
                def read_params(i, keys=keys):
                    return {"data": keys[i % len(keys)].hex(), "path": "",
                            "height": 0, "prove": True}

                for j, st in enumerate(read_stats):
                    floods.append(threading.Thread(
                        target=_flood_loop, daemon=True,
                        args=(replicas[j % len(replicas)].rpc_port,
                              "abci_query", read_params, stop, st,
                              f"127.0.1.{j + 1}"),
                    ))
                for r in replicas:
                    ws = WSClient(r.rpc_url)
                    ws.subscribe("NewBlock")
                    subs.append(ws)
                for th in floods:
                    th.start()
                # loaded cadence, measured on the validator
                flood_heights = max(heights, 6)
                h0 = target_node.metrics_height()
                t_f = time.monotonic()
                deadline = t_f + 120.0 * flood_heights
                while time.monotonic() < deadline:
                    if target_node.metrics_height() >= h0 + flood_heights:
                        break
                    time.sleep(0.25)
                h1 = target_node.metrics_height()
                assert h1 >= h0 + flood_heights, (
                    f"consensus stalled under replica flood: {h0} -> {h1}")
                flood_hps = flood_heights / (time.monotonic() - t_f)
                # every downstream subscriber rode the relayed stream
                relayed = 0
                for ws in subs:
                    try:
                        ev = ws.next_event(timeout=30.0)
                        hdr = ((ev.get("data") or {}).get("block")
                               or {}).get("header") or {}
                        if hdr.get("height"):
                            relayed += 1
                    except Exception:  # noqa: BLE001 — counted below
                        pass
                assert relayed == len(subs), (
                    f"only {relayed}/{len(subs)} subscribers saw events")
                stop.set()
                for th in floods:
                    th.join(timeout=10)
                # replica scrape surface: reads served off the verified
                # cache, zero proof failures on the honest replicas
                served = hits = 0.0
                for r in replicas:
                    m = r.metrics()
                    assert (fleet.metric_value(
                        m, "replica_height", default=0) or 0) >= 1, (
                        f"replica :{r.rpc_port} reports no height")
                    assert (fleet.metric_value(
                        m, "replica_proof_verify_failures",
                        default=0) or 0) == 0, (
                        f"proof failures on honest replica :{r.rpc_port}")
                    served += fleet.metric_value(
                        m, "replica_served_reads_total", default=0) or 0
                    hits += fleet.metric_value(
                        m, "replica_cache_hits", default=0) or 0
                assert served > 0, "replicas served no reads"
                assert hits > 0, "no proof-cache hits under a hot-key flood"
                # cadence: the validator must not feel the read flood
                assert flood_hps >= baseline_hps / 1.5, (
                    f"cadence degraded past 1.5x behind replicas: "
                    f"{flood_hps:.2f} hps vs {baseline_hps:.2f} unloaded")
                # byte identity: a replica-served block IS the
                # validator's block, byte for byte
                h = max(1, target_node.metrics_height() - 2)
                want = json.dumps(
                    target_node.rpc("block", {"height": h}), sort_keys=True)
                for r in replicas:
                    got = json.dumps(
                        r.rpc("block", {"height": h}), sort_keys=True)
                    assert got == want, (
                        f"replica :{r.rpc_port} serves different bytes "
                        f"at height {h}")
                # tamper probe: a verifying client rejects EVERY read
                # from the lying replica — corruption is detected, not
                # propagated
                lc = LightClient.from_genesis(
                    HTTPClient(tamper_rep.rpc_url))
                probe_keys = keys[:4]
                rejected = 0
                for k in probe_keys:
                    try:
                        lc.verified_query(k)
                    except LightClientError:
                        rejected += 1
                assert rejected == len(probe_keys), (
                    f"tampered replica only rejected "
                    f"{rejected}/{len(probe_keys)} reads")
            finally:
                stop.set()
                for th in floods:
                    th.join(timeout=10)
                for ws in subs:
                    try:
                        ws.close()
                    except Exception:  # noqa: BLE001
                        pass
                for r in procs:
                    r.kill()
            target = min(h for h in net.heights() if h >= 0)
            result["converged_heights"] = net.assert_converged(target)
            result["heights"] = target
            result["replicas"] = len(replicas)
            result["baseline_heights_per_s"] = round(baseline_hps, 3)
            result["flood_heights_per_s"] = round(flood_hps, 3)
            result["cadence_ratio"] = round(flood_hps / baseline_hps, 3)
            result["replica_reads_served"] = int(served)
            result["replica_cache_hits"] = int(hits)
            result["tamper_rejected"] = rejected
            result["tamper_probes"] = len(probe_keys)
            agg: dict = {}
            for st in read_stats:
                for k, v in st.items():
                    agg[str(k)] = agg.get(str(k), 0) + v
            result["flood_statuses"] = agg
        else:
            raise ValueError(
                f"unknown scenario {scenario!r}; known: converge, "
                "partition_heal, rolling_restart, upgrade, pex_churn, "
                "overload, replica_flood"
            )
        result["duplicate_vote_ratio"] = net.duplicate_vote_ratio()
        result["gossip_bytes"] = net.gossip_bytes()
        result["final_heights"] = net.heights()
        return result
    finally:
        net.stop(keep_root=keep_root)


# -- CLI ----------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="N-process localnet: generate homes, boot real CLI "
                    "nodes through netfaults link proxies, run a chaos "
                    "scenario, read convergence off the scrape surface",
    )
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--root", default="",
                    help="net root dir (default: a temp dir, removed "
                         "unless --keep)")
    ap.add_argument("--scenario", default="converge",
                    choices=["converge", "partition_heal", "rolling_restart",
                             "upgrade", "pex_churn", "overload",
                             "replica_flood"])
    ap.add_argument("--heights", type=int, default=5)
    ap.add_argument("--topology", default="",
                    choices=["", "full", "ring", "star"])
    ap.add_argument("--ring-k", type=int, default=DEFAULT_RING_K)
    ap.add_argument("--wan", default="",
                    help="netfaults WAN profile (lan, continental, "
                         "intercontinental, lossy-mobile)")
    ap.add_argument("--geo", type=int, default=0,
                    help="geo-cluster count (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--base-port", type=int, default=47100)
    ap.add_argument("--upgrade-height", type=int, default=0,
                    help="schedule the commit-format flip at this height "
                         "(upgrade scenario defaults to max(4, --heights))")
    ap.add_argument("--no-dedup", action="store_true",
                    help="boot with gossip_dedup=false (the undeduplicated "
                         "gossip baseline)")
    ap.add_argument("--keep", action="store_true",
                    help="keep homes + logs after the run")
    args = ap.parse_args(argv)

    import tempfile

    logging.basicConfig(level=logging.INFO)
    root = args.root or tempfile.mkdtemp(prefix="localnet-")
    spec = LocalnetSpec(
        n=args.n, root=root, seed=args.seed, topology=args.topology,
        ring_k=args.ring_k, base_port=args.base_port, wan=args.wan,
        geo=args.geo, gossip_dedup=not args.no_dedup,
        upgrade_height=args.upgrade_height,
    )
    result = run_scenario(
        spec, scenario=args.scenario, heights=args.heights,
        keep_root=args.keep,
    )
    if args.keep:
        result["root"] = root
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
