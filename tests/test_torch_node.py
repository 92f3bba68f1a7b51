"""The port's node (tendermint_tpu_torch/node/node.py) against the JAX
package's.

- Two JAX and two port validators, each a `Node` built by
  `default_new_node` from its own home, with a seed (a persistent peer) and
  PEX on, commit heights over TCP and secret connections: the block bytes
  are equal on all four at every height, and each address book learns the
  other three nodes.
- A port node built in a process where `jax` and `tendermint_tpu` cannot
  be imported commits blocks on injected CPU defaults.
- With no card, no device daemon and no injected defaults, building a port
  node raises `resolve_device`'s RuntimeError before it binds a port.
- Each package reads the other's address book, light anchor and flight
  dumps.
- A port node's GET /metrics families are a JAX node's, for one config.
- `Listener(skip_upnp=False)` maps its port through a fake IGD.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import time
import types

import pytest

from tests.test_torch_nat_profiler import _FakeIGD

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(root: str) -> types.SimpleNamespace:
    mods = {
        "config": "config",
        "toml": "config.toml",
        "gateway": "ops.gateway",
        "node": "node",
        "types": "types",
        "keys": "crypto.keys",
        "addrbook": "p2p.addrbook",
        "netaddress": "p2p.netaddress",
        "light_anchor": "node.light_anchor",
        "light": "rpc.light",
        "flightrec": "node.flightrec",
        "block": "types.block",
        "block_id": "types.block_id",
        "validator": "types.validator",
        "validator_set": "types.validator_set",
    }
    return types.SimpleNamespace(root=root, **{k: importlib.import_module(f"{root}.{m}") for k, m in mods.items()})


PORT = _pkg("tendermint_tpu_torch")
JAX = _pkg("tendermint_tpu")


def wait_until(cond, timeout=30.0, tick=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return cond()


@pytest.fixture
def host_defaults(monkeypatch):
    """Both packages' gateway defaults on the CPU: the port's as injected
    instances (a port node has no CPU default), the JAX package's on its
    CPU path."""
    monkeypatch.setattr(PORT.gateway, "_default_verifier", PORT.gateway.Verifier(device="cpu"))
    monkeypatch.setattr(PORT.gateway, "_default_hasher", PORT.gateway.Hasher(device="cpu", min_tpu_batch=1 << 30))
    monkeypatch.setattr(JAX.gateway, "_default_verifier", JAX.gateway.Verifier(use_tpu=False))


def _home(p, keys, doc, own: int):
    """A node home written as an operator's would be, by package `p`:
    config.toml (the test preset), the shared genesis.json and this
    validator's priv_validator.json (both in the port's format, which the
    two packages share). Returns the config, with RPC and p2p on 127.0.0.1
    port 0, PEX on, and the address book not strict about 127.0.0.1."""
    root = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
    cfg = p.config.test_config()
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.pex_reactor = True
    cfg.p2p.addr_book_strict = False
    cfg.consensus.timeout_propose = 1.0
    p.toml.ensure_root(root, cfg)
    PORT.types.PrivValidatorFS(keys[own], cfg.base.priv_validator_file()).save()
    doc.save_as(cfg.base.genesis_file())
    return cfg


def _genesis(n: int):
    keys = sorted((PORT.keys.gen_priv_key_ed25519(b"node-test-%d" % i) for i in range(n)),
                  key=lambda k: k.pub_key().address())
    doc = PORT.types.GenesisDoc(
        genesis_time_ns=1_700_000_000 * 10**9, chain_id="tendermint_test",
        validators=[PORT.types.GenesisValidator(k.pub_key(), 1, f"v{i}") for i, k in enumerate(keys)],
    )
    return keys, doc


def test_mixed_nodes_commit_equal_blocks_and_learn_each_other(host_defaults, monkeypatch):
    """(a) JAX, port, JAX, port validators of one 4-validator chain (no
    package has a quorum alone). Nodes 1-3 take node 0 as their seed; PEX
    spreads the addresses and dials the rest of the mesh."""
    monkeypatch.setenv("TENDERMINT_PEX_ENSURE_PERIOD_S", "1")
    keys, doc = _genesis(4)
    pkgs = [JAX, PORT, JAX, PORT]
    nodes = []
    try:
        for i, p in enumerate(pkgs):
            cfg = _home(p, keys, doc, i)
            if nodes:
                cfg.p2p.seeds = str(nodes[0].listener.internal_address())
            node = p.node.default_new_node(cfg)
            node.start()
            nodes.append(node)
        heights = 3
        assert wait_until(lambda: all(n.block_store.height() >= heights for n in nodes), timeout=90), \
            [n.block_store.height() for n in nodes]
        for h in range(1, heights + 1):
            blocks = [n.block_store.load_block(h).to_bytes() for n in nodes]
            assert all(b == blocks[0] for b in blocks), f"block {h} differs"
        addrs = [str(n.listener.internal_address()) for n in nodes]

        def learned():
            return all({a for a in addrs if a != addrs[i]} <= set(n.addr_book._addrs) for i, n in enumerate(nodes))

        assert wait_until(learned, timeout=30), [sorted(n.addr_book._addrs) for n in nodes]
        # ... and PEX dials them: a full mesh
        assert wait_until(lambda: all(n.sw.peers.size() == 3 for n in nodes), timeout=30), \
            [n.sw.peers.size() for n in nodes]
    finally:
        for n in nodes:
            n.stop()


# the commit timeout of the parity net: the window in which its chain holds
# still and both packages' nodes are read
QUIET_S = 8.0
# flat /metrics values a still chain fixes (heights, sizes, config and
# counts of the one tx's path), unlike the gossip and timing ones
QUIET_METRICS = (
    "blockstore_base", "blockstore_height", "consensus_height", "consensus_round", "mempool_size",
    "node_health_status", "node_health_peers", "p2p_addrbook_size", "evidence_count", "flightrec_enabled",
    "pruning_enabled", "pruning_retain_blocks", "pruning_interval_heights", "statesync_snapshots",
    "txtrace_sampled", "txtrace_completed", "txtrace_active", "upgrade_height", "upgrade_active",
    "wal_format", "wal_flush_interval_s", "wal_sync_every_write", "gateway_verify_tpu_sigs",
    "gateway_hash_tpu_leaves",
)


def test_mixed_nodes_answer_equal_rpc_bodies(host_defaults, monkeypatch):
    """(a) A JAX and a port validator of one chain (JAX, port, JAX, port)
    answer the node-level routes with equal bodies while the chain holds
    still (a commit timeout of QUIET_S after height 2, whose block holds
    one tx): every height's block, commit and validators, blockchain,
    genesis, the tx with its proof, abci_info and abci_query, the
    unconfirmed txs; status and net_info on the chain's fields; the tx's
    trace, the consensus traces and the flight ring on all but their
    timings; and the /metrics values a still chain fixes, over JSON-RPC
    and in GET /metrics."""
    import urllib.request

    from tendermint_tpu_torch.rpc.client import HTTPClient

    monkeypatch.setenv("TENDERMINT_PEX_ENSURE_PERIOD_S", "1")
    keys, doc = _genesis(4)
    nodes = []
    try:
        for i, p in enumerate([JAX, PORT, JAX, PORT]):
            cfg = _home(p, keys, doc, i)
            cfg.consensus.timeout_commit = QUIET_S
            cfg.consensus.skip_timeout_commit = False
            if nodes:
                cfg.p2p.seeds = str(nodes[0].listener.internal_address())
            node = p.node.default_new_node(cfg)
            node.start()
            nodes.append(node)
        clients = [HTTPClient(f"127.0.0.1:{n.rpc_port()}") for n in nodes]
        assert wait_until(lambda: all(n.block_store.height() == 1 for n in nodes), timeout=60), \
            [n.block_store.height() for n in nodes]
        # in height 1's commit timeout: the tx reaches every mempool
        tx = b"quiet-key=quiet-value"
        res = clients[0].broadcast_tx_sync(tx=tx.hex())
        assert res["code"] == 0
        assert wait_until(lambda: all(n.mempool.size() == 1 for n in nodes), timeout=QUIET_S / 2)
        last = 2
        assert wait_until(lambda: all(n.block_store.height() == last for n in nodes), timeout=60), \
            [n.block_store.height() for n in nodes]
        # the tx reached both nodes from a peer
        jc, pc = clients[2], clients[1]
        jn, pn = nodes[2], nodes[1]

        def both(method, **params):
            return getattr(jc, method)(**params), getattr(pc, method)(**params)

        for h in range(1, last + 1):
            for method in ("block", "commit", "validators"):
                j, t = both(method, height=h)
                if method == "commit" and h == last:
                    # each node's own seen commit: the precommits it heard
                    assert not t["canonical_commit"] and not j["canonical_commit"]
                    assert t["header"] == j["header"] and t["commit"]["block_id"] == j["commit"]["block_id"]
                    continue
                assert t == j, (method, h)
        for method, params in (("blockchain", {"min_height": 1, "max_height": last}), ("genesis", {}),
                               ("tx", {"hash": res["hash"], "prove": True}), ("abci_info", {}),
                               ("abci_query", {"data": b"quiet-key".hex()}), ("unconfirmed_txs", {}),
                               ("num_unconfirmed_txs", {})):
            j, t = both(method, **params)
            assert t == j, method
        j, t = both("status")
        assert sorted(t) == sorted(j)
        chain_fields = ("latest_block_hash", "latest_app_hash", "latest_block_height", "latest_block_time")
        assert {k: t[k] for k in chain_fields} == {k: j[k] for k in chain_fields}
        j, t = both("net_info")
        assert sorted(t) == sorted(j) and t["listening"] and j["listening"]
        assert sorted(t["peers"][0]) == sorted(j["peers"][0]) and len(t["peers"]) == len(j["peers"]) == 3

        def trace_shape(tr):
            return (tr["hash"], tr["source"], tr["height"], tr["outcome"], sorted(tr["stages"]),
                    sorted(tr["spans"]), tr["commit_latency_s"] is None, sorted(tr))

        j, t = both("tx_trace", hash=res["hash"])
        assert [trace_shape(x) for x in t["traces"]] == [trace_shape(x) for x in j["traces"]]
        assert len(j["traces"]) == 1 and j["active"] == t["active"] == []
        j, t = both("consensus_trace", last=10)
        assert [(x["height"], sorted(x)) for x in t["traces"]] == [(x["height"], sorted(x)) for x in j["traces"]]

        def http_get(node, path):
            return urllib.request.urlopen(f"http://127.0.0.1:{node.rpc_port()}/{path}", timeout=10).read()

        fj, ft = (json.loads(http_get(n, "debug/flight")) for n in (jn, pn))
        assert sorted(ft) == sorted(fj)
        assert {k: ft[k] for k in ("enabled", "ring_size", "dumps")} == {k: fj[k] for k in ("enabled", "ring_size", "dumps")}
        ends = [[e["height"] for e in f["events"] if e["kind"] == "wal_endheight"] for f in (fj, ft)]
        assert ends[0] == ends[1] == list(range(1, last + 1))
        j, t = both("metrics")
        assert {k: t[k] for k in QUIET_METRICS} == {k: j[k] for k in QUIET_METRICS}
        assert t["blockstore_height"] == last and t["txtrace_completed"] == 1

        def scraped(node):
            out = {}
            for line in http_get(node, "metrics").decode().splitlines():
                name, _, value = line.rpartition(" ")
                if name in QUIET_METRICS:
                    out[name] = value
            return out

        sj, st = scraped(jn), scraped(pn)
        assert len(sj) > 10 and st == sj
        # and the chain held still while it was read
        assert [n.block_store.height() for n in nodes] == [last] * 4
    finally:
        for n in nodes:
            n.stop()


def test_port_node_commits_without_jax():
    """(b) A process that cannot import `jax` or `tendermint_tpu` builds a
    port node on injected CPU defaults; it commits 2 blocks and stops."""
    child = textwrap.dedent(f"""
        import sys, tempfile, time
        sys.modules["jax"] = None
        sys.modules["tendermint_tpu"] = None
        sys.path.insert(0, {REPO_ROOT!r})
        from tendermint_tpu_torch.ops import gateway
        gateway._default_verifier = gateway.Verifier(device="cpu")
        gateway._default_hasher = gateway.Hasher(device="cpu", min_tpu_batch=1 << 30)
        from tendermint_tpu_torch.config import reset_test_root
        from tendermint_tpu_torch.node import default_new_node
        cfg = reset_test_root(tempfile.mkdtemp(prefix="tmd", dir="/tmp"))
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
        node = default_new_node(cfg)
        node.start()
        deadline = time.monotonic() + 60
        while node.block_store.height() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        node.stop()
        assert not any(m == "jax" or m.startswith("jax.") or m.startswith("tendermint_tpu.")
                       for m, v in sys.modules.items() if v is not None)
        print("height", node.block_store.height())
    """)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, timeout=180,
                          cwd=REPO_ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split("height")[-1]) >= 2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_no_card_no_daemon_raises_before_binding(monkeypatch):
    """(c) The port node takes the gateway's defaults: with no card, no
    serving daemon and none injected, building it raises resolve_device's
    RuntimeError, and neither its p2p nor its RPC port was bound. The card
    is taken away on every host, a CUDA one too."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(PORT.gateway, "_default_verifier", None)
    monkeypatch.setattr(PORT.gateway, "_default_hasher", None)
    monkeypatch.setenv("TENDERMINT_DEVD_SOCK", "/nonexistent/devd.sock")
    monkeypatch.delenv("TENDERMINT_DEVD_SOCKS", raising=False)
    monkeypatch.delenv("TENDERMINT_TPU_KERNEL", raising=False)
    cfg = PORT.toml.reset_test_root(tempfile.mkdtemp(prefix="tmd", dir="/tmp"))
    p2p_port, rpc_port = _free_port(), _free_port()
    cfg.p2p.laddr = f"tcp://127.0.0.1:{p2p_port}"
    cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc_port}"
    with pytest.raises(RuntimeError, match="CUDA is not available; pass device='cpu'"):
        PORT.node.default_new_node(cfg)
    for port in (p2p_port, rpc_port):
        with socket.socket() as s:  # nothing listens there
            assert s.connect_ex(("127.0.0.1", port)) != 0


def test_restart_replays_state_tree_through_the_hasher(host_defaults):
    """A restarted node hands its Hasher to the app's state tree before the
    Handshaker replays the stored blocks, so the replayed commit waves go
    through the Hasher as live ones do (the JAX node wires it after)."""
    cfg = PORT.toml.reset_test_root(tempfile.mkdtemp(prefix="tmd", dir="/tmp"))
    cfg.base.proxy_app = "kvstore"  # in memory: a restart replays every block into it
    cfg.base.db_backend = "sqlite"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    node = PORT.node.default_new_node(cfg)
    node.start()
    try:
        for i in range(200):
            node.mempool.check_tx(b"replay-%03d=v" % i)
        assert wait_until(lambda: node.block_store.height() >= 2 and node.mempool.size() == 0, timeout=60)
        # live waves of 32 nodes or more take the Hasher
        assert node.app_state_tree_app.tree.stats()["gateway_nodes"] > 0
    finally:
        node.stop()
    restarted = PORT.node.default_new_node(cfg)  # the Handshaker replays every stored block
    try:
        tree = restarted.app_state_tree_app.tree
        assert tree.latest_version() >= 2 and tree.hasher is restarted.hasher
        assert tree.stats()["gateway_nodes"] > 0
    finally:
        restarted.stop()


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)], ids=["jax-to-port", "port-to-jax"])
def test_address_book_read_by_the_other_package(writer, reader):
    """(d) An address book saved by one package loads in the other with
    the same entries, and the reader's save writes the same JSON."""
    root = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
    na = writer.netaddress.NetAddress
    book = writer.addrbook.AddrBook(os.path.join(root, "a.json"), routability_strict=False)
    src = na("10.1.0.1", 26656)
    for i in range(12):
        book.add_address(na(f"10.{i % 4}.{i}.7", 26656), src)
    book.mark_good(na("10.0.0.7", 26656))
    book.mark_attempt(na("10.1.1.7", 26656))
    book.save()
    other = reader.addrbook.AddrBook(os.path.join(root, "a.json"), routability_strict=False)
    assert other.key == book.key
    assert sorted(other._addrs) == sorted(book._addrs)
    for k, ka in book._addrs.items():
        assert other._addrs[k].to_json() == ka.to_json()
    other.file_path = os.path.join(root, "b.json")
    other.save()
    with open(os.path.join(root, "a.json")) as fa, open(os.path.join(root, "b.json")) as fb:
        a, b = json.load(fa), json.load(fb)
    assert a["key"] == b["key"]
    assert sorted(a["addrs"], key=lambda o: o["addr"]) == sorted(b["addrs"], key=lambda o: o["addr"])


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)], ids=["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("with_header", [True, False])
def test_light_anchor_read_by_the_other_package(writer, reader, with_header):
    """(d) A light anchor saved by one package loads in the other: the same
    height, validator set and trusted header, byte for byte."""
    root = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
    chain = "anchor-x"
    vset = writer.validator_set.ValidatorSet([
        writer.validator.Validator.new(writer.keys.gen_priv_key_ed25519(b"anchor-x-%d" % i).pub_key(), 10)
        for i in range(3)
    ])
    header = writer.block.Header(chain_id=chain, height=9, time_ns=9000, num_txs=0,
                                 last_block_id=writer.block_id.BlockID(), last_commit_hash=b"\x02" * 20,
                                 data_hash=b"\x03" * 20, validators_hash=vset.hash(), app_hash=b"\x04" * 20)
    lc = writer.light.LightClient(None, chain, vset, trusted_height=9)
    lc._trusted_header = header if with_header else None
    assert writer.light_anchor.save_anchor(root, lc)
    got = reader.light_anchor.load_anchor(root, chain)
    assert got is not None
    height, vs, hdr = got
    assert height == 9 and vs.hash() == vset.hash()
    assert vs.to_json() == vset.to_json()
    if with_header:
        assert hdr.hash() == header.hash() and hdr.to_json() == header.to_json()
    else:
        assert hdr is None
    assert reader.light_anchor.load_anchor(root, "other-chain") is None


def test_flight_dumps_equal_across_packages():
    """(d) The two packages' flight recorders, fed the same events, write
    dumps of one format: the same file name pattern and keys, the same
    events and counters; each package's dump parses as the other's."""
    dumps = {}
    for p in (JAX, PORT):
        home = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
        rec = p.flightrec.FlightRecorder(home=home, ring=8)
        rec.counters_fn = lambda: {"height": 7, "round": 0}
        for i in range(10):
            rec.record("step", height=i, round=0, step=3)
        rec.note_exception("consensus", ValueError("boom"))
        path = rec.dump("manual")
        assert path is not None and os.path.basename(path).startswith("dump-")
        assert path.endswith("-manual.json")
        with open(path) as f:
            dumps[p.root] = json.load(f)
    j, t = dumps["tendermint_tpu"], dumps["tendermint_tpu_torch"]
    assert sorted(j) == sorted(t)

    def strip(d):
        return {
            **{k: v for k, v in d.items() if k not in ("dumped_at", "events")},
            "events": [{k: v for k, v in e.items() if k != "t"} for e in d["events"]],
        }

    assert strip(j) == strip(t)


def test_metrics_family_names_equal_jax():
    """(e) For one config, a port node's GET /metrics families are named
    as a JAX node's, so the dashboards read the same. In a fresh process:
    the default registries of a test process carry families other tests
    install."""
    child = textwrap.dedent(f"""
        import importlib, json, sys, tempfile, time, urllib.request
        sys.path.insert(0, {REPO_ROOT!r})
        fams = {{}}
        for root in ("tendermint_tpu", "tendermint_tpu_torch"):
            gateway = importlib.import_module(root + ".ops.gateway")
            if root == "tendermint_tpu":
                gateway._default_verifier = gateway.Verifier(use_tpu=False)
            else:
                gateway._default_verifier = gateway.Verifier(device="cpu")
                gateway._default_hasher = gateway.Hasher(device="cpu", min_tpu_batch=1 << 30)
            toml = importlib.import_module(root + ".config.toml")
            cfg = toml.reset_test_root(tempfile.mkdtemp(prefix="tmd", dir="/tmp"))
            cfg.rpc.laddr = "tcp://127.0.0.1:0"
            cfg.p2p.laddr = "tcp://127.0.0.1:0"
            node = importlib.import_module(root + ".node").default_new_node(cfg)
            node.start()
            try:
                deadline = time.monotonic() + 60
                while node.block_store.height() < 2 and time.monotonic() < deadline:
                    time.sleep(0.05)
                url = "http://127.0.0.1:%d/metrics" % node.rpc_port()
                body = urllib.request.urlopen(url, timeout=10).read().decode()
                fams[root] = sorted({{line.split()[2] for line in body.splitlines() if line.startswith("# TYPE ")}})
            finally:
                node.stop()
        print(json.dumps(fams))
    """)
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True, timeout=300,
                          cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    fams = {k: set(v) for k, v in json.loads(proc.stdout.strip().splitlines()[-1]).items()}
    assert len(fams["tendermint_tpu"]) > 40
    assert fams["tendermint_tpu_torch"] == fams["tendermint_tpu"], (
        sorted(fams["tendermint_tpu"] - fams["tendermint_tpu_torch"]),
        sorted(fams["tendermint_tpu_torch"] - fams["tendermint_tpu"]),
    )


def test_listener_maps_its_port_through_upnp(monkeypatch):
    """(f) Listener(skip_upnp=False) finds the fake IGD, maps its port, and
    gives the gateway's external IP as its external address; stop()
    deletes the mapping."""
    from tendermint_tpu_torch.p2p import upnp
    from tendermint_tpu_torch.p2p.listener import Listener

    igd = _FakeIGD()
    monkeypatch.setattr(upnp, "discover", functools.partial(upnp.discover, ssdp_addr=igd.ssdp_addr))
    try:
        lst = Listener("127.0.0.1:0", skip_upnp=False)
        port = lst.internal_address().port
        try:
            assert igd.mapped == [("tcp", port)]
            ext = lst.external_address()
            assert (ext.ip, ext.port) == ("203.0.113.7", port)
        finally:
            lst.stop()
        assert igd.deleted == [("tcp", port)]
    finally:
        igd.close()
