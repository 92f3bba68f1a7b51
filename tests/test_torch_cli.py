"""The port's CLI (tendermint_tpu_torch/cli.py) and its WAL replay tool
(consensus/replay_file.py) against the JAX package's, on the cases of
tests/test_cli.py, with the CLI module's package as a parameter.

- `init`, `testnet`, `gen_validator`, `show_validator`, `reset_all` and
  `version` behave alike under both CLIs, and a home written by either
  loads under both packages' `config` and `types`.
- Both packages' `replay` of one WAL give the same replayed count and the
  same final height/round/step line, for a WAL written by a port node and
  for one written by a JAX node (each package reads the other's).
- The port's device rule in processes: `node` and `replica` end their
  wait with exit code 1 when a device error has stopped the node's
  consensus, its blockchain or state-sync reactor, or the replica's
  follower; `node` with no card and no daemon exits non-zero before it
  binds a port.

Also the port's copy of the node-process harness of
tests/consensus_common.py (`init_node_home`, `write_fast_config`,
`node_proc`, `rpc`, `wait_height`) with the package as a parameter, and
`devd_sock`, a module-scoped port device daemon that accepts the CPU: a
port node process has no card here and no CPU default, so it verifies and
hashes through that daemon (tests/test_torch_wal_torture.py,
tests/test_torch_persist.py and tests/test_torch_localnet.py use both).
"""

from __future__ import annotations

import importlib
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "tendermint_tpu", "tendermint_tpu_torch"
PACKAGES = (JAX_PKG, PORT_PKG)
# the fail-point knobs a node process never inherits from the test's env
FAIL_ENV = ("FAIL_TEST_INDEX", "FAIL_TEST_MODE", "FAIL_TEST_WAL_BYTES",
            "FAIL_TEST_ROTATE_INDEX", "FAIL_TEST_ROTATE_PHASE")
DEVD_HELD_S = 120.0  # the CPU daemon's start on a loaded box (no warm-up)
GUARD_S = 90.0  # a device-rule case's bound on a wait that never ends


def _pkg(root: str) -> types.SimpleNamespace:
    mods = {
        "cli": "cli",
        "config": "config",
        "toml": "config.toml",
        "types": "types",
        "gateway": "ops.gateway",
        "node": "node",
        "replay_file": "consensus.replay_file",
        "version": "version",
    }
    return types.SimpleNamespace(root=root, **{k: importlib.import_module(f"{root}.{m}") for k, m in mods.items()})


PKG = {root: _pkg(root) for root in PACKAGES}


# -- the node-process harness, both packages ------------------------------------


@pytest.fixture(scope="module")
def devd_sock():
    """A port device daemon accepting the CPU on a short socket, unwarmed
    (a port node process here has no card): its socket path."""
    from tests.test_torch_devd import DevdProc

    daemon = DevdProc(env={"TENDERMINT_DEVD_WARM": ""})
    try:
        daemon.wait_held(DEVD_HELD_S)
        yield daemon.sock
    finally:
        daemon.stop()


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def node_env(pkg: str, devd_sock: str | None = None, extra_env: dict | None = None) -> dict:
    """A node process's environment: the JAX package's on its CPU path
    (as tests/consensus_common.py sets it), the port's routed to the
    daemon at `devd_sock` and with no host fallback; no fail point unless
    `extra_env` arms one."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in FAIL_ENV:
        env.pop(k, None)
    if pkg == JAX_PKG:
        env.update(JAX_PLATFORMS="cpu", TENDERMINT_TPU_DISABLE="1")
    else:
        env.pop("TENDERMINT_TPU_DISABLE", None)
        env.pop("TENDERMINT_DEVD_SOCKS", None)
        env["TENDERMINT_DEVD_SOCK"] = devd_sock or "/nonexistent/devd.sock"
    env.update({k: str(v) for k, v in (extra_env or {}).items()})
    return env


def init_node_home(home: str, chain_id: str, pkg: str = PORT_PKG) -> None:
    """`cli init` + the fast-consensus subprocess config."""
    subprocess.run(
        [sys.executable, "-m", f"{pkg}.cli", "--home", home, "init", "--chain-id", chain_id],
        check=True, capture_output=True, env=dict(os.environ, PYTHONPATH=REPO),
    )
    write_fast_config(home, pkg)


def write_fast_config(home: str, pkg: str = PORT_PKG) -> None:
    """Speed up consensus for the subprocess (config.toml is what the CLI
    node loads)."""
    p = PKG[pkg]
    cfg = p.toml.load_config(home)
    c = cfg.consensus
    c.timeout_propose = 0.3
    c.timeout_prevote = 0.05
    c.timeout_precommit = 0.05
    c.timeout_commit = 0.05
    c.skip_timeout_commit = True
    cfg.base.db_backend = "filedb"
    cfg.base.proxy_app = "persistent_kvstore"
    with open(os.path.join(home, "config.toml"), "w") as f:
        f.write(p.toml.config_to_toml(cfg))


def node_proc(home: str, rpc_port: int, fail_index: int | None = None, extra_env: dict | None = None,
              pkg: str = PORT_PKG, devd_sock: str | None = None):
    """A real node subprocess of `pkg`'s CLI; fail_index arms
    FAIL_TEST_INDEX, extra_env anything else (the torn-write tier)."""
    extra = dict(extra_env or {})
    if fail_index is not None:
        extra["FAIL_TEST_INDEX"] = fail_index
    return subprocess.Popen(
        [
            sys.executable, "-m", f"{pkg}.cli", "--home", home, "node",
            "--rpc.laddr", f"tcp://127.0.0.1:{rpc_port}",
            "--p2p.laddr", "tcp://127.0.0.1:0",
            "--log_level", "warning",
        ],
        env=node_env(pkg, devd_sock, extra),
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
    )


def rpc(port: int, method: str, timeout=5, **params):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/",
        data=json.dumps({"jsonrpc": "2.0", "id": 1, "method": method, "params": params}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = json.loads(resp.read().decode())
    if body.get("error"):
        raise RuntimeError(body["error"])
    return body["result"]


def wait_height(port: int, h: int, deadline_s: float = 60) -> int:
    deadline = time.time() + deadline_s
    last = -1
    while time.time() < deadline:
        try:
            last = rpc(port, "status", timeout=2)["latest_block_height"]
            if last >= h:
                return last
        except Exception:  # noqa: BLE001 — down or starting
            pass
        time.sleep(0.2)
    return last


def stop_proc(proc) -> None:
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(15)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(15)
    if proc.stdout:
        proc.stdout.close()


@pytest.fixture
def host_defaults(monkeypatch):
    """The port's gateway defaults on the CPU, as injected instances (a
    port node has no CPU default); the JAX package's take its CPU path."""
    gw = PKG[PORT_PKG].gateway
    monkeypatch.setattr(gw, "_default_verifier", gw.Verifier(device="cpu"))
    monkeypatch.setattr(gw, "_default_hasher", gw.Hasher(device="cpu", min_tpu_batch=1 << 30))
    yield


# -- the commands (tests/test_cli.py), both CLIs ----------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_init_and_show_validator(pkg, tmp_path, capsys):
    main = PKG[pkg].cli.main
    home = str(tmp_path / "node0")
    assert main(["--home", home, "init", "--chain-id", "cli-chain"]) == 0
    out = capsys.readouterr().out
    assert "Generated private validator" in out
    assert "Generated genesis file" in out
    assert os.path.exists(os.path.join(home, "genesis.json"))
    assert os.path.exists(os.path.join(home, "config.toml"))
    # idempotent
    assert main(["--home", home, "init"]) == 0
    assert "Found private validator" in capsys.readouterr().out

    assert main(["--home", home, "show_validator"]) == 0
    pub = json.loads(capsys.readouterr().out)
    assert pub[0] == 1 and len(pub[1]) == 64  # [type, hex32]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_gen_validator_and_version(pkg, capsys):
    main = PKG[pkg].cli.main
    assert main(["gen_validator"]) == 0
    pv = json.loads(capsys.readouterr().out)
    assert pv["pub_key"][0] == 1
    assert main(["version"]) == 0
    out = capsys.readouterr().out.strip()
    assert out.count(".") == 2
    assert out == PKG[JAX_PKG].version.VERSION


@pytest.mark.parametrize("pkg", PACKAGES)
def test_testnet(pkg, tmp_path, capsys):
    main = PKG[pkg].cli.main
    d = str(tmp_path / "net")
    assert main(["testnet", "--n", "3", "--dir", d, "--chain-id", "net-chain"]) == 0
    docs = []
    for i in range(3):
        with open(os.path.join(d, f"mach{i}", "genesis.json")) as f:
            docs.append(json.load(f))
    assert all(doc["chain_id"] == "net-chain" for doc in docs)
    assert all(len(doc["validators"]) == 3 for doc in docs)
    assert docs[0]["validators"] == docs[1]["validators"] == docs[2]["validators"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_reset_all(pkg, tmp_path, capsys):
    main = PKG[pkg].cli.main
    home = str(tmp_path / "node1")
    main(["--home", home, "init"])
    data = os.path.join(home, "data")
    os.makedirs(data, exist_ok=True)
    with open(os.path.join(data, "junk"), "w") as f:
        f.write("x")
    assert main(["--home", home, "reset_all"]) == 0
    assert not os.path.exists(os.path.join(data, "junk"))


def test_help_lists_the_same_commands():
    """Both parsers take the same commands, global flags and per-command
    flags, and the same TMHOME / home default."""

    def shape(pkg):
        parser = PKG[pkg].cli.build_parser()
        sub = next(a for a in parser._actions if isinstance(a.choices, dict))
        flags = {name: sorted(opt for a in sp._actions for opt in a.option_strings)
                 for name, sp in sub.choices.items()}
        home = next(a for a in parser._actions if "--home" in a.option_strings).default
        return flags, home

    assert shape(PORT_PKG) == shape(JAX_PKG)
    flags, _ = shape(PORT_PKG)
    assert set(flags) == {"init", "node", "replica", "testnet", "gen_validator", "show_validator",
                          "reset_priv_validator", "reset_all", "replay", "replay_console", "version",
                          "probe_upnp"}


@pytest.mark.parametrize("writer", PACKAGES)
def test_homes_load_under_both_packages(writer, tmp_path, capsys):
    """A home written by one CLI (`init`, `testnet --n 4`), a
    `gen_validator` key and a `show_validator` answer load under both
    packages' `config` and `types` to the same values."""
    main = PKG[writer].cli.main
    home = str(tmp_path / "home")
    net = str(tmp_path / "net")
    assert main(["--home", home, "init", "--chain-id", "both-chain"]) == 0
    assert main(["testnet", "--n", "4", "--dir", net, "--chain-id", "net-chain"]) == 0
    capsys.readouterr()
    assert main(["gen_validator"]) == 0
    gen = json.loads(capsys.readouterr().out)
    assert main(["--home", home, "show_validator"]) == 0
    shown = json.loads(capsys.readouterr().out)

    def read(pkg, root):
        p = PKG[pkg]
        cfg = p.toml.load_config(root)
        pv = p.types.PrivValidatorFS.load(cfg.base.priv_validator_file())
        doc = p.types.GenesisDoc.from_file(cfg.base.genesis_file())
        return {"toml": p.toml.config_to_toml(cfg), "pub": pv.get_pub_key().to_json(),
                "pv": pv.to_json(), "genesis": doc.to_json()}

    for root in [home] + [os.path.join(net, f"mach{i}") for i in range(4)]:
        got = {pkg: read(pkg, root) for pkg in PACKAGES}
        assert got[JAX_PKG] == got[PORT_PKG], root
    assert read(JAX_PKG, home)["pub"] == shown
    assert len({json.dumps(read(PORT_PKG, os.path.join(net, f"mach{i}"))["genesis"]) for i in range(4)}) == 1
    for pkg in PACKAGES:
        path = str(tmp_path / f"gen-{pkg}.json")
        with open(path, "w") as f:
            json.dump(gen, f)
        pv = PKG[pkg].types.PrivValidatorFS.load(path)
        assert pv.to_json() == gen and pv.get_pub_key().to_json() == gen["pub_key"]


@pytest.mark.slow
def test_cli_node_subprocess(tmp_path, devd_sock):
    """Boot a real port node via the CLI (through the CPU daemon), hit its
    RPC, shut it down cleanly (the reference's test/app/dummy_test.sh
    shape)."""
    home = str(tmp_path / "noderun")
    subprocess.run(
        [sys.executable, "-m", "tendermint_tpu_torch.cli", "--home", home, "init"],
        check=True, capture_output=True, env=dict(os.environ, PYTHONPATH=REPO),
    )
    port = free_port()
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "tendermint_tpu_torch.cli", "--home", home, "node",
            "--proxy_app", "kvstore",
            "--rpc.laddr", f"tcp://127.0.0.1:{port}",
            "--p2p.laddr", "tcp://127.0.0.1:0",
        ],
        env=node_env(PORT_PKG, devd_sock), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        assert wait_height(port, 1, 60) >= 1
        res = rpc(port, "broadcast_tx_commit", timeout=30, tx=b"cli-key=cli-val".hex())
        assert res["deliver_tx"]["code"] == 0
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(15) == 0
        proc.stdout.close()


# -- the WAL replay tool, across packages -----------------------------------------


def _run_node_in_process(pkg: str, home: str, heights: int = 3) -> None:
    """A `pkg` node from a CLI-initialised home, in this process (the port's
    on the injected CPU defaults), until its store holds `heights`."""
    p = PKG[pkg]
    p.cli.main(["--home", home, "init"])
    cfg = p.toml.load_config(home)
    cfg.base.proxy_app = "kvstore"
    cfg.rpc.laddr = ""
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    # test-speed consensus
    cfg.consensus.timeout_commit = 0.05
    cfg.consensus.skip_timeout_commit = True
    cfg.consensus.timeout_propose = 0.2
    with open(os.path.join(home, "config.toml"), "w") as f:
        f.write(p.toml.config_to_toml(cfg))
    node = p.node.default_new_node(cfg)
    node.start()
    try:
        deadline = time.time() + 30
        while time.time() < deadline and node.block_store.height() < heights:
            time.sleep(0.05)
        assert node.block_store.height() >= heights
    finally:
        node.stop()


REPLAYED = re.compile(r"replayed (\d+) messages; final height/round/step: (\S+)")


@pytest.mark.parametrize("writer", PACKAGES)
def test_replay_after_run(writer, tmp_path, capsys, host_defaults):
    """A `writer` node runs in-process briefly; then both packages' `replay`
    read its WAL: each replays the same number of messages (more than 0)
    to the same final height/round/step, through `run_replay_file` and
    through the CLI's `replay` command."""
    home = str(tmp_path / "replaynode")
    _run_node_in_process(writer, home)
    capsys.readouterr()
    got = {}
    for pkg in PACKAGES:
        p = PKG[pkg]
        replayed = p.replay_file.run_replay_file(p.toml.load_config(home), console=False)
        out = capsys.readouterr().out
        m = REPLAYED.search(out)
        assert m is not None, out
        assert int(m.group(1)) == replayed > 0
        assert p.cli.main(["--home", home, "replay"]) == 0
        again = REPLAYED.search(capsys.readouterr().out)
        assert again is not None and again.groups() == m.groups()
        got[pkg] = m.groups()
    assert got[JAX_PKG] == got[PORT_PKG]
    height = int(got[PORT_PKG][1].split("/")[0])
    assert height >= 3


# -- the device rule in processes -------------------------------------------------


class _FailingVerifier(PKG[PORT_PKG].gateway.Verifier):
    """A CPU Verifier whose commit verify raises DeviceError: a kernel that
    fails to launch on the card."""

    def __init__(self):
        super().__init__(device="cpu")
        self.calls = 0

    def commit_batch_verifier(self):
        def verify(items):
            self.calls += 1
            raise PKG[PORT_PKG].gateway.DeviceError("ed25519_verify kernel launch failed: cudaError 700")

        return verify


@pytest.fixture
def caught_signals(monkeypatch):
    """signal.signal recorded instead of installed (the CLI's wait loop
    runs in this test's thread); a guard delivers SIGTERM through the
    recorded handler after GUARD_S, so a wait that never ends returns 0."""
    handlers = {}
    monkeypatch.setattr(signal, "signal", lambda sig, fn: handlers.__setitem__(sig, fn))

    def fire():
        if signal.SIGTERM in handlers:
            handlers[signal.SIGTERM](signal.SIGTERM, None)

    guard = threading.Timer(GUARD_S, fire)
    guard.start()
    yield handlers
    guard.cancel()


def test_node_exits_1_when_a_device_error_stops_consensus(tmp_path, monkeypatch, capsys, caught_signals):
    """`cli node` over a verifier whose commit check raises DeviceError:
    consensus stops at height 2's LastCommit check, the wait loop sees
    the error, stops the node, writes it to stderr and returns 1 (the
    JAX CLI would wait for a signal)."""
    gw = PKG[PORT_PKG].gateway
    failing = _FailingVerifier()
    monkeypatch.setattr(gw, "_default_verifier", failing)
    monkeypatch.setattr(gw, "_default_hasher", gw.Hasher(device="cpu", min_tpu_batch=1 << 30))
    home = str(tmp_path / "home")
    PKG[PORT_PKG].cli.main(["--home", home, "init"])
    write_fast_config(home)
    t0 = time.monotonic()
    rc = PKG[PORT_PKG].cli.main(["--home", home, "node", "--proxy_app", "kvstore",
                                 "--rpc.laddr", "tcp://127.0.0.1:0", "--p2p.laddr", "tcp://127.0.0.1:0"])
    out, err = capsys.readouterr()
    assert rc == 1 and time.monotonic() - t0 < GUARD_S
    assert "node stopped by a device error: DeviceError" in err and "cudaError 700" in err
    assert _launch_lines(out) == 1
    assert failing.calls >= 1


def _launch_lines(out: str) -> int:
    """The `kernel launches {...}` lines a stopped node or replica printed,
    each holding every wrapper's count."""
    from tendermint_tpu_torch.ops import kernels

    lines = [ln for ln in out.splitlines() if ln.startswith("kernel launches ")]
    for ln in lines:
        assert set(json.loads(ln.split(" ", 2)[2])) == set(kernels.LAUNCH_COUNTERS)
    return len(lines)


def test_report_launches_is_read_back_from_a_member_log(tmp_path, monkeypatch, capsys):
    """What a stopped node or replica prints (cli.report_launches: this
    process's launch counts) is what the smoke's logged_launches reads
    back from a fleet member's log, among its other lines."""
    import chip_smoke
    from tendermint_tpu_torch.ops import hashing, kernels, merkle

    monkeypatch.setattr(hashing, "ripemd160_launches", 39)
    monkeypatch.setattr(merkle, "launches", 5)
    PKG[PORT_PKG].cli.report_launches()
    out = capsys.readouterr().out
    assert _launch_lines(out) == 1
    counts = kernels.launch_counts()
    assert counts["ripemd160"] == 39 and counts["merkle_tree"] == 5
    log = tmp_path / "node.log"
    log.write_text("Started node: moniker=m rpc_port=1\n2026 consensus WARNING late\n" + out)
    assert chip_smoke.logged_launches(str(log)) == counts
    (tmp_path / "empty.log").write_text("Started node: moniker=m rpc_port=1\n")
    with pytest.raises(AssertionError, match="no kernel launches line"):
        chip_smoke.logged_launches(str(tmp_path / "empty.log"))


def test_node_device_error_reads_the_reactors():
    """The node's check reads the consensus state's `device_error` and the
    two reactors' `sync_error`; a reactor's other error is not a device
    error (the node serves on, as the JAX node does)."""
    gw, cli = PKG[PORT_PKG].gateway, PKG[PORT_PKG].cli
    dev = gw.DeviceError("merkle_tree kernel launch failed")

    def node(cs=None, bc=None, ss=None):
        return types.SimpleNamespace(consensus_state=types.SimpleNamespace(device_error=cs),
                                     blockchain_reactor=types.SimpleNamespace(sync_error=bc),
                                     statesync_reactor=types.SimpleNamespace(sync_error=ss))

    assert cli.node_device_error(node()) is None
    assert cli.node_device_error(node(bc=ValueError("bad block"), ss=OSError("peer"))) is None
    assert cli.node_device_error(node(cs=dev)) is dev
    assert cli.node_device_error(node(bc=dev)) is dev
    assert cli.node_device_error(node(bc=ValueError("x"), ss=dev)) is dev


def test_replica_exits_1_when_a_device_error_stops_its_follower(monkeypatch, capsys, caught_signals):
    """`cli replica` following an upstream on a verifier whose commit check
    raises DeviceError: the follower stops at its first commit, the wait
    loop sees the replica's `device_error`, stops it and returns 1."""
    from tendermint_tpu_torch.statesync.devchain import build_kvstore_chain
    from tests.test_torch_replica import UpstreamSim

    gw = PKG[PORT_PKG].gateway
    failing = _FailingVerifier()
    monkeypatch.setattr(gw, "_default_verifier", failing)
    sim = UpstreamSim(build_kvstore_chain(3))
    home = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
    try:
        t0 = time.monotonic()
        rc = PKG[PORT_PKG].cli.main(["--home", home, "replica", "--upstream", f"127.0.0.1:{sim.port}",
                                     "--rpc.laddr", "tcp://127.0.0.1:0", "--log_level", "error"])
    finally:
        sim.stop()
    out, err = capsys.readouterr()
    assert rc == 1 and time.monotonic() - t0 < GUARD_S
    assert "replica stopped by a device error: DeviceError" in err and "cudaError 700" in err
    assert failing.calls == 1
    assert _launch_lines(out) == 1


def test_node_without_card_or_daemon_exits_before_binding(tmp_path):
    """`cli node` in a process where the card is taken away
    (torch.cuda.is_available patched to False) and no daemon serves exits
    non-zero with resolve_device's error, and neither of its ports was
    bound."""
    home = str(tmp_path / "home")
    init_node_home(home, "no-card")
    p2p_port, rpc_port = free_port(), free_port()
    script = (
        "import sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from tendermint_tpu_torch.cli import main\n"
        "sys.exit(main(sys.argv[1:]))\n"
    )
    env = node_env(PORT_PKG)
    env.pop("TENDERMINT_TPU_KERNEL", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", script, "--home", home, "node",
         "--p2p.laddr", f"tcp://127.0.0.1:{p2p_port}", "--rpc.laddr", f"tcp://127.0.0.1:{rpc_port}"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        out, err = proc.communicate(timeout=GUARD_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"the node did not exit: {out[-500:]} {err[-500:]}")
    assert proc.returncode != 0
    assert "CUDA is not available; pass device='cpu'" in err
    assert "Started node" not in out
    for port in (p2p_port, rpc_port):
        with socket.socket() as s:  # nothing listens there
            assert s.connect_ex(("127.0.0.1", port)) != 0
