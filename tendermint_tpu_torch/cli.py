"""Command-line interface (reference: cmd/tendermint/main.go:14-37 +
cmd/tendermint/commands/*).

Commands: init, node, replica, testnet, gen_validator, show_validator,
reset_all, reset_priv_validator, replay, replay_console, version,
probe_upnp. `--home` picks the node root (config.toml + genesis + privval
+ data), with the JAX package's default and flags, so a home written by
either CLI runs under the other.

    python -m tendermint_tpu_torch.cli --home ~/.tendermint_tpu init
    python -m tendermint_tpu_torch.cli --home ~/.tendermint_tpu node --proxy_app signedkv

A node, a replica or a replay runs on the card, or through a serving
device daemon (TENDERMINT_DEVD_SOCK); with neither, building the node or
the replica raises before it binds, and the command exits non-zero.

The port's one difference from the JAX CLI: `node` and `replica` wait for
a signal as the JAX CLI does, but their wait also ends when a device
error (ops.gateway.DeviceError) has stopped a part of the process: the
node's consensus state (`device_error`), its blockchain or state-sync
reactor (`sync_error`), or the replica's follower (`device_error`). The
command then stops the node or replica, writes the error to stderr and
exits 1. A JAX node whose consensus has stopped keeps running. Once
stopped, either prints its kernels' launches in this process, one line
`kernel launches {...}` (ops.kernels.launch_counts), as the device
daemon logs its own.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import time

# the wait loop's poll: a signal or a device error ends it within this
WAIT_POLL_S = 0.5


def _load_config(home: str):
    from tendermint_tpu_torch.config import ensure_root, load_config

    ensure_root(home)
    return load_config(home)


def node_device_error(node):
    """The gateway.DeviceError that stopped a part of `node` (its consensus
    state, its blockchain reactor, its state-sync reactor), or None. Any
    other error a reactor keeps is not a device error: the node serves on,
    as the JAX node does."""
    from tendermint_tpu_torch.ops.gateway import DeviceError

    for err in (
        node.consensus_state.device_error,
        node.blockchain_reactor.sync_error,
        node.statesync_reactor.sync_error,
    ):
        if isinstance(err, DeviceError):
            return err
    return None


def replica_device_error(daemon):
    """The gateway.DeviceError that stopped the replica's follower, or None."""
    from tendermint_tpu_torch.ops.gateway import DeviceError

    err = daemon.device_error
    return err if isinstance(err, DeviceError) else None


def wait_for_stop(device_error) -> BaseException | None:
    """Wait until SIGINT or SIGTERM (returns None) or until
    `device_error()` answers an error (returns it)."""
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    while not stop:
        err = device_error()
        if err is not None:
            return err
        time.sleep(WAIT_POLL_S)
    return None


def report_launches() -> None:
    """This process's kernel launches, by ops.kernels.LAUNCH_COUNTERS key,
    on a line of stdout: how an operator (or the smoke) reads what a node
    or replica process ran on the card."""
    from tendermint_tpu_torch.ops import kernels

    print(f"kernel launches {json.dumps(kernels.launch_counts())}", flush=True)


def _report_device_error(what: str, err: BaseException) -> int:
    print(f"{what} stopped by a device error: {type(err).__name__}: {err}", file=sys.stderr)
    return 1


# -- commands -----------------------------------------------------------------


def cmd_init(args) -> int:
    """commands/init.go:19-43: privval + genesis + config.toml."""
    from tendermint_tpu_torch.config import ensure_root
    from tendermint_tpu_torch.types import GenesisDoc, GenesisValidator, PrivValidatorFS

    cfg = ensure_root(args.home)
    pv_file = cfg.base.priv_validator_file()
    if os.path.exists(pv_file):
        pv = PrivValidatorFS.load(pv_file)
        print(f"Found private validator: {pv_file}")
    else:
        pv = PrivValidatorFS.generate(pv_file)
        pv.save()
        print(f"Generated private validator: {pv_file}")
    gen_file = cfg.base.genesis_file()
    if os.path.exists(gen_file):
        print(f"Found genesis file: {gen_file}")
    else:
        doc = GenesisDoc(
            genesis_time_ns=time.time_ns(),
            chain_id=args.chain_id or f"test-chain-{os.urandom(3).hex()}",
            validators=[GenesisValidator(pv.get_pub_key(), 10, "")],
        )
        doc.save_as(gen_file)
        print(f"Generated genesis file: {gen_file}")
    return 0


def cmd_node(args) -> int:
    """commands/run_node.go."""
    import logging

    logging.basicConfig(
        level=getattr(logging, (args.log_level or "info").upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    cfg = _load_config(args.home)
    for attr in ("proxy_app", "moniker", "fast_sync"):
        v = getattr(args, attr, None)
        if v is not None:
            setattr(cfg.base, attr, v)
    if args.db_backend:
        cfg.base.db_backend = args.db_backend
    if args.p2p_laddr:
        cfg.p2p.laddr = args.p2p_laddr
    if args.rpc_laddr:
        cfg.rpc.laddr = args.rpc_laddr
    if args.grpc_laddr:
        cfg.rpc.grpc_laddr = args.grpc_laddr
    if args.rpc_unsafe:
        cfg.rpc.unsafe = True
    if args.seeds:
        cfg.p2p.seeds = args.seeds
    if args.pex:
        cfg.p2p.pex_reactor = True
    if args.addr_book_strict is not None:
        cfg.p2p.addr_book_strict = args.addr_book_strict == "true"

    # TENDERMINT_RACECHECK=1 == running the reference under `go test -race`:
    # every lock the node builds joins a process-wide order graph, reported
    # at shutdown (libs/racecheck.py). Install BEFORE node construction so
    # the reactors' locks are in scope.
    race_mon = None
    if os.environ.get("TENDERMINT_RACECHECK", "") == "1":
        from tendermint_tpu_torch.libs import racecheck

        race_mon = racecheck.install()

    from tendermint_tpu_torch.node import default_new_node

    node = default_new_node(cfg)
    node.start()
    print(f"Started node: moniker={cfg.base.moniker} rpc_port={node.rpc_port()}")

    try:
        err = wait_for_stop(lambda: node_device_error(node))
    finally:
        node.stop()
        report_launches()
        if race_mon is not None:
            print(race_mon.report())
    if err is not None:
        return _report_device_error("node", err)
    return 0


def cmd_replica(args) -> int:
    """Run a verified read replica (docs/serving.md § Read
    replicas): follows --upstream with a light client and serves the
    read RPC surface from a proof-carrying cache."""
    import logging

    logging.basicConfig(
        level=getattr(logging, (args.log_level or "info").upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    cfg = _load_config(args.home)
    if args.upstream:
        cfg.replica.upstream = args.upstream
    if args.rpc_laddr:
        cfg.replica.laddr = args.rpc_laddr
    if args.max_lag_heights is not None:
        cfg.replica.max_lag_heights = args.max_lag_heights

    from tendermint_tpu_torch.replica import ReplicaDaemon

    daemon = ReplicaDaemon(cfg)
    daemon.start()
    print(
        f"Started replica: upstream={cfg.replica.upstream} "
        f"rpc_port={daemon.rpc_port}"
    )

    try:
        err = wait_for_stop(lambda: replica_device_error(daemon))
    finally:
        daemon.stop()
        report_launches()
    if err is not None:
        return _report_device_error("replica", err)
    return 0


def cmd_testnet(args) -> int:
    """commands/testnet.go:36-70: N validator dirs + shared genesis."""
    from tendermint_tpu_torch.config import ensure_root
    from tendermint_tpu_torch.types import GenesisDoc, GenesisValidator, PrivValidatorFS

    n = args.n
    gen_vals = []
    pvs = []
    for i in range(n):
        home = os.path.join(args.dir, f"mach{i}")
        cfg = ensure_root(home)
        pv = PrivValidatorFS.load_or_generate(cfg.base.priv_validator_file())
        pvs.append((home, pv, cfg))
        gen_vals.append(GenesisValidator(pv.get_pub_key(), 1, f"mach{i}"))
    doc = GenesisDoc(
        genesis_time_ns=time.time_ns(),
        chain_id=args.chain_id or "chain-" + os.urandom(3).hex(),
        validators=gen_vals,
    )
    for home, _pv, cfg in pvs:
        doc.save_as(cfg.base.genesis_file())
    print(f"Successfully initialized {n} node directories in {args.dir}")
    return 0


def cmd_gen_validator(args) -> int:
    from tendermint_tpu_torch.types import PrivValidatorFS

    pv = PrivValidatorFS.generate(None)
    print(json.dumps(pv.to_json(), indent=2))
    return 0


def cmd_show_validator(args) -> int:
    from tendermint_tpu_torch.config import ensure_root
    from tendermint_tpu_torch.types import PrivValidatorFS

    cfg = ensure_root(args.home)
    pv = PrivValidatorFS.load_or_generate(cfg.base.priv_validator_file())
    print(json.dumps(pv.get_pub_key().to_json()))
    return 0


def cmd_reset_priv_validator(args) -> int:
    """commands/reset_priv_validator.go: DANGEROUS — signing state reset."""
    from tendermint_tpu_torch.config import ensure_root
    from tendermint_tpu_torch.types import PrivValidatorFS

    cfg = ensure_root(args.home)
    pv_file = cfg.base.priv_validator_file()
    if os.path.exists(pv_file):
        pv = PrivValidatorFS.load(pv_file)
        pv.reset()
        print(f"Reset private validator signing state: {pv_file}")
    else:
        PrivValidatorFS.generate(pv_file)
        print(f"Generated private validator: {pv_file}")
    return 0


def cmd_reset_all(args) -> int:
    """commands/reset_priv_validator.go ResetAll: wipe data/ + signing state."""
    from tendermint_tpu_torch.config import ensure_root

    cfg = ensure_root(args.home)
    data_dir = cfg.base.db_dir()
    if os.path.isdir(data_dir):
        shutil.rmtree(data_dir, ignore_errors=True)
        os.makedirs(data_dir, exist_ok=True)
        print(f"Removed all data: {data_dir}")
    return cmd_reset_priv_validator(args)


def cmd_replay(args, console: bool = False) -> int:
    """commands/replay.go -> consensus/replay_file.go."""
    from tendermint_tpu_torch.consensus.replay_file import run_replay_file

    cfg = _load_config(args.home)
    run_replay_file(cfg, console=console)
    return 0


def cmd_version(args) -> int:
    from tendermint_tpu_torch.version import VERSION

    print(VERSION)
    return 0


def cmd_probe_upnp(args) -> int:
    """Probe the local network for UPnP port-mapping support
    (cmd/tendermint/main.go:29, p2p/upnp/probe.go)."""
    import json as _json

    from tendermint_tpu_torch.p2p import upnp

    try:
        caps = upnp.probe()
        print(_json.dumps({"port_mapping": caps.port_mapping, "hairpin": caps.hairpin}))
        return 0
    except Exception as exc:  # noqa: BLE001 — a probe never tracebacks
        print(_json.dumps({"error": str(exc)}))
        return 1


# -- parser -------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tendermint-tpu-torch",
        description="BFT state-machine replication node on an NVIDIA H100 (the port)",
    )
    p.add_argument(
        "--home",
        default=os.environ.get("TMHOME", os.path.expanduser("~/.tendermint_tpu")),
        help="node root directory",
    )
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("init", help="initialize a node (privval + genesis)")
    sp.add_argument("--chain-id", default="")
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("node", help="run the node")
    sp.add_argument("--proxy_app", default=None, help="app address or name (kvstore, signedkv, counter, nilapp, tcp://...)")
    sp.add_argument("--moniker", default=None)
    sp.add_argument("--fast_sync", action="store_true", default=None)
    sp.add_argument("--p2p.laddr", dest="p2p_laddr", default=None)
    sp.add_argument("--rpc.laddr", dest="rpc_laddr", default=None)
    sp.add_argument("--rpc.grpc_laddr", dest="grpc_laddr", default=None)
    sp.add_argument(
        "--rpc.unsafe", dest="rpc_unsafe", action="store_true",
        help="enable unsafe RPC routes (profiler, dial_seeds, flush "
        "mempool — rpc/core/routes.go:37-46 equivalent)",
    )
    sp.add_argument("--seeds", default=None, help="comma-separated host:port")
    sp.add_argument("--pex", action="store_true")
    sp.add_argument(
        "--p2p.addr_book_strict",
        dest="addr_book_strict",
        default=None,
        choices=["true", "false"],
        help="only store globally-routable peer addresses (turn off for "
        "loopback testnets; p2p/addrbook.py routability)",
    )
    sp.add_argument("--log_level", default="info")
    sp.add_argument("--db_backend", default=None, help="sqlite | filedb | memdb")
    sp.set_defaults(fn=cmd_node)

    sp = sub.add_parser(
        "replica",
        help="run a verified read replica following an upstream node "
        "(docs/serving.md § Read replicas)",
    )
    sp.add_argument(
        "--upstream", default=None,
        help="upstream RPC address (host:port) — a node, or another replica",
    )
    sp.add_argument("--rpc.laddr", dest="rpc_laddr", default=None)
    sp.add_argument(
        "--max_lag_heights", type=int, default=None,
        help="bounded staleness: refuse latest-reads when the verified "
        "view lags upstream by more than this many heights",
    )
    sp.add_argument("--log_level", default="info")
    sp.set_defaults(fn=cmd_replica)

    sp = sub.add_parser("testnet", help="initialize files for an N-node testnet")
    sp.add_argument("--n", type=int, default=4)
    sp.add_argument("--dir", default="mytestnet")
    sp.add_argument("--chain-id", default="")
    sp.set_defaults(fn=cmd_testnet)

    sub.add_parser("gen_validator", help="generate a new validator keypair").set_defaults(
        fn=cmd_gen_validator
    )
    sub.add_parser("show_validator", help="show this node's validator pubkey").set_defaults(
        fn=cmd_show_validator
    )
    sub.add_parser(
        "reset_priv_validator", help="reset the validator signing state (DANGEROUS)"
    ).set_defaults(fn=cmd_reset_priv_validator)
    sub.add_parser(
        "reset_all", help="wipe blockchain data and signing state (DANGEROUS)"
    ).set_defaults(fn=cmd_reset_all)
    sub.add_parser("replay", help="replay the consensus WAL against a fresh state").set_defaults(
        fn=lambda a: cmd_replay(a, console=False)
    )
    sub.add_parser("replay_console", help="interactive WAL replay").set_defaults(
        fn=lambda a: cmd_replay(a, console=True)
    )
    sub.add_parser("version", help="print the version").set_defaults(fn=cmd_version)
    sub.add_parser(
        "probe_upnp", help="probe the network for UPnP port-mapping support"
    ).set_defaults(fn=cmd_probe_upnp)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
