"""Operator WAL-replay tool (reference: consensus/replay_file.go).

Replays a node's consensus WAL against a fresh state built from the
genesis doc + a fresh app, recomputing every commit. `console=True` gives
an interactive stepper (next [N] / locate / status / quit — replay_file.go:144).
Because blocks re-execute from scratch, a divergence between the WAL and
the app surfaces as a commit failure at the offending height.

The fresh consensus state takes the gateway's defaults, as a node does:
its commits verify on the card (or through a serving device daemon), and
a device error (ops.gateway.DeviceError) raised while a message is fed
ends the replay with that error. The one catch-all wraps the WAL line's
decoding only.
"""

from __future__ import annotations

import threading

from tendermint_tpu_torch.consensus.state import ConsensusState, MsgInfo
from tendermint_tpu_torch.consensus.wal import decode_wal_line
from tendermint_tpu_torch.libs.db import MemDB
from tendermint_tpu_torch.libs.events import EventSwitch


def new_consensus_state_for_replay(cfg):
    """replay_file.go:237-267: fresh state + stores + proxy app."""
    from tendermint_tpu_torch.blockchain.store import BlockStore
    from tendermint_tpu_torch.consensus.replay import Handshaker
    from tendermint_tpu_torch.proxy.client_creator import default_client_creator
    from tendermint_tpu_torch.proxy.multi_app_conn import AppConns
    from tendermint_tpu_torch.state.state import State
    from tendermint_tpu_torch.types import GenesisDoc

    doc = GenesisDoc.from_file(cfg.base.genesis_file())
    state = State.get_state(MemDB(), doc)
    store = BlockStore(MemDB())
    creator = default_client_creator(cfg.base.proxy_app, cfg.base.db_dir())
    proxy_app = AppConns(creator, Handshaker(state, store))
    proxy_app.start()
    evsw = EventSwitch()
    evsw.start()

    from tendermint_tpu_torch.mempool.mempool import Mempool

    mempool = Mempool(cfg.mempool, proxy_app.mempool())
    cs = ConsensusState(
        cfg.consensus, state, proxy_app.consensus(), store, mempool
    )
    cs.set_event_switch(evsw)
    return cs


def run_replay_file(cfg, console: bool = False) -> int:
    """Feed the node's WAL through a fresh consensus state; returns the
    number of replayed messages."""
    wal_file = cfg.consensus.wal_file()
    # format-aware READ-ONLY view (v2 CRC frames or legacy JSON lines):
    # an operator tool must never run the mutating repair pass against
    # the home it inspects — a damaged frame just ends the prefix here
    from tendermint_tpu_torch.consensus.wal import read_wal_lines

    lines = read_wal_lines(wal_file)

    cs = new_consensus_state_for_replay(cfg)
    cs.replay_mode = True
    cs.start_routines(max_steps=0)  # ticker + routine, no WAL, no round-0
    replayed = 0
    step_budget = [float("inf")]

    def prompt() -> bool:
        """console UI; False = quit."""
        while True:
            try:
                cmdline = input("> ").strip().split()
            except EOFError:
                return False
            if not cmdline:
                continue
            cmd = cmdline[0]
            if cmd in ("q", "quit"):
                return False
            if cmd in ("n", "next"):
                step_budget[0] = int(cmdline[1]) if len(cmdline) > 1 else 1
                return True
            if cmd == "status":
                rs = cs.get_round_state()
                print(rs.to_json())
                continue
            print("commands: next [N] | status | quit")

    if console:
        print(f"replaying {wal_file} ({len(lines)} lines); commands: next [N] | status | quit")
        step_budget[0] = 0

    for i, line in enumerate(lines):
        try:
            entry = decode_wal_line(line)
        except Exception as exc:  # noqa: BLE001
            if i == len(lines) - 1:
                print(f"skipping corrupt tail line: {exc}")
                break
            raise
        if entry is None or entry[0] in ("event", "endheight"):
            continue
        if console and step_budget[0] <= 0:
            if not prompt():
                break
        # feed synchronously through the handler (replay determinism)
        if entry[0] == "msg_info":
            cs.handle_msg(MsgInfo(entry[1], entry[2]))
        elif entry[0] == "timeout":
            cs.handle_timeout(entry[1])
        replayed += 1
        step_budget[0] -= 1

    rs = cs.get_round_state()
    print(f"replayed {replayed} messages; final height/round/step: "
          f"{rs.height}/{rs.round_}/{rs.step}")
    cs.stop()
    return replayed
