"""Measure the port's p2p transport: two MConnections over a local socket
pair, each under a SecretConnection, one sending the other windows of
messages the size of a state-sync chunk response (64 KiB of chunk, hex
encoded in JSON: 131,000 bytes), the next window once the last has
arrived, as the state-sync reactor's 8-chunk windows go.

Run from the repository root (no card needed):

    python3 scripts/mconn_rate.py [--against LABEL=DIR ...] [--messages N]
        [--window W] [--rate BYTES_PER_S] [--turns T]

This checkout is measured beside every `--against` checkout (for example
the parent commit, unpacked with `git archive`), each in a process of its
own importing tendermint_tpu_torch from its directory, the checkouts
taking turns T times. `--rate` is both connections' send and receive
rate limit (0: none; default 0, so that the transport's own cost shows).
The secret connection's AEAD backend is the process's
(TENDERMINT_SECRETCONN_BACKEND picks it). One JSON line per run: the
checkout, MB/s, wall seconds, CPU seconds of the process (both ends).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

MESSAGE_BYTES = 131_000


def worker(repo: str, messages: int, window: int, rate: float) -> dict:
    sys.path.insert(0, repo)
    import socket
    import threading
    import time

    from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
    from tendermint_tpu_torch.p2p.conn import ChannelDescriptor, MConnConfig, MConnection
    from tendermint_tpu_torch.p2p.secret_connection import SecretConnection
    from tendermint_tpu_torch.p2p.stream import SocketStream

    a, b = socket.socketpair()
    out = {}
    t = threading.Thread(target=lambda: out.update(conn=SecretConnection(SocketStream(b), gen_priv_key_ed25519())))
    t.start()
    ca = SecretConnection(SocketStream(a), gen_priv_key_ed25519())
    t.join()
    descs = [ChannelDescriptor(id=0x60, priority=5, send_queue_capacity=window, recv_message_capacity=1 << 22)]
    cfg = MConnConfig(send_rate=rate, recv_rate=rate, flush_throttle=0.01)
    got: list[int] = []
    errors: list[Exception] = []
    ma = MConnection(ca, descs, lambda ch, m: None, errors.append, cfg)
    mb = MConnection(out["conn"], descs, lambda ch, m: got.append(len(m)), errors.append, cfg)
    ma.start()
    mb.start()
    msg = b"7" * MESSAGE_BYTES
    c0, t0 = time.process_time(), time.perf_counter()
    sent = 0
    while sent < messages:
        n = min(window, messages - sent)
        for _ in range(n):
            if not ma.send(0x60, msg):
                raise RuntimeError("send refused")
        sent += n
        while len(got) < sent and not errors:
            time.sleep(0.0005)
    wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    failed = list(errors)  # before the stops, whose closed streams end the routines
    ma.stop()
    mb.stop()
    if failed or got != [MESSAGE_BYTES] * messages:
        raise RuntimeError(f"transport failed: {failed[:1]}, {len(got)} of {messages} messages")
    return {"mb_s": messages * MESSAGE_BYTES / wall / 1e6, "wall_s": wall, "cpu_s": cpu,
            "backend": ca._send_aead.backend}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[], metavar="LABEL=DIR")
    ap.add_argument("--messages", type=int, default=160)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.0)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.messages, args.window, args.rate)))
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    checkouts = [("this", here)] + [tuple(s.split("=", 1)) for s in args.against]
    for turn in range(args.turns):
        order = checkouts if turn % 2 == 0 else checkouts[::-1]
        for label, repo in order:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", os.path.abspath(repo),
                 "--messages", str(args.messages), "--window", str(args.window), "--rate", str(args.rate)],
                capture_output=True, text=True)
            if res.returncode:
                sys.stderr.write(res.stderr)
                return res.returncode
            row = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps({"checkout": label, "turn": turn, "messages": args.messages,
                              "window": args.window, "rate": args.rate, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
