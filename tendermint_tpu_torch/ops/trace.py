"""Operator CLI: dump a node's per-height consensus traces.

    python -m tendermint_tpu_torch.ops.trace --home ~/.tendermint --last 5
    python -m tendermint_tpu_torch.ops.trace --url 127.0.0.1:46657 --json

Pulls the `consensus_trace` RPC (consensus/trace.py ring) and renders
each committed height's wall time as named segments — where a slow
height actually spent it — plus the height's device-vs-CPU verify/hash
attribution and breaker state. `--home` resolves the RPC address from
the node's config.toml; `--url` talks to any reachable node directly.
"""

from __future__ import annotations

import argparse
import json
import sys

from tendermint_tpu_torch.consensus.trace import SEGMENTS


def _resolve_url(args) -> str:
    if args.url:
        return args.url
    from tendermint_tpu_torch.config.toml import load_config

    cfg = load_config(args.home)
    laddr = cfg.rpc.laddr
    if not laddr:
        raise SystemExit(f"node at {args.home} has no rpc.laddr configured")
    addr = laddr.split("://", 1)[-1]
    if addr.startswith("unix") or "/" in addr.split(":", 1)[0]:
        return f"unix://{addr.split('://', 1)[-1]}"
    host, _, port = addr.rpartition(":")
    if host in ("", "0.0.0.0", "::"):
        host = "127.0.0.1"  # listen-anywhere means dial loopback locally
    return f"{host}:{port}"


def _bar(frac: float, width: int = 24) -> str:
    n = max(0, min(width, round(frac * width)))
    return "#" * n + "." * (width - n)


def render(traces: list[dict], out=sys.stdout) -> None:
    if not traces:
        print("no completed heights traced yet", file=out)
        return
    for t in traces:
        wall = t.get("wall_s", 0.0) or 0.0
        dev = t.get("device", {})
        print(
            f"height {t['height']}  wall {wall:.3f}s  "
            f"rounds {t.get('rounds', 1)}  "
            f"(segments sum {t.get('total_s', 0.0):.3f}s)",
            file=out,
        )
        segs = t.get("segments", {})
        order = [s for s in SEGMENTS if s in segs] + [
            s for s in segs if s not in SEGMENTS
        ]
        for name in order:
            v = segs[name]
            frac = (v / wall) if wall > 0 else 0.0
            print(f"  {name:<14} {v:>9.4f}s  {_bar(frac)} {frac * 100:5.1f}%",
                  file=out)
        aux = t.get("aux", {})
        if "overlap_apply_s" in aux:
            # pipelined execution: the deferred apply of the
            # PREVIOUS height ran against this height's propose/prevote
            # segments — split it into the part consensus never waited
            # for (hidden) vs the join wait it actually paid (idle)
            apply_s = aux["overlap_apply_s"]
            wait_s = aux.get("pipeline_join_wait_s", 0.0)
            hidden = max(0.0, apply_s - wait_s)
            frac = (hidden / apply_s) if apply_s > 0 else 0.0
            print(
                f"  = apply(H-1)   {apply_s:>9.4f}s  {_bar(frac)} "
                f"{frac * 100:5.1f}% hidden / {wait_s:.4f}s join wait",
                file=out,
            )
        for k, v in sorted(aux.items()):
            if k == "overlap_apply_s":
                continue  # rendered as the split line above
            print(f"  ~ {k:<12} {v:>9.4f}s  (overlaps segments)", file=out)
        vt, vc = dev.get("verify_tpu_sigs", 0), dev.get("verify_cpu_sigs", 0)
        ht, hc = dev.get("hash_tpu_leaves", 0), dev.get("hash_cpu_leaves", 0)
        br = dev.get("breaker_state_end", -1)
        br_s = {-1: "n/a (no devd)", 0: "closed", 1: "half-open",
                2: "OPEN (CPU fallback)"}.get(br, str(br))
        print(
            f"  device: verify {vt} sigs on-device / {vc} cpu; "
            f"hash {ht} leaves on-device / {hc} cpu; breaker {br_s}",
            file=out,
        )
        print(file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dump per-height consensus wall-time traces",
    )
    ap.add_argument("--home", default=None,
                    help="node home (reads rpc.laddr from config.toml)")
    ap.add_argument("--url", default=None,
                    help="RPC address (host:port or unix:///path.sock); "
                         "overrides --home")
    ap.add_argument("--last", type=int, default=10,
                    help="how many recent heights (default 10)")
    ap.add_argument("--json", action="store_true",
                    help="raw JSON instead of the rendered table")
    args = ap.parse_args(argv)
    if not args.url and not args.home:
        ap.error("one of --home or --url is required")

    from tendermint_tpu_torch.rpc.client import HTTPClient

    client = HTTPClient(_resolve_url(args))
    traces = client.consensus_trace(last=args.last)["traces"]
    try:
        if args.json:
            print(json.dumps(traces, indent=2))
        else:
            render(traces)
    except BrokenPipeError:
        # piped into `head` etc. — a closed pager is a clean exit, not
        # a traceback
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
