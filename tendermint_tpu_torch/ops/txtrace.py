"""Cross-node transaction-lifecycle timelines.

    python -m tendermint_tpu_torch.ops.txtrace --urls host1:46657,host2:46657
    python -m tendermint_tpu_torch.ops.txtrace --urls ... --hash 3FA9C1...
    python -m tendermint_tpu_torch.ops.txtrace --urls ... --json

Per node it pulls the ``tx_trace`` RPC (libs/txtrace.py: completed ring
+ in-flight actives) and joins the records by tx HASH — the natural
cross-node causal id — into per-tx timelines: the stage instants are
absolute wall-clock seconds (the arrival-mark convention of
consensus/trace.py), so one tx's lifecycle reads ACROSS the fleet:
submitted on A (rpc_ingress there), gossiped (p2p_broadcast on A,
rpc_ingress source=peer on B), reaped into B's proposal, committed
everywhere. A tx parked mid-flight (a partition) shows with its last
stamped stage and no commit — which is the wedge-triage read.

Scrape-parallel like ops/fleet (one thread per node; a dead node
contributes an error entry, not a dead CLI). Importable pieces:
``collect_txtraces`` / ``join_tx_timelines`` / ``render``.
"""

from __future__ import annotations

import argparse
import json
import sys

from tendermint_tpu_torch.libs.txtrace import STAGES


def fetch_txtraces(url: str, last: int = 20, tx_hash: str = "",
                   timeout: float = 10.0) -> dict:
    from tendermint_tpu_torch.rpc.client import HTTPClient

    client = HTTPClient(url, timeout=timeout)
    return client.tx_trace(hash=tx_hash, last=int(last))


def collect_txtraces(urls: list[str], last: int = 20,
                     tx_hash: str = "") -> dict:
    """{url: {"traces": [...], "active": [...]} | {"error": ...}} —
    scraped in parallel; partial fleets are when this tool matters."""
    from concurrent.futures import ThreadPoolExecutor

    if not urls:
        return {}

    def one(url: str) -> dict:
        try:
            return fetch_txtraces(url, last=last, tx_hash=tx_hash)
        except Exception as exc:  # noqa: BLE001 — one dead node != no view
            return {"error": f"{type(exc).__name__}: {exc}"}

    with ThreadPoolExecutor(max_workers=min(16, len(urls))) as pool:
        return dict(zip(urls, pool.map(one, urls)))


def join_tx_timelines(snapshot: dict) -> list[dict]:
    """Join per-node records into per-tx cross-node rows, newest
    activity first. Each row: the tx hash, its committed height (from
    whichever node knows it), per-node {stage: instant} maps, the
    submitting node (earliest rpc_ingress with source=rpc), and
    end-to-end latencies where measurable."""
    by_hash: dict[str, dict[str, dict]] = {}
    for url, entry in snapshot.items():
        if "error" in entry:
            continue
        for t in entry.get("traces", []) + entry.get("active", []):
            by_hash.setdefault(t["hash"], {})[url] = t

    rows = []
    for h, nodes in by_hash.items():
        ingresses = [
            (t["stages"].get("rpc_ingress"), url, t)
            for url, t in nodes.items()
            if t["stages"].get("rpc_ingress") is not None
        ]
        ingresses.sort(key=lambda x: x[0])
        submitted_on = next(
            (url for _at, url, t in ingresses if t.get("source") == "rpc"),
            ingresses[0][1] if ingresses else None,
        )
        height = max((t.get("height") or 0 for t in nodes.values()),
                     default=0)
        committed = any(
            t["stages"].get("block_commit") is not None
            for t in nodes.values()
        )
        proposed_on = next(
            (url for url, t in nodes.items()
             if t["stages"].get("proposal") is not None),
            None,
        )
        last_activity = max(
            (max(t["stages"].values()) for t in nodes.values()
             if t["stages"]),
            default=0.0,
        )
        commit_latency = min(
            (t["commit_latency_s"] for t in nodes.values()
             if t.get("commit_latency_s") is not None),
            default=None,
        )
        # the furthest stage ANY node stamped — a parked tx reads as
        # "parked at <last stage>" straight off this field
        last_stage = None
        for stage in STAGES:
            if any(t["stages"].get(stage) is not None
                   for t in nodes.values()):
                last_stage = stage
        rows.append({
            "hash": h,
            "height": height or None,
            "committed": committed,
            "submitted_on": submitted_on,
            "proposed_on": proposed_on,
            "last_stage": last_stage,
            "commit_latency_s": commit_latency,
            "nodes_reporting": len(nodes),
            "last_activity": last_activity,
            "per_node": {
                url: {
                    "source": t.get("source"),
                    "outcome": t.get("outcome"),
                    "stages": t["stages"],
                    "spans": t.get("spans", {}),
                }
                for url, t in nodes.items()
            },
        })
    rows.sort(key=lambda r: r["last_activity"], reverse=True)
    return rows


# -- rendering -----------------------------------------------------------------


def _ms(v) -> str:
    return "-" if v is None else f"{v * 1000:.1f}ms"


def render(rows: list[dict], out=sys.stdout, last: int = 10) -> None:
    if not rows:
        print("no traced txs reported (sampling knobs: "
              "TENDERMINT_TXTRACE_FIRST_K / _SAMPLE_N)", file=out)
        return
    for r in rows[: max(1, int(last))]:
        state = (
            f"committed @h={r['height']}" if r["committed"]
            else f"PARKED at {r['last_stage'] or 'nowhere'}"
        )
        lat = f" e2e {_ms(r['commit_latency_s'])}" if r["committed"] else ""
        print(f"tx {r['hash'][:16]}.. {state}{lat} "
              f"(submitted on {r['submitted_on'] or '?'}, "
              f"proposal on {r['proposed_on'] or '?'}, "
              f"{r['nodes_reporting']} node(s) reporting)", file=out)
        # per-stage instants relative to the earliest ingress
        base = min(
            (t["stages"].get("rpc_ingress") for t in r["per_node"].values()
             if t["stages"].get("rpc_ingress") is not None),
            default=None,
        )
        if base is None:
            continue
        nodes = sorted(r["per_node"])
        print(f"  {'stage':<16}" + "".join(f"{n:>22}" for n in nodes),
              file=out)
        for stage in STAGES:
            vals = []
            any_set = False
            for n in nodes:
                at = r["per_node"][n]["stages"].get(stage)
                if at is None:
                    vals.append(f"{'-':>22}")
                else:
                    any_set = True
                    vals.append(f"{f'+{(at - base) * 1000:.1f}ms':>22}")
            if any_set:
                print(f"  {stage:<16}" + "".join(vals), file=out)
        print(file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="cross-node tx-lifecycle timelines from tx_trace "
                    "RPC scrapes",
    )
    ap.add_argument("--urls", required=True,
                    help="comma-separated RPC addresses (host:port)")
    ap.add_argument("--hash", default="",
                    help="filter to one tx hash (hex)")
    ap.add_argument("--last", type=int, default=10,
                    help="how many recent txs to show (default 10)")
    ap.add_argument("--json", action="store_true",
                    help="raw JSON instead of the rendered timelines")
    args = ap.parse_args(argv)
    urls = [u.strip() for u in args.urls.split(",") if u.strip()]

    snapshot = collect_txtraces(urls, last=max(args.last, 20),
                                tx_hash=args.hash)
    rows = join_tx_timelines(snapshot)
    try:
        if args.json:
            errors = {u: e["error"] for u, e in snapshot.items()
                      if "error" in e}
            print(json.dumps({"txs": rows, "errors": errors}, indent=2))
        else:
            for u, e in snapshot.items():
                if "error" in e:
                    print(f"{u}: UNREACHABLE ({e['error']})",
                          file=sys.stderr)
            render(rows, last=args.last)
    except BrokenPipeError:
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
