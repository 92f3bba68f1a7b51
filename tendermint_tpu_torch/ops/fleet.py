"""Fleet observability aggregator: cross-node height
timelines from nothing but each node's public scrape surface.

    python -m tendermint_tpu_torch.ops.fleet --urls host1:46657,host2:46657 --last 5
    python -m tendermint_tpu_torch.ops.fleet --urls ... --json

Per node it pulls GET /metrics (Prometheus text 0.0.4), GET /health
(node/health.py contract), and the ``consensus_trace`` RPC — then joins
the traces' gossip arrival marks (consensus/trace.py ARRIVALS, absolute
wall-clock instants) across nodes into a per-height timeline:

- **propagation lag**: spread of ``first_block_part`` instants — how long
  after the proposer held the first part the slowest peer did;
- **quorum-formation time**: per node, ``precommit_quorum`` (and
  ``prevote_quorum``) minus the height's start — the committee-scale
  bottleneck the vote-dissemination literature engineers against;
- **commit skew**: spread of the finalize instants — how staggered the
  fleet commits the same height.

A partition reads off these scrapes alone, never by reaching into
harness objects: a quorum-time spike, a degraded /health and frozen
per-peer gossip counters.

Importable pieces: ``fetch_metrics`` / ``fetch_health`` / ``fetch_traces`` / ``collect`` /
``build_timeline`` / ``metric_value`` / ``render``.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import urllib.error
import urllib.request

# one sample line: name{labels} value  (labels optional)
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>\+Inf|-Inf|NaN|[0-9.eE+-]+)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """Prometheus text 0.0.4 -> {sample_name: [(labels_dict, value)]}.
    Sample names keep their _bucket/_sum/_count suffixes — this is a
    scrape reader, not a data model."""
    out: dict[str, list] = {}

    def unescape(v: str) -> str:
        return (v.replace(r"\n", "\n").replace(r"\"", '"')
                .replace("\\\\", "\\"))

    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        labels = {
            k: unescape(v)
            for k, v in _LABEL_RE.findall(m.group("labels") or "")
        }
        raw = m.group("value")
        value = float("inf") if raw == "+Inf" else (
            float("-inf") if raw == "-Inf" else float(raw)
        )
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


def metric_value(metrics: dict, name: str, labels: dict | None = None,
                 default: float | None = None) -> float | None:
    """First sample of `name` whose labels contain `labels`; with no
    labels given and several series, the SUM (the per-peer counters'
    natural fleet read)."""
    samples = metrics.get(name)
    if not samples:
        return default
    if labels:
        for lbls, v in samples:
            if all(lbls.get(k) == str(want) for k, want in labels.items()):
                return v
        return default
    if len(samples) == 1:
        return samples[0][1]
    return sum(v for _l, v in samples)


# -- scrape --------------------------------------------------------------------


def _base(url: str) -> str:
    return url if url.startswith("http") else f"http://{url}"


def fetch_metrics(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(f"{_base(url)}/metrics",
                                timeout=timeout) as r:
        return parse_prometheus(r.read().decode())


def fetch_health(url: str, timeout: float = 10.0) -> dict:
    """GET /health — parsed whatever the HTTP status (503 = failing is
    still a well-formed body, and exactly what a probe wants to read)."""
    req = urllib.request.Request(f"{_base(url)}/health")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode())
    except urllib.error.HTTPError as exc:
        body = exc.read().decode()
        try:
            return json.loads(body)
        except ValueError:
            raise exc


def fetch_traces(url: str, last: int = 10, timeout: float = 10.0) -> list:
    from tendermint_tpu_torch.rpc.client import HTTPClient

    client = HTTPClient(url, timeout=timeout)
    return client.consensus_trace(last=int(last))["traces"]


def _collect_one(url: str, last: int) -> dict:
    entry: dict = {}
    try:
        entry["metrics"] = fetch_metrics(url)
        entry["health"] = fetch_health(url)
        entry["traces"] = fetch_traces(url, last=last)
    except Exception as exc:  # noqa: BLE001 — one dead node != no view
        entry["error"] = f"{type(exc).__name__}: {exc}"
    return entry


def collect(urls: list[str], last: int = 10) -> dict:
    """Scrape every node IN PARALLEL (one thread per node); a dead node
    contributes an {"error": ...} entry instead of killing the fleet
    view — and costs one timeout, not a serial stall of the whole
    render (partial fleets are exactly when an operator reaches for
    this tool)."""
    from concurrent.futures import ThreadPoolExecutor

    if not urls:
        return {}
    with ThreadPoolExecutor(max_workers=min(16, len(urls))) as pool:
        entries = pool.map(lambda u: _collect_one(u, last), urls)
        return dict(zip(urls, entries))


# -- timeline reconstruction ---------------------------------------------------


def _spread(instants: list[float]) -> float | None:
    return (max(instants) - min(instants)) if len(instants) >= 2 else None


def build_timeline(per_node_traces: dict, last: int = 10) -> list[dict]:
    """Join per-node traces into per-height cross-node rows, newest
    first. `per_node_traces`: {node_key: [trace dicts]} (the
    consensus_trace JSON shape). Rows carry None where a mark is absent
    (a catchup height has no prevote quorum; a single reporter has no
    skew) — the renderer prints "-", JSON keeps null."""
    by_height: dict[int, dict[str, dict]] = {}
    for node, traces in per_node_traces.items():
        for t in traces or []:
            by_height.setdefault(t["height"], {})[node] = t

    rows = []
    for height in sorted(by_height, reverse=True)[: max(1, int(last))]:
        nodes = by_height[height]
        first_parts, commits, quorum_s, prevote_q_s = [], [], [], []
        per_node = {}
        for node, t in nodes.items():
            arr = t.get("arrivals", {})
            start = t.get("started_at")
            fp, cm = arr.get("first_block_part"), arr.get("commit")
            if fp is not None:
                first_parts.append(fp)
            if cm is not None:
                commits.append(cm)
            pq, vq = arr.get("precommit_quorum"), arr.get("prevote_quorum")
            q = (pq - start) if (pq is not None and start is not None) \
                else None
            v = (vq - start) if (vq is not None and start is not None) \
                else None
            if q is not None:
                quorum_s.append(q)
            if v is not None:
                prevote_q_s.append(v)
            per_node[node] = {
                "wall_s": t.get("wall_s"),
                "rounds": t.get("rounds"),
                "first_part_at": fp,
                "commit_at": cm,
                "prevote_quorum_s": v,
                "precommit_quorum_s": q,
            }
        rows.append({
            "height": height,
            "nodes_reporting": len(nodes),
            "propagation_lag_s": _spread(first_parts),
            "prevote_quorum_s_max": max(prevote_q_s) if prevote_q_s else None,
            "precommit_quorum_s_max": max(quorum_s) if quorum_s else None,
            "precommit_quorum_s_min": min(quorum_s) if quorum_s else None,
            "commit_skew_s": _spread(commits),
            "per_node": per_node,
        })
    return rows


def fleet_summary(snapshot: dict) -> dict:
    """One status row per node off the scrape: height, peers, health,
    gossip send totals — the 'is the fleet alive' glance."""
    out = {}
    for url, entry in snapshot.items():
        if "error" in entry:
            out[url] = {"error": entry["error"]}
            continue
        m = entry["metrics"]
        health = entry.get("health", {})
        peers = (metric_value(m, "p2p_peers_outbound", default=0) or 0) + (
            metric_value(m, "p2p_peers_inbound", default=0) or 0
        )
        out[url] = {
            "height": metric_value(m, "consensus_height"),
            "peers": peers,
            "health": health.get("status", "?"),
            "vote_gossip_sends": metric_value(
                m, "p2p_peer_vote_gossip_sends_total", default=0
            ),
            "vote_gossip_send_failures": metric_value(
                m, "p2p_peer_vote_gossip_send_failures_total", default=0
            ),
        }
    return out


# -- rendering -----------------------------------------------------------------


def _ms(v) -> str:
    return "-" if v is None else f"{v * 1000:.1f}ms"


def render(snapshot: dict, rows: list[dict], out=sys.stdout) -> None:
    print("fleet:", file=out)
    for url, s in fleet_summary(snapshot).items():
        if "error" in s:
            print(f"  {url:<28} UNREACHABLE ({s['error']})", file=out)
            continue
        print(
            f"  {url:<28} height {int(s['height'] or 0):<7} "
            f"peers {int(s['peers']):<3} health {s['health']:<9} "
            f"gossip sends {int(s['vote_gossip_sends'] or 0)} "
            f"(+{int(s['vote_gossip_send_failures'] or 0)} failed)",
            file=out,
        )
    print(file=out)
    if not rows:
        print("no cross-node heights reconstructed yet", file=out)
        return
    print(
        f"{'height':>8}  {'nodes':>5}  {'prop-lag':>9}  "
        f"{'prevote-q':>10}  {'precommit-q':>11}  {'commit-skew':>11}",
        file=out,
    )
    for r in rows:
        print(
            f"{r['height']:>8}  {r['nodes_reporting']:>5}  "
            f"{_ms(r['propagation_lag_s']):>9}  "
            f"{_ms(r['prevote_quorum_s_max']):>10}  "
            f"{_ms(r['precommit_quorum_s_max']):>11}  "
            f"{_ms(r['commit_skew_s']):>11}",
            file=out,
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="cross-node height timelines + fleet health from "
                    "GET /metrics + consensus_trace + GET /health scrapes",
    )
    ap.add_argument("--urls", required=True,
                    help="comma-separated RPC addresses (host:port)")
    ap.add_argument("--last", type=int, default=10,
                    help="how many recent heights (default 10)")
    ap.add_argument("--json", action="store_true",
                    help="raw JSON instead of the rendered tables")
    args = ap.parse_args(argv)
    urls = [u.strip() for u in args.urls.split(",") if u.strip()]

    snapshot = collect(urls, last=args.last)
    rows = build_timeline(
        {u: e.get("traces", []) for u, e in snapshot.items()},
        last=args.last,
    )
    try:
        if args.json:
            print(json.dumps({
                "fleet": fleet_summary(snapshot),
                "health": {u: e.get("health") for u, e in snapshot.items()},
                "timeline": rows,
            }, indent=2))
        else:
            render(snapshot, rows)
    except BrokenPipeError:
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
