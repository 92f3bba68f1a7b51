"""RPC method implementations (reference: rpc/core/*.go).

Every handler takes (ctx: RPCContext, **params) and returns a JSON-ready
dict. Byte params arrive hex-encoded; byte results leave hex-encoded
(uppercase, matching the codebase's canonical JSON style).
"""

from __future__ import annotations

import threading
import time

from tendermint_tpu_torch.mempool.mempool import (
    MempoolFullError,
    MempoolSourceLimitError,
    TxInCacheError,
)
from tendermint_tpu_torch.rpc import admission as _admission
from tendermint_tpu_torch.types import events as tev
from tendermint_tpu_torch.types.tx import tx_hash


class RPCError(Exception):
    pass


def _mempool_check_tx(ctx, tx, cb=None) -> None:
    """check_tx with typed shed mapping: mempool intake
    refusals become RPCError with STABLE reason strings (tx_in_cache /
    mempool_full / mempool_source_limit), not generic 500s. The request's
    client IP (rpc/admission thread-local) keys per-source accounting."""
    try:
        ctx.mempool.check_tx(tx, cb, source_id=_admission.request_source())
    except TxInCacheError as exc:
        raise RPCError(f"tx_in_cache: {exc}") from exc
    except (MempoolFullError, MempoolSourceLimitError) as exc:
        # str(exc) already leads with the stable reason string
        raise RPCError(str(exc)) from exc


def _deadline_wait(default_wait: float) -> float:
    """Bound a handler wait by the request's admission deadline budget."""
    left = _admission.deadline_remaining()
    if left is None:
        return default_wait
    return min(default_wait, max(0.0, left))


def _raise_deadline(ctx, what: str) -> None:
    admission_ctl = getattr(getattr(ctx, "node", None), "rpc_admission", None)
    if admission_ctl is not None:
        admission_ctl.shed(_admission.SHED_DEADLINE)
    raise RPCError(f"deadline_exceeded: {what}")


def _wait_or_deadline(ctx, event: threading.Event, default_wait: float,
                      what: str) -> None:
    """Wait bounded by min(handler default, deadline budget); expiry of
    the DEADLINE is a typed deadline_exceeded, of the handler's own
    timeout the pre-existing timed-out error."""
    wait = _deadline_wait(default_wait)
    if not event.wait(wait):
        if wait < default_wait:
            _raise_deadline(ctx, what)
        raise RPCError(f"timed out waiting for {what}")


def _hex(b: bytes) -> str:
    return b.hex().upper()


def _unhex(s) -> bytes:
    if isinstance(s, bytes):
        return s
    return bytes.fromhex(s)


# -- status / net_info (rpc/core/status.go, net_info.go) ----------------------


def status(ctx) -> dict:
    latest_height = ctx.block_store.height()
    latest_meta = ctx.block_store.load_block_meta(latest_height)
    latest_hash, latest_app_hash, latest_time = b"", b"", 0
    if latest_meta is not None:
        latest_hash = latest_meta.block_id.hash
        latest_app_hash = latest_meta.header.app_hash
        latest_time = latest_meta.header.time_ns
    info = ctx.switch.node_info if ctx.switch else None
    return {
        "node_info": info.to_json() if info else None,
        "pub_key": ctx.priv_validator.get_pub_key().to_json()
        if ctx.priv_validator
        else None,
        "latest_block_hash": _hex(latest_hash),
        "latest_app_hash": _hex(latest_app_hash),
        "latest_block_height": latest_height,
        # the store base — a client planning historical reads
        # learns the retained range without probing for errors
        "earliest_block_height": ctx.block_store.base(),
        "latest_block_time": latest_time,
    }


def net_info(ctx) -> dict:
    peers = []
    for peer in ctx.switch.peers.list():
        peers.append(
            {
                "node_info": peer.node_info.to_json() if peer.node_info else None,
                "is_outbound": peer.outbound,
                "connection_status": peer.status(),
            }
        )
    return {
        "listening": bool(ctx.switch.listeners),
        "listeners": [str(l.internal_address()) for l in ctx.switch.listeners],
        "peers": peers,
    }


def genesis(ctx) -> dict:
    return {"genesis": ctx.genesis_doc.to_json()}


# -- blockchain (rpc/core/blocks.go) ------------------------------------------


def blockchain_info(ctx, min_height: int = 0, max_height: int = 0) -> dict:
    """Block metas for [min_height, max_height], newest first. On a
    pruned/restored node the range CLAMPS to the store base:
    a request reaching below base returns the retained tail (possibly
    empty) plus the `base` so the client sees exactly what was clamped —
    it never errors mid-range for asking about history that was
    legitimately dropped. min > max in the CALLER's own numbers is still
    an error."""
    store_height = ctx.block_store.height()
    base = ctx.block_store.base()
    floor = max(1, base)
    if min_height and max_height and min_height > max_height:
        raise RPCError(f"min height {min_height} > max height {max_height}")
    max_height = min(store_height, max_height) if max_height else store_height
    min_height = max(floor, min_height) if min_height else max(floor, max_height - 20 + 1)
    metas = []
    for h in range(max_height, min_height - 1, -1):
        meta = ctx.block_store.load_block_meta(h)
        if meta is not None:
            metas.append(meta.to_json())
    return {"last_height": store_height, "base": base, "block_metas": metas}


def _check_pruned(ctx, height: int) -> None:
    """A store restored from a snapshot (or pruned) legitimately starts
    above height 1: queries below its base get a CLEAR error, never a
    None-decoding surprise (satellite)."""
    base = ctx.block_store.base()
    if height < base:
        raise RPCError(
            f"height {height} is below the store's base {base} "
            "(pruned or restored from a snapshot)"
        )


def block(ctx, height: int) -> dict:
    height = int(height)
    if height <= 0:
        raise RPCError("height must be greater than 0")
    if height > ctx.block_store.height():
        raise RPCError("height must be less than or equal to the head")
    _check_pruned(ctx, height)
    meta = ctx.block_store.load_block_meta(height)
    blk = ctx.block_store.load_block(height)
    return {
        "block_meta": meta.to_json() if meta else None,
        "block": blk.to_json() if blk else None,
    }


def commit(ctx, height: int) -> dict:
    height = int(height)
    store_height = ctx.block_store.height()
    if height <= 0:
        raise RPCError("height must be greater than 0")
    if height > store_height:
        raise RPCError("height must be less than or equal to the head")
    _check_pruned(ctx, height)
    meta = ctx.block_store.load_block_meta(height)
    if meta is None:  # pruned or mid-write height inside the valid range
        raise RPCError(f"no block meta for height {height}")
    header = meta.header
    if height == store_height:
        cmt = ctx.block_store.load_seen_commit(height)
        canonical = False
    else:
        cmt = ctx.block_store.load_block_commit(height)
        canonical = True
    return {
        "header": header.to_json(),
        "commit": cmt.to_json() if cmt else None,
        "canonical_commit": canonical,
    }


def validators(ctx, height: int = 0) -> dict:
    """Current validator set, or — with `height` — the historical set
    that signed at that height (per-height history via the state's
    last-changed pointers; state/state.go:162-194). The historical form
    is what a light client pairs with /commit to verify old headers
    (docs/specification/light-client-protocol.md)."""
    height = int(height)
    if height > 0:
        if ctx.state is None:
            raise RPCError("historical validator sets unavailable")
        try:
            vs = ctx.state.load_validators(height)
        except Exception as exc:
            raise RPCError(f"no validator set for height {height}: {exc}")
        return {"block_height": height, "validators": vs.to_json()}
    rs = ctx.consensus_state.get_round_state()
    return {
        "block_height": rs.height - 1,
        "validators": rs.validators.to_json() if rs.validators else None,
    }


def dump_consensus_state(ctx) -> dict:
    rs = ctx.consensus_state.get_round_state()
    peer_states = {}
    for peer in ctx.switch.peers.list():
        ps = peer.get("ConsensusReactor.peerState")
        if ps is not None:
            prs = ps.get_round_state()
            peer_states[peer.id()] = {
                "height": prs.height,
                "round": prs.round_,
                "step": prs.step,
                "proposal": prs.proposal,
            }
    return {"round_state": rs.to_json(), "peer_round_states": peer_states}


# -- mempool (rpc/core/mempool.go) --------------------------------------------


def broadcast_tx_async(ctx, tx) -> dict:
    tx = _unhex(tx)
    _mempool_check_tx(ctx, tx)
    return {"hash": _hex(tx_hash(tx)), "code": 0, "data": "", "log": ""}


def broadcast_tx_sync(ctx, tx) -> dict:
    """Waits for the CheckTx response (rpc/core/mempool.go:47-77)."""
    tx = _unhex(tx)
    done = threading.Event()
    box = {}

    def cb(res):
        box["res"] = res
        done.set()

    _mempool_check_tx(ctx, tx, cb)
    _wait_or_deadline(ctx, done, 10.0, "CheckTx")
    res = box["res"]
    return {
        "code": res.code,
        "data": _hex(res.data or b""),
        "log": res.log,
        "hash": _hex(tx_hash(tx)),
    }


def broadcast_tx_commit(ctx, tx, timeout: float = 60.0) -> dict:
    """CheckTx, then wait for the tx to be committed in a block
    (rpc/core/mempool.go:149-230; 60s cap)."""
    tx = _unhex(tx)
    committed = threading.Event()
    box = {}

    listener_id = f"rpc-tx-{_hex(tx_hash(tx))[:16]}-{time.monotonic_ns()}"
    event = tev.event_string_tx(tx_hash(tx))

    def on_tx(data):
        box["deliver"] = data
        committed.set()

    ctx.event_switch.add_listener_for_event(listener_id, event, on_tx)
    try:
        check_done = threading.Event()

        def cb(res):
            box["check"] = res
            check_done.set()

        _mempool_check_tx(ctx, tx, cb)
        _wait_or_deadline(ctx, check_done, 10.0, "CheckTx")
        check = box["check"]
        check_json = {
            "code": check.code,
            "data": _hex(check.data or b""),
            "log": check.log,
        }
        if check.code != 0:
            return {
                "check_tx": check_json,
                "deliver_tx": None,
                "hash": _hex(tx_hash(tx)),
                "height": 0,
            }
        _wait_or_deadline(ctx, committed, float(timeout),
                          "tx to be committed")
        d = box["deliver"]
        return {
            "check_tx": check_json,
            "deliver_tx": {"code": d.code, "data": _hex(d.data or b""), "log": d.log},
            "hash": _hex(tx_hash(tx)),
            "height": d.height,
        }
    finally:
        ctx.event_switch.remove_listener(listener_id)


def unconfirmed_txs(ctx) -> dict:
    txs = ctx.mempool.reap(-1) if hasattr(ctx.mempool, "reap") else []
    return {"n_txs": len(txs), "txs": [_hex(t) for t in txs]}


def num_unconfirmed_txs(ctx) -> dict:
    return {"n_txs": ctx.mempool.size(), "txs": None}


# -- tx lookup with proof (rpc/core/tx.go) ------------------------------------


def tx(ctx, hash, prove: bool = False) -> dict:
    h = _unhex(hash)
    res = ctx.tx_indexer.get(h)
    if res is None:
        raise RPCError(f"tx ({_hex(h)}) not found")
    out = {
        "height": res.height,
        "index": res.index,
        "tx_result": {
            "code": res.result.code,
            "data": _hex(res.result.data or b""),
            "log": res.result.log,
        },
        "tx": _hex(bytes(res.tx)),
    }
    if prove:
        from tendermint_tpu_torch.types.tx import txs_proof

        # the proof needs the block itself; on a pruned store the index
        # may outlive the block — clear error, not a crash
        _check_pruned(ctx, res.height)
        blk = ctx.block_store.load_block(res.height)
        if blk is None:
            raise RPCError(f"no block at height {res.height} for tx proof")
        proof = txs_proof(blk.data.txs, res.index)
        out["proof"] = proof.to_json()
    return out


# -- abci passthrough (rpc/core/abci.go) --------------------------------------


def abci_query(ctx, data=b"", path: str = "", height: int = 0, prove: bool = False) -> dict:
    res = ctx.proxy_app_query.query_sync(
        data=_unhex(data) if data else b"", path=path, height=int(height),
        prove=bool(prove),
    )
    return {
        "response": {
            "code": res.code,
            "index": getattr(res, "index", 0),
            "key": _hex(getattr(res, "key", b"") or b""),
            "value": _hex(res.value or b""),
            # the app's state-tree proof (hex of the JSON
            # TreeProof — merkle/statetree_proof.py) and the height it
            # proves at; rpc/light.verified_query checks it against the
            # light-verified header (height+1)'s app_hash
            "proof": _hex(getattr(res, "proof", b"") or b""),
            "log": res.log,
            "height": getattr(res, "height", 0),
        }
    }


def abci_info(ctx) -> dict:
    res = ctx.proxy_app_query.info_sync()
    return {
        "response": {
            "data": res.data,
            "version": getattr(res, "version", ""),
            "last_block_height": res.last_block_height,
            "last_block_app_hash": _hex(res.last_block_app_hash or b""),
        }
    }


# -- unsafe (rpc/core/net.go, dev.go, mempool.go) -----------------------------


def snapshots(ctx) -> dict:
    """State-sync discovery over RPC: the node's locally held
    snapshots in manifest-lite form, newest first — what an operator (or
    an out-of-band bootstrapper) reads before pointing a fresh node's
    statesync at this one. docs/state-sync.md."""
    node = ctx.node
    store = getattr(node, "snapshot_store", None)
    if store is None:
        return {"snapshots": []}
    out = []
    for h in reversed(store.heights()):
        m = store.load_manifest(h)
        if m is not None:
            out.append(m.lite())
    return {"snapshots": out}


def unsafe_dial_seeds(ctx, seeds) -> dict:
    if isinstance(seeds, str):
        seeds = [s for s in seeds.split(",") if s]
    if not seeds:
        raise RPCError("no seeds provided")
    ctx.switch.dial_seeds(list(seeds))
    return {"log": "dialing seeds in rounds"}


def metrics(ctx) -> dict:
    """Flat numeric snapshot of node health — consensus position, mempool
    depth, peer counts, fast-sync progress, and the gateway counters
    (tpu_sigs moving is how an operator confirms the device path is live).
    Beyond-reference observability: the reference declares a go-metrics
    dep it never wires (SURVEY.md §5); here the node exports one.

    The dict is rendered FROM the node's telemetry registry
    (node/telemetry.py holds the canonical <plane>_<name> wiring; the
    same registry serves Prometheus text on GET /metrics). Byte-
    compatible with the pre-registry handler: same flat key set, same
    values. The wiring is DIRECT — a renamed attribute fails loudly here
    instead of silently dropping a gauge (the loud-wiring convention; the old
    handler's getattr(..., 0.0) defaults and setdefault collision
    handling are gone)."""
    return ctx.node.telemetry.flatten()


def consensus_trace(ctx, last: int = 10) -> dict:
    """The last `last` committed heights' wall-time traces, newest
    first: step-partitioned segments (propose -> prevote-wait ->
    precommit-wait -> commit -> apply -> snapshot-hook), overlapping
    aux attributions (part hashing), and the height's device-vs-CPU
    verify/hash split with breaker state (consensus/trace.py). Operator
    CLI: python -m tendermint_tpu_torch.ops.trace."""
    rec = ctx.consensus_state.trace
    return {"traces": [t.to_json() for t in rec.last(int(last))]}


def tx_trace(ctx, hash="", last: int = 20) -> dict:
    """Sampled tx-lifecycle traces (libs/txtrace.py): the
    completed ring (newest first) PLUS the in-flight actives — a
    partition-parked tx is visible mid-flight with its stages frozen at
    wherever it stalled. `hash` filters both lists to one tx (the
    cross-node causal id ops/txtrace joins on)."""
    node = getattr(ctx, "node", None)
    rec = getattr(node, "txtrace", None)
    if rec is None:
        return {"traces": [], "active": []}
    traces = rec.last(int(last))
    active = rec.active()
    if hash:
        want = str(hash).upper()
        traces = [t for t in traces if t["hash"] == want]
        active = [t for t in active if t["hash"] == want]
    return {"traces": traces, "active": active}


def unsafe_flush_mempool(ctx) -> dict:
    ctx.mempool.flush()
    return {}


# -- profiler API (rpc/core/routes.go:42-45): the pprof equivalents are
# cProfile for CPU and tracemalloc for heap ----------------------------------

_profiler_state: dict = {"profiler": None}


def unsafe_start_cpu_profiler(ctx, filename) -> dict:
    import cProfile

    if _profiler_state["profiler"] is not None:
        raise RPCError("cpu profiler already running")
    prof = cProfile.Profile()
    prof.enable()
    _profiler_state["profiler"] = (prof, str(filename))
    return {}


def unsafe_stop_cpu_profiler(ctx) -> dict:
    entry = _profiler_state["profiler"]
    if entry is None:
        raise RPCError("cpu profiler not running")
    prof, filename = entry
    prof.disable()
    prof.dump_stats(filename)
    _profiler_state["profiler"] = None
    return {"log": f"profile written to {filename}"}


def unsafe_write_heap_profile(ctx, filename) -> dict:
    import tracemalloc

    started_here = not tracemalloc.is_tracing()
    if started_here:
        # no baseline was running: a point-in-time snapshot still captures
        # allocations made from here on; start tracing for next time
        tracemalloc.start()
    snap = tracemalloc.take_snapshot()
    with open(str(filename), "w") as f:
        for stat in snap.statistics("lineno")[:200]:
            f.write(f"{stat}\n")
    return {"log": f"heap profile written to {filename}"}


def evidence(ctx) -> dict:
    """Recorded duplicate-vote evidence (beyond reference: v0.11 detects
    conflicts and punts, consensus/state.go:1438-1447 — this surfaces
    what the node's pool has validated; types/evidence.py)."""
    pool = getattr(ctx.consensus_state, "evidence_pool", None)
    evs = pool.list() if pool is not None else []
    return {"count": len(evs), "evidence": [e.to_json() for e in evs]}


ROUTES_TABLE = {
    # info API
    "status": (status, []),
    "net_info": (net_info, []),
    "genesis": (genesis, []),
    "blockchain": (blockchain_info, ["min_height", "max_height"]),
    "block": (block, ["height"]),
    "commit": (commit, ["height"]),
    "validators": (validators, ["height"]),
    "dump_consensus_state": (dump_consensus_state, []),
    "evidence": (evidence, []),
    "snapshots": (snapshots, []),
    "metrics": (metrics, []),
    "consensus_trace": (consensus_trace, ["last"]),
    "tx_trace": (tx_trace, ["hash", "last"]),
    "tx": (tx, ["hash", "prove"]),
    "unconfirmed_txs": (unconfirmed_txs, []),
    "num_unconfirmed_txs": (num_unconfirmed_txs, []),
    # tx broadcast
    "broadcast_tx_async": (broadcast_tx_async, ["tx"]),
    "broadcast_tx_sync": (broadcast_tx_sync, ["tx"]),
    "broadcast_tx_commit": (broadcast_tx_commit, ["tx"]),
    # abci
    "abci_query": (abci_query, ["data", "path", "height", "prove"]),
    "abci_info": (abci_info, []),
}

UNSAFE_ROUTES_TABLE = {
    "unsafe_dial_seeds": (unsafe_dial_seeds, ["seeds"]),
    "unsafe_flush_mempool": (unsafe_flush_mempool, []),
    # profiler API (rpc/core/routes.go:42-45)
    "unsafe_start_cpu_profiler": (unsafe_start_cpu_profiler, ["filename"]),
    "unsafe_stop_cpu_profiler": (unsafe_stop_cpu_profiler, []),
    "unsafe_write_heap_profile": (unsafe_write_heap_profile, ["filename"]),
}
