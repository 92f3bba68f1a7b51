"""Debug introspection payloads: GET /debug/{flight,stacks,
queues} on the RPC listener (rpc/server.py dispatches here).

These are the live-triage reads for a node that has stopped answering
anything clever — a wedged consensus thread still leaves the RPC
listener (its own threads) serving these:

- ``flight``  the black-box event ring (node/flightrec.py) — what
              happened in the recent past
- ``stacks``  every thread's current stack via sys._current_frames —
              WHERE a wedge is parked right now
- ``queues``  p2p channel queue depths, the consensus input queues,
              the ApplyExecutor backlog, mempool depth, sig-gate
              backlog, vote-batcher counters — what is backed up

Every section is best-effort: a subsystem mid-teardown (or a bare mock
context without a node) yields a partial payload, never a 500 — this
surface exists precisely for nodes in a bad state.
"""

from __future__ import annotations

import sys
import threading
import traceback


def debug_payload(what: str, node) -> dict:
    if what == "flight":
        return _flight(node)
    if what == "stacks":
        return _stacks()
    if what == "queues":
        return _queues(node)
    raise KeyError(what)


def _flight(node) -> dict:
    rec = getattr(node, "flightrec", None)
    if rec is None:
        return {"enabled": False, "events": [],
                "note": "no flight recorder in RPC context"}
    return {
        "enabled": rec.enabled,
        "recorded_total": rec.recorded,
        "ring_size": rec._ring.maxlen,
        "dumps": rec.dumps,
        "dump_dir": rec.dump_dir,
        "events": rec.events(),
    }


def _stacks() -> dict:
    """All-thread stack dump. Names come from threading.enumerate();
    frames from sys._current_frames() — a thread racing its own exit
    may appear in one and not the other, which is fine for triage."""
    names = {t.ident: t for t in threading.enumerate()}
    threads = []
    for ident, frame in sorted(sys._current_frames().items()):
        t = names.get(ident)
        threads.append({
            "ident": ident,
            "name": t.name if t is not None else "?",
            "daemon": bool(t.daemon) if t is not None else None,
            "stack": [
                f"{fs.filename}:{fs.lineno} {fs.name}: {fs.line or ''}"
                for fs in traceback.extract_stack(frame)
            ],
        })
    return {"count": len(threads), "threads": threads}


def _queues(node) -> dict:
    out: dict = {}
    if node is None:
        return {"note": "no node in RPC context"}

    def section(name, fn):
        try:
            out[name] = fn()
        except Exception as exc:  # noqa: BLE001 — partial > broken
            out[name] = {"error": f"{type(exc).__name__}: {exc}"}

    cs = getattr(node, "consensus_state", None)
    if cs is not None:
        section("consensus", lambda: {
            "inputs": cs._inputs.qsize(),
            "peer_msgs": cs.peer_msg_queue.qsize(),
            "internal_msgs": cs.internal_msg_queue.qsize(),
            "peer_msg_drops": cs.peer_msg_drops,
            "height": cs.rs.height,
            "round": cs.rs.round_,
            "step": int(cs.rs.step),
        })
        section("pipeline", lambda: {
            "executor_backlog": (
                len(cs._apply_executor._queue)
                if cs._apply_executor is not None else 0
            ),
            "pending_apply_height": (
                cs._pending_apply.height
                if cs._pending_apply is not None else None
            ),
            "poisoned": cs.pipeline_poisoned(),
        })
        section("vote_batcher", lambda: {
            "batches": cs.vote_batcher.batches,
            "batched_sigs": cs.vote_batcher.batched_sigs,
            "singletons": cs.vote_batcher.singletons,
            "duplicates": cs.vote_duplicates,
        })
    mp = getattr(node, "mempool", None)
    if mp is not None:
        def mempool_section():
            row = {"size": mp.size()}
            batcher = mp.sig_batcher
            if batcher is not None:
                with batcher._cv:
                    row["sig_gate_backlog"] = len(batcher._buf)
                row["sig_gate_dropped"] = batcher.dropped
            return row

        section("mempool", mempool_section)
    sw = getattr(node, "sw", None)
    if sw is not None:
        def p2p_section():
            peers = {}
            for peer in sw.peers.list():
                try:
                    peers[peer.id()] = {
                        ch_label: depth
                        for ch_label, depth in
                        peer.mconn.status()["channels"].items()
                    }
                except Exception:  # noqa: BLE001 — peer mid-teardown
                    peers[peer.id()] = {"error": "unavailable"}
            return {"peers": peers, "count": sw.peers.size()}

        section("p2p", p2p_section)
    return out
