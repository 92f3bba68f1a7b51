"""Replica route table: the read-only RPC surface, served
off the daemon's verified state.

Same wire methods, param names, and response shapes as the node's
rpc/core/handlers.py — a light client (or another replica) pointed at a
replica cannot tell the difference until it asks for something outside
the replica's verified window, where it gets a typed error plus a
/status ``earliest_block_height`` to horizon-jump from. The ctx is an
ordinary RPCContext whose ``node`` is the ReplicaDaemon, so the shared
server machinery (admission, /metrics, /health, /websocket) works
unchanged.
"""

from __future__ import annotations


def status(ctx) -> dict:
    return ctx.node.status_view()


def genesis(ctx) -> dict:
    return ctx.node.genesis_view()


def commit(ctx, height: int) -> dict:
    return ctx.node.commit_view(height)


def validators(ctx, height: int = 0) -> dict:
    return ctx.node.validators_view(height)


def block(ctx, height: int) -> dict:
    return ctx.node.block_view(height)


def blockchain_info(ctx, min_height: int = 0, max_height: int = 0) -> dict:
    return ctx.node.blockchain_view(min_height, max_height)


def abci_query(ctx, data=b"", path: str = "", height: int = 0,
               prove: bool = False) -> dict:
    return ctx.node.query(data=data, path=path, height=height, prove=prove)


def metrics(ctx) -> dict:
    return ctx.node.telemetry.flatten()


REPLICA_ROUTES = {
    "status": (status, []),
    "genesis": (genesis, []),
    "commit": (commit, ["height"]),
    "validators": (validators, ["height"]),
    "block": (block, ["height"]),
    "blockchain": (blockchain_info, ["min_height", "max_height"]),
    "abci_query": (abci_query, ["data", "path", "height", "prove"]),
    "metrics": (metrics, []),
}
