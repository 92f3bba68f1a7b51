"""Route table (reference: rpc/core/routes.go:8-46)."""

from __future__ import annotations

from tendermint_tpu_torch.rpc.core.handlers import ROUTES_TABLE, UNSAFE_ROUTES_TABLE


def build_routes(unsafe: bool = False) -> dict:
    """method name -> (handler(ctx, **params), [param names])."""
    routes = dict(ROUTES_TABLE)
    if unsafe:
        routes.update(UNSAFE_ROUTES_TABLE)
    return routes
