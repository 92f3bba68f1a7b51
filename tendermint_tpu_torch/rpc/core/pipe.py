"""Dependency container for RPC handlers (reference: rpc/core/pipe.go).

The reference injects node internals into package globals
(pipe.go:36-116); here they travel in one explicit context object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class RPCContext:
    event_switch: Any = None
    block_store: Any = None
    consensus_state: Any = None
    mempool: Any = None
    switch: Any = None
    proxy_app_query: Any = None
    genesis_doc: Any = None
    priv_validator: Any = None
    tx_indexer: Any = None
    state: Any = None  # for historical validator-set lookups
    node: Any = None
