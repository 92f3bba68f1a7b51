"""Host-side distributed communication backend.

The reference's p2p stack (p2p/switch.go, connection.go,
secret_connection.go) is a custom TCP mesh: a Switch of Reactors over
multiplexed, prioritized, encrypted connections with PEX discovery. The
consensus overlay stays on the host: gossip is irregular, small-message,
latency-bound work; only the crypto batch plane rides the card, through
the Verifier and Hasher that reactors are handed. This package is therefore a clean-room,
threading-based Python implementation of the same capability surface, with
an in-memory pipe transport for deterministic in-process multi-node tests
(the net.Pipe() trick, p2p/switch.go:502-547).
"""

from tendermint_tpu_torch.p2p.conn import ChannelDescriptor, MConnection, MConnConfig
from tendermint_tpu_torch.p2p.netaddress import NetAddress
from tendermint_tpu_torch.p2p.node_info import NodeInfo
from tendermint_tpu_torch.p2p.peer import Peer, PeerConfig
from tendermint_tpu_torch.p2p.peer_set import PeerSet
from tendermint_tpu_torch.p2p.switch import (
    Reactor,
    Switch,
    connect2_switches,
    make_connected_switches,
)

__all__ = [
    "ChannelDescriptor",
    "MConnection",
    "MConnConfig",
    "NetAddress",
    "NodeInfo",
    "Peer",
    "PeerConfig",
    "PeerSet",
    "Reactor",
    "Switch",
    "connect2_switches",
    "make_connected_switches",
]
