"""Verified read-replica tier (docs/serving.md § Read replicas):
stateless proof-carrying replicas that scale the read RPC
surface horizontally while clients keep verifying every byte against
validator-signed headers."""

from tendermint_tpu_torch.replica.cache import ProofCache
from tendermint_tpu_torch.replica.daemon import ReplicaDaemon

__all__ = ["ProofCache", "ReplicaDaemon"]
