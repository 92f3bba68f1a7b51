"""State-sync snapshot subsystem.

A fresh node used to have exactly one way in: fast-sync every block from
genesis and re-execute it — an O(chain-length) cold start. This package
gives it a second one: restore a chunked, Merkle-rooted snapshot of app
state + block-store tail taken at a recent height, verify it against the
light-client header chain, and fast-sync only the tail.

Layout:
- snapshot.py  — manifest + chunking + the CRC-framed on-disk store
- producer.py  — exports snapshots at configured height intervals
- restore.py   — verify (light client + batched chunk digests) and apply
- reactor.py   — the p2p serving/fetching reactor + restore driver
- devchain.py  — deterministic single-validator chain builder (tests,
                 benches, dev seeding)

docs/state-sync.md has the wire format, manifest layout, trust model and
failure modes.
"""

from tendermint_tpu_torch.statesync.snapshot import (  # noqa: F401
    Manifest,
    SnapshotError,
    SnapshotStore,
    chunk_payload,
)
from tendermint_tpu_torch.statesync.producer import SnapshotProducer  # noqa: F401
from tendermint_tpu_torch.statesync.restore import Restorer, RestoreError  # noqa: F401
