"""The batching gateway: where the host commit path meets the card.

The reference verifies signatures one at a time at three call sites
(types/vote_set.go:175, types/validator_set.go:247,
blockchain/reactor.go:235). Here those sites call a Verifier, which
decides per batch whether the device kernel or the CPU runs, with
identical accept/reject semantics:

- batches below `min_tpu_batch` (env TENDERMINT_TPU_MIN_BATCH, default 32)
  run on the CPU: single votes stay on the host, where a launch and a
  marshal cost more than they save;
- wider batches run on the verifier's device: the CUDA kernel
  (ops.ed25519_f32p) on the card, or its plain version for
  `device="cpu"`.

Unlike the JAX gateway, a kernel failure is never caught: there is no
latch to the CPU and no retry. The stats keep the JAX key names
(`tpu_batches`, `tpu_sigs`, `cpu_sigs`, ...), where "tpu" now means the
device route, so callers read them unchanged.
"""

from __future__ import annotations

import logging
import os
import threading

from tendermint_tpu_torch import native
from tendermint_tpu_torch.crypto.keys import verify_any
from tendermint_tpu_torch.ops import ed25519_f32p, resolve_device

logger = logging.getLogger("tendermint_tpu_torch.ops.gateway")

Item = tuple[bytes, bytes, bytes]  # (pubkey, message, signature)


def _cpu_verify_batch(items: list[Item]) -> list[bool]:
    """CPU path: wide all-ed25519 batches ride the native C++ batch
    verifier (one ctypes call, strict RFC 8032 semantics identical to
    crypto.ed25519.verify); everything else verifies per item."""
    if len(items) >= 16 and all(len(it[0]) == 32 and len(it[2]) == 64 for it in items):
        # ready(), not available(): a batch never waits behind a C++ build
        if native.ready():
            return native.ed25519_verify_batch(items)
    return [verify_any(pk, msg, sig) for pk, msg, sig in items]


def _split_by_key_type(items: list[Item]):
    """(ed25519 items, their positions, other items, their positions).
    The kernel is ed25519-only; anything else verifies on the CPU."""
    ed_items, ed_pos, other_items, other_pos = [], [], [], []
    for i, it in enumerate(items):
        if len(it[0]) == 32 and len(it[2]) == 64:
            ed_items.append(it)
            ed_pos.append(i)
        else:
            other_items.append(it)
            other_pos.append(i)
    return ed_items, ed_pos, other_items, other_pos


def _min_batch_from_env() -> int:
    raw = os.environ.get("TENDERMINT_TPU_MIN_BATCH", "")
    try:
        return int(raw) if raw else 32
    except ValueError:
        logger.warning("TENDERMINT_TPU_MIN_BATCH=%r is not an integer; using 32", raw)
        return 32


class Verifier:
    """Batch signature verifier on the card (or, for `device="cpu"`, the
    kernel's plain version), with the CPU below the size gate."""

    def __init__(self, min_tpu_batch: int | None = None, device=None):
        self.device = resolve_device(device)
        self.min_tpu_batch = _min_batch_from_env() if min_tpu_batch is None else min_tpu_batch
        self._mtx = threading.Lock()
        self._stats = {
            "tpu_batches": 0, "tpu_sigs": 0, "cpu_sigs": 0,
            # aggregate-commit lanes: zero until verify_aggregate is ported
            "agg_batches": 0, "agg_lanes_device": 0, "agg_lanes_cpu": 0,
        }
        # verify-ahead verdicts for the live vote path, popped single-use
        # by verify_one; unconsumed entries age out FIFO
        self._primed: dict[Item, bool] = {}
        self._primed_cap = 1 << 14

    def _count(self, key: str, n: int) -> None:
        with self._mtx:
            self._stats[key] += n

    def _device_batch(self, n: int) -> None:
        with self._mtx:
            self._stats["tpu_batches"] += 1
            self._stats["tpu_sigs"] += n

    # -- core API ----------------------------------------------------------

    def verify_batch(self, items: list[Item]) -> list[bool]:
        return self.verify_batch_async(items)()

    def verify_batch_async(self, items: list[Item]):
        """Marshal + launch the device kernel now; return a zero-arg
        resolver for list[bool]. Host work on the next batch overlaps the
        device's work on this one. Below the size gate the result is
        computed on the CPU now and the resolver just returns it."""
        n = len(items)
        if n == 0:
            return lambda: []
        ed_items, ed_pos, other_items, other_pos = _split_by_key_type(items)
        if other_items:
            inner = self.verify_batch_async(ed_items) if ed_items else (lambda: [])
            others = _cpu_verify_batch(other_items)
            self._count("cpu_sigs", len(other_items))

            def resolve_mixed():
                out: list = [None] * n
                for p, ok in zip(ed_pos, inner()):
                    out[p] = ok
                for p, ok in zip(other_pos, others):
                    out[p] = ok
                return out

            return resolve_mixed
        if n < self.min_tpu_batch:
            self._count("cpu_sigs", n)
            res = _cpu_verify_batch(items)
            return lambda: res
        kernel_resolve = ed25519_f32p.verify_batch_async(items, self.device)
        self._device_batch(n)
        return lambda: [bool(b) for b in kernel_resolve()]

    def pop_primed(self, item: Item) -> bool | None:
        """Pop (single-use) the primed verdict for one item, or None if it
        was never primed or has aged out."""
        with self._mtx:
            return self._primed.pop(item, None)

    def verify_one(self, pubkey: bytes, msg: bytes, sig: bytes) -> bool:
        """Single-signature path (vote-by-vote arrival): a verdict primed
        by prime_cache is consumed without re-verifying; otherwise the CPU
        verifies it — latency over throughput."""
        primed = self.pop_primed((pubkey, msg, sig))
        if primed is not None:
            return primed
        self._count("cpu_sigs", 1)
        return verify_any(pubkey, msg, sig)

    def prime_cache(self, items: list[Item]) -> None:
        """Batch-verify now and stash per-item verdicts for imminent
        verify_one calls, so a burst of gossiped votes rides the kernel
        while VoteSet keeps its one-vote-at-a-time semantics."""
        if not items:
            return
        oks = self.verify_batch(items)
        with self._mtx:
            for it, ok in zip(items, oks):
                self._primed[it] = bool(ok)
            while len(self._primed) > self._primed_cap:
                self._primed.pop(next(iter(self._primed)))

    def stats(self) -> dict:
        with self._mtx:
            return dict(self._stats)

    # -- adapters for the call sites --------------------------------------

    def commit_batch_verifier(self):
        """For ValidatorSet.verify_commit(batch_verifier=...)."""
        return self.verify_batch

    def vote_verifier(self):
        """For VoteSet.add_vote(verifier=...)."""
        return self.verify_one
