"""The batching gateway: where the host commit path meets the card.

The reference verifies signatures one at a time at three call sites
(types/vote_set.go:175, types/validator_set.go:247,
blockchain/reactor.go:235). Here those sites call a Verifier, which
decides per batch whether the device kernel or the CPU runs, with
identical accept/reject semantics:

- batches below `min_tpu_batch` (env TENDERMINT_TPU_MIN_BATCH, default 32)
  run on the CPU: single votes stay on the host, where a launch and a
  marshal cost more than they save;
- wider batches run on the verifier's device: a CUDA kernel on the card,
  or its plain version for `device="cpu"`. The kernel comes from the
  registry `KERNELS` by the JAX package's env knob TENDERMINT_TPU_KERNEL,
  read once per Verifier: `f32p` (B1, the default), `pallas` (B2), `comb`
  (B4, the per-validator comb tables), or the torch compositions `f32`
  (B3) and `int32` (B5's verify).

`ShardedVerifier` splits each device batch over a mesh of devices: under
`f32p` one launch of B1 per shard on its own device and stream (B1', the
counterpart of the JAX package's shard_map over the f32p ladder), under
`f32` B3's `verify_plain` per shard (the JAX package's pjit backend).

Aggregate commits verify as one half-aggregate equation
(`verify_aggregate`): its n + 1 dual scalar multiplications run in the
dsm kernel (`ops.ed25519.dsm_batch`) at or above the same size gate, and
on the pure-Python reference below it.

Unlike the JAX gateway, a kernel failure is never caught: there is no
latch to the CPU and no retry, and a verify-ahead batch that fails
re-raises where its verdict is read. The stats keep the JAX key names
(`tpu_batches`, `tpu_sigs`, `cpu_sigs`, ...), where "tpu" now means the
device route, so callers read them unchanged.
"""

from __future__ import annotations

import importlib
import logging
import os
import threading
import time

from tendermint_tpu_torch import native
from tendermint_tpu_torch.crypto import ed25519_agg
from tendermint_tpu_torch.crypto.keys import verify_any
from tendermint_tpu_torch.ops import ed25519, ed25519_f32, ed25519_f32p, resolve_device

logger = logging.getLogger("tendermint_tpu_torch.ops.gateway")

Item = tuple[bytes, bytes, bytes]  # (pubkey, message, signature)


def _ed25519_lane(it: Item) -> bool:
    """An item the ed25519 kernels take: a 32-byte key and a 64-byte
    signature (a secp256k1 key has 33 bytes; anything else is malformed
    and verifies as False on the CPU)."""
    return len(it[0]) == 32 and len(it[2]) == 64


def _cpu_verify_batch(items: list[Item]) -> list[bool]:
    """CPU path: wide all-ed25519 batches ride the native C++ batch
    verifier (one ctypes call, strict RFC 8032 semantics identical to
    crypto.ed25519.verify); everything else verifies per item."""
    if len(items) >= 16 and all(_ed25519_lane(it) for it in items):
        # ready(), not available(): a batch never waits behind a C++ build
        if native.ready():
            return native.ed25519_verify_batch(items)
    return [verify_any(pk, msg, sig) for pk, msg, sig in items]


def _split_by_key_type(items: list[Item]):
    """(ed25519 items, their positions, other items, their positions).
    The kernel is ed25519-only; anything else verifies on the CPU."""
    ed_items, ed_pos, other_items, other_pos = [], [], [], []
    for i, it in enumerate(items):
        if _ed25519_lane(it):
            ed_items.append(it)
            ed_pos.append(i)
        else:
            other_items.append(it)
            other_pos.append(i)
    return ed_items, ed_pos, other_items, other_pos


# The port's verify kernels by their JAX registry names. Each module has
# verify_batch(items, device) -> bool[n] with identical accept/reject
# semantics; f32p, f32 and comb also pipeline (verify_batch_async).
KERNELS = {
    "comb": "tendermint_tpu_torch.ops.ed25519_comb",
    "f32": "tendermint_tpu_torch.ops.ed25519_f32",
    "f32p": "tendermint_tpu_torch.ops.ed25519_f32p",
    "int32": "tendermint_tpu_torch.ops.ed25519",
    "pallas": "tendermint_tpu_torch.ops.ed25519_pallas",
}
# names the JAX package's registry has and the port does not yet
_NOT_PORTED = ("devd",)


def kernel_name(accepted=None, refusal=None) -> str:
    """Validated TENDERMINT_TPU_KERNEL; empty means "f32p". Raises on a
    name the port lacks, so a typo or a JAX-only choice fails at startup
    instead of running another kernel. A caller that takes only some
    names passes them as `accepted`, and `refusal(name)`, the message
    for any other."""
    name = os.environ.get("TENDERMINT_TPU_KERNEL", "") or "f32p"
    if accepted is not None and name not in accepted:
        raise ValueError(refusal(name))
    if name in _NOT_PORTED:
        raise ValueError(
            f"TENDERMINT_TPU_KERNEL={name!r} is a kernel of the JAX package "
            f"that is not ported; the port has {sorted(KERNELS)}"
        )
    if name not in KERNELS:
        raise ValueError(
            f"TENDERMINT_TPU_KERNEL={name!r}: expected one of {sorted(KERNELS)}"
        )
    return name


def _min_batch_from_env() -> int:
    raw = os.environ.get("TENDERMINT_TPU_MIN_BATCH", "")
    try:
        return int(raw) if raw else 32
    except ValueError:
        logger.warning("TENDERMINT_TPU_MIN_BATCH=%r is not an integer; using 32", raw)
        return 32


class _PendingBatch:
    """An in-flight prime_cache_async dispatch. Each primed item maps to
    the shared handle; a background thread materializes the verdicts the
    moment the device answers, so the batch is drained even when no
    verify_one ever pops an item. `on_done(dt_s)` fires once on success
    with the dispatch-to-verdicts wall time.

    Unlike the JAX gateway's handle, a failed resolve is not turned into
    "not primed" (which would re-verify on the CPU): the exception is kept
    and re-raised by every result_for."""

    __slots__ = ("_done", "_error", "_event")

    def __init__(self, items: list[Item], resolve, on_done=None):
        self._done: dict[Item, bool] = {}
        self._error: Exception | None = None
        self._event = threading.Event()
        t0 = time.monotonic()

        def materialize() -> None:
            try:
                self._done.update((it, bool(ok)) for it, ok in zip(items, resolve()))
                if on_done is not None:
                    on_done(time.monotonic() - t0)
            except Exception as exc:  # kept for result_for, which re-raises
                self._error = exc
            finally:
                self._event.set()

        threading.Thread(target=materialize, daemon=True, name="gateway-prime").start()

    def result_for(self, item: Item) -> bool | None:
        """The primed verdict (None if the item was not in the batch);
        re-raises the batch's failure."""
        self._event.wait()
        if self._error is not None:
            raise self._error
        return self._done.get(item)


class Verifier:
    """Batch signature verifier on the card (or, for `device="cpu"`, the
    kernel's plain version), with the CPU below the size gate."""

    def __init__(self, min_tpu_batch: int | None = None, device=None):
        self.device = resolve_device(device)
        self.min_tpu_batch = _min_batch_from_env() if min_tpu_batch is None else min_tpu_batch
        # resolved once: a typo fails here, and the kernel cannot change
        # under a live node
        self._kernel = kernel_name()
        self._module = importlib.import_module(KERNELS[self._kernel])
        self._mtx = threading.Lock()
        self._stats = {
            "tpu_batches": 0, "tpu_sigs": 0, "cpu_sigs": 0,
            # aggregate-commit verify lanes: dsm kernel vs the pure-Python
            # reference below the size gate
            "agg_batches": 0, "agg_lanes_device": 0, "agg_lanes_cpu": 0,
        }
        # verify-ahead verdicts for the live vote path, popped single-use
        # by verify_one (a _PendingBatch until its batch resolves);
        # unconsumed entries age out FIFO
        self._primed: dict[Item, bool | _PendingBatch] = {}
        self._primed_cap = 1 << 14

    @property
    def kernel(self) -> str:
        """The registry name of the verify kernel this verifier runs."""
        return self._kernel

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
        if not hasattr(self._module, "verify_batch_async"):
            # B2 and int32, like their JAX modules, verify synchronously
            # under the same contract
            res_now = [bool(b) for b in self._module.verify_batch(items, self.device)]
            self._device_batch(n)
            return lambda: res_now
        kernel_resolve = self._module.verify_batch_async(items, self.device)
        self._device_batch(n)
        return lambda: [bool(b) for b in kernel_resolve()]

    def verify_aggregate(self, pubs: list[bytes], msgs: list[bytes],
                         rs: list[bytes], s_agg: bytes) -> bool:
        """Half-aggregate verify (the crypto.ed25519_agg equation) with its
        n + 1 dual-scalar-mul lanes in one dsm launch on the verifier's
        device. Below `min_tpu_batch` lanes the pure-Python reference runs
        instead: the size gate, as for signatures. Semantics identical to
        ed25519_agg.verify_aggregate."""
        terms = ed25519_agg.aggregate_terms(pubs, msgs, rs, s_agg)
        if terms is None:
            return False
        n = len(terms)
        if n < self.min_tpu_batch:
            self._count("agg_lanes_cpu", n)
            return ed25519_agg.verify_aggregate(pubs, msgs, rs, s_agg)
        points = ed25519.dsm_batch(terms, self.device)
        with self._mtx:
            self._stats["agg_batches"] += 1
            self._stats["agg_lanes_device"] += n
        return ed25519_agg.finish_from_points(points)

    def pop_primed(self, item: Item) -> bool | None:
        """Pop (single-use) the primed verdict for one item: True/False
        from a resolved batch, None if never primed or aged out. A primed
        batch that failed re-raises its failure here."""
        with self._mtx:
            primed = self._primed.pop(item, None)
        if isinstance(primed, _PendingBatch):
            # wait outside the mutex: this blocks on the device
            primed = primed.result_for(item)
        return primed

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

    def prime_cache_async(self, items: list[Item], on_done=None) -> None:
        """Pipelined prime_cache: dispatch the batch now
        (verify_batch_async) and park a pending handle per item; the first
        verify_one to pop one blocks for the batch verdicts. The caller's
        host work between dispatch and first pop overlaps the marshal and
        the kernel. `on_done(dt_s)` observes the dispatch-to-verdicts wall
        time on success."""
        if not items:
            return
        pending = _PendingBatch(items, self.verify_batch_async(items), on_done)
        with self._mtx:
            for it in items:
                self._primed[it] = pending
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


class ShardedVerifier(Verifier):
    """A Verifier whose device batches split over `mesh`, a sequence of
    devices (see ed25519_f32p.ShardedVerify): each shard runs B1 (under
    `f32p`, the default) or B3's `verify_plain` (under `f32`) on its own
    device and stream, and the verdicts gather into one pinned host
    buffer. A 10,000-validator commit's lanes split over n cards.

    As in the JAX package: batches below `min_tpu_batch` run on the CPU,
    and a batch with secp256k1 (or malformed) lanes goes through the base
    class's key-type split, whose ed25519 lanes come back here while the
    rest verify on the CPU. Unlike the JAX package there is no
    f32p -> f32 -> CPU ratchet: a failed build, launch, copy or event
    raises out of verify_batch and out of the resolver, no stat moves,
    and nothing is latched. A dispatch counts in `tpu_batches` and
    `tpu_sigs` once its verdicts are back."""

    @staticmethod
    def _refusal(name: str) -> str:
        return (f"ShardedVerifier shards the f32/f32p kernels; TENDERMINT_TPU_KERNEL={name!r} — "
                "run a bake-off backend through the base Verifier")

    def __init__(self, mesh, min_tpu_batch: int | None = None):
        # before the base reads the knob: the sharded path has its own
        # refusal for every other name
        name = kernel_name(accepted=("f32p", "f32"), refusal=self._refusal)
        if name == "f32":
            sharded = ed25519_f32p.ShardedVerify(mesh, ed25519_f32.verify_rows, ed25519_f32.sharded_bucket)
        else:
            sharded = ed25519_f32p.ShardedVerify(mesh)
        # the base's own device (aggregate verifies) is the mesh's first
        super().__init__(min_tpu_batch=min_tpu_batch, device=sharded.devices[0])
        self.mesh = list(mesh)
        self._sharded = sharded
        # (device, lanes) per shard of the latest sharded dispatch; None
        # until one runs
        self.last_shard_layout: list[tuple[str, int]] | None = None

    def verify_batch_async(self, items: list[Item]):
        """Dispatch the shards now; the resolver waits on every shard's
        event, then masks the verdicts once."""
        n = len(items)
        if n == 0 or n < self.min_tpu_batch or not all(_ed25519_lane(it) for it in items):
            # the CPU floor, or the key-type split, which re-enters here
            # with the ed25519 lanes; never the base's unsharded kernel
            return super().verify_batch_async(items)
        res, valid, _ = ed25519_f32p.sharded_verify_arrays(items, self._sharded)
        self.last_shard_layout = list(res.shards)
        memo: list = []

        def resolve() -> list[bool]:
            if not memo:
                oks = ed25519_f32p.materialize_verdicts(res.wait(), valid, n)
                self._device_batch(n)
                memo.append([bool(b) for b in oks])
            return memo[0]

        return resolve


# -- the process-wide verifier -----------------------------------------------

_default_verifier: Verifier | None = None
_default_mtx = threading.Lock()


def default_verifier() -> Verifier:
    """The process-wide Verifier on the card (what AggregateCommit.verify
    reaches when no verifier is passed)."""
    global _default_verifier
    with _default_mtx:
        if _default_verifier is None:
            _default_verifier = Verifier()
        return _default_verifier
