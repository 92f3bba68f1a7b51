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

`Hasher` is the hash plane's gateway: the part-set leaves and tree
(`PartSet.from_data`) and the tx root (`types.tx.txs_hash`) of every block
build run through the hash kernels on the card (ops/merkle.py), with the
native host library below its size gate.

Unlike the JAX gateway, a kernel failure is never caught: there is no
latch to the CPU and no retry, and a verify-ahead batch or a submitted
hash job that fails re-raises where its result is read. The stats keep
the JAX key names (`tpu_batches`, `tpu_sigs`, `cpu_sigs`, `tpu_leaves`,
...), where "tpu" now means the device route, so callers read them
unchanged.
"""

from __future__ import annotations

import importlib
import logging
import os
import queue
import threading
import time
from collections import OrderedDict

from tendermint_tpu_torch import native
from tendermint_tpu_torch.crypto import ed25519_agg
from tendermint_tpu_torch.crypto.hashing import ripemd160
from tendermint_tpu_torch.crypto.keys import verify_any
from tendermint_tpu_torch.merkle.simple import FlatTree, simple_hash_from_byteslices
from tendermint_tpu_torch.ops import ed25519, ed25519_f32, ed25519_f32p, resolve_device
from tendermint_tpu_torch.ops import merkle as ops_merkle

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


def _env_int(name: str, default: int) -> int:
    """An integer knob; unset or empty is the default, and a malformed
    value warns and falls back to it."""
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        logger.warning("%s=%r is not an integer; using %d", name, raw, default)
        return default


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
        self.min_tpu_batch = (
            _env_int("TENDERMINT_TPU_MIN_BATCH", 32) if min_tpu_batch is None else min_tpu_batch
        )
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


# -- merkle/hashing gateway --------------------------------------------------


class _HashFuture:
    """Join handle for a hash job submitted early. result() re-raises the
    worker's exception."""

    __slots__ = ("_evt", "_value", "_exc")

    def __init__(self):
        self._evt = threading.Event()
        self._value = None
        self._exc: BaseException | None = None

    def _finish(self, value=None, exc: BaseException | None = None) -> None:
        self._value = value
        self._exc = exc
        self._evt.set()

    def result(self, timeout: float | None = None):
        if not self._evt.wait(timeout):
            raise TimeoutError("hash submission did not complete")
        if self._exc is not None:
            raise self._exc
        return self._value


class Hasher:
    """Batched hashing gateway for the part-set and tx-tree paths of every
    block build: consensus wires `part_leaf_hashes`, `part_set_tree` and
    `submit_part_set_tree` into `Block.make_block`, and `tx_merkle_root`
    into `types.tx.set_batch_tx_root`.

    A batch of at least `min_tpu_batch` leaves (TENDERMINT_TPU_HASH_MIN_BATCH,
    default 16) hashes on the card: K1 (RIPEMD-160, two threads a message)
    writes the leaf digests into K3's node buffer and K3 builds the tree
    there (ops/merkle.py), so a part set's nodes, or a tx set's root, come
    back in one copy; for `device="cpu"` the kernels' plain versions run
    instead. Narrower batches, and every batch when the operator asks for
    CPU hashing (TENDERMINT_TPU_HASHES=0 or TENDERMINT_TPU_DISABLE=1), run
    on the host: the native library's batch RIPEMD-160 and the flat
    FlatTree, as in the JAX package.

    Unlike the JAX package's Hasher, this one offloads by default (the JAX
    default keys on a measured device round trip, and its devd route
    rides the device daemon; neither is ported yet), and a kernel or
    submission failure raises instead of latching the CPU."""

    def __init__(self, min_tpu_batch: int | None = None, device=None):
        if min_tpu_batch is None:
            min_tpu_batch = _env_int("TENDERMINT_TPU_HASH_MIN_BATCH", 16)
        env = os.environ.get("TENDERMINT_TPU_HASHES", "")
        use_device = not (os.environ.get("TENDERMINT_TPU_DISABLE", "") == "1" or env == "0")
        self.min_tpu_batch = min_tpu_batch
        # the card (or the plain versions' CPU) when offloading; None when
        # the operator asked for host hashing
        self.device = resolve_device(device) if use_device else None
        self._mtx = threading.Lock()
        self._stats = {
            "tpu_part_batches": 0, "tpu_leaves": 0,
            "tpu_tx_roots": 0, "cpu_leaves": 0,
            # bytes through the offload path and the last / EWMA batch time
            "batch_bytes": 0, "batch_ms_last": 0.0, "batch_ms_avg": 0.0,
            # tx-root cache hits: reproposals and re-validation of an
            # unchanged tx set never rehash
            "tx_root_cache_hits": 0,
            # jobs queued to the submit worker, and tx_merkle_root calls
            # that joined an in-flight submission instead of recomputing
            "submitted_jobs": 0, "tx_root_prehash_joins": 0,
            # the JAX package's streamed-transport gauges (its devd route),
            # always present so a scrape reads a stable set; zeros here
            "stream_batches": 0, "stream_chunks_out": 0,
            "stream_lanes": 0, "stream_bytes_out": 0,
            "stream_trees": 0, "stream_reconnects": 0,
            "stream_single_batches": 0, "stream_single_lanes": 0,
        }
        # tx-root LRU keyed by the tx tuple (one hash pass over the raw
        # txs; keys pin their tx bytes, so the cap is small)
        self._tx_roots: OrderedDict[tuple, bytes] = OrderedDict()
        self._tx_roots_cap = 16
        # submitted-early jobs: one daemon worker runs them in order, and
        # an in-flight tx root is joined by a later tx_merkle_root
        self._submit_q: queue.Queue | None = None
        self._submit_thread: threading.Thread | None = None
        self._inflight_tx_roots: dict[tuple, _HashFuture] = {}

    def stats(self) -> dict:
        with self._mtx:
            return dict(self._stats)

    def _use_offload(self, n: int) -> bool:
        return self.device is not None and n >= self.min_tpu_batch

    def _note_batch(self, n_bytes: int, dt_s: float) -> None:
        ms = dt_s * 1000.0
        with self._mtx:
            s = self._stats
            s["batch_bytes"] += n_bytes
            s["batch_ms_last"] = round(ms, 3)
            s["batch_ms_avg"] = round(
                0.8 * s["batch_ms_avg"] + 0.2 * ms, 3
            ) if s["batch_ms_avg"] else round(ms, 3)

    def _note_offload(self, key: str, leaves: int, n_bytes: int, t0: float) -> None:
        self._note_batch(n_bytes, time.perf_counter() - t0)
        with self._mtx:
            self._stats[key] += 1
            self._stats["tpu_leaves"] += leaves

    def part_leaf_hashes(self, chunks: list[bytes]) -> list[bytes]:
        """Part.Hash batch, for PartSet.from_data(hasher=...)."""
        if self._use_offload(len(chunks)):
            t0 = time.perf_counter()
            out = ops_merkle.part_leaf_hashes(chunks, self.device)
            self._note_offload("tpu_part_batches", len(chunks), sum(map(len, chunks)), t0)
            return out
        with self._mtx:
            self._stats["cpu_leaves"] += len(chunks)
        # ready(), not available(): the block path never waits behind a
        # native build
        if len(chunks) >= 2 and native.ready():
            return native.ripemd160_batch(chunks)
        return [ripemd160(c) for c in chunks]

    def part_set_tree(self, chunks: list[bytes]):
        """(leaf hashes, FlatTree) of a part set built on the device, or
        None below the size gate (PartSet.from_data then builds on the
        host). One pass of K1 and K3 returns every node, so the proofs
        cost the host no hashing."""
        if not self._use_offload(len(chunks)):
            return None
        t0 = time.perf_counter()
        digests, nodes = ops_merkle.part_set_nodes(chunks, self.device)
        tree = FlatTree.from_nodes(len(chunks), nodes)
        self._note_offload("tpu_part_batches", len(chunks), sum(map(len, chunks)), t0)
        return digests, tree

    # -- submitted-early jobs --------------------------------------------

    def _submit(self, fn) -> _HashFuture:
        """Queue fn on the submit worker (started at first use); returns
        the join handle."""
        fut = _HashFuture()
        with self._mtx:
            if self._submit_q is None:
                self._submit_q = queue.Queue()
                self._submit_thread = threading.Thread(
                    target=self._submit_loop, daemon=True, name="gw.hashSubmit",
                )
                self._submit_thread.start()
            self._stats["submitted_jobs"] += 1
            q = self._submit_q
        q.put((fut, fn))
        return fut

    def _submit_loop(self) -> None:
        while True:
            fut, fn = self._submit_q.get()
            try:
                fut._finish(value=fn())
            except BaseException as exc:  # noqa: BLE001 - re-raised by result()
                fut._finish(exc=exc)

    def submit_tx_root(self, txs: list[bytes]) -> _HashFuture:
        """Start the tx root now and return a future; a later
        tx_merkle_root on the same tx set joins it instead of recomputing."""
        key = tuple(txs)
        done = _HashFuture()
        with self._mtx:
            cached = self._tx_roots.get(key)
            if cached is not None:
                self._tx_roots.move_to_end(key)
                done._finish(value=cached)
                return done
            fut = self._inflight_tx_roots.get(key)
            if fut is not None:
                return fut
            fut = _HashFuture()
            self._inflight_tx_roots[key] = fut

        def work():
            try:
                root = self._tx_merkle_root_uncached(txs)
            except BaseException as exc:  # noqa: BLE001 - re-raised by result()
                with self._mtx:
                    self._inflight_tx_roots.pop(key, None)
                fut._finish(exc=exc)
                return
            with self._mtx:
                # cached before the in-flight entry goes: a joiner sees one
                # or the other
                self._remember_root(key, root)
            fut._finish(value=root)
            with self._mtx:
                self._inflight_tx_roots.pop(key, None)

        self._submit(work)
        return fut

    def submit_part_set_tree(self, chunks: list[bytes]) -> _HashFuture:
        """part_set_tree as a future: the card hashes while the caller
        builds the parts (PartSet.from_data joins before the proofs).
        Resolves to (digests, FlatTree) or None, as part_set_tree."""
        return self._submit(lambda: self.part_set_tree(chunks))

    def _remember_root(self, key: tuple, root: bytes) -> None:
        self._tx_roots[key] = root
        while len(self._tx_roots) > self._tx_roots_cap:
            self._tx_roots.popitem(last=False)

    def tx_merkle_root(self, txs: list[bytes]) -> bytes:
        """Txs.Hash, the tx tree's root (types/tx.go:33-46): memoized per tx
        set, an in-flight submit_tx_root joined (its failure re-raises),
        else computed now."""
        key = tuple(txs)
        with self._mtx:
            cached = self._tx_roots.get(key)
            if cached is not None:
                self._tx_roots.move_to_end(key)
                self._stats["tx_root_cache_hits"] += 1
                return cached
            fut = self._inflight_tx_roots.get(key)
        if fut is not None:
            root = fut.result(timeout=120)
            with self._mtx:
                self._stats["tx_root_prehash_joins"] += 1
            return root
        root = self._tx_merkle_root_uncached(txs)
        with self._mtx:
            self._remember_root(key, root)
        return root

    def _tx_merkle_root_uncached(self, txs: list[bytes]) -> bytes:
        if self._use_offload(len(txs)):
            t0 = time.perf_counter()
            out = ops_merkle.tx_root(txs, self.device)
            self._note_offload("tpu_tx_roots", len(txs), sum(map(len, txs)), t0)
            return out
        with self._mtx:
            self._stats["cpu_leaves"] += len(txs)
        return simple_hash_from_byteslices(txs)


# -- the process-wide verifier and hasher ------------------------------------

_default_verifier: Verifier | None = None
_default_hasher: Hasher | None = None
_default_mtx = threading.Lock()


def default_verifier() -> Verifier:
    """The process-wide Verifier on the card (what AggregateCommit.verify
    reaches when no verifier is passed)."""
    global _default_verifier
    with _default_mtx:
        if _default_verifier is None:
            _default_verifier = Verifier()
        return _default_verifier


def default_hasher() -> Hasher:
    """The process-wide Hasher (on the card unless the operator asked for
    host hashing)."""
    global _default_hasher
    with _default_mtx:
        if _default_hasher is None:
            _default_hasher = Hasher()
        return _default_hasher
