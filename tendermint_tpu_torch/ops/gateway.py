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

The device daemon (tendermint_tpu_torch/devd.py) is the registry's
`devd`: with TENDERMINT_TPU_KERNEL unset and a daemon serving, a default
Verifier and Hasher send their batches to it over its socket
(ops/devd_backend.py) and hold no device of their own. That route keeps
the JAX gateway's breaker plane: transport failures feed one
`CircuitBreaker` a daemon socket; while it is open, batches verify on the
native CPU floor and count in `cpu_sigs` (hashes on the host, in
`cpu_leaves`), logged at WARNING; a ping probe on jittered backoff
re-closes it when the daemon is back. With TENDERMINT_DEVD_SOCKS naming
two or more daemons, the batches split over them (ops/devd_shard.py), one
breaker a daemon, and the floor engages only when every breaker is open.

Everywhere else a kernel failure is never caught: there is no latch to
the CPU and no retry, and a verify-ahead batch or a submitted hash job
that fails re-raises where its result is read. On the in-process route
any failure to build, launch or read back a kernel raises `DeviceError`
(a RuntimeError), so a caller such as consensus can tell a broken device
from a bad input and stop instead of treating it as a bad vote or block.
The stats keep the JAX key names (`tpu_batches`, `tpu_sigs`, `cpu_sigs`,
`tpu_leaves`, ...), where "tpu" now means the device route, so callers
read them unchanged.
"""

from __future__ import annotations

import importlib
import logging
import os
import queue
import random
import threading
import time
from collections import OrderedDict

from tendermint_tpu_torch import devd, native
from tendermint_tpu_torch.crypto import ed25519_agg
from tendermint_tpu_torch.crypto.hashing import ripemd160
from tendermint_tpu_torch.crypto.keys import verify_any
from tendermint_tpu_torch.libs import telemetry
from tendermint_tpu_torch.libs.envknob import env_number as _env_number
from tendermint_tpu_torch.merkle.simple import FlatTree, simple_hash_from_byteslices
from tendermint_tpu_torch.ops import ed25519, ed25519_f32, ed25519_f32p, faults, resolve_device
from tendermint_tpu_torch.ops import merkle as ops_merkle

logger = logging.getLogger("tendermint_tpu_torch.ops.gateway")

Item = tuple[bytes, bytes, bytes]  # (pubkey, message, signature)


class DeviceError(RuntimeError):
    """A kernel or its device failed on the in-process route: the build,
    the launch or the read-back. The message keeps the cause's."""


def _on_device(what: str, fn, *args):
    """fn(*args), with any failure raised as DeviceError."""
    try:
        return fn(*args)
    except DeviceError:
        raise
    except Exception as exc:
        raise DeviceError(f"{what} failed: {type(exc).__name__}: {exc}") from exc


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


# The port's verify kernels by their JAX registry names. Each kernel
# module has verify_batch(items, device) -> bool[n] with identical
# accept/reject semantics; f32p, f32 and comb also pipeline
# (verify_batch_async). `devd` is not a kernel: socket IPC to the device
# daemon, which serves its claim-time bake-off winner (comb or f32p) on
# the card it holds.
KERNELS = {
    "comb": "tendermint_tpu_torch.ops.ed25519_comb",
    "f32": "tendermint_tpu_torch.ops.ed25519_f32",
    "f32p": "tendermint_tpu_torch.ops.ed25519_f32p",
    "int32": "tendermint_tpu_torch.ops.ed25519",
    "pallas": "tendermint_tpu_torch.ops.ed25519_pallas",
    "devd": "tendermint_tpu_torch.ops.devd_backend",
}


def kernel_name(accepted=None, refusal=None) -> str:
    """Validated TENDERMINT_TPU_KERNEL. Unset or empty: "devd" when a
    device daemon serves (devd.available), else "f32p". Raises on a name
    the registry lacks, so a typo fails at startup instead of running
    another kernel. A caller that takes only some names passes them as
    `accepted`, and `refusal(name)`, the message for any other; it gets
    "f32p", never the daemon, when the variable is unset."""
    name = os.environ.get("TENDERMINT_TPU_KERNEL", "")
    if not name:
        if accepted is None and devd.available() is not None:
            return "devd"
        name = "f32p"
    if accepted is not None and name not in accepted:
        raise ValueError(refusal(name))
    if name not in KERNELS:
        raise ValueError(
            f"TENDERMINT_TPU_KERNEL={name!r}: expected one of {sorted(KERNELS)}"
        )
    return name


def _env_int(name: str, default: int) -> int:
    """An integer knob; unset or empty is the default, and a malformed
    value warns and falls back to it."""
    return int(_env_number(name, default, cast=int))


class CircuitBreaker:
    """The closed -> open -> half-open policy of the devd route, shared by
    the verify and hash planes (the JAX gateway's, state for state).

    - CLOSED: devd routes normally. `threshold` consecutive failures
      (default 3, TENDERMINT_TPU_BREAKER_FAILURES) open it.
    - OPEN: callers take the CPU floor a batch at a time: verdicts and
      digests stay right, only the transport degrades. Probes are
      scheduled on exponential backoff with jitter (base
      TENDERMINT_TPU_BREAKER_BACKOFF_S, default 0.5 s; cap
      TENDERMINT_TPU_BREAKER_BACKOFF_CAP_S, default 30 s).
    - HALF-OPEN: when a probe is due, `allow()` runs it inline (a fresh
      daemon ping, bounded about 1 s; at most one caller probes a window,
      the others stay on the floor). A healthy probe re-closes the breaker;
      a failed one re-opens it with doubled backoff. With no probe
      injected, the one `allow()` that finds a due window returns True as
      a trial request, whose record_success / record_failure settles it.

    `stats()` gives flat numeric gauges (state, transitions, probes,
    consecutive failures, seconds on the floor) that Verifier and Hasher
    fold into theirs."""

    CLOSED, HALF_OPEN, OPEN = 0, 1, 2

    def __init__(self, threshold: int | None = None,
                 base_backoff_s: float | None = None,
                 max_backoff_s: float | None = None,
                 probe=None, on_close=None, seed: int | None = None):
        self.threshold = max(1, int(
            threshold if threshold is not None
            else _env_number("TENDERMINT_TPU_BREAKER_FAILURES", 3)
        ))
        self.base_backoff_s = float(
            base_backoff_s if base_backoff_s is not None
            else _env_number("TENDERMINT_TPU_BREAKER_BACKOFF_S", 0.5)
        )
        self.max_backoff_s = float(
            max_backoff_s if max_backoff_s is not None
            else _env_number("TENDERMINT_TPU_BREAKER_BACKOFF_CAP_S", 30.0)
        )
        self._probe = probe
        self._on_close = on_close
        self._rng = random.Random(seed)
        self._mtx = threading.Lock()
        self._state = self.CLOSED
        self._fails = 0
        self._backoff = self.base_backoff_s
        self._opened_at = 0.0
        self._next_probe = 0.0
        self._probing = False
        self._opens = 0
        self._closes = 0
        self._probes = 0
        self._probe_failures = 0
        self._fallback_s = 0.0

    def _jittered(self, backoff: float) -> float:
        # jitter on [0.5x, 1.5x]: processes sharing one daemon must not
        # probe in lockstep after a restart
        return backoff * (0.5 + self._rng.random())

    def _open_locked(self, now: float, *, reopen: bool) -> None:
        if self._state != self.OPEN and not reopen:
            self._opens += 1
            self._opened_at = now
            self._backoff = self.base_backoff_s
        self._state = self.OPEN
        if reopen:
            self._backoff = min(self._backoff * 2.0, self.max_backoff_s)
        self._next_probe = now + self._jittered(self._backoff)

    def _close_locked(self, now: float) -> None:
        if self._state != self.CLOSED:
            self._closes += 1
            self._fallback_s += now - self._opened_at
        self._state = self.CLOSED
        self._fails = 0
        self._backoff = self.base_backoff_s

    def allow(self) -> bool:
        """May the caller route to devd now? CLOSED: yes. OPEN with a probe
        due: run the probe (or admit one trial request); success restores
        routing for everyone. Otherwise: no, take the floor."""
        with self._mtx:
            if self._state == self.CLOSED:
                return True
            now = time.monotonic()
            if self._probing or now < self._next_probe:
                return False
            self._state = self.HALF_OPEN
            self._probes += 1
            if self._probe is None:
                # trial mode: this request is the probe. The window
                # advances now, so other callers stay on the floor while
                # the trial is in flight (one trial a window)
                self._next_probe = time.monotonic() + self._jittered(self._backoff)
                return True
            self._probing = True
            probe = self._probe
        ok = False
        try:
            ok = bool(probe())
        except Exception:  # noqa: BLE001 - a raising probe is a failed probe
            logger.exception("breaker probe raised")
        closed = False
        with self._mtx:
            self._probing = False
            now = time.monotonic()
            if ok:
                self._close_locked(now)
                closed = True
            else:
                self._probe_failures += 1
                # re-open only if this probe still owns the half-open
                # slot: a concurrent record_success may have closed the
                # breaker while the probe ran, and that fresher evidence
                # wins
                if self._state == self.HALF_OPEN:
                    self._open_locked(now, reopen=True)
        if closed:
            logger.warning("devd breaker re-closed: device routing restored")
            self._run_on_close()
        return ok

    def record_success(self) -> None:
        closed = False
        with self._mtx:
            self._fails = 0
            if self._state != self.CLOSED:
                self._close_locked(time.monotonic())
                closed = True
        if closed:
            logger.warning("devd breaker re-closed: device routing restored")
            self._run_on_close()

    def record_failure(self) -> bool:
        """Note one failure; True if the breaker is now open."""
        with self._mtx:
            now = time.monotonic()
            self._fails += 1
            if self._state == self.HALF_OPEN:
                # the trial request failed: back to OPEN, doubled backoff
                self._probe_failures += 1
                self._open_locked(now, reopen=True)
                return True
            if self._state == self.CLOSED and self._fails >= self.threshold:
                self._open_locked(now, reopen=False)
                logger.warning(
                    "devd breaker OPEN after %d consecutive failures; "
                    "CPU floor until a probe finds the daemon healthy",
                    self._fails,
                )
                return True
            return self._state == self.OPEN

    def _run_on_close(self) -> None:
        if self._on_close is None:
            return
        try:
            self._on_close()
        except Exception:  # noqa: BLE001 - a bad hook must not block recovery
            logger.exception("breaker on_close hook failed")

    @property
    def state(self) -> int:
        with self._mtx:
            return self._state

    def stats(self) -> dict:
        with self._mtx:
            now = time.monotonic()
            current = (now - self._opened_at) if self._state != self.CLOSED else 0.0
            return {
                "breaker_state": self._state,  # 0 closed / 1 half-open / 2 open
                "breaker_opens": self._opens,
                "breaker_closes": self._closes,
                "breaker_probes": self._probes,
                "breaker_probe_failures": self._probe_failures,
                "breaker_consecutive_failures": self._fails,
                "breaker_fallback_s": round(self._fallback_s + current, 3),
            }


_devd_breakers: dict[str, CircuitBreaker] = {}
_breaker_mtx = threading.Lock()


def _devd_probe(path: str | None = None) -> bool:
    """The breaker's half-open probe: one fresh ping (never the TTL cache,
    which may predate the daemon's death) proving a daemon serves and
    holds the card."""
    devd.bust_avail_cache(path)
    return devd.available(timeout=1.0, path=path) is not None


def devd_breaker(endpoint: str | None = None) -> CircuitBreaker:
    """The breaker of one daemon socket (default devd.sock_path()), made at
    first use: the Verifier and the Hasher of a process share it, so a
    recovery restores both planes at once."""
    if endpoint is None:
        endpoint = devd.sock_path()
    with _breaker_mtx:
        br = _devd_breakers.get(endpoint)
        if br is None:
            br = CircuitBreaker(
                probe=lambda: _devd_probe(endpoint),
                # a re-close means the daemon came back, possibly another
                # build: the version-skew latches must learn again
                on_close=lambda: _breaker_on_close(endpoint),
            )
            _devd_breakers[endpoint] = br
        return br


def _breaker_on_close(endpoint: str) -> None:
    """Re-arm the version-skew latches of the endpoint whose breaker
    re-closed: the multi-daemon plane's latches for that endpoint, and
    devd_backend's when it is the one daemon socket its client talks to."""
    from tendermint_tpu_torch.ops import devd_backend, devd_shard

    devd_shard.reset_endpoint_latches(endpoint)
    if endpoint == devd.sock_path():
        devd_backend.reset_stream_latches()


def devd_breaker_states() -> dict[str, int]:
    """Every registered breaker's state by socket path (never makes one: a
    scrape must not spawn breakers for sockets nothing dispatched to)."""
    with _breaker_mtx:
        items = list(_devd_breakers.items())
    return {path: br.state for path, br in items}


def reset_devd_breaker() -> None:
    """Drop every registered breaker (tests; also re-reads the knobs)."""
    with _breaker_mtx:
        _devd_breakers.clear()


# -- devd plane gating ----------------------------------------------------------
#
# Verifier and Hasher gate each batch through these. With one daemon they
# are its breaker. With several (TENDERMINT_DEVD_SOCKS), the plane admits
# work while any endpoint's breaker does, the dispatcher (ops/devd_shard)
# counts each slice on the endpoint that ran it, and the CPU floor engages
# only when every breaker is open.


def devd_plane_allow() -> bool:
    """Admission gate for the devd route as a whole."""
    from tendermint_tpu_torch.ops import devd_shard

    if devd_shard.enabled():
        return devd_shard.plane_allow()
    return devd_breaker().allow()


def devd_plane_failure() -> None:
    """A devd-route batch raised. One daemon: count it on its breaker. A
    fleet: the dispatcher already counted each failed slice on its
    endpoint, and a batch raises only when no healthy endpoint was left,
    so counting it again would count it twice."""
    from tendermint_tpu_torch.ops import devd_shard

    if not devd_shard.enabled():
        devd_breaker().record_failure()


def devd_plane_success() -> None:
    from tendermint_tpu_torch.ops import devd_shard

    if not devd_shard.enabled():
        devd_breaker().record_success()


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
    kernel's plain version), with the CPU below the size gate.

    With no `device` and TENDERMINT_TPU_KERNEL unset, a serving device
    daemon takes the batches (the `devd` route): this process then holds
    no device, and `device` is None. A caller that names a device runs
    the kernel in process on it."""

    def __init__(self, min_tpu_batch: int | None = None, device=None):
        self.min_tpu_batch = (
            _env_int("TENDERMINT_TPU_MIN_BATCH", 32) if min_tpu_batch is None else min_tpu_batch
        )
        # resolved once: a typo fails here, and the kernel cannot change
        # under a live node (a daemon appearing or dying included)
        explicit = os.environ.get("TENDERMINT_TPU_KERNEL", "")
        self._kernel = kernel_name() if explicit or device is None else "f32p"
        self._module = importlib.import_module(KERNELS[self._kernel])
        self.device = None if self._kernel == "devd" else resolve_device(device)
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

    def _max_retries(self) -> int:
        """A devd batch's retries: the breaker's threshold, so a lone
        caller still drives the breaker open before the floor, and a
        batch never recurses past it."""
        return devd_breaker().threshold

    def _devd_floor(self, items: list[Item]):
        """The devd route's CPU floor: every breaker open, or this batch's
        retries spent. Counted in cpu_sigs and logged."""
        n = len(items)
        logger.warning("devd plane unavailable: %d lanes on the CPU floor", n)
        self._count("cpu_sigs", n)
        res = _cpu_verify_batch(items)
        return lambda: res

    def _devd_batch_async(self, items: list[Item], attempt: int = 0):
        """The devd route: dispatch now over the daemon socket; a transport
        or daemon failure feeds the breaker and the whole batch
        re-dispatches (at-least-once, the verdicts merge idempotently),
        until the breaker opens or the retries are spent, then the CPU
        floor."""
        n = len(items)
        if attempt > self._max_retries() or not devd_plane_allow():
            return self._devd_floor(items)
        try:
            kernel_resolve = self._module.verify_batch_async(items)
        except Exception:
            logger.exception("batch verify via devd failed")
            devd_plane_failure()
            return self._devd_batch_async(items, attempt + 1)
        self._device_batch(n)

        def resolve() -> list[bool]:
            try:
                res = [bool(b) for b in kernel_resolve()]
            except Exception:
                logger.exception("verify via devd failed at resolve")
                with self._mtx:
                    self._stats["tpu_batches"] -= 1
                    self._stats["tpu_sigs"] -= n
                devd_plane_failure()
                return self._devd_batch_async(items, attempt + 1)()
            devd_plane_success()
            return res

        return resolve

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
        if self._kernel == "devd":
            return self._devd_batch_async(items)
        if not hasattr(self._module, "verify_batch_async"):
            # B2 and int32, like their JAX modules, verify synchronously
            # under the same contract
            res_now = [bool(b) for b in _on_device(
                f"{self._kernel} verify", self._module.verify_batch, items, self.device)]
            self._device_batch(n)
            return lambda: res_now
        kernel_resolve = _on_device(
            f"{self._kernel} verify launch", self._module.verify_batch_async, items, self.device)
        self._device_batch(n)
        return lambda: [bool(b) for b in _on_device(f"{self._kernel} verify read-back", kernel_resolve)]

    def verify_aggregate(self, pubs: list[bytes], msgs: list[bytes],
                         rs: list[bytes], s_agg: bytes) -> bool:
        """Half-aggregate verify (the crypto.ed25519_agg equation) with its
        n + 1 dual-scalar-mul lanes in one dsm launch on the verifier's
        device, or the daemon's `agg` op on the devd route. Below
        `min_tpu_batch` lanes the pure-Python reference runs instead: the
        size gate, as for signatures; so it does on the devd route when
        the breaker is open, the retries are spent, or the daemon predates
        the agg op. Semantics identical to ed25519_agg.verify_aggregate."""
        terms = ed25519_agg.aggregate_terms(pubs, msgs, rs, s_agg)
        if terms is None:
            return False
        n = len(terms)
        if n < self.min_tpu_batch:
            self._count("agg_lanes_cpu", n)
            return ed25519_agg.verify_aggregate(pubs, msgs, rs, s_agg)
        if self._kernel == "devd":
            points = self._devd_agg(terms)
        else:
            points = _on_device("dsm aggregate verify", ed25519.dsm_batch, terms, self.device)
        if points is None:
            self._count("agg_lanes_cpu", n)
            return ed25519_agg.verify_aggregate(pubs, msgs, rs, s_agg)
        with self._mtx:
            self._stats["agg_batches"] += 1
            self._stats["agg_lanes_device"] += n
        return ed25519_agg.finish_from_points(points)

    def _devd_agg(self, terms) -> list[tuple[int, int]] | None:
        """The agg op's points, or None for the CPU floor."""
        for _ in range(self._max_retries() + 1):
            if not devd_plane_allow():
                break
            try:
                points = self._module.agg_batch(terms)
            except self._module.AggUnsupported:
                # a healthy daemon without the op: the floor, no breaker
                # penalty, latched until the breaker re-closes
                return None
            except Exception:
                logger.exception("aggregate verify via devd failed")
                devd_plane_failure()
                continue
            devd_plane_success()
            return points
        logger.warning("devd plane unavailable: %d aggregate lanes on the CPU floor", len(terms))
        return None

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
            out = dict(self._stats)
        if self._kernel == "devd":
            # the client's streamed-transport counters, the breaker's gauges
            # and the fault harness's counters (zeros with none installed),
            # flat numeric keys as in the JAX gateway
            from tendermint_tpu_torch.ops import devd_backend

            for k, val in devd_backend.stream_stats().items():
                out[k if k.startswith("stream") else f"stream_{k}"] = val
            out.update(devd_breaker().stats())
            out.update(faults.global_counters())
        return out

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
        # refusal for every other name, and never routes to a daemon
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
        res, valid, _ = _on_device("sharded verify launch", ed25519_f32p.sharded_verify_arrays,
                                   items, self._sharded)
        self.last_shard_layout = list(res.shards)
        memo: list = []

        def resolve() -> list[bool]:
            if not memo:
                oks = ed25519_f32p.materialize_verdicts(
                    _on_device("sharded verify read-back", res.wait), valid, n)
                self._device_batch(n)
                memo.append([bool(b) for b in oks])
            return memo[0]

        return resolve


# -- merkle/hashing gateway --------------------------------------------------

_rtt_cache: dict[str, float | None] = {}
_rtt_lock = threading.Lock()


def device_rtt_ms(device=None) -> float | None:
    """The measured round trip the Hasher's policy keys on, cached per
    process. With no `device` and a daemon socket present: the daemon's
    (the least of 3 pings after one, None when no daemon serving the card
    answers), and this process never dials the card the daemon owns.
    Otherwise: one tiny synchronised op on `device` in process
    (jitcache.probe_rtt_ms; the card unless the caller names the CPU),
    None when it did not answer in 30 s."""
    sock = devd.sock_path()
    key = f"devd:{sock}" if device is None and os.path.exists(sock) else str(resolve_device(device))
    with _rtt_lock:
        if key in _rtt_cache:
            return _rtt_cache[key]
        if key.startswith("devd:"):
            rtt = _daemon_rtt_ms(sock)
        else:
            from tendermint_tpu_torch.jitcache import probe_rtt_ms

            rtt = probe_rtt_ms(30.0, key)
        if rtt is not None:
            logger.info("device rtt (%s): %.3f ms", key, rtt)
        _rtt_cache[key] = rtt
        return rtt


def _daemon_rtt_ms(sock: str) -> float | None:
    client = devd.DevdClient(sock, connect_timeout=1.0, io_timeout=5.0)
    try:
        if not client.ping().get("held"):
            return None
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            client.ping()
            dt = (time.perf_counter() - t0) * 1e3
            best = dt if best is None else min(best, dt)
        return best
    except (OSError, devd.DevdError):
        return None
    finally:
        client.close()


# Above this round trip the hash offload cannot win at part-batch shapes: a
# 1 MB part set must beat the host's batch RIPEMD-160, so even zero device
# time loses once the round trip alone passes about 5 ms.
HASH_RTT_MS_MAX = 5.0


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
    default 16) hashes on the device: K1 (RIPEMD-160, two warps a message)
    writes the leaf digests into K3's node buffer and K3 builds the tree
    there (ops/merkle.py), so a part set's nodes, or a tx set's root, come
    back in one copy; for `device="cpu"` the kernels' plain versions run
    instead. Narrower batches, and every batch when the operator asks for
    CPU hashing (TENDERMINT_TPU_HASHES=0 or TENDERMINT_TPU_DISABLE=1), run
    on the host: the native library's batch RIPEMD-160 and the flat
    FlatTree, as in the JAX package.

    Routing, resolved once: with no `device` and a device daemon serving,
    every offload batch goes to the daemon (`_route` "devd":
    ops/devd_backend's streamed hash frames at or above its floor, the
    single-shot op below it, and the tree frame for part sets), else the
    kernels run in process ("local"). As in the JAX package the policy
    keys on the measured round trip (`device_rtt_ms`): above
    HASH_RTT_MS_MAX the host hashes; TENDERMINT_TPU_HASHES=1 offloads
    whatever it is. A round trip that cannot be measured raises, as does a
    missing card: never silent host hashing.

    On the devd route a failed batch feeds the breaker and hashes on the
    host (counted in cpu_leaves), as in the JAX package; in process a
    kernel or submission failure raises instead of latching the CPU."""

    def __init__(self, min_tpu_batch: int | None = None, device=None):
        if min_tpu_batch is None:
            min_tpu_batch = _env_int("TENDERMINT_TPU_HASH_MIN_BATCH", 16)
        env = os.environ.get("TENDERMINT_TPU_HASHES", "")
        use_device = not (os.environ.get("TENDERMINT_TPU_DISABLE", "") == "1" or env == "0")
        self.min_tpu_batch = min_tpu_batch
        # "devd", "local" or None (host hashing)
        self._route = None
        # the card (or the plain versions' CPU) of the local route
        self.device = None
        if use_device:
            self._route = "devd" if device is None and devd.available() is not None else "local"
            if env != "1":
                # with no device named: the daemon's round trip when its
                # socket is there (None when it does not serve), else the
                # card's
                rtt = device_rtt_ms(device)
                if rtt is None:
                    raise RuntimeError(
                        f"the {self._route} hash route's round trip could not be measured "
                        "(device or daemon not answering); TENDERMINT_TPU_HASHES=0 hashes "
                        "on the host"
                    )
                if rtt > HASH_RTT_MS_MAX:
                    logger.warning("device rtt %.1f ms > %.1f: hashing on the host",
                                   rtt, HASH_RTT_MS_MAX)
                    self._route = None
            if self._route == "local":
                self.device = resolve_device(device)
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
            # the streamed-transport gauges of the devd route, always
            # present so a scrape reads a stable set; zeros off it
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
        # the full distribution behind batch_ms_last / _avg (one observation
        # an offload batch)
        self._batch_hist = telemetry.default_registry().histogram(
            "gateway_hash_batch_seconds",
            "hash-offload batch wall time (devd IPC or in-process kernel)",
        )

    def stats(self) -> dict:
        with self._mtx:
            out = dict(self._stats)
        if self._route == "devd":
            # the client's hash-transport counters over the zeros, the
            # breaker the verify plane shares, and the fault counters
            from tendermint_tpu_torch.ops import devd_backend

            for k, val in devd_backend.hash_stream_stats().items():
                out[k if k.startswith("stream") else f"stream_{k}"] = val
            out.update(devd_breaker().stats())
            out.update(faults.global_counters())
        return out

    def _use_offload(self, n: int) -> bool:
        """Offload this batch? The size gate, and on the devd route the
        breaker (open: this batch hashes on the host)."""
        if self._route is None or n < self.min_tpu_batch:
            return False
        if self._route == "devd" and not devd_plane_allow():
            logger.warning("devd plane unavailable: %d leaves on the host", n)
            return False
        return True

    def _devd_call(self, fn):
        """fn() on the devd route: its value after a success, None after a
        failure (counted on the breaker; the caller hashes on the host)."""
        try:
            out = fn()
        except Exception:
            logger.exception("hashing via devd failed; this batch on the host")
            devd_plane_failure()
            return None
        devd_plane_success()
        return out

    def _note_batch(self, n_bytes: int, dt_s: float) -> None:
        self._batch_hist.observe(dt_s)
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
            if self._route == "devd":
                from tendermint_tpu_torch.ops import devd_backend

                out = self._devd_call(lambda: devd_backend.hash_batch(chunks, "part"))
            else:
                out = _on_device("part leaf hashes", ops_merkle.part_leaf_hashes, chunks, self.device)
            if out is not None:
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
        if self._route == "devd":
            from tendermint_tpu_torch.ops import devd_backend

            # one pass: the leaf digests and every internal node (the tree
            # frame), so the proofs cost this process no hashing
            got = self._devd_call(lambda: devd_backend.hash_tree(chunks, "part"))
            if got is None:
                return None
            digests = [bytes(d) for d in got[0]]
            nodes = digests + [bytes(x) for x in got[1]]
        else:
            digests, nodes = _on_device("part set tree", ops_merkle.part_set_nodes, chunks, self.device)
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
            if self._route == "devd":
                from tendermint_tpu_torch.ops import devd_backend

                # the daemon's tree kernel gives every internal node; the
                # root is the last
                got = self._devd_call(lambda: devd_backend.hash_tree(txs, "leaf"))
                out = None if got is None else bytes(got[1][-1] if got[1] else got[0][0])
            else:
                out = _on_device("tx root", ops_merkle.tx_root, txs, self.device)
            if out is not None:
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
    """The process-wide Verifier: the serving device daemon's route, or the
    card (what AggregateCommit.verify reaches when no verifier is
    passed)."""
    global _default_verifier
    with _default_mtx:
        if _default_verifier is None:
            _default_verifier = Verifier()
        return _default_verifier


def default_hasher() -> Hasher:
    """The process-wide Hasher (through the serving device daemon, or on
    the card, unless the operator asked for host hashing)."""
    global _default_hasher
    with _default_mtx:
        if _default_hasher is None:
            _default_hasher = Hasher()
        return _default_hasher
