"""The multi-daemon device plane: N device daemons behind one gateway, the
port's copy of the JAX package's `ops/devd_shard.py`.

TENDERMINT_DEVD_SOCKS (comma-separated socket paths) names a fleet of
daemons, and every verify, aggregate and hash batch wide enough splits
into contiguous slices scheduled over the healthy endpoints. Each daemon
is its own process with its own CUDA context, so a fleet also marshals its
slices in parallel, outside the client's GIL. One daemon a card is the
deployment: each daemon's environment pins its card with CUDA's own
CUDA_VISIBLE_DEVICES (`CUDA_VISIBLE_DEVICES=1 TENDERMINT_DEVD_SOCK=...
python -m tendermint_tpu_torch.devd`); several daemons may also share one
card.

Scheduling: a dispatch plans about two slices a healthy endpoint (none
below the size floor, TENDERMINT_TPU_MIN_BATCH for signature and
aggregate lanes, TENDERMINT_TPU_HASH_MIN_BATCH for hash leaves), with
widths in proportion to each endpoint's measured verify rate once it has
one, and gives each slice a home endpoint. One worker an endpoint drains
its own slices first, then steals from the shared tail, so the batch
finishes at the fleet's speed, not its slowest member's.

Failures: each endpoint has its own `CircuitBreaker` in ops/gateway's
keyed registry. A failed slice counts on that endpoint's breaker, goes
back on the queue, and a healthy endpoint takes it; results merge back at
each slice's offsets, so every lane keeps its verdict. A dispatch raises
(DevdShardError, which the gateway handles as a dead daemon) only when no
endpoint can make progress, and the plane falls to the native CPU floor
only when every breaker is open (gateway.devd_plane_allow).

With fewer than two endpoints `enabled()` is False and none of this runs:
ops/devd_backend keeps its single-client path.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from tendermint_tpu_torch import devd
from tendermint_tpu_torch.libs.envknob import env_number

logger = logging.getLogger(__name__)


class DevdShardError(devd.DevdError):
    """A sharded dispatch could not finish on any endpoint. The gateway's
    devd failure handling (bounded retry, then the CPU floor) takes it as
    it takes a dead single daemon."""


def endpoint_paths() -> list[str]:
    """The configured endpoint sockets: TENDERMINT_DEVD_SOCKS's entries
    (stripped, de-duplicated, in order), else the one daemon socket
    (devd.sock_path())."""
    paths: list[str] = []
    for p in os.environ.get("TENDERMINT_DEVD_SOCKS", "").split(","):
        p = p.strip()
        if p and p not in paths:
            paths.append(p)
    return paths or [devd.sock_path()]


def enabled() -> bool:
    """The dispatcher runs only at two or more endpoints."""
    return len(endpoint_paths()) >= 2


# -- endpoints ---------------------------------------------------------------------


class _Endpoint:
    """One daemon socket: its client, its version-skew latches and its
    dispatch counters. Its breaker lives in gateway's keyed registry, so
    the gateway's stats and every other reader see the object the
    dispatcher feeds."""

    def __init__(self, path: str):
        self.path = path
        self.client = devd.DevdClient(path)
        # this daemon's version-skew latches: an older build on one socket
        # does not latch the streamed path off for its siblings
        self.stream_ok = True
        self.hash_stream_ok = True
        self.mtx = threading.Lock()
        self.outstanding = 0
        self.dispatched_slices = 0
        self.stolen_slices = 0
        self.redispatches = 0
        self.sigs = 0
        self.hash_bytes = 0
        self.sigs_per_s = 0.0  # EWMA over the slices' verify rates

    @property
    def breaker(self):
        from tendermint_tpu_torch.ops import gateway

        return gateway.devd_breaker(self.path)

    def note_success(self, lanes: int, n_bytes: int, dt_s: float, stolen: bool, sigs: bool) -> None:
        with self.mtx:
            self.dispatched_slices += 1
            if stolen:
                self.stolen_slices += 1
            if sigs:
                self.sigs += lanes
                if dt_s > 0:
                    rate = lanes / dt_s
                    self.sigs_per_s = (0.8 * self.sigs_per_s + 0.2 * rate) if self.sigs_per_s else rate
            else:
                self.hash_bytes += n_bytes


_endpoints: dict[str, _Endpoint] = {}
_eps_mtx = threading.Lock()


def _fleet() -> list[_Endpoint]:
    """The endpoints of the current configuration, made at first sight (a
    client dials lazily, so an unreachable entry costs nothing until a
    slice goes to it)."""
    out = []
    with _eps_mtx:
        for path in endpoint_paths():
            ep = _endpoints.get(path)
            if ep is None:
                ep = _endpoints[path] = _Endpoint(path)
            out.append(ep)
    return out


def reset() -> None:
    """Drop the endpoint table: fresh clients and counters after the
    configuration or the sockets changed. The breakers live in gateway's
    registry (gateway.reset_devd_breaker())."""
    with _eps_mtx:
        eps = list(_endpoints.values())
        _endpoints.clear()
    for ep in eps:
        try:
            ep.client.close()
        except Exception:  # noqa: BLE001 - teardown, best effort
            pass


def reset_endpoint_latches(path: str) -> None:
    """Re-arm one endpoint's version-skew latches (its breaker's on_close:
    the daemon came back, possibly another build)."""
    with _eps_mtx:
        ep = _endpoints.get(path)
    if ep is not None:
        ep.stream_ok = True
        ep.hash_stream_ok = True


def plane_allow() -> bool:
    """True while any endpoint's breaker admits work: the plane takes the
    CPU floor only when every breaker is open. allow() may run a bounded
    half-open probe inline."""
    return any(ep.breaker.allow() for ep in _fleet())


# -- slicing -----------------------------------------------------------------------


def _verify_floor() -> int:
    return max(1, int(env_number("TENDERMINT_TPU_MIN_BATCH", 32, cast=int)))


def _hash_floor() -> int:
    return max(1, int(env_number("TENDERMINT_TPU_HASH_MIN_BATCH", 16, cast=int)))


def _plan_slices(n: int, workers: int, floor: int) -> list[tuple[int, int]]:
    """Contiguous (start, stop) slices: about two a worker, so there is
    work left to steal, as many as the floor allows (no slice below it),
    at least one."""
    floor = max(1, floor)
    k = max(1, min(workers * 2, n // floor))
    base, rem = divmod(n, k)
    out, start = [], 0
    for i in range(k):
        size = base + (1 if i < rem else 0)
        out.append((start, start + size))
        start += size
    return out


def _plan_slices_weighted(n: int, weights: list[float], floor: int) -> list[tuple[int, int, int]] | None:
    """(start, stop, home) slices whose widths follow each endpoint's
    recorded `sigs_per_s`, so a lastingly slower card gets narrower slices
    up front instead of losing them to steals every batch. An endpoint
    with no history takes the fleet's mean rate. None when no endpoint has
    history or the batch is too narrow to split: the caller plans equal
    widths. Each home still gets two slices where its share allows, so
    steals keep absorbing a passing slowness."""
    floor = max(1, floor)
    known = [w for w in weights if w > 0]
    if not known or n < 2 * floor:
        return None
    fill = sum(known) / len(known)
    w = [wi if wi > 0 else fill for wi in weights]
    total = sum(w)
    # largest-remainder apportionment of the n lanes over the workers
    raw = [n * wi / total for wi in w]
    shares = [int(r) for r in raw]
    short = n - sum(shares)
    for i in sorted(range(len(w)), key=lambda j: raw[j] - shares[j], reverse=True)[:short]:
        shares[i] += 1
    out, start = [], 0
    for i, q in enumerate(shares):
        if q <= 0:
            continue
        parts = 2 if q >= 2 * floor else 1
        base, rem = divmod(q, parts)
        for j in range(parts):
            size = base + (1 if j < rem else 0)
            out.append((start, start + size, i))
            start += size
    return out or None


# -- the dispatcher ----------------------------------------------------------------

# Full re-dispatch rounds. Within a round the surviving workers take a
# failed slice at once; a new round starts only when every worker of the
# last one has left, so a third round already means the fleet failed
# repeatedly, and the gateway's retries and breakers own anything past it.
_MAX_ROUNDS = 3


def _dispatch(items: list, run, floor: int, sigs: bool) -> list:
    """Shard `items` over the healthy endpoints and merge each slice's
    results back at its offsets. `run(ep, sub)` runs one slice on one
    endpoint and returns len(sub) results."""
    n = len(items)
    out: list = [None] * n
    cond = threading.Condition()
    last_exc: list[BaseException] = []
    pending: list[list[int]] = []  # [start, stop, home worker]
    inflight = [0]

    for round_ in range(_MAX_ROUNDS):
        eps = [ep for ep in _fleet() if ep.breaker.allow()]
        if not eps:
            raise DevdShardError("all devd endpoint breakers are open") from (
                last_exc[-1] if last_exc else None)
        if not pending:
            if round_ > 0:  # everything finished in an earlier round
                break
            weighted = _plan_slices_weighted(n, [ep.sigs_per_s for ep in eps], floor) if sigs else None
            if weighted is not None:
                pending = [[s, e, h] for s, e, h in weighted]
            else:
                pending = [[s, e, i % len(eps)] for i, (s, e) in enumerate(_plan_slices(n, len(eps), floor))]
        else:
            # the slices left over re-home onto this round's workers
            for i, rec in enumerate(pending):
                rec[2] = i % len(eps)

        def take(idx: int):
            """A home slice first, else a steal from the tail. An empty queue
            with slices in flight is not done (one may fail and come back),
            so an idle worker waits for new work or an idle fleet."""
            with cond:
                while True:
                    if pending:
                        for j, rec in enumerate(pending):
                            if rec[2] == idx:
                                inflight[0] += 1
                                return pending.pop(j), False
                        inflight[0] += 1
                        return pending.pop(), True
                    if inflight[0] == 0:
                        return None, False
                    cond.wait(0.05)

        def worker(idx: int, ep: _Endpoint) -> None:
            while True:
                rec, stolen = take(idx)
                if rec is None:
                    return
                start, stop = rec[0], rec[1]
                sub = items[start:stop]
                with ep.mtx:
                    ep.outstanding += 1
                t0 = time.monotonic()
                try:
                    res = list(run(ep, sub))
                except Exception as exc:  # noqa: BLE001 - the endpoint's breaker counts it
                    ep.breaker.record_failure()
                    with ep.mtx:
                        ep.outstanding -= 1
                        ep.redispatches += 1
                    with cond:
                        pending.append(rec)
                        last_exc.append(exc)
                        inflight[0] -= 1
                        cond.notify_all()
                    logger.warning("devd endpoint %s failed a %d-lane slice (%s); "
                                   "re-dispatching to a healthy endpoint", ep.path, len(sub), exc)
                    return  # this endpoint sits out the rest of the batch
                ep.breaker.record_success()
                with ep.mtx:
                    ep.outstanding -= 1
                n_bytes = 0 if sigs else sum(len(x) for x in sub)
                ep.note_success(len(sub), n_bytes, time.monotonic() - t0, stolen, sigs)
                with cond:
                    out[start:stop] = res
                    inflight[0] -= 1
                    cond.notify_all()

        threads = [threading.Thread(target=worker, args=(i, ep), daemon=True, name=f"devd-shard-{i}")
                   for i, ep in enumerate(eps)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with cond:
            if not pending:
                return out
    raise DevdShardError(f"sharded dispatch exhausted {_MAX_ROUNDS} rounds with slices unserved") from (
        last_exc[-1] if last_exc else None)


# -- verify plane ------------------------------------------------------------------


def _verify_slice(ep: _Endpoint, sub: list) -> list:
    """One verify slice on one endpoint: the streamed transport at or above
    the stream floor (this endpoint's latch allowing), single-shot below
    it, as ops/devd_backend decides a batch."""
    from tendermint_tpu_torch.ops import devd_backend

    if ep.stream_ok and len(sub) >= devd_backend._stream_min():
        try:
            return list(ep.client.verify_stream(sub))
        except devd.DevdError as exc:
            if "too old" not in str(exc):
                raise
            ep.stream_ok = False
    return list(ep.client.verify_batch(sub))


def verify_batch(items) -> list[bool]:
    """devd_backend.verify_batch's contract (a bool a lane, in order) over
    the fleet."""
    items = list(items)
    if not items:
        return []
    return [bool(b) for b in _dispatch(items, _verify_slice, _verify_floor(), sigs=True)]


def verify_batch_async(items):
    """The dispatch runs on a thread now; the zero-arg resolver joins it
    and re-raises its failure."""
    items = list(items)
    if not items:
        return lambda: []
    box: dict = {}
    evt = threading.Event()

    def run() -> None:
        try:
            box["res"] = verify_batch(items)
        except BaseException as exc:  # noqa: BLE001 - re-raised by resolve
            box["exc"] = exc
        finally:
            evt.set()

    threading.Thread(target=run, daemon=True, name="devd-shard-async").start()

    def resolve():
        evt.wait()
        if "exc" in box:
            raise box["exc"]
        return box["res"]

    return resolve


# -- aggregate plane ---------------------------------------------------------------


def agg_batch(terms) -> list[tuple[int, int]]:
    """The aggregate verify's [a]P + [b]Q lanes (the daemons' `agg` op) in
    contiguous slices over the fleet, merged back at their offsets. A lane
    costs one ladder, as a signature does, so the verify floor gates it."""
    terms = [tuple(t) for t in terms]
    if not terms:
        return []
    return [tuple(p) for p in _dispatch(terms, lambda ep, sub: ep.client.agg_batch(sub),
                                        _verify_floor(), sigs=True)]


# -- hash plane --------------------------------------------------------------------


def _hash_slice(ep: _Endpoint, sub: list, mode: str) -> list:
    """One hash slice on one endpoint: streamed chunk frames when the slice
    is wide or fat enough (this endpoint's latch allowing), single-shot
    otherwise."""
    from tendermint_tpu_torch.ops import devd_backend

    total = sum(len(b) for b in sub)
    if ep.hash_stream_ok and (len(sub) >= devd_backend._stream_min()
                              or total >= devd_backend._hash_stream_min_bytes()):
        try:
            return list(ep.client.hash_stream(sub, mode=mode, chunk=devd_backend._hash_chunk(mode)))
        except devd.DevdError as exc:
            if "too old" not in str(exc):
                raise
            ep.hash_stream_ok = False
    return list(ep.client.hash_batch(sub, mode=mode))


def hash_batch(items, mode: str = "part") -> list[bytes]:
    """The leaf digests, in order, over the fleet."""
    items = [bytes(b) for b in items]
    if not items:
        return []
    return _dispatch(items, lambda ep, sub: _hash_slice(ep, sub, mode), _hash_floor(), sigs=False)


def hash_tree(items, mode: str = "part") -> tuple[list, list]:
    """(leaf digests, postorder internal nodes). The leaves, the expensive
    term (64 KB parts, tx blobs), hash over the fleet; the internal nodes
    build here from the gathered digests with the builder the daemons'
    hashers match (merkle.simple.flat_tree_from_leaf_digests), so the
    node buffer equals one daemon's tree frame. Internal nodes hash 64-byte
    digest pairs, well under 1% of the leaf work at part shapes, so
    another round trip a level would cost more than it saves."""
    from tendermint_tpu_torch.merkle.simple import flat_tree_from_leaf_digests

    digests = hash_batch(items, mode)
    return digests, flat_tree_from_leaf_digests(digests).internal_nodes()


# -- observability -----------------------------------------------------------------


def stream_stats() -> dict:
    """The verify transport's counters summed over the endpoints' clients
    (one DevdClient's key set)."""
    return _sum_stats("stream_stats")


def hash_stream_stats() -> dict:
    """The hash transport's counters summed over the endpoints' clients."""
    return _sum_stats("hash_stream_stats")


def _sum_stats(method: str) -> dict:
    out: dict = {}
    for ep in _fleet():
        for k, v in getattr(ep.client, method)().items():
            if isinstance(v, (int, float)):
                out[k] = out.get(k, 0) + v
            else:
                out.setdefault(k, v)
    return out


def endpoint_stats() -> dict[str, dict]:
    """Each endpoint's dispatch counters and breaker state (0 closed, 1
    half-open, 2 open; read without probing), by socket path."""
    out: dict[str, dict] = {}
    for ep in _fleet():
        with ep.mtx:
            d = {
                "outstanding": ep.outstanding,
                "dispatched_slices": ep.dispatched_slices,
                "stolen_slices": ep.stolen_slices,
                "redispatches": ep.redispatches,
                "sigs": ep.sigs,
                "sigs_per_s": round(ep.sigs_per_s, 1),
                "hash_bytes": ep.hash_bytes,
            }
        d["breaker_state"] = ep.breaker.state
        out[ep.path] = d
    return out


def plane_stats() -> dict:
    """The fleet's flat aggregates (a stable key set; with one socket the
    dispatch counters stay 0 and `count` is 1)."""
    vals = list(endpoint_stats().values())
    return {
        "count": len(vals),
        "healthy": sum(1 for d in vals if d["breaker_state"] != 2),
        "dispatched_slices": sum(d["dispatched_slices"] for d in vals),
        "stolen_slices": sum(d["stolen_slices"] for d in vals),
        "redispatches": sum(d["redispatches"] for d in vals),
        "outstanding": sum(d["outstanding"] for d in vals),
    }
