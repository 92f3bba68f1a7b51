"""The registry's `devd`: a gateway kernel backend that sends batches to
the device daemon (tendermint_tpu_torch/devd.py) over its socket.

Selected as `devd` in ops/gateway.KERNELS, and the default whenever a
daemon is serving (gateway.kernel_name). A process on this backend holds
no CUDA context, no kernel build and no comb pool: the daemon owns the
card, and this module is socket IPC only.

Transport policy: batches of at least TENDERMINT_DEVD_STREAM_MIN lanes
(default 256) ride the streamed protocol (binary chunk frames sent while
the daemon verifies earlier chunks, verdicts streaming back a chunk at a
time: devd.DevdClient.verify_stream_async); below it the single-shot
pickle op wins. A daemon that rejects verify_stream (an older build)
latches the single-shot path until the gateway's breaker re-closes.

The same contract as the kernel modules: verify_batch returns an
array-like of bools, verify_batch_async a zero-arg resolver. Failures
raise; the gateway's breaker plane (ops/gateway.devd_breaker) counts them.

One daemon: the multi-daemon plane (TENDERMINT_DEVD_SOCKS with several
endpoints) is not ported; the gateway refuses it when a Verifier or
Hasher is built.
"""

from __future__ import annotations

import threading

import numpy as np

from tendermint_tpu_torch import devd
from tendermint_tpu_torch.libs.envknob import env_number

_client: devd.DevdClient | None = None
_mtx = threading.Lock()
# False once the serving daemon rejected verify_stream: no doomed stream
# attempt a batch against an older daemon
_stream_ok = True


def _get_client() -> devd.DevdClient:
    global _client
    with _mtx:
        if _client is None:
            _client = devd.DevdClient()
        return _client


def _stream_min() -> int:
    return int(env_number("TENDERMINT_DEVD_STREAM_MIN", 256, cast=int))


def _use_stream(n: int) -> bool:
    return _stream_ok and n >= _stream_min()


def verify_batch(items) -> np.ndarray:
    items = list(items)
    c = _get_client()
    if _use_stream(len(items)):
        try:
            return np.asarray(c.verify_stream(items), dtype=bool)
        except devd.DevdError as exc:
            if "too old" not in str(exc):
                raise
            _latch_single_shot()
    return np.asarray(c.verify_batch(items), dtype=bool)


def verify_batch_async(items):
    items = list(items)
    c = _get_client()
    if _use_stream(len(items)):
        resolve = c.verify_stream_async(items)

        def resolve_stream() -> np.ndarray:
            try:
                return np.asarray(resolve(), dtype=bool)
            except devd.DevdError as exc:
                if "too old" not in str(exc):
                    raise
                _latch_single_shot()
                return np.asarray(c.verify_batch(items), dtype=bool)

        return resolve_stream
    resolve = c.verify_batch_async(items)
    return lambda: np.asarray(resolve(), dtype=bool)


def _latch_single_shot() -> None:
    global _stream_ok
    _stream_ok = False


def reset_stream_latches() -> None:
    """Re-arm the version-skew latches of the verify, hash and agg planes.
    The breaker's on_close hook calls it: a re-close means the daemon came
    back, possibly another build."""
    global _stream_ok, _hash_stream_ok, _agg_ok
    _stream_ok = True
    _hash_stream_ok = True
    _agg_ok = True


# -- aggregate plane ----------------------------------------------------------
#
# The aggregate-commit verify's dual-scalar-mul lanes (docs/upgrade.md): one
# "agg" op a commit, the lanes batched daemon-side through the dsm kernel
# (ops/ed25519.dsm_batch).


class AggUnsupported(Exception):
    """The serving daemon predates the agg op. The gateway takes this as
    'route unavailable': the CPU floor, with no breaker penalty (the
    daemon is healthy, just old)."""


_agg_ok = True


def _latch_agg_off() -> None:
    global _agg_ok
    _agg_ok = False


def agg_batch(terms) -> list[tuple[int, int]]:
    """Per-lane [a]P + [b]Q on the daemon's card; terms as in
    ops/ed25519.dsm_batch. Raises AggUnsupported on a daemon without the
    agg op (latched until the breaker re-closes)."""
    if not _agg_ok:
        raise AggUnsupported("daemon predates the agg op (latched)")
    terms = [tuple(t) for t in terms]
    try:
        return _get_client().agg_batch(terms)
    except devd.DevdError as exc:
        if "unknown op" not in str(exc):
            raise
        _latch_agg_off()
        raise AggUnsupported(str(exc)) from exc


def stream_stats() -> dict:
    """Client-side streamed-transport counters; Verifier.stats() folds
    them in."""
    return _get_client().stream_stats()


# -- hash plane ---------------------------------------------------------------
#
# The verify plane's transport policy plus a bytes floor: part-set batches
# are few but fat (16 x 64 KB for a 1 MB block, far under the 256-lane
# stream minimum), and it is those megabyte frames whose marshal the
# stream overlaps with the device's hashing.

_HASH_STREAM_MIN_BYTES = 1 << 18  # 256 KB

# the hash plane's own version-skew latch: a daemon may serve verify_stream
# and still reject hash_stream
_hash_stream_ok = True


def _hash_stream_min_bytes() -> int:
    return int(env_number("TENDERMINT_DEVD_HASH_STREAM_MIN_BYTES", _HASH_STREAM_MIN_BYTES, cast=int))


def _use_hash_stream(n: int, total_bytes: int) -> bool:
    return _hash_stream_ok and (n >= _stream_min() or total_bytes >= _hash_stream_min_bytes())


def _latch_hash_single_shot() -> None:
    global _hash_stream_ok
    _hash_stream_ok = False


def _hash_chunk(mode: str) -> int | None:
    """Stream chunk width in items: TENDERMINT_DEVD_HASH_CHUNK pins it;
    otherwise part mode frames 8 parts (a 512 KB frame, enough to overlap
    decode with the kernel without starving the pipeline) and leaf mode
    rides the daemon's advertised width (tx leaves are signature-lane
    sized)."""
    env = int(env_number("TENDERMINT_DEVD_HASH_CHUNK", 0, cast=int))
    if env > 0:
        return env
    return 8 if mode == "part" else None


def hash_batch(items, mode: str = "part") -> list[bytes]:
    """Daemon-side hashing (the Hasher's devd route): streamed chunk frames
    when the batch is wide or fat enough, the single-shot op otherwise.
    Digests equal crypto.hashing.ripemd160 / merkle.simple.leaf_hash."""
    items = [bytes(b) for b in items]
    c = _get_client()
    if _use_hash_stream(len(items), sum(len(b) for b in items)):
        try:
            return c.hash_stream(items, mode=mode, chunk=_hash_chunk(mode))
        except devd.DevdError as exc:
            if "too old" not in str(exc):
                raise
            _latch_hash_single_shot()
    return c.hash_batch(items, mode=mode)


def hash_tree(items, mode: str = "part") -> tuple[list, list]:
    """(leaf digests, postorder internal tree nodes): one pass hashes every
    leaf and the whole Merkle tree daemon-side, and
    merkle.simple.FlatTree.from_nodes gives the proofs with no host
    hashing."""
    items = [bytes(b) for b in items]
    c = _get_client()
    if _use_hash_stream(len(items), sum(len(b) for b in items)):
        try:
            return c.hash_stream(items, mode=mode, tree=True, chunk=_hash_chunk(mode))
        except devd.DevdError as exc:
            if "too old" not in str(exc):
                raise
            _latch_hash_single_shot()
    return c.hash_batch(items, mode=mode, tree=True)


def hash_stream_stats() -> dict:
    """Client-side hash-transport counters; Hasher.stats() folds them in
    as flat stream_* gauges."""
    return _get_client().hash_stream_stats()
