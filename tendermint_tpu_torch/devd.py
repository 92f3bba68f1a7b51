"""The device daemon: one long-lived process owns the card and serves
verify, hash and aggregate work to every other process over a unix socket.

- devd is the one process of a host that holds the card: it claims it,
  builds the kernels (`jitcache.enable`), warms the verify kernels at
  serving shapes, runs a claim-time bake-off between the comb kernel (B4)
  and the ladder (B1) and serves the faster, and then serves batches over
  a unix socket of mode 0600 until it is told to stop.
- Everything else (nodes, benches, tests) talks to it through `DevdClient`
  and `ops/devd_backend.py`, the registry's `devd`: with
  TENDERMINT_TPU_KERNEL unset and a daemon serving, a default
  `ops.gateway.Verifier` and `Hasher` route through it, so node processes
  hold no CUDA context, no kernel build and no comb pool of their own.
- devd ignores SIGTERM and SIGINT (TENDERMINT_DEVD_EXIT_ON_TERM=1 honours
  them, as tests need); the `shutdown` op stops it.
- It finds the card with a probe in a throwaway subprocess
  (`subprocess_probe`) and initialises CUDA only after the probe answered;
  while no card answers it re-probes every TENDERMINT_DEVD_RETRY_S. Its
  state is always visible through `ping`.

The wire protocol is the JAX package's (`tendermint_tpu/devd.py`) byte for
byte, so a client of either package talks to a daemon of either: a 4-byte
big-endian length and a pickled dict for requests and replies, and binary
chunk frames on the streamed ops. Requests: {"op": "ping" | "status" |
"verify" | "verify_stream" | "hash" | "hash_stream" | "agg" | "stats" |
"bench" | "shutdown", ...}. Replies: {"ok": bool, ...}, builtins only.

Streamed verify: the client sends {"op": "verify_stream", "chunks": K,
"total": N} and then K binary chunk frames (`_pack_chunk`); the daemon
answers K binary result frames, one a chunk, in order, each sent as soon
as that chunk's verdicts are back, with up to TENDERMINT_DEVD_STREAM_DEPTH
chunks on the card at once: chunk N+1 is read and decoded while chunk N is
in the kernel. A malformed chunk frame gets an error frame and the stream
closes, never a hang.

Streamed hashing: "hash_stream" carries leaf payloads the same way
(`_pack_hash_chunk`); each chunk runs through the RIPEMD-160 kernel (K1) as
it decodes and its 20-byte digests stream back in order. With "tree":
true the daemon builds the Merkle tree over all the leaf digests with the
tree kernel (K3) after the last chunk and sends one tree frame with every
internal node in postorder (merkle.simple.FlatTree's slot order), so part
set proofs cost the client no hashing.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import queue as queuelib
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

# deadline budgets parse through the defensive knob helper (stdlib only,
# so the sim daemon stays free of torch): a typo never kills a verify
from tendermint_tpu_torch.libs.envknob import env_number as _env_timeout

logger = logging.getLogger("devd")

# the same path as the JAX package's daemon: the protocol is shared
DEFAULT_SOCK = "/tmp/tendermint-devd.sock"

# streamed-chunk lane bound: a frame claiming more lanes than this is
# malformed by definition (1M lanes ~ 100MB+ of signatures)
_MAX_CHUNK_LANES = 1 << 20
# default chunk width when neither the daemon's claim-time tuning nor
# TENDERMINT_DEVD_CHUNK pinned one
DEFAULT_STREAM_CHUNK = 2048
# writer-thread reap budget (DevdClient._reap_writer)
WRITER_REAP_S = 5.0


def sock_path() -> str:
    """The daemon socket: TENDERMINT_DEVD_SOCK, else the first entry of
    TENDERMINT_DEVD_SOCKS (the multi-daemon plane's list, ops/devd_shard: its
    first entry is the primary, so a one-entry list behaves as
    TENDERMINT_DEVD_SOCK), else DEFAULT_SOCK."""
    explicit = os.environ.get("TENDERMINT_DEVD_SOCK")
    if explicit:
        return explicit
    for p in os.environ.get("TENDERMINT_DEVD_SOCKS", "").split(","):
        p = p.strip()
        if p:
            return p
    return DEFAULT_SOCK


# -- framing ------------------------------------------------------------------


def _send_frame(conn: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    conn.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("devd peer closed")
        buf += chunk
    return buf


def _recv_raw_frame(conn: socket.socket) -> bytes:
    """Length-prefixed frame WITHOUT unpickling — stream chunk/result
    frames are binary, not pickle."""
    (n,) = struct.unpack(">I", _recv_exact(conn, 4))
    if n > (1 << 30):
        raise ValueError(f"devd frame too large: {n}")
    return _recv_exact(conn, n)


def _recv_frame(conn: socket.socket):
    return pickle.loads(_recv_raw_frame(conn))


# -- stream chunk codec -------------------------------------------------------
#
# One chunk frame carries n verify lanes as four contiguous planes —
#   u32 n | pubkeys 32*n | sigs 64*n | msg_lens u32*n | msgs concat
# — so the daemon decodes with np.frombuffer over the received buffer
# (no per-item pickling on either side). Result frame payloads:
#   status u8 (0=ok) | index u32 | n u32 | verdicts u8*n
#   status u8 (1=err) | index u32 | utf-8 error message
# An error frame terminates the stream; the daemon closes the connection
# after sending it (framing past a malformed chunk is untrustworthy).

STREAM_OK = 0
STREAM_ERR = 1
# hash_stream only: the post-chunk frame carrying the tree's internal
# nodes (postorder) when the request asked for "tree": true
STREAM_TREE = 2

# hash modes: "part" = raw ripemd160 per item (Part.Hash), "leaf" =
# ripemd160 of the length-prefixed item (merkle.simple.leaf_hash)
HASH_MODES = ("part", "leaf")


def _pack_chunk(items) -> bytes:
    """items: [(pubkey32, msg, sig64)] -> one chunk frame payload.
    List-comprehension planes + one join each: the whole pack is C-loop
    work (measured ~8x a per-item append loop; pickling the same items
    costs more AND forces the daemon through per-item pickle decode)."""
    import numpy as np

    n = len(items)
    pks = [it[0] for it in items]
    msgs = [it[1] for it in items]
    sigs = [it[2] for it in items]
    if any(len(pk) != 32 for pk in pks) or any(len(s) != 64 for s in sigs):
        bad = next(
            i for i, it in enumerate(items)
            if len(it[0]) != 32 or len(it[2]) != 64
        )
        raise ValueError(
            f"stream lane {bad}: pubkey/sig must be 32/64 bytes "
            f"(got {len(items[bad][0])}/{len(items[bad][2])}); "
            "route non-ed25519 via CPU"
        )
    lens = np.fromiter(map(len, msgs), dtype="<u4", count=n)
    return b"".join((
        struct.pack("<I", n),
        b"".join(pks),
        b"".join(sigs),
        lens.tobytes(),
        b"".join(msgs),
    ))


def _unpack_chunk(payload: bytes) -> list:
    """Inverse of _pack_chunk; raises ValueError on any malformed frame.
    Plane-sliced decode: lens via ONE np.frombuffer, fixed-width planes
    via C-level bytes slicing — no per-item pickle, no memoryview churn
    (bytes(memoryview[...]) measured 6x slower than plane slicing)."""
    import numpy as np

    if len(payload) < 4:
        raise ValueError("chunk frame shorter than its lane count")
    (n,) = struct.unpack_from("<I", payload, 0)
    if n > _MAX_CHUNK_LANES:
        raise ValueError(f"chunk claims {n} lanes (max {_MAX_CHUNK_LANES})")
    off_sig = 4 + n * 32
    off_len = off_sig + n * 64
    fixed = off_len + n * 4
    if fixed > len(payload):
        raise ValueError(
            f"chunk truncated: {len(payload)} bytes < {fixed} fixed planes"
        )
    lens_arr = np.frombuffer(payload, dtype="<u4", count=n, offset=off_len)
    if fixed + int(lens_arr.sum()) != len(payload):
        raise ValueError(
            f"chunk size mismatch: {len(payload)} != "
            f"{fixed + int(lens_arr.sum())}"
        )
    pk_plane = payload[4:off_sig]
    sig_plane = payload[off_sig:off_len]
    pks = [pk_plane[i: i + 32] for i in range(0, n * 32, 32)]
    sigs = [sig_plane[i: i + 64] for i in range(0, n * 64, 64)]
    msgs, mo = [], fixed
    for ln in lens_arr.tolist():
        msgs.append(payload[mo: mo + ln])
        mo += ln
    return list(zip(pks, msgs, sigs))


def _send_result_frame(conn: socket.socket, index: int, oks) -> None:
    import numpy as np

    payload = struct.pack("<BII", STREAM_OK, index, len(oks)) + (
        np.asarray(oks, dtype=np.uint8).tobytes()
    )
    conn.sendall(struct.pack(">I", len(payload)) + payload)


# -- hash chunk codec ---------------------------------------------------------
#
# One hash chunk frame carries n leaf payloads as two contiguous planes —
#   u32 n | lens u32*n | payload bytes concatenated
# — decoded daemon-side with ONE np.frombuffer for the lengths plus
# C-level bytes slicing for the payloads (no per-item pickling). Digest
# result frames:
#   status u8 (0=ok) | index u32 | n u32 | digests 20*n
#   status u8 (1=err) | index u32 | utf-8 error message
#   status u8 (2=tree) | count u32 | internal nodes 20*count  (postorder;
#            sent once, after the last chunk's digests, iff "tree": true)
# Error semantics match the verify stream: an error frame terminates the
# stream and the daemon closes the connection.


def _pack_hash_chunk(items) -> bytes:
    """items: [bytes] -> one hash chunk frame payload (lengths plane +
    packed bytes; list-join C-loop work, mirroring _pack_chunk)."""
    import numpy as np

    n = len(items)
    lens = np.fromiter(map(len, items), dtype="<u4", count=n)
    return b"".join((struct.pack("<I", n), lens.tobytes(), b"".join(items)))


def _unpack_hash_chunk(payload: bytes) -> list:
    """Inverse of _pack_hash_chunk; raises ValueError on any malformed
    frame (same validation discipline as _unpack_chunk)."""
    import numpy as np

    if len(payload) < 4:
        raise ValueError("hash chunk frame shorter than its item count")
    (n,) = struct.unpack_from("<I", payload, 0)
    if n > _MAX_CHUNK_LANES:
        raise ValueError(f"hash chunk claims {n} items (max {_MAX_CHUNK_LANES})")
    fixed = 4 + n * 4
    if fixed > len(payload):
        raise ValueError(
            f"hash chunk truncated: {len(payload)} bytes < {fixed} length plane"
        )
    lens_arr = np.frombuffer(payload, dtype="<u4", count=n, offset=4)
    if fixed + int(lens_arr.sum()) != len(payload):
        raise ValueError(
            f"hash chunk size mismatch: {len(payload)} != "
            f"{fixed + int(lens_arr.sum())}"
        )
    items, off = [], fixed
    for ln in lens_arr.tolist():
        items.append(payload[off: off + ln])
        off += ln
    return items


def _send_digest_frame(conn: socket.socket, index: int, digests) -> None:
    payload = struct.pack("<BII", STREAM_OK, index, len(digests)) + b"".join(
        digests
    )
    conn.sendall(struct.pack(">I", len(payload)) + payload)


def _send_tree_frame(conn: socket.socket, nodes) -> None:
    payload = struct.pack("<BI", STREAM_TREE, len(nodes)) + b"".join(nodes)
    conn.sendall(struct.pack(">I", len(payload)) + payload)


def _send_error_frame(conn: socket.socket, index: int, msg: str) -> None:
    payload = struct.pack("<BI", STREAM_ERR, index) + msg.encode()
    conn.sendall(struct.pack(">I", len(payload)) + payload)


# -- server -------------------------------------------------------------------


class _DaemonState:
    def __init__(self):
        self.started = time.time()
        self.platform: str | None = None
        self.device: str | None = None  # "cuda:0" (or "cpu") once held
        self.verifier = None  # ops.gateway.Verifier once the device is held
        self.hasher = None    # hash backend once the device is held
        self.warmed: list[int] = []
        self.status = "starting"
        self.lock = threading.Lock()
        self.stop = threading.Event()
        # claim-time-tuned streamed chunk width, advertised in ping/status
        # so clients frame at the width the held device actually likes
        self.stream_chunk = int(
            os.environ.get("TENDERMINT_DEVD_CHUNK") or "0"
        ) or DEFAULT_STREAM_CHUNK
        # serving-path observability: how the streamed data plane is doing
        self.stream = {
            "streams": 0,            # verify_stream requests served
            "chunks": 0,             # chunk frames verified
            "lanes": 0,              # signatures through the stream path
            "bytes_framed": 0,       # chunk-frame payload bytes received
            "inflight": 0,           # chunks currently dispatched, unresolved
            "inflight_max": 0,       # high-water mark (proves overlap)
            "errors": 0,             # malformed/aborted streams
            "chunk_device_ms_last": 0.0,   # dispatch->verdict, last chunk
            "chunk_device_ms_avg": 0.0,    # EWMA (alpha .2) of the same
        }
        # hash-plane observability: the verify stream's gauges, "lanes" =
        # leaves hashed, plus the tree-frame and single-shot hash-op counters
        self.hash_stream = {
            "streams": 0,
            "chunks": 0,
            "lanes": 0,
            "bytes_framed": 0,
            "inflight": 0,
            "inflight_max": 0,
            "errors": 0,
            "trees": 0,              # tree frames served (proof-free part sets)
            "single_batches": 0,     # single-shot "hash" op requests
            "single_lanes": 0,
            "chunk_device_ms_last": 0.0,
            "chunk_device_ms_avg": 0.0,
        }

    def stream_stats(self) -> dict:
        with self.lock:
            return dict(self.stream)

    def hash_stream_stats(self) -> dict:
        with self.lock:
            return dict(self.hash_stream)


class _SimVerifier:
    """Transport-bench stand-in for the device kernel
    (TENDERMINT_DEVD_SIM_RATE=<sigs/s>, honored only with
    TENDERMINT_DEVD_ACCEPT_CPU=1 — never near real hardware).

    Models a pipelined device: ONE worker drains dispatches FIFO (device
    compute serializes) at the configured rate, with verify_batch_async
    returning immediately, so transport and marshal overlap is real but
    simulated compute never parallelizes with itself. Verdicts are
    structural only (32/64-byte lanes pass): this exists to measure the
    IPC data plane with device time held constant. Parity testing uses the real kernel."""

    def __init__(self, rate: float):
        self.rate = float(rate)
        self._q: queuelib.Queue = queuelib.Queue()
        self._stats = {"tpu_batches": 0, "tpu_sigs": 0, "cpu_sigs": 0}
        self._mtx = threading.Lock()
        threading.Thread(target=self._worker, daemon=True,
                         name="devd-simdev").start()

    def _worker(self) -> None:
        while True:
            n, done = self._q.get()
            time.sleep(n / self.rate)
            done.set()

    def verify_batch_async(self, items):
        items = list(items)
        oks = [len(it[0]) == 32 and len(it[2]) == 64 for it in items]
        done = threading.Event()
        self._q.put((len(items), done))
        with self._mtx:
            self._stats["tpu_batches"] += 1
            self._stats["tpu_sigs"] += len(items)

        def resolve():
            done.wait()
            return oks

        return resolve

    def verify_batch(self, items):
        return self.verify_batch_async(items)()

    def stats(self) -> dict:
        with self._mtx:
            return dict(self._stats)


class _DevdHasher:
    """The daemon's hash backend on the device it holds: RIPEMD-160 on K1
    over the port's ragged block packing (`ops/hashing`), the tree on K3
    (`ops/merkle`). hash_batch_async packs, copies and launches now and
    copies the digests back in the resolver, so the stream handler decodes
    chunk N+1 while chunk N's compressions run. On `device="cpu"` the
    kernels' plain versions run."""

    def __init__(self, device):
        self.device = device

    def hash_batch_async(self, items, mode: str):
        from tendermint_tpu_torch.ops import hashing as oh

        if mode == "leaf":
            from tendermint_tpu_torch.codec.binary import encode_bytes

            msgs = [encode_bytes(it) for it in items]
        else:
            msgs = list(items)
        if not msgs:
            return lambda: []
        out = oh.ripemd160_lanes(*oh.to_device(*oh.pack_ragged(msgs, True), self.device))

        def resolve():
            return oh.digests_to_bytes_le(out)

        return resolve

    def tree_internal_nodes(self, digests):
        """Postorder internal nodes over the leaf digests, built by K3:
        the tree frame's payload."""
        from tendermint_tpu_torch.ops import merkle as ops_merkle

        return ops_merkle.tree_nodes_from_leaf_digests(digests, self.device)[len(digests):]


class _SimHasher:
    """Transport-bench stand-in for the hash kernel (same
    TENDERMINT_DEVD_SIM_RATE gate as _SimVerifier): ONE FIFO worker
    computes REAL digests (crypto.hashing — byte-identical, so parity
    holds even in sim mode) and charges simulated device time at
    rate items/s, so streamed-vs-single-shot isolates the transport with
    device time held constant."""

    def __init__(self, rate: float):
        self.rate = float(rate)
        self._q: queuelib.Queue = queuelib.Queue()
        threading.Thread(target=self._worker, daemon=True,
                         name="devd-simhash").start()

    def _worker(self) -> None:
        from tendermint_tpu_torch.codec.binary import encode_bytes
        from tendermint_tpu_torch.crypto.hashing import ripemd160

        while True:
            items, mode, box, done = self._q.get()
            try:
                if mode == "leaf":
                    box.extend(ripemd160(encode_bytes(it)) for it in items)
                else:
                    box.extend(ripemd160(it) for it in items)
                time.sleep(len(items) / self.rate)
            finally:
                done.set()

    def hash_batch_async(self, items, mode: str):
        box: list = []
        done = threading.Event()
        self._q.put((list(items), mode, box, done))

        def resolve():
            done.wait()
            return box

        return resolve

    def tree_internal_nodes(self, digests):
        from tendermint_tpu_torch.merkle.simple import flat_tree_from_leaf_digests

        return flat_tree_from_leaf_digests(digests).internal_nodes()


def subprocess_probe(timeout_s: float) -> str | None:
    """Dial the card in a throwaway subprocess; the card's name, or None.
    The child bounds itself (`jitcache.probe_device`'s daemon-thread dial
    and a clean exit), so no process is killed while it holds the card; a
    child that somehow outlives its bound is left to finish. The daemon
    initialises CUDA in its own process only after this answered."""
    code = (
        "from tendermint_tpu_torch.jitcache import probe_device; import sys;"
        f"p = probe_device({timeout_s});"
        "print(p or '', end='');"
        "sys.exit(0 if p else 1)"
    )
    try:
        proc = subprocess.Popen(
            [sys.executable, "-c", code],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        try:
            out, _ = proc.communicate(timeout=timeout_s + 60)
        except subprocess.TimeoutExpired:
            logger.warning("probe subprocess overran; leaving it to exit on its own")
            return None
        if proc.returncode == 0:
            return (out or b"").decode() or "unknown"
        return None
    except Exception:
        logger.exception("probe subprocess failed")
        return None


def _warm_items(keys, shape: int, tag: bytes) -> list:
    """`shape` lanes signed by 64 keys in turn: at most 256 distinct
    signatures (pure Python), repeated."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    items = [
        (keys[i % 64][1], tag + b"-%d" % i, ed.sign(keys[i % 64][0], tag + b"-%d" % i))
        for i in range(min(shape, 256))
    ]
    return [items[i % len(items)] for i in range(shape)]


def _warm_keys():
    """64 distinct keys: enough to exercise the comb pool's gather path
    without minutes of keygen."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    seeds = [bytes([5, k]) + b"\x05" * 30 for k in range(64)]
    return [(s, ed.public_key(s)) for s in seeds]


def _pipelined_rate(v, batch: list, n_pipe: int = 6) -> tuple[float, float]:
    """(seconds, sigs/s) of n_pipe batches in flight at once on v."""
    t0 = time.time()
    resolvers = [v.verify_batch_async(batch) for _ in range(n_pipe)]
    for r in resolvers:
        r()
    dt = time.time() - t0
    return dt, (n_pipe * len(batch) / dt if dt > 0 else 0.0)


def _kernel_launches() -> dict[str, int]:
    """The port's kernel wrappers' launch counts in this process; empty
    while no kernel module is loaded (the sim daemon never imports torch)."""
    kernels = sys.modules.get("tendermint_tpu_torch.ops.kernels")
    return kernels.launch_counts() if kernels is not None else {}


def _claim(st: _DaemonState, platform: str, accept_cpu: bool,
           warm_shapes: tuple[int, ...]) -> None:
    """Claim the device the probe found: build the kernels, warm and bake
    off the candidate kernels, tune the chunk width, and flip `st` to
    serving."""
    t_claim = time.time()
    device = "cpu" if accept_cpu else "cuda:0"
    if not accept_cpu:
        from tendermint_tpu_torch import jitcache
        from tendermint_tpu_torch.ops import kernels  # noqa: F401 - torch's import off the build's clock

        t0 = time.time()
        built = jitcache.enable()
        logger.info("kernels built in %.1fs: %s", time.time() - t0, json.dumps(built))
    from tendermint_tpu_torch.ops import gateway

    # explicit TENDERMINT_DEVD_KERNEL wins; on the card, bake the comb
    # kernel (B4) off against the ladder (B1) and serve the winner; the
    # CPU daemon serves the plain ladder. Pinning the kernel also keeps
    # the daemon's own Verifier from routing back through the daemon.
    env_k = os.environ.get("TENDERMINT_DEVD_KERNEL", "")
    if env_k:
        candidates = [env_k]
    elif accept_cpu:
        candidates = ["f32"]
    else:
        candidates = ["comb", "f32p"]
    st.status = "warming"
    keys = _warm_keys() if warm_shapes else []
    verifier = None
    best: tuple[float, str] | None = None
    rates = {}
    for kname in candidates:
        os.environ["TENDERMINT_TPU_KERNEL"] = kname
        v = gateway.Verifier(min_tpu_batch=1, device=device)
        if not warm_shapes:
            # warming disabled (TENDERMINT_DEVD_WARM=""): serve the first
            # candidate unwarmed
            if verifier is None:
                verifier, best = v, (0.0, kname)
            continue
        for shape in warm_shapes:
            t0 = time.time()
            ok = v.verify_batch(_warm_items(keys, shape, b"warm"))
            if not all(ok):
                raise RuntimeError(f"warm verify failed: kernel {kname} shape {shape}")
            logger.info("kernel %s warmed shape %d in %.2fs", kname, shape, time.time() - t0)
            if shape not in st.warmed:
                st.warmed.append(shape)
        # the timed pass at the largest shape, after two untimed ones: the
        # comb kernel's second-sight policy may route a shape's first pass
        # to the ladder and build tables on its second, and neither may
        # land on the clock. Several batches in flight: the daemon exists
        # for serving throughput, not one batch's latency.
        full = _warm_items(keys, max(warm_shapes), b"warm")
        for _ in range(2):
            v.verify_batch(full)
        dt, rate = _pipelined_rate(v, full)
        rates[kname] = rate
        logger.info("kernel %s: %.0f sigs/s sustained (6 x %d pipelined)", kname, rate, len(full))
        if best is None or dt < best[0]:
            best, verifier = (dt, kname), v
    os.environ["TENDERMINT_TPU_KERNEL"] = best[1]
    logger.info("serving kernel: %s (bake-off %s)", best[1], json.dumps(rates))
    if not os.environ.get("TENDERMINT_DEVD_CHUNK") and warm_shapes:
        # chunk-width bake-off on the same machinery: among the widths the
        # warm set covers, the smallest whose pipelined rate is within 10%
        # of the best (finer chunks overlap decode with the kernel better)
        top = max(warm_shapes)
        widths = sorted({c for c in (1024, 2048, 4096) if c <= top} or {top})
        chunk_rates: list[tuple[int, float]] = []
        for width in widths:
            batch = _warm_items(keys, width, b"warm")
            verifier.verify_batch(batch)  # shape warm, off the clock
            chunk_rates.append((width, _pipelined_rate(verifier, batch)[1]))
            logger.info("chunk %d: %.0f sigs/s pipelined", width, chunk_rates[-1][1])
        top_rate = max(r for _, r in chunk_rates)
        st.stream_chunk = next(w for w, r in chunk_rates if r >= 0.9 * top_rate)
        logger.info("stream chunk width: %d", st.stream_chunk)
    with st.lock:
        st.platform = "cpu" if accept_cpu else "cuda"
        st.device = device
        st.verifier = verifier
        st.hasher = _DevdHasher(device)
        st.status = "serving"
    logger.info("device held (%s, %s) in %.1fs of claim; serving", platform, device,
                time.time() - t_claim)


def _device_loop(st: _DaemonState, *, accept_cpu: bool, probe_timeout: float,
                 retry_s: float, warm_shapes: tuple[int, ...]) -> None:
    """Poll for the card, claim it, warm the kernels, flip to serving."""
    sim_rate = float(os.environ.get("TENDERMINT_DEVD_SIM_RATE", "0") or 0)
    if sim_rate > 0:
        # a pure-Python daemon (serve() enforces ACCEPT_CPU): no torch, no
        # device, instant start-up, for transport benches and tests that
        # need device time held constant
        with st.lock:
            st.platform = "cpu"
            st.verifier = _SimVerifier(sim_rate)
            st.hasher = _SimHasher(sim_rate)
            st.status = "serving"
        logger.info("sim device (%.0f sigs/s); serving", sim_rate)
        return
    while not st.stop.is_set():
        st.status = "probing"
        platform = "cpu" if accept_cpu else subprocess_probe(probe_timeout)
        if platform is None:
            st.status = "waiting-for-device"
            logger.warning("no card answered; retrying in %.0fs", retry_s)
            if st.stop.wait(retry_s):
                return
            continue
        try:
            st.status = "claiming"
            _claim(st, platform, accept_cpu, warm_shapes)
            return
        except Exception:
            logger.exception("claim/warm failed; retrying in %.0fs", retry_s)
            st.status = "waiting-for-device"
            if st.stop.wait(retry_s):
                return


# one bench at a time daemon-wide (see the bench op)
_bench_gate = threading.Lock()


def _stream_depth() -> int:
    try:
        return max(2, int(os.environ.get("TENDERMINT_DEVD_STREAM_DEPTH", "4")))
    except ValueError:  # serve() validates; stay serving if it didn't run
        return 4


def _handle_verify_stream(conn: socket.socket, st: _DaemonState,
                          req: dict) -> bool:
    """Serve one verify_stream request: read chunk frames off the socket,
    dispatch each to the kernel as it decodes (verify_batch_async), and
    stream verdict frames back in order from a sender thread — so chunk
    N+1 deserializes while chunk N is in the kernel. Returns True when
    the connection stays usable (all chunks answered), False when the
    stream aborted (error frame sent; caller closes the connection)."""
    n_chunks = int(req.get("chunks", 0))
    v = st.verifier
    if v is None or n_chunks < 0:
        _send_error_frame(
            conn, 0xFFFFFFFF,
            f"device not held (status: {st.status})" if v is None
            else f"bad chunk count {n_chunks}",
        )
        return False
    with st.lock:
        st.stream["streams"] += 1
    return _serve_stream(
        conn, st, st.stream, n_chunks,
        _unpack_chunk, v.verify_batch_async, _send_result_frame,
    )


def _handle_hash_stream(conn: socket.socket, st: _DaemonState,
                        req: dict) -> bool:
    """Serve one hash_stream request on the shared stream core: hash
    chunk frames decode as they arrive, each dispatches to the batched
    RIPEMD-160 kernel, digest frames stream back per chunk in order.
    With "tree": true the leaf digests accumulate (in chunk order,
    through the sender thread) and ONE tree frame with every internal
    node follows the last digest frame — proofs come free host-side."""
    n_chunks = int(req.get("chunks", 0))
    mode = req.get("mode", "part")
    want_tree = bool(req.get("tree"))
    h = st.hasher
    if h is None or n_chunks < 0 or mode not in HASH_MODES:
        _send_error_frame(
            conn, 0xFFFFFFFF,
            f"device not held (status: {st.status})" if h is None
            else (f"bad chunk count {n_chunks}" if n_chunks < 0
                  else f"bad hash mode {mode!r}"),
        )
        return False
    with st.lock:
        st.hash_stream["streams"] += 1
    leaves: list = []
    ok = _serve_stream(
        conn, st, st.hash_stream, n_chunks,
        _unpack_hash_chunk, lambda items: h.hash_batch_async(items, mode),
        _send_digest_frame,
        on_result=(leaves.extend if want_tree else None),
    )
    if not ok:
        return False
    if want_tree:
        try:
            nodes = h.tree_internal_nodes(leaves) if len(leaves) > 1 else []
            _send_tree_frame(conn, nodes)
            with st.lock:
                st.hash_stream["trees"] += 1
        except Exception as exc:  # noqa: BLE001 — tree build/send died
            logger.exception("hash tree build failed")
            try:
                _send_error_frame(conn, n_chunks, f"{type(exc).__name__}: {exc}")
            except Exception:
                pass
            with st.lock:
                st.hash_stream["errors"] += 1
            return False
    return True


def _serve_stream(conn: socket.socket, st: _DaemonState, gauges: dict,
                  n_chunks: int, unpack, dispatch, send_result,
                  on_result=None) -> bool:
    """The chunked-stream serving core shared by verify_stream and
    hash_stream: bounded in-flight dispatch, in-order result frames from
    a sender thread, error-frame-then-close on any malformed frame.
    `gauges` is the st-owned counter dict (st.stream / st.hash_stream —
    same keys); `dispatch(items)` returns a zero-arg resolver;
    `send_result(conn, idx, result)` frames one chunk's result;
    `on_result(result)` (optional) observes results in chunk order from
    the sender thread. Returns True when the connection stays usable."""
    depth = threading.Semaphore(_stream_depth())
    results: queuelib.Queue = queuelib.Queue()
    send_ok = threading.Event()
    send_ok.set()

    def sender() -> None:
        while True:
            entry = results.get()
            if entry is None:
                return
            idx, resolver_or_err, n, t_disp = entry
            try:
                if isinstance(resolver_or_err, str):
                    _send_error_frame(conn, idx, resolver_or_err)
                    with st.lock:
                        gauges["errors"] += 1
                    send_ok.clear()
                    return
                counted = False
                res = resolver_or_err()
                dt_ms = (time.time() - t_disp) * 1000.0
                with st.lock:
                    s = gauges
                    s["inflight"] -= 1
                    counted = True
                    s["chunks"] += 1
                    s["lanes"] += n
                    s["chunk_device_ms_last"] = round(dt_ms, 3)
                    s["chunk_device_ms_avg"] = round(
                        0.8 * s["chunk_device_ms_avg"] + 0.2 * dt_ms, 3
                    ) if s["chunk_device_ms_avg"] else round(dt_ms, 3)
                if on_result is not None:
                    on_result(res)
                send_result(conn, idx, res)
            except Exception as exc:  # noqa: BLE001 — resolve/send died
                logger.exception("stream chunk %d failed", idx)
                try:
                    _send_error_frame(conn, idx, f"{type(exc).__name__}: {exc}")
                except Exception:
                    pass
                with st.lock:
                    gauges["errors"] += 1
                    # decrement exactly once per dispatched chunk: the
                    # success path may have counted it before the send
                    # died (a post-send failure must not double-count)
                    if not isinstance(resolver_or_err, str) and not counted:
                        gauges["inflight"] -= 1
                send_ok.clear()
                return
            finally:
                depth.release()

    send_thread = threading.Thread(target=sender, daemon=True,
                                   name="devd-stream-send")
    send_thread.start()

    def acquire_slot() -> bool:
        """Bound in-flight device work WITHOUT deadlocking on a dead
        sender: give up as soon as the stream is known broken."""
        while send_ok.is_set():
            if depth.acquire(timeout=0.5):
                return True
        return False

    aborted = False
    try:
        for idx in range(n_chunks):
            try:
                payload = _recv_raw_frame(conn)
                items = unpack(payload)
            except (ConnectionError, EOFError):
                aborted = True
                break
            except Exception as exc:  # noqa: BLE001 — malformed frame:
                # answer with an error frame, never hang the client
                if acquire_slot():
                    results.put((idx, f"malformed chunk: {exc}", 0, 0.0))
                aborted = True
                break
            if not acquire_slot():
                aborted = True
                break
            try:
                resolver = dispatch(items)
            except Exception as exc:  # noqa: BLE001 — dispatch failed
                results.put((idx, f"{type(exc).__name__}: {exc}", 0, 0.0))
                aborted = True
                break
            with st.lock:
                s = gauges
                s["bytes_framed"] += len(payload)
                s["inflight"] += 1
                s["inflight_max"] = max(s["inflight_max"], s["inflight"])
            results.put((idx, resolver, len(items), time.time()))
    finally:
        results.put(None)
        send_thread.join()
        # stats hygiene on abort: entries the dead sender never resolved
        # must not leave the in-flight gauge elevated forever
        leaked = 0
        while True:
            try:
                entry = results.get_nowait()
            except queuelib.Empty:
                break
            if entry is not None and not isinstance(entry[1], str):
                leaked += 1
        if leaked:
            with st.lock:
                gauges["inflight"] -= leaked
    return not aborted and send_ok.is_set()


def _handle_conn(conn: socket.socket, st: _DaemonState) -> None:
    try:
        while True:
            try:
                req = _recv_frame(conn)
            except (ConnectionError, EOFError):
                return
            op = req.get("op")

            def held_stats() -> dict:
                with st.lock:
                    return st.verifier.stats() if st.verifier else {}

            try:
                if op in ("ping", "status"):
                    rep = {
                        "ok": True,
                        "platform": st.platform,
                        "held": st.verifier is not None,
                        "status": st.status,
                        "warmed": list(st.warmed),
                        "uptime_s": round(time.time() - st.started, 1),
                        "stats": held_stats(),
                        "pid": os.getpid(),
                        "stream_chunk": st.stream_chunk,
                    }
                    if op == "status":
                        # the serving path, measurable in production:
                        # chunks in flight, bytes framed, per-chunk
                        # device latency, for both planes
                        rep["stream"] = st.stream_stats()
                        rep["hash_stream"] = st.hash_stream_stats()
                        rep["stream_depth"] = _stream_depth()
                    _send_frame(conn, rep)
                elif op == "verify_stream":
                    if not _handle_verify_stream(conn, st, req):
                        return  # stream aborted; framing is untrustworthy
                elif op == "hash_stream":
                    if not _handle_hash_stream(conn, st, req):
                        return  # stream aborted; framing is untrustworthy
                elif op == "hash":
                    # single-shot hash: one pickle frame each way — what
                    # small batches ride (stream setup loses below
                    # TENDERMINT_DEVD_STREAM_MIN) and the baseline the
                    # hash-stream bench row measures against
                    h = st.hasher
                    mode = req.get("mode", "part")
                    if h is None:
                        _send_frame(conn, {
                            "ok": False,
                            "error": f"device not held (status: {st.status})",
                        })
                    elif mode not in HASH_MODES:
                        _send_frame(conn, {
                            "ok": False, "error": f"bad hash mode {mode!r}",
                        })
                    else:
                        items = [bytes(b) for b in req.get("items", [])]
                        digests = h.hash_batch_async(items, mode)()
                        rep = {"ok": True, "digests": digests}
                        if req.get("tree"):
                            rep["nodes"] = (
                                h.tree_internal_nodes(digests)
                                if len(digests) > 1 else []
                            )
                        with st.lock:
                            st.hash_stream["single_batches"] += 1
                            st.hash_stream["single_lanes"] += len(items)
                        _send_frame(conn, rep)
                elif op == "verify":
                    v = st.verifier
                    if v is None:
                        _send_frame(conn, {
                            "ok": False,
                            "error": f"device not held (status: {st.status})",
                        })
                    else:
                        oks = v.verify_batch(req["items"])
                        _send_frame(conn, {"ok": True, "results": [bool(b) for b in oks]})
                elif op == "agg":
                    # aggregate-commit dual-scalar-mul lanes
                    # (ops/ed25519.dsm_batch, the dsm kernel on the held
                    # device; docs/upgrade.md): terms are (a, (px,py), b,
                    # (qx,qy)) Python-int tuples, the reply the per-lane
                    # affine points as Python ints
                    if st.verifier is None:
                        _send_frame(conn, {
                            "ok": False,
                            "error": f"device not held (status: {st.status})",
                        })
                    else:
                        from tendermint_tpu_torch.ops import ed25519 as _ops_ed

                        points = _ops_ed.dsm_batch(
                            [tuple(t) for t in req.get("items", [])],
                            st.device or "cpu",
                        )
                        _send_frame(conn, {"ok": True, "points": points})
                elif op == "stats":
                    if isinstance(st.hasher, _DevdHasher):
                        # the kernels' launch counts, on the daemon's log
                        # (the reply keeps the JAX package's keys)
                        logger.info("kernel launches %s", json.dumps(_kernel_launches()))
                    _send_frame(conn, {
                        "ok": True,
                        "stats": held_stats(),
                        "stream": st.stream_stats(),
                        "hash_stream": st.hash_stream_stats(),
                    })
                elif op == "bench":
                    # In-daemon pipelined throughput measurement: the one
                    # number free of ALL client-side confounds (IPC
                    # marshal, socket hops, client thread scheduling) —
                    # how fast the held device verifies when its queue is
                    # kept full. Items are synthesized daemon-side with
                    # the warm-set key-reuse shape (64 keys cycled, a
                    # real commit's profile). MAINTENANCE op: it queues
                    # ~n_batches*batch lanes on the shared serving
                    # verifier, so concurrent verify traffic both stalls
                    # and skews it — benches are serialized against each
                    # other here, and callers should run it on an
                    # otherwise idle daemon.
                    v = st.verifier
                    if v is None:
                        _send_frame(conn, {
                            "ok": False,
                            "error": f"device not held (status: {st.status})",
                        })
                    elif not _bench_gate.acquire(blocking=False):
                        _send_frame(conn, {
                            "ok": False,
                            "error": "bench already running (serialized)",
                        })
                    else:
                        try:
                            batch = int(req.get("batch", 8192))
                            n_batches = int(req.get("n_batches", 8))
                            from tendermint_tpu_torch.crypto import ed25519 as _ed

                            seeds = [
                                bytes([5, k]) + b"\x05" * 30 for k in range(64)
                            ]
                            base_items = [
                                (
                                    _ed.public_key(seeds[i % 64]),
                                    b"dbench-%d" % i,
                                    _ed.sign(seeds[i % 64], b"dbench-%d" % i),
                                )
                                for i in range(min(batch, 256))
                            ]
                            items = [
                                base_items[i % len(base_items)]
                                for i in range(batch)
                            ]
                            for _ in range(2):  # tables/compile off-clock
                                v.verify_batch(items)
                            t0 = time.time()
                            resolvers = [
                                v.verify_batch_async(items)
                                for _ in range(n_batches)
                            ]
                            # resolve EVERY batch before stopping the
                            # clock — short-circuiting on a failed batch
                            # would leave device work in flight and
                            # inflate the rate
                            results = [r() for r in resolvers]
                            dt = time.time() - t0
                            all_ok = all(all(res) for res in results)
                        finally:
                            _bench_gate.release()
                        _send_frame(conn, {
                            "ok": True,
                            "sigs_per_sec": (
                                batch * n_batches / dt if dt > 0 else 0.0
                            ),
                            "elapsed_s": dt,
                            "batch": batch,
                            "n_batches": n_batches,
                            "all_ok": all_ok,
                            "kernel": os.environ.get("TENDERMINT_TPU_KERNEL", ""),
                        })
                elif op == "shutdown":
                    _send_frame(conn, {"ok": True})
                    st.stop.set()
                    return
                else:
                    _send_frame(conn, {"ok": False, "error": f"unknown op {op!r}"})
            except Exception as exc:  # noqa: BLE001 — report, keep serving
                logger.exception("request failed")
                try:
                    _send_frame(conn, {"ok": False, "error": f"{type(exc).__name__}: {exc}"})
                except Exception:
                    return
    finally:
        try:
            conn.close()
        except Exception:
            pass


def serve(path: str | None = None) -> None:
    """Run the daemon (blocking). Env knobs:
    TENDERMINT_DEVD_SOCK          socket path (default /tmp/tendermint-devd.sock)
    TENDERMINT_DEVD_ACCEPT_CPU=1  serve the CPU backend (the kernels' plain
                                  versions; tests / no card)
    TENDERMINT_DEVD_WARM          comma-separated warm shapes (default 1024,4096,8192)
    TENDERMINT_DEVD_KERNEL        pin the served kernel (skips the claim-time
                                  comb-vs-f32p bake-off; any gateway.KERNELS
                                  name except "devd")
    TENDERMINT_DEVD_RETRY_S       device re-probe interval (default 120)
    TENDERMINT_DEVD_EXIT_ON_TERM=1  honor SIGTERM (default: ignore it)
    TENDERMINT_DEVD_CHUNK         pin the streamed chunk width (skips the
                                  claim-time width bake-off; clients pin
                                  their framing with the same var)
    TENDERMINT_DEVD_STREAM_DEPTH  max chunks in flight per stream (default 4)
    TENDERMINT_DEVD_SIM_RATE      serve a SIMULATED device at this sigs/s —
                                  transport benches only; requires ACCEPT_CPU=1
    """
    path = path or sock_path()
    env_k = os.environ.get("TENDERMINT_DEVD_KERNEL", "")
    if env_k:
        from tendermint_tpu_torch.ops.gateway import KERNELS

        # fail fast at startup: inside the claim loop a bad name would be
        # swallowed by the retry handler and the daemon would spin forever
        if env_k not in KERNELS or env_k == "devd":
            raise SystemExit(
                f"TENDERMINT_DEVD_KERNEL={env_k!r}: expected one of "
                f"{sorted(k for k in KERNELS if k != 'devd')}"
            )
    accept_cpu = os.environ.get("TENDERMINT_DEVD_ACCEPT_CPU", "") == "1"
    # fail fast at startup on the remaining env knobs too: inside the
    # device thread a raise would be swallowed (threading ignores
    # SystemExit off the main thread) and the daemon would sit in
    # "starting" forever
    if float(os.environ.get("TENDERMINT_DEVD_SIM_RATE", "0") or 0) > 0 \
            and not accept_cpu:
        raise SystemExit(
            "TENDERMINT_DEVD_SIM_RATE requires TENDERMINT_DEVD_ACCEPT_CPU=1 "
            "(the sim verifier must never stand in front of real hardware)"
        )
    depth_env = os.environ.get("TENDERMINT_DEVD_STREAM_DEPTH", "")
    if depth_env:
        try:
            int(depth_env)
        except ValueError:
            raise SystemExit(
                f"TENDERMINT_DEVD_STREAM_DEPTH={depth_env!r}: expected an int"
            ) from None
    warm = tuple(
        int(x) for x in os.environ.get(
            "TENDERMINT_DEVD_WARM", "1024,4096,8192"
        ).split(",") if x
    )
    retry_s = float(os.environ.get("TENDERMINT_DEVD_RETRY_S", "120"))

    if os.environ.get("TENDERMINT_DEVD_EXIT_ON_TERM", "") != "1":
        def _ignore(signum, frame):
            logger.warning(
                "ignoring signal %d: the device owner stops on the shutdown "
                "op (or TENDERMINT_DEVD_EXIT_ON_TERM=1)",
                signum,
            )
        signal.signal(signal.SIGTERM, _ignore)
        signal.signal(signal.SIGINT, _ignore)

    # Bind first: refuse to start a second daemon on a live socket.
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    if os.path.exists(path):
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        probe.settimeout(1.0)
        try:
            probe.connect(path)
            raise SystemExit(f"devd already serving on {path}")
        except (ConnectionRefusedError, socket.timeout, FileNotFoundError):
            os.unlink(path)  # stale socket from a dead daemon
        finally:
            probe.close()
    srv.bind(path)
    os.chmod(path, 0o600)
    srv.listen(64)
    srv.settimeout(1.0)

    st = _DaemonState()
    threading.Thread(
        target=_device_loop, args=(st,),
        kwargs=dict(accept_cpu=accept_cpu, probe_timeout=60.0,
                    retry_s=retry_s, warm_shapes=warm),
        daemon=True, name="devd-device",
    ).start()

    logger.info("devd listening on %s (pid %d)", path, os.getpid())
    try:
        while not st.stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            threading.Thread(
                target=_handle_conn, args=(conn, st), daemon=True
            ).start()
    finally:
        srv.close()
        try:
            os.unlink(path)
        except OSError:
            pass
        logger.info("devd stopped")


# -- client -------------------------------------------------------------------


class DevdError(Exception):
    pass


# Fault-injection point: when set, every NEW client connection passes
# through the wrapper (a socket-like proxy that injects scheduled faults).
# Production leaves it None; a chaos harness installs it so the unmodified
# client and gateway paths are what gets exercised.
_socket_wrapper = None


def set_socket_wrapper(wrapper) -> None:
    """Install (or clear, with None) the connection-factory wrapper
    applied by DevdClient._fresh."""
    global _socket_wrapper
    _socket_wrapper = wrapper


# -- client latency distributions ----------------------------------------------
#
# The counters say how much rode each transport; these histograms say how
# long it took (docs/observability.md). Process-wide (the devd client is
# process-global), labeled by plane: op="verify" | "hash" | "agg".

_hist_cache: dict = {}


def _latency_hists():
    """(per-chunk stream wait, single-shot round trip) histograms off
    the CURRENT default telemetry registry — re-fetched when tests swap
    the registry, cached otherwise so the hot path pays a dict probe."""
    from tendermint_tpu_torch.libs import telemetry

    reg = telemetry.default_registry()
    if _hist_cache.get("reg") is not reg:
        _hist_cache["chunk"] = reg.histogram(
            "devd_stream_chunk_seconds",
            "per-chunk result wait on an active devd stream (writer "
            "overlap means this is the residual, not the full RTT)",
            labelnames=("op",),
        )
        _hist_cache["single"] = reg.histogram(
            "devd_single_shot_seconds",
            "single-shot devd pickle round trip (whole batch)",
            labelnames=("op",),
        )
        _hist_cache["reg"] = reg
    return _hist_cache["chunk"], _hist_cache["single"]


class DevdClient:
    """Client for the device daemon. verify_batch is synchronous;
    verify_batch_async sends on a pooled connection and returns a
    zero-arg resolver (the gateway's pipelining contract) — concurrent
    in-flight requests each ride their own connection, and the daemon
    serves connections in parallel, so the device queue stays full.

    verify_stream / verify_stream_async ride the chunked streaming
    protocol (module docstring): a writer thread packs and sends
    fixed-width chunk frames while the daemon verifies earlier chunks,
    and verdicts stream back per chunk — host marshal, IPC, and device
    compute all overlap instead of paying one monolithic round trip.

    A request that fails on a POOLED connection retries once on a fresh
    one: pooled sockets go stale whenever the daemon restarts, and a
    client must survive that without its caller seeing the flap.

    Deadline budgets: the flat io_timeout is only the default for three
    per-phase budgets — `connect` (dial), `claim`
    (control-plane ops: ping/status/stats/shutdown and stream headers),
    and `stream` (each frame read/write on an active stream). Data-plane
    single-shot verify/hash keep the full io budget (a first batch may
    legitimately sit behind a minutes-long kernel compile); everything
    else can and should fail faster. Env overrides:
    TENDERMINT_DEVD_CONNECT_TIMEOUT_S / _CLAIM_TIMEOUT_S /
    _STREAM_TIMEOUT_S."""

    def __init__(self, path: str | None = None,
                 connect_timeout: float | None = None,
                 io_timeout: float = 300.0, claim_timeout: float | None = None,
                 stream_timeout: float | None = None):
        self.path = path or sock_path()
        # env tunes only the DEFAULTS — an explicit constructor arg
        # always wins (devd.available builds its probe client with
        # connect_timeout=1.0 precisely so the breaker's inline health
        # probe stays bounded ~1 s; an operator's env knob must not
        # silently un-bound the verify hot path through it)
        self.connect_timeout = connect_timeout if connect_timeout is not None \
            else _env_timeout("TENDERMINT_DEVD_CONNECT_TIMEOUT_S", 2.0)
        self.io_timeout = io_timeout
        self.claim_timeout = claim_timeout if claim_timeout is not None \
            else _env_timeout("TENDERMINT_DEVD_CLAIM_TIMEOUT_S", io_timeout)
        self.stream_timeout = stream_timeout if stream_timeout is not None \
            else _env_timeout("TENDERMINT_DEVD_STREAM_TIMEOUT_S", io_timeout)
        self._pool: list[socket.socket] = []
        self._mtx = threading.Lock()
        self._adv_chunk: int | None = None  # daemon-advertised width
        # reconnects is the TOTAL; the labeled pair splits it by where
        # the stale socket surfaced — at first use of a pooled conn
        # (reconnects_connect: daemon restarted between requests) vs
        # mid-exchange (reconnects_midstream: it died under an active
        # request/stream) — so chaos tests can assert WHICH path fired
        self._stream_stats = {
            "stream_batches": 0, "stream_chunks_out": 0,
            "stream_lanes": 0, "stream_bytes_out": 0, "reconnects": 0,
            "reconnects_connect": 0, "reconnects_midstream": 0,
            "writer_abandoned": 0,
        }
        # hash-plane counters, same key shape (consumers prefix; the
        # gateway Hasher folds these in as flat stream_* gauges)
        self._hash_stats = {
            "stream_batches": 0, "stream_chunks_out": 0,
            "stream_lanes": 0, "stream_bytes_out": 0, "reconnects": 0,
            "reconnects_connect": 0, "reconnects_midstream": 0,
            "writer_abandoned": 0,
            "stream_trees": 0, "single_batches": 0, "single_lanes": 0,
        }

    def _note_reconnect(self, stats: dict, where: str) -> None:
        with self._mtx:
            stats["reconnects"] += 1
            stats[f"reconnects_{where}"] += 1

    def _acquire(self) -> tuple[socket.socket, bool]:
        """(connection, was_pooled). Pooled sockets may be stale — the
        caller retries once on a fresh one when was_pooled."""
        with self._mtx:
            if self._pool:
                return self._pool.pop(), True
        return self._fresh(), False

    def _release(self, conn: socket.socket) -> None:
        with self._mtx:
            self._pool.append(conn)

    def _discard(self, conn: socket.socket) -> None:
        try:
            conn.close()
        except Exception:
            pass

    def _kill(self, conn) -> None:
        """shutdown THEN discard: a conn being abandoned mid-stream may
        have the writer thread blocked in sendall on it, and close()
        alone never wakes a syscall pinned on the same fd — shutdown
        fails it fast, so the follow-up _reap_writer join returns
        promptly instead of burning the full reap budget."""
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except Exception:  # noqa: BLE001 — already dead is fine
            pass
        self._discard(conn)

    def request(self, obj, timeout: float | None = None) -> dict:
        """One pickle round trip. The read/write budget defaults to the
        CLAIM deadline (control-plane ops fail fast); data-plane ops
        that may sit behind a kernel compile pass the io budget
        explicitly (verify_batch / hash_batch)."""
        conn, pooled = self._acquire()
        while True:
            conn.settimeout(timeout if timeout is not None
                            else self.claim_timeout)
            try:
                _send_frame(conn, obj)
                rep = _recv_frame(conn)
            except Exception as exc:
                self._discard(conn)
                # retry ONLY plausibly-stale pooled sockets (the daemon
                # restarted between requests): ConnectionError/EOF. A
                # timeout is a live-but-slow daemon — resubmitting the
                # same work would double device load exactly when it is
                # saturated (and break at-most-once for non-verify ops).
                if pooled and isinstance(exc, (ConnectionError, EOFError)):
                    self._note_reconnect(self._stream_stats, "connect")
                    conn, pooled = self._fresh(), False
                    continue
                raise
            conn.settimeout(self.io_timeout)
            self._release(conn)
            return rep

    def _fresh(self) -> socket.socket:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(self.connect_timeout)
        conn.connect(self.path)
        conn.settimeout(self.io_timeout)
        if _socket_wrapper is not None:  # a chaos harness's proxy
            conn = _socket_wrapper(conn)
        return conn

    def ping(self, timeout: float = 5.0) -> dict:
        rep = self.request({"op": "ping"}, timeout=timeout)
        if not rep.get("ok"):
            raise DevdError(rep.get("error", "ping failed"))
        return rep

    def verify_batch(self, items) -> list[bool]:
        t0 = time.perf_counter()
        rep = self.request({"op": "verify", "items": list(items)},
                           timeout=self.io_timeout)
        _latency_hists()[1].labels(op="verify").observe(
            time.perf_counter() - t0
        )
        if not rep.get("ok"):
            raise DevdError(rep.get("error", "verify failed"))
        return rep["results"]

    def agg_batch(self, terms) -> list[tuple[int, int]]:
        """Aggregate-commit dual-scalar-mul lanes (the 'agg' op): terms
        as in ops/ed25519.dsm_batch; returns per-lane affine points. A
        pre-agg daemon replies 'unknown op' -> DevdError, which
        ops/devd_backend latches into its CPU-floor fallback."""
        t0 = time.perf_counter()
        rep = self.request({"op": "agg", "items": [tuple(t) for t in terms]},
                           timeout=self.io_timeout)
        _latency_hists()[1].labels(op="agg").observe(
            time.perf_counter() - t0
        )
        if not rep.get("ok"):
            raise DevdError(rep.get("error", "agg failed"))
        return [tuple(p) for p in rep["points"]]

    def verify_batch_async(self, items):
        items = list(items)
        conn, pooled = self._acquire()
        try:
            _send_frame(conn, {"op": "verify", "items": items})
        except Exception as exc:
            self._discard(conn)
            if not (pooled and isinstance(exc, (ConnectionError, EOFError))):
                raise
            self._note_reconnect(self._stream_stats, "connect")
            conn, pooled = self._fresh(), False
            try:
                _send_frame(conn, {"op": "verify", "items": items})
            except Exception:
                self._discard(conn)
                raise

        def resolve() -> list[bool]:
            try:
                rep = _recv_frame(conn)
            except Exception as exc:
                self._discard(conn)
                if pooled and isinstance(exc, (ConnectionError, EOFError)):
                    # stale pooled socket: the daemon restarted between
                    # requests — the whole batch retries on a fresh conn
                    # (timeouts deliberately do NOT retry: see request())
                    self._note_reconnect(self._stream_stats, "midstream")
                    return self.verify_batch(items)
                raise
            self._release(conn)
            if not rep.get("ok"):
                raise DevdError(rep.get("error", "verify failed"))
            return rep["results"]

        return resolve

    # -- streaming transport ------------------------------------------------

    def stream_chunk(self) -> int:
        """Chunk width for streamed submission: TENDERMINT_DEVD_CHUNK
        pins it; otherwise the daemon's claim-time-tuned width (one ping,
        cached for the client lifetime); DEFAULT_STREAM_CHUNK failing
        both."""
        try:
            env = int(os.environ.get("TENDERMINT_DEVD_CHUNK", "0") or 0)
        except ValueError:  # a typo'd env var must not kill the verify
            # hot path (gateway would latch the CPU fallback); the
            # daemon-side serve() validation is the loud failure
            logger.warning("ignoring malformed TENDERMINT_DEVD_CHUNK")
            env = 0
        if env > 0:
            return env
        if self._adv_chunk is None:
            try:
                self._adv_chunk = int(
                    self.ping().get("stream_chunk", 0)
                ) or DEFAULT_STREAM_CHUNK
            except Exception:  # noqa: BLE001 — daemon unreachable: the
                # stream attempt itself will surface the real error
                return DEFAULT_STREAM_CHUNK
        return self._adv_chunk

    def verify_stream(self, items, chunk: int | None = None) -> list[bool]:
        """Streamed verify_batch: same verdicts, pipelined transport."""
        return self.verify_stream_async(items, chunk=chunk)()

    def verify_stream_async(self, items, chunk: int | None = None):
        """Submit `items` as fixed-width chunk frames on one connection;
        a writer thread streams frames while the daemon verifies, and
        the returned zero-arg resolver collects per-chunk verdicts in
        order. A failed attempt on a pooled connection retries once on a
        fresh one (daemon restarts must not surface to the caller)."""
        items = list(items)
        if not items:
            return lambda: []
        width = max(1, chunk or self.stream_chunk())
        spans = [items[i: i + width] for i in range(0, len(items), width)]
        header = {
            "op": "verify_stream",
            "chunks": len(spans),
            "total": sum(len(s) for s in spans),
        }
        return self._stream_resolver(
            spans, header, _pack_chunk, self._stream_stats,
            lambda conn, writer, werr: self._collect_stream(
                conn, writer, werr, len(spans)
            ),
        )

    def _stream_resolver(self, spans, header: dict, pack, stats, collect):
        """Open a chunked stream NOW and return the zero-arg resolver
        with the shared reconnect-once error triage (verify and hash
        planes): a DevdError is final; a writer error that is not an
        OSError is a deterministic client-side marshal failure (a retry
        would fail identically — surface the real cause); a transport
        failure on a POOLED connection retries once on a fresh one
        (daemon restarts must not surface to the caller)."""
        first = self._start_stream(spans, False, header, pack, stats)

        def resolve():
            conn, pooled, writer, werr = first
            try:
                return collect(conn, writer, werr)
            except DevdError:
                self._kill(conn)
                self._reap_writer(writer, stats, conn)
                raise
            except Exception as exc:
                self._kill(conn)
                self._reap_writer(writer, stats, conn)
                if werr and not isinstance(werr[0], OSError):
                    raise werr[0] from exc
                if not (pooled and isinstance(exc, (ConnectionError, EOFError))):
                    raise
                self._note_reconnect(stats, "midstream")
                conn2, _, writer2, werr2 = self._start_stream(
                    spans, True, header, pack, stats
                )
                try:
                    return collect(conn2, writer2, werr2)
                except Exception:
                    self._kill(conn2)
                    self._reap_writer(writer2, stats, conn2)
                    raise

        return resolve

    def _reap_writer(self, writer, stats: dict, conn) -> bool:
        """Join the writer thread under a bounded budget. An overrun is
        abandonment: it counts as a fault (`writer_abandoned`, surfaced
        through the stream_* stats), and the connection is closed, which
        both unwedges the stuck sendall (it fails fast on the dead fd)
        and keeps the socket out of the pool. Returns True when the
        writer had to be abandoned."""
        writer.join(timeout=WRITER_REAP_S)
        if not writer.is_alive():
            return False
        with self._mtx:
            stats["writer_abandoned"] += 1
        logger.warning(
            "stream writer abandoned after join timeout; closing its conn"
        )
        self._kill(conn)  # shutdown-then-close: unwedges a pinned sendall
        return True

    def _start_stream(self, spans, fresh: bool, header: dict, pack, stats):
        """Open one chunked stream (verify or hash plane): send the
        pickle header, then launch the writer thread that packs and
        streams chunk frames. `stats` is the client counter dict the
        writer notes its totals into (shared key shape)."""
        if fresh:
            conn, pooled = self._fresh(), False
        else:
            conn, pooled = self._acquire()
        try:
            conn.settimeout(self.claim_timeout)
            _send_frame(conn, header)
            # per-frame budget for the active stream: each chunk write
            # and each result read must make progress inside this window
            # (a stalled daemon surfaces as socket.timeout here instead
            # of sitting on the full flat io budget)
            conn.settimeout(self.stream_timeout)
        except Exception as exc:
            self._discard(conn)
            if not (pooled and isinstance(exc, (ConnectionError, EOFError))):
                raise
            self._note_reconnect(stats, "connect")
            return self._start_stream(spans, True, header, pack, stats)
        werr: list = []

        def write() -> None:
            # pack-as-you-send: marshaling chunk N+1 overlaps the
            # daemon's decode+verify of chunk N (and the resolver's
            # reads) — the client never builds the whole wire image
            try:
                sent_chunks = sent_bytes = sent_lanes = 0
                for span in spans:
                    payload = pack(span)
                    conn.sendall(struct.pack(">I", len(payload)) + payload)
                    sent_chunks += 1
                    sent_bytes += len(payload)
                    sent_lanes += len(span)
                with self._mtx:
                    stats["stream_batches"] += 1
                    stats["stream_chunks_out"] += sent_chunks
                    stats["stream_bytes_out"] += sent_bytes
                    stats["stream_lanes"] += sent_lanes
            except Exception as exc:  # noqa: BLE001 — surfaced by resolver
                werr.append(exc)
                # fail FAST on both sides: without this the daemon would
                # block reading the chunks that will never come and the
                # resolver would block on verdicts until io_timeout
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

        writer = threading.Thread(target=write, daemon=True,
                                  name="devd-stream-write")
        writer.start()
        return conn, pooled, writer, werr

    def _collect_stream(self, conn, writer, werr, n_chunks: int) -> list[bool]:
        import numpy as np

        chunk_hist = _latency_hists()[0].labels(op="verify")
        out: list[bool] = []
        for want in range(n_chunks):
            t0 = time.perf_counter()
            payload = _recv_raw_frame(conn)
            chunk_hist.observe(time.perf_counter() - t0)
            status, idx = struct.unpack_from("<BI", payload, 0)
            if status == STREAM_ERR:
                # the resolver's DevdError handler discards the conn and
                # reaps the writer (abandonment-counted) — no join here
                raise DevdError(
                    f"stream chunk {idx}: {payload[5:].decode(errors='replace')}"
                )
            if status not in (STREAM_OK, STREAM_ERR):
                if status == 0x80:  # a PICKLE frame: the daemon answered
                    # the verify_stream header with {"ok": False, ...} —
                    # it predates the streaming protocol. The marker
                    # below is what devd_backend latches single-shot on;
                    # any OTHER desync must NOT latch (it would silently
                    # disable the fast path over a transient bug).
                    raise DevdError("daemon too old for verify_stream")
                raise DevdError(
                    f"bad stream result frame (status {status}, chunk {want})"
                )
            if idx != want:
                raise DevdError(
                    f"stream result desync: got chunk {idx}, want {want}"
                )
            (n,) = struct.unpack_from("<I", payload, 5)
            if len(payload) != 9 + n:
                raise DevdError(f"result frame size mismatch for chunk {idx}")
            out.extend(
                np.frombuffer(payload, dtype=np.uint8, offset=9)
                .astype(bool).tolist()
            )
        abandoned = self._reap_writer(writer, self._stream_stats, conn)
        if werr:
            # results complete but the writer died — impossible unless
            # the daemon answered chunks it never received; be loud
            raise DevdError(f"stream writer failed: {werr[0]}")
        if not abandoned:
            conn.settimeout(self.io_timeout)  # back to pickle mode
            self._release(conn)
        return out

    # -- streamed hash transport --------------------------------------------

    def hash_batch(self, items, mode: str = "part", tree: bool = False):
        """Single-shot daemon hashing: one pickle frame each way. Digest
        list; with tree=True, (digests, postorder internal nodes)."""
        t0 = time.perf_counter()
        rep = self.request({
            "op": "hash", "mode": mode,
            "items": [bytes(b) for b in items], "tree": bool(tree),
        }, timeout=self.io_timeout)
        _latency_hists()[1].labels(op="hash").observe(
            time.perf_counter() - t0
        )
        if not rep.get("ok"):
            raise DevdError(rep.get("error", "hash failed"))
        with self._mtx:
            self._hash_stats["single_batches"] += 1
            self._hash_stats["single_lanes"] += len(rep["digests"])
        if tree:
            return rep["digests"], rep.get("nodes", [])
        return rep["digests"]

    def hash_stream(self, items, mode: str = "part", tree: bool = False,
                    chunk: int | None = None):
        """Streamed hash_batch: same digests, pipelined transport."""
        return self.hash_stream_async(items, mode=mode, tree=tree,
                                      chunk=chunk)()

    def hash_stream_async(self, items, mode: str = "part",
                          tree: bool = False, chunk: int | None = None):
        """Submit leaf payloads as chunked hash frames on one connection;
        the returned resolver collects per-chunk digest frames in order
        (plus the tree frame when tree=True → (digests, internal_nodes)).
        Reconnect-once semantics match verify_stream_async: a failed
        attempt on a pooled connection retries on a fresh one."""
        items = [bytes(b) for b in items]
        if not items:
            return (lambda: ([], [])) if tree else (lambda: [])
        width = max(1, chunk or self.stream_chunk())
        spans = [items[i: i + width] for i in range(0, len(items), width)]
        header = {
            "op": "hash_stream",
            "chunks": len(spans),
            "total": len(items),
            "mode": mode,
            "tree": bool(tree),
        }
        return self._stream_resolver(
            spans, header, _pack_hash_chunk, self._hash_stats,
            lambda conn, writer, werr: self._collect_hash_stream(
                conn, writer, werr, len(spans), tree
            ),
        )

    def _collect_hash_stream(self, conn, writer, werr, n_chunks: int,
                             want_tree: bool):
        chunk_hist = _latency_hists()[0].labels(op="hash")
        digests: list[bytes] = []
        for want in range(n_chunks):
            t0 = time.perf_counter()
            payload = _recv_raw_frame(conn)
            chunk_hist.observe(time.perf_counter() - t0)
            status, idx = struct.unpack_from("<BI", payload, 0)
            if status == STREAM_ERR:
                # resolver discards + reaps (see _collect_stream)
                raise DevdError(
                    f"hash stream chunk {idx}: "
                    f"{payload[5:].decode(errors='replace')}"
                )
            if status != STREAM_OK:
                if status == 0x80:  # pickle frame: an older daemon answered
                    # the header with {"ok": False, "error": "unknown op"}
                    raise DevdError("daemon too old for hash_stream")
                raise DevdError(
                    f"bad hash result frame (status {status}, chunk {want})"
                )
            if idx != want:
                raise DevdError(
                    f"hash stream desync: got chunk {idx}, want {want}"
                )
            (n,) = struct.unpack_from("<I", payload, 5)
            if len(payload) != 9 + 20 * n:
                raise DevdError(f"digest frame size mismatch for chunk {idx}")
            digests.extend(
                payload[9 + 20 * i: 29 + 20 * i] for i in range(n)
            )
        nodes: list[bytes] | None = None
        if want_tree:
            payload = _recv_raw_frame(conn)
            status, cnt = struct.unpack_from("<BI", payload, 0)
            if status == STREAM_ERR:
                raise DevdError(
                    f"hash stream tree: {payload[5:].decode(errors='replace')}"
                )
            if status != STREAM_TREE or len(payload) != 5 + 20 * cnt:
                raise DevdError(f"bad tree frame (status {status})")
            nodes = [payload[5 + 20 * i: 25 + 20 * i] for i in range(cnt)]
            with self._mtx:
                self._hash_stats["stream_trees"] += 1
        abandoned = self._reap_writer(writer, self._hash_stats, conn)
        if werr:
            raise DevdError(f"hash stream writer failed: {werr[0]}")
        if not abandoned:
            conn.settimeout(self.io_timeout)  # back to pickle mode
            self._release(conn)
        return (digests, nodes) if want_tree else digests

    def hash_stream_stats(self) -> dict:
        """Client-side hash-transport counters (ops/gateway.Hasher folds
        these in as flat stream_* gauges for the metrics RPC)."""
        with self._mtx:
            return dict(self._hash_stats)

    def stream_stats(self) -> dict:
        """Client-side streamed-transport counters (Verifier.stats()
        merges these under \"stream\" for the devd backend)."""
        with self._mtx:
            return dict(self._stream_stats)

    def status(self, timeout: float = 5.0) -> dict:
        """Ping plus the daemon's streamed-chunk observability counters."""
        rep = self.request({"op": "status"}, timeout=timeout)
        if not rep.get("ok"):
            raise DevdError(rep.get("error", "status failed"))
        return rep

    def stats(self) -> dict:
        rep = self.request({"op": "stats"})
        if not rep.get("ok"):
            raise DevdError(rep.get("error", "stats failed"))
        return rep["stats"]

    def bench(self, batch: int = 8192, n_batches: int = 8,
              timeout: float = 600.0) -> dict:
        """In-daemon pipelined device rate (see the bench op)."""
        rep = self.request(
            {"op": "bench", "batch": batch, "n_batches": n_batches},
            timeout=timeout,
        )
        if not rep.get("ok"):
            raise DevdError(rep.get("error", "bench failed"))
        return rep

    def shutdown(self) -> None:
        self.request({"op": "shutdown"})

    def close(self) -> None:
        with self._mtx:
            pool, self._pool = self._pool, []
        for c in pool:
            self._discard(c)


# per-path probe cache: one entry per socket path
_avail_cache: dict[str, tuple[float, dict | None]] = {}
_avail_mtx = threading.Lock()
_AVAIL_TTL = 15.0


def bust_avail_cache(path: str | None = None) -> None:
    """Force the next available() to ping fresh — failure paths must not
    trust a TTL-cached 'held' from a daemon that just died. No-arg busts
    every endpoint's entry; a path busts just that endpoint's."""
    with _avail_mtx:
        if path is None:
            _avail_cache.clear()
        else:
            _avail_cache.pop(path, None)


def available(timeout: float = 1.0, path: str | None = None) -> dict | None:
    """Liveness probe: the daemon's ping reply if a daemon is serving AND
    holds the device, else None. Never raises. Positive AND negative
    results are cached ~15s per socket path — the gateway consults this
    per batch on its kernel-selection default, and a ping (or a failed
    connect) per batch would dominate small-batch latency. `path` probes
    another socket; default is sock_path()."""
    path = path or sock_path()
    now = time.monotonic()
    with _avail_mtx:
        hit = _avail_cache.get(path)
        if hit is not None and now - hit[0] < _AVAIL_TTL:
            return hit[1]
    rep = None
    if os.path.exists(path):
        try:
            c = DevdClient(path, connect_timeout=timeout, io_timeout=timeout)
            r = c.ping(timeout=timeout)
            c.close()
            rep = r if r.get("held") else None
        except Exception:
            rep = None
    with _avail_mtx:
        _avail_cache[path] = (now, rep)
    return rep


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    serve()


if __name__ == "__main__":
    main()
