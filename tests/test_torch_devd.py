"""The port's device daemon (tendermint_tpu_torch/devd.py) against the JAX
package's (tendermint_tpu/devd.py): the frames byte for byte, clients of
both packages against a port daemon serving the CPU (the kernels' plain
versions), sim daemons of both packages answering alike, and the
daemon's behaviours: ping, pipelining order, the gateway's default route,
a refused second daemon, the Hasher over the stream.

Every daemon runs as a subprocess in which `import jax` fails, on a short
socket under /tmp (AF_UNIX caps a path at 108 bytes), with
TENDERMINT_DEVD_EXIT_ON_TERM=1, and is shut down in a finalizer and killed
if it outlives a bounded wait. Every wait has a deadline.
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from tendermint_tpu import devd as jdevd
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto import ed25519_agg as jagg
from tendermint_tpu.crypto.hashing import ripemd160 as jripemd160
from tendermint_tpu.merkle import simple as jsimple
from tendermint_tpu_torch import devd
from tendermint_tpu_torch.ops import devd_backend, gateway

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = jed.P
# the daemon's interpreter: the port's daemon with JAX unimportable, or
# the JAX package's (its sim mode imports no jax either)
PORT_MAIN = "import sys; sys.modules['jax'] = None; from tendermint_tpu_torch.devd import main; main()"
JAX_MAIN = "from tendermint_tpu.devd import main; main()"
CPU_DAEMON_S = 240.0  # warm-up of the plain ladder on a loaded CPU
SIM_DAEMON_S = 60.0


class DevdProc:
    """One daemon subprocess on a short socket. `env` adds to the test
    daemon's knobs (ACCEPT_CPU, WARM=16, EXIT_ON_TERM, one torch thread)."""

    def __init__(self, main: str = PORT_MAIN, env: dict | None = None, sock: str | None = None):
        self.own_dir = None
        if sock is None:
            self.own_dir = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
            sock = os.path.join(self.own_dir, "d.sock")
        assert len(sock.encode()) < 100, sock
        self.sock = sock
        fd, self.log_path = tempfile.mkstemp(prefix="tmdlog", dir="/tmp")
        self.log = os.fdopen(fd, "wb")
        full = {k: v for k, v in os.environ.items()
                if k not in ("TENDERMINT_TPU_KERNEL", "TENDERMINT_DEVD_SOCKS")}
        full.update({
            "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
            "TENDERMINT_DEVD_SOCK": sock, "TENDERMINT_DEVD_ACCEPT_CPU": "1",
            "TENDERMINT_DEVD_WARM": "16", "TENDERMINT_DEVD_EXIT_ON_TERM": "1",
            "OMP_NUM_THREADS": "1",
        })
        full.update(env or {})
        self.proc = subprocess.Popen([sys.executable, "-c", main], env=full, cwd=REPO,
                                     stdout=subprocess.DEVNULL, stderr=self.log)

    def log_tail(self, n: int = 3000) -> str:
        self.log.flush()
        with open(self.log_path, "rb") as f:
            return f.read()[-n:].decode(errors="replace")

    def wait_held(self, deadline_s: float) -> dict:
        client = devd.DevdClient(self.sock, connect_timeout=1.0, io_timeout=10.0)
        deadline = time.monotonic() + deadline_s
        try:
            while time.monotonic() < deadline:
                if self.proc.poll() is not None:
                    pytest.fail(f"daemon exited {self.proc.returncode}: {self.log_tail()}")
                try:
                    rep = client.ping(timeout=2.0)
                    if rep.get("held"):
                        return rep
                except (OSError, devd.DevdError):
                    pass
                time.sleep(0.2)
        finally:
            client.close()
        self.kill()
        pytest.fail(f"daemon not serving after {deadline_s} s: {self.log_tail()}")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=10)

    def stop(self) -> None:
        """The shutdown op, then a bounded wait, then SIGKILL."""
        if self.proc.poll() is None:
            client = devd.DevdClient(self.sock, connect_timeout=1.0, io_timeout=5.0)
            try:
                client.shutdown()
            except (OSError, devd.DevdError, EOFError):
                pass
            finally:
                client.close()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                pass
        self.kill()
        self.log.close()
        os.unlink(self.log_path)
        if self.own_dir:
            shutil.rmtree(self.own_dir, ignore_errors=True)


@pytest.fixture(scope="module")
def cpu_daemon():
    """The port's daemon on the CPU: the bake-off's one candidate, the
    plain ladder (`f32`), warmed at 16 lanes."""
    d = DevdProc(env={"TENDERMINT_DEVD_CHUNK": "4"})
    try:
        d.wait_held(CPU_DAEMON_S)
        yield d
    finally:
        d.stop()


@pytest.fixture
def sim_daemon():
    d = DevdProc(env={"TENDERMINT_DEVD_SIM_RATE": "100000"})
    try:
        d.wait_held(SIM_DAEMON_S)
        yield d
    finally:
        d.stop()


@pytest.fixture
def routed(monkeypatch):
    """Point this process's gateway at a daemon: the socket, a fresh
    backend client, fresh probe caches and breakers."""

    def point(sock: str) -> None:
        monkeypatch.setenv("TENDERMINT_DEVD_SOCK", sock)
        monkeypatch.delenv("TENDERMINT_TPU_KERNEL", raising=False)
        monkeypatch.setattr(devd_backend, "_client", None)
        devd.bust_avail_cache()
        gateway.reset_devd_breaker()
        devd_backend.reset_stream_latches()

    yield point
    if devd_backend._client is not None:
        devd_backend._client.close()
    devd.bust_avail_cache()
    gateway.reset_devd_breaker()


def signed_items(n: int, tag: bytes = b"devd"):
    """n valid lanes over 4 keys (JAX package's signer), then a forged
    signature, a tampered message, an empty message and a 33-byte key."""
    seeds = [bytes([33, k]) + b"\x21" * 30 for k in range(4)]
    pubs = [jed.public_key(s) for s in seeds]
    items = [(pubs[i % 4], tag + b"-%d" % i, jed.sign(seeds[i % 4], tag + b"-%d" % i)) for i in range(n)]
    if n >= 8:
        items[2] = (items[2][0], items[2][1], b"\x13" * 64)
        items[4] = (items[4][0], items[4][1] + b"x", items[4][2])
        items[5] = (pubs[1], b"", jed.sign(seeds[1], b""))
        items[7] = (b"\x02" + items[7][0], items[7][1], items[7][2])
    return items


# -- frames ----------------------------------------------------------------------


def _wire(send, *args) -> bytes:
    """The bytes one frame sender writes."""
    a, b = socket.socketpair()
    try:
        send(a, *args)
        a.close()
        out = b""
        while chunk := b.recv(1 << 16):
            out += chunk
        return out
    finally:
        b.close()


VERIFY_CHUNKS = {
    "empty": [],
    "one": [(b"\x01" * 32, b"m", b"\x02" * 64)],
    "ragged": [(bytes([i]) * 32, bytes([i]) * (i * 37 % 300), bytes([255 - i]) * 64) for i in range(19)],
}
HASH_CHUNKS = {
    "empty": [],
    "one_empty_item": [b""],
    "ragged": [bytes([i]) * (i * 911 % 5000) for i in range(23)],
}


@pytest.mark.parametrize("case", sorted(VERIFY_CHUNKS))
def test_verify_chunk_frames_byte_identical(case):
    items = VERIFY_CHUNKS[case]
    payload = devd._pack_chunk(items)
    assert payload == jdevd._pack_chunk(items)
    assert devd._unpack_chunk(payload) == jdevd._unpack_chunk(payload) == [tuple(it) for it in items]


@pytest.mark.parametrize("case", sorted(HASH_CHUNKS))
def test_hash_chunk_frames_byte_identical(case):
    items = HASH_CHUNKS[case]
    payload = devd._pack_hash_chunk(items)
    assert payload == jdevd._pack_hash_chunk(items)
    assert devd._unpack_hash_chunk(payload) == jdevd._unpack_hash_chunk(payload) == items


@pytest.mark.parametrize("kind", ["result", "digest", "tree", "error", "pickle"])
def test_reply_frames_byte_identical(kind):
    digests = [bytes([i]) * 20 for i in range(5)]
    args = {
        "result": ("_send_result_frame", (7, [True, False, True])),
        "digest": ("_send_digest_frame", (3, digests)),
        "tree": ("_send_tree_frame", (digests[:4],)),
        "error": ("_send_error_frame", (0xFFFFFFFF, "malformed chunk: x")),
        "pickle": ("_send_frame", ({"ok": True, "results": [True, False], "points": [(1, 2)]},)),
    }[kind]
    mine = _wire(getattr(devd, args[0]), *args[1])
    assert mine == _wire(getattr(jdevd, args[0]), *args[1])
    assert struct.unpack(">I", mine[:4])[0] == len(mine) - 4
    if kind == "pickle":
        assert mine[4:] == pickle.dumps(args[1][0], protocol=pickle.HIGHEST_PROTOCOL)


MALFORMED = {
    "short": b"\x01\x02",
    "too_many_lanes": struct.pack("<I", (1 << 20) + 1),
    "truncated": struct.pack("<I", 2) + b"\x00" * 40,
    "size_mismatch": devd._pack_chunk([(b"\x01" * 32, b"abc", b"\x02" * 64)]) + b"!",
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_frames_refused_alike(case):
    """Both packages refuse the same malformed payloads with the same
    message, verify chunks and hash chunks alike; the lane bound is
    _MAX_CHUNK_LANES in both."""
    assert devd._MAX_CHUNK_LANES == jdevd._MAX_CHUNK_LANES == 1 << 20
    payload = MALFORMED[case]
    for unpack in ("_unpack_chunk", "_unpack_hash_chunk"):
        with pytest.raises(ValueError) as mine:
            getattr(devd, unpack)(payload)
        with pytest.raises(ValueError) as theirs:
            getattr(jdevd, unpack)(payload)
        assert str(mine.value) == str(theirs.value)


def test_pack_refuses_a_non_ed25519_lane_alike():
    items = [(b"\x01" * 33, b"m", b"\x02" * 64)]
    with pytest.raises(ValueError) as mine:
        devd._pack_chunk(items)
    with pytest.raises(ValueError) as theirs:
        jdevd._pack_chunk(items)
    assert str(mine.value) == str(theirs.value)


def test_protocol_constants_equal():
    for name in ("DEFAULT_SOCK", "DEFAULT_STREAM_CHUNK", "STREAM_OK", "STREAM_ERR", "STREAM_TREE",
                 "HASH_MODES"):
        assert getattr(devd, name) == getattr(jdevd, name), name


# -- both packages' clients against the port's CPU daemon --------------------------

CLIENTS = {"port": devd.DevdClient, "jax": jdevd.DevdClient}


def test_ping_reports_serving(cpu_daemon):
    rep = devd.DevdClient(cpu_daemon.sock).ping()
    assert rep["held"] and rep["status"] == "serving"
    assert rep["platform"] == "cpu" and rep["warmed"] == [16]
    assert rep["pid"] == cpu_daemon.proc.pid and rep["stream_chunk"] == 4
    log = cpu_daemon.log_tail(20000)
    assert "serving kernel: f32" in log and "device held (cpu, cpu)" in log


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_verify_and_stream_equal_the_jax_reference(cpu_daemon, client):
    c = CLIENTS[client](cpu_daemon.sock)
    items = signed_items(10, tag=client.encode())
    want = [jed.verify(*it) for it in items]
    assert want[:8] == [True, True, False, True, False, True, True, False]
    try:
        assert c.verify_batch(items) == want
        # a stream carries ed25519 lanes only: 3 chunks, the last partial
        ed = [i for i, it in enumerate(items) if len(it[0]) == 32]
        assert c.verify_stream([items[i] for i in ed], chunk=4) == [want[i] for i in ed]
    finally:
        c.close()


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_hash_ops_equal_the_jax_reference(cpu_daemon, client):
    c = CLIENTS[client](cpu_daemon.sock)
    items = [bytes([i]) * (i * 53 % 200) for i in range(9)]  # the first empty
    try:
        assert c.hash_batch(items, mode="part") == [jripemd160(x) for x in items]
        assert c.hash_batch(items, mode="leaf") == [jsimple.leaf_hash(x) for x in items]
        digests, nodes = c.hash_stream(items, mode="leaf", tree=True, chunk=4)
        tree = jsimple.flat_tree_from_leaf_digests([jsimple.leaf_hash(x) for x in items])
        assert digests == [jsimple.leaf_hash(x) for x in items]
        assert nodes == tree.internal_nodes()
        assert nodes[-1] == jsimple.simple_hash_from_byteslices(items)
        one = c.hash_stream(items[:1], mode="part", tree=True, chunk=4)
        assert one == ([jripemd160(items[0])], [])
    finally:
        c.close()


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_agg_op_equals_the_group_law(cpu_daemon, client):
    """The agg op's points for an aggregate commit's terms equal the pure
    Python group law, and finish the aggregate check."""
    seeds = [bytes([44, k]) + b"\x2c" * 30 for k in range(3)]
    items = [(jed.public_key(s), b"agg-%d" % i, jed.sign(s, b"agg-%d" % i)) for i, s in enumerate(seeds)]
    rs, s_agg = jagg.aggregate(items)
    terms = jagg.aggregate_terms([it[0] for it in items], [it[1] for it in items], rs, s_agg)

    def ext(pt):
        return (pt[0], pt[1], 1, pt[0] * pt[1] % P)

    def affine(pt):
        zinv = pow(pt[2], P - 2, P)
        return (pt[0] * zinv % P, pt[1] * zinv % P)

    want = [affine(jed.point_add(jed.scalar_mult(a, ext(p)), jed.scalar_mult(b, ext(q))))
            for a, p, b, q in terms]
    c = CLIENTS[client](cpu_daemon.sock)
    try:
        points = c.agg_batch(terms)
    finally:
        c.close()
    assert points == want
    assert all(type(x) is int for pt in points for x in pt)
    assert jagg.finish_from_points(points)


def test_async_pipelining_preserves_order(sim_daemon):
    c = devd.DevdClient(sim_daemon.sock)
    batches = [[(b"\x05" * 32, b"pipe%d-%d" % (k, i), b"\x06" * (64 if i != k else 63)) for i in range(5)]
               for k in range(4)]
    try:
        resolvers = [c.verify_batch_async(b) for b in batches]
        for k, resolve in enumerate(resolvers):
            assert resolve() == [i != k for i in range(5)], k
    finally:
        c.close()


def test_gateway_default_routes_through_daemon(cpu_daemon, routed):
    """With a daemon serving and TENDERMINT_TPU_KERNEL unset, a default
    Verifier takes the devd route: no device here, the daemon's counters
    move, the verdicts are the JAX package's."""
    routed(cpu_daemon.sock)
    assert gateway.kernel_name() == "devd"
    client = devd.DevdClient(cpu_daemon.sock)
    before = client.stats()["tpu_sigs"]
    v = gateway.Verifier(min_tpu_batch=1)
    assert v.kernel == "devd" and v.device is None
    items = signed_items(8, tag=b"gw")
    assert v.verify_batch(items) == [jed.verify(*it) for it in items]
    stats = v.stats()
    # the 33-byte key verifies here on the CPU, the 7 ed25519 lanes there
    assert (stats["tpu_sigs"], stats["cpu_sigs"], stats["breaker_state"]) == (7, 1, 0)
    assert client.stats()["tpu_sigs"] - before == 7
    # an explicit device keeps the kernel in process
    assert gateway.Verifier(device="cpu").kernel == "f32p"
    client.close()


def test_second_daemon_refuses_a_live_socket(sim_daemon):
    second = DevdProc(env={"TENDERMINT_DEVD_SIM_RATE": "100000"}, sock=sim_daemon.sock)
    try:
        assert second.proc.wait(timeout=60) != 0
        assert f"devd already serving on {sim_daemon.sock}" in second.log_tail()
    finally:
        second.stop()
    assert devd.DevdClient(sim_daemon.sock).ping()["held"]


def test_stale_socket_is_replaced(sim_daemon):
    """A socket file nobody listens on (a dead daemon's) is unlinked and
    rebound; the socket is mode 0600."""
    d = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
    sock = os.path.join(d, "s")
    stale = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stale.bind(sock)
    stale.close()
    fresh = DevdProc(env={"TENDERMINT_DEVD_SIM_RATE": "100000"}, sock=sock)
    try:
        fresh.wait_held(SIM_DAEMON_S)
        assert os.stat(sock).st_mode & 0o777 == 0o600
    finally:
        fresh.stop()
        shutil.rmtree(d, ignore_errors=True)


def test_sim_daemons_of_both_packages_answer_alike(sim_daemon):
    """The same requests to a port sim daemon and a JAX sim daemon get the
    same replies, but for the process-bound keys (pid, uptime)."""
    theirs = DevdProc(main=JAX_MAIN, env={"TENDERMINT_DEVD_SIM_RATE": "100000"})
    try:
        theirs.wait_held(SIM_DAEMON_S)
        items = [(b"\x05" * 32, b"sim-%d" % i, b"\x06" * 64) for i in range(9)]
        leaves = [bytes([i]) * (i * 7) for i in range(6)]
        replies = []
        for d in (sim_daemon, theirs):
            c = jdevd.DevdClient(d.sock)
            try:
                rep = {
                    "verify": c.verify_batch(items),
                    "stream": c.verify_stream(items, chunk=4),
                    "hash": c.hash_batch(leaves, mode="leaf", tree=True),
                    "hash_stream": c.hash_stream(leaves, mode="part", tree=True, chunk=4),
                    "ping": {k: v for k, v in c.ping().items() if k not in ("pid", "uptime_s")},
                    "status": sorted(c.status()),
                    "stream_status": sorted(c.status()["stream"]),
                    "hash_status": sorted(c.status()["hash_stream"]),
                    "stats": c.stats(),
                    "unknown": c.request({"op": "nope"}),
                }
            finally:
                c.close()
            replies.append(rep)
        assert replies[0] == replies[1]
        assert replies[0]["unknown"] == {"ok": False, "error": "unknown op 'nope'"}
    finally:
        theirs.stop()


def test_hasher_over_the_stream(cpu_daemon, routed, monkeypatch):
    """A default Hasher beside a serving daemon takes the devd route: part
    sets through hash_stream with the tree frame, equal to the host's in
    header and every proof; the tx root through the tree frame too."""
    from tendermint_tpu_torch.merkle.simple import simple_hash_from_byteslices
    from tendermint_tpu_torch.types.part_set import PartSet

    routed(cpu_daemon.sock)
    monkeypatch.setenv("TENDERMINT_DEVD_STREAM_MIN", "4")
    monkeypatch.setenv("TENDERMINT_DEVD_HASH_CHUNK", "3")
    monkeypatch.delenv("TENDERMINT_TPU_HASHES", raising=False)
    monkeypatch.delenv("TENDERMINT_TPU_DISABLE", raising=False)
    monkeypatch.setattr(gateway, "_rtt_cache", {})
    h = gateway.Hasher(min_tpu_batch=2)
    assert h._route == "devd" and h.device is None
    data = bytes(range(256)) * 5
    dev = PartSet.from_data(data, 100, tree_hasher=h.part_set_tree)
    host = PartSet.from_data(data, 100)
    assert dev.header() == host.header()
    for i in range(host.header().total):
        a, b = dev.get_part(i), host.get_part(i)
        assert (a.hash(), a.proof.aunts) == (b.hash(), b.proof.aunts)
    txs = [b"tx-%d" % i for i in range(7)]
    assert h.tx_merkle_root(txs) == simple_hash_from_byteslices(txs)
    stats = h.stats()
    assert stats["stream_trees"] == 2 and stats["tpu_part_batches"] == 1 and stats["tpu_tx_roots"] == 1
    assert stats["cpu_leaves"] == 0 and stats["breaker_state"] == 0
    status = devd.DevdClient(cpu_daemon.sock).status()["hash_stream"]
    assert status["trees"] >= 2 and status["chunks"] >= 6


def test_concurrent_clients_get_what_each_gets_alone(cpu_daemon):
    """Several client threads against one daemon (a connection each, a
    handler thread each, the one Verifier and hasher shared) get the
    verdicts and digests each gets alone: two verify (one streamed, one
    single-shot), two hash with the tree frame."""
    items = [[it for it in signed_items(8, tag=b"conc%d" % k) if len(it[0]) == 32] for k in range(2)]
    leaves = [[bytes([k, i]) * (50 * i + k) for i in range(5)] for k in range(2)]
    calls = [
        lambda c: c.verify_stream(items[0], chunk=8),
        lambda c: c.verify_batch(items[1]),
        lambda c: c.hash_stream(leaves[0], mode="part", tree=True, chunk=2),
        lambda c: c.hash_stream(leaves[1], mode="leaf", tree=True, chunk=3),
    ]
    c = devd.DevdClient(cpu_daemon.sock)
    alone = [call(c) for call in calls]
    c.close()
    assert alone[0] == [jed.verify(*it) for it in items[0]]
    got: list = [None] * len(calls)
    errors: list = []

    def run(k: int) -> None:
        client = devd.DevdClient(cpu_daemon.sock)
        try:
            got[k] = calls[k](client)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(k,)) for k in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert got == alone


def test_socket_paths_are_short_and_under_tmp(cpu_daemon, sim_daemon):
    for d in (cpu_daemon, sim_daemon):
        assert d.sock.startswith("/tmp/tmd") and len(d.sock.encode()) < 108
