"""Injectable faults for the devd device plane: the port's copy of the JAX
package's `ops/faults.py`, rule for rule.

The verify and hash planes reach the card through a socket to the device
daemon (tendermint_tpu_torch/devd.py), so the failures that matter are the
transport's: a daemon killed mid-stream, a truncated or corrupted frame, a
read that stalls, a refused connect, a daemon of an older build. A
`FaultPlan` is a deterministic, seeded schedule of such faults, injected
without patching the client or the daemon, in one of two ways:

- **in process** (`install_client_faults`): every new DevdClient
  connection is wrapped through `devd.set_socket_wrapper`, so the
  production client path runs unchanged and the faults fire at the
  socket's sendall / recv.
- **out of process** (`FaultProxy`): a unix-socket shim in front of a real
  daemon. Each length-prefixed frame relays byte for byte unless the plan
  injects, so the stream framing, the daemon's malformed-frame path and
  its abort handling see real bytes. `python -m
  tendermint_tpu_torch.ops.faults` runs one as its own process.

Every injected fault counts in a `faults_*` counter; registered plans
show in `Verifier.stats()` / `Hasher.stats()` beside the `stream_*`
gauges, and in the telemetry registry's scrape.

`DaemonSupervisor` kills and restarts daemons on a schedule, and refuses
any daemon but an ACCEPT_CPU one (the sim or the kernels' plain versions):
no harness SIGKILLs the process that owns a card.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import random
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

from tendermint_tpu_torch import devd
from tendermint_tpu_torch.libs import telemetry as _telemetry

logger = logging.getLogger("ops.faults")

# The fault taxonomy:
#   refuse    connect refused (daemon down, socket gone)
#   corrupt   a byte flipped inside a relayed frame's payload (framing intact)
#   truncate  a frame cut mid-payload, the connection closed (framing broken)
#   stall     a read or write held for stall_s before it proceeds
#   drop      the connection closed without warning mid-exchange
#   skew      a *_stream header answered as a daemon without streaming would
#             (pickle {"ok": False}): the version-skew path
#   kill      a daemon killed or restarted (DaemonSupervisor, a blackout)
FAULT_KINDS = ("refuse", "corrupt", "truncate", "stall", "drop", "skew", "kill")

# the event streams a Fault keys on: "connect" (a new client connection),
# "c2s" (a client-to-daemon frame), "s2c" (a daemon-to-client frame)
FAULT_EVENTS = ("connect", "c2s", "s2c")


class Fault:
    """One rule of a FaultPlan: fire `kind` on the `first`-th event of
    stream `on` (1-based), then every `every` events after, at most
    `limit` times. The schedule is a pure function of the event
    sequence."""

    __slots__ = ("kind", "on", "first", "every", "limit", "stall_s", "fired")

    def __init__(self, kind: str, on: str, first: int = 1, every: int = 0,
                 limit: int = 1, stall_s: float = 0.5):
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}: {FAULT_KINDS}")
        if on not in FAULT_EVENTS:
            raise ValueError(f"unknown fault event {on!r}: {FAULT_EVENTS}")
        self.kind = kind
        self.on = on
        self.first = max(1, int(first))
        self.every = max(0, int(every))
        self.limit = max(1, int(limit))
        self.stall_s = float(stall_s)
        self.fired = 0

    def due(self, n: int) -> bool:
        if self.fired >= self.limit:
            return False
        if n == self.first:
            return True
        return bool(self.every) and n > self.first and (n - self.first) % self.every == 0

    def __repr__(self) -> str:
        return (f"Fault({self.kind} on {self.on} first={self.first} "
                f"every={self.every} limit={self.limit} fired={self.fired})")


class FaultPlan:
    """A seeded schedule of device-plane faults and the counters of what
    fired. The seed decides only content (which byte a corrupt flips);
    when a fault fires is a pure function of the event sequence, so a
    replayed run injects the same schedule."""

    def __init__(self, faults=(), seed: int = 0):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self.faults = list(faults)
        self.counters = {f"faults_{k}": 0 for k in FAULT_KINDS}
        self._events = {e: 0 for e in FAULT_EVENTS}
        self._mtx = threading.Lock()

    def add(self, kind: str, on: str, **kw) -> FaultPlan:
        self.faults.append(Fault(kind, on, **kw))
        return self

    def pick(self, event: str, supported=None):
        """Advance the `event` stream one step and return the Fault due
        there (counted), or None. `supported` (kinds; None for all) names
        what the calling injection point can inject: a due fault it cannot
        inject is skipped, neither consumed nor counted, and warned about,
        so the faults_* counters report only injections that happened."""
        with self._mtx:
            self._events[event] += 1
            n = self._events[event]
            for f in self.faults:
                if f.on != event or not f.due(n):
                    continue
                if supported is not None and f.kind not in supported:
                    logger.warning("fault %r due but not injectable at this point (supports %s); "
                                   "skipped, not counted", f, tuple(supported))
                    continue
                f.fired += 1
                self.counters[f"faults_{f.kind}"] += 1
                return f
        return None

    def wants(self, kind: str, event: str) -> bool:
        """Does a rule not yet exhausted target (kind, event)? Lets an
        injection point skip work a frame (sniffing for skew) that no rule
        could need."""
        with self._mtx:
            return any(f.kind == kind and f.on == event and f.fired < f.limit for f in self.faults)

    def note(self, kind: str) -> None:
        """Count a fault injected outside the event streams (a daemon kill
        by the supervisor, a proxy blackout)."""
        with self._mtx:
            self.counters[f"faults_{kind}"] += 1

    def corrupt_offset(self, lo: int, hi: int) -> int:
        """The seeded byte position of a corrupt fault."""
        with self._mtx:
            return self._rng.randrange(lo, max(lo + 1, hi))

    def stats(self) -> dict:
        with self._mtx:
            out = dict(self.counters)
            out["faults_total"] = sum(self.counters.values())
            return out


# -- registry: the counters beside the stream_* gauges ----------------------------

_registry: list[FaultPlan] = []
_reg_mtx = threading.Lock()


def register(plan: FaultPlan) -> FaultPlan:
    with _reg_mtx:
        if plan not in _registry:
            _registry.append(plan)
    return plan


def unregister(plan: FaultPlan) -> None:
    with _reg_mtx:
        if plan in _registry:
            _registry.remove(plan)


def global_counters() -> dict:
    """The faults_* counters summed over every registered plan: a stable
    key set (zeros with no harness installed), which Verifier and Hasher
    fold into their stats()."""
    out = {f"faults_{k}": 0 for k in FAULT_KINDS}
    with _reg_mtx:
        plans = list(_registry)
    for plan in plans:
        for k, v in plan.stats().items():
            if k in out:
                out[k] += v
    return out


# -- telemetry: the counters and the supervisor's churn, scrape-only -------------

_sup_totals = {"kills": 0, "restarts": 0}
_sup_mtx = threading.Lock()


def _note_supervisor(kind: str) -> None:
    with _sup_mtx:
        _sup_totals[kind] += 1


def telemetry_counters() -> dict:
    """faults_* over every registered plan and the supervisors' kill and
    restart totals (flat numerics; the scrape-only producer below)."""
    out = global_counters()
    with _sup_mtx:
        out["faults_supervisor_kills"] = _sup_totals["kills"]
        out["faults_supervisor_restarts"] = _sup_totals["restarts"]
    return out


def _install_telemetry(reg) -> None:
    # prefix "": the keys carry their faults_ prefix already. legacy=False:
    # scrape-only, so the flat metrics map's key set does not change
    reg.register_producer("", telemetry_counters, legacy=False)


_telemetry.on_default_registry(_install_telemetry)


# -- in process: the DevdClient socket wrapper -----------------------------------


class FaultSocket:
    """A socket proxy that injects the plan's faults at the client's socket.
    The client sends every frame with one sendall, so c2s faults key on
    sendall calls; s2c faults key on frames, fired at a frame's first
    payload read (the client reads the 4-byte length and the payload
    separately, in as many recv calls as the kernel hands it), so the
    schedule does not depend on how recv splits the bytes. Everything else
    delegates to the wrapped socket."""

    def __init__(self, sock: socket.socket, plan: FaultPlan):
        self._sock = sock
        self._plan = plan
        self._len_rem = 4
        self._len_acc = b""
        self._frame_rem = 0
        self._frame_new = False

    def sendall(self, data) -> None:
        f = self._plan.pick("c2s", supported=("stall", "drop", "truncate", "corrupt"))
        if f is not None:
            if f.kind == "stall":
                time.sleep(f.stall_s)
            elif f.kind == "drop":
                # shutdown, then close: a resolver thread may be blocked in
                # recv on this fd, and close() alone would not wake it
                _kill_sock(self._sock)
                raise ConnectionError("fault: connection dropped before send")
            elif f.kind == "truncate":
                cut = max(1, len(data) // 2)
                try:
                    self._sock.sendall(bytes(data[:cut]))
                finally:
                    _kill_sock(self._sock)
                raise ConnectionError("fault: frame truncated mid-send")
            elif f.kind == "corrupt":
                # a byte of the frame's leading structure (lane counts,
                # status, length planes), which frame validation rejects;
                # never the 4-byte length prefix (the daemon would wait for
                # bytes that never come) and never deep payload (a flipped
                # signature byte on a local socket is memory corruption,
                # which the protocol does not claim to detect)
                buf = bytearray(data)
                if len(buf) > 5:
                    off = self._plan.corrupt_offset(4, min(len(buf), 12))
                    buf[off] ^= 0xFF
                data = bytes(buf)
        return self._sock.sendall(data)

    def recv(self, n: int) -> bytes:
        if self._len_rem > 0:
            # the length prefix passes untouched: a flipped length wedges
            # both sides silently, which models nothing the protocol detects
            data = self._sock.recv(min(n, self._len_rem))
            self._len_rem -= len(data)
            self._len_acc += data
            if self._len_rem == 0:
                (self._frame_rem,) = struct.unpack(">I", self._len_acc)
                self._len_acc = b""
                self._frame_new = True
                if self._frame_rem == 0:  # an empty frame: the next is new
                    self._len_rem = 4
            return data
        f = None
        if self._frame_new:  # the frame's first payload read
            self._frame_new = False
            f = self._plan.pick("s2c", supported=("stall", "drop", "corrupt"))
        if f is not None:
            if f.kind == "stall":
                time.sleep(f.stall_s)
            elif f.kind == "drop":
                _kill_sock(self._sock)
                raise ConnectionError("fault: connection dropped mid-read")
        data = bytearray(self._sock.recv(min(n, self._frame_rem)))
        self._frame_rem -= len(data)
        if self._frame_rem == 0:
            self._len_rem = 4
        if f is not None and f.kind == "corrupt" and data:
            # the frame's structural head (status, index, counts)
            data[self._plan.corrupt_offset(0, min(len(data), 9))] ^= 0xFF
        return bytes(data)

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def shutdown(self, how) -> None:
        self._sock.shutdown(how)

    def close(self) -> None:
        self._sock.close()

    def fileno(self) -> int:
        return self._sock.fileno()


def install_client_faults(plan: FaultPlan) -> FaultPlan:
    """Route every new DevdClient connection of this process through the
    plan. Connect faults fire when the socket is wrapped: `refuse` closes
    it and raises ConnectionRefusedError as a dead daemon would. Pair with
    `uninstall_client_faults()`."""

    def wrap(sock: socket.socket):
        f = plan.pick("connect", supported=("refuse", "stall"))
        if f is not None and f.kind == "refuse":
            sock.close()
            raise ConnectionRefusedError("fault: connect refused")
        if f is not None and f.kind == "stall":
            time.sleep(f.stall_s)
        return FaultSocket(sock, plan)

    devd.set_socket_wrapper(wrap)
    return register(plan)


def uninstall_client_faults(plan: FaultPlan | None = None) -> None:
    devd.set_socket_wrapper(None)
    if plan is not None:
        unregister(plan)


# -- out of process: a frame relay in front of a real daemon ----------------------


def _kill_sock(s: socket.socket) -> None:
    """shutdown, then close. close() from another thread does not wake a
    recv blocked on the same fd (the syscall pins the file description, so
    no FIN goes out and both sides hang); shutdown() ends the connection
    at once."""
    try:
        s.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        s.close()
    except Exception:  # noqa: BLE001 - teardown, best effort
        pass


def _is_stream_header(payload: bytes) -> bool:
    """Is this c2s frame a verify_stream / hash_stream header? (A binary
    chunk frame does not unpickle; a failed loads is a clean no.)"""
    try:
        obj = pickle.loads(payload)
    except Exception:  # noqa: BLE001 - a binary chunk frame, not a header
        return False
    return isinstance(obj, dict) and str(obj.get("op", "")).endswith("_stream")


class FaultProxy:
    """A frame-aware unix-socket shim between DevdClients and a real
    daemon. Both planes' frames cross byte for byte (the length prefix and
    the payload relayed as read, with the daemon's own read loop
    `devd._recv_exact`), and the plan injects a frame at a time: a
    `corrupt` lands inside a real chunk or digest frame, a `truncate` cuts
    a real frame, and `skew` answers a *_stream header with the error a
    daemon without streaming sends. `blackout()` stands in for the
    daemon's death without touching it: live connections drop and new
    ones are refused for the window. Runs as threads in process, or alone
    through `python -m tendermint_tpu_torch.ops.faults`."""

    def __init__(self, listen_path: str, upstream_path: str, plan: FaultPlan | None = None):
        self.listen_path = listen_path
        self.upstream_path = upstream_path
        self.plan = plan if plan is not None else FaultPlan()
        self._srv: socket.socket | None = None
        self._stop = threading.Event()
        self._conns: list[socket.socket] = []
        self._mtx = threading.Lock()
        self._blackout_until = 0.0
        self._accept_thread: threading.Thread | None = None

    def start(self) -> FaultProxy:
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if os.path.exists(self.listen_path):
            os.unlink(self.listen_path)
        srv.bind(self.listen_path)
        os.chmod(self.listen_path, 0o600)
        srv.listen(64)
        srv.settimeout(0.5)
        self._srv = srv
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True,
                                               name="fault-proxy-accept")
        self._accept_thread.start()
        register(self.plan)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        if self._srv is not None:
            self._srv.close()
        try:
            os.unlink(self.listen_path)
        except OSError:
            pass
        self._drop_all()
        unregister(self.plan)

    def blackout(self, seconds: float) -> None:
        """The daemon's death without a SIGKILL (a shared daemon, a daemon
        that owns a card): refuse new connects and drop live ones for the
        window."""
        with self._mtx:
            self._blackout_until = time.monotonic() + seconds
        self.plan.note("kill")
        self._drop_all()

    def _drop_all(self) -> None:
        with self._mtx:
            conns, self._conns = self._conns, []
        for c in conns:
            _kill_sock(c)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            now = time.monotonic()
            with self._mtx:
                dark = now < self._blackout_until
            f = None if dark else self.plan.pick("connect", supported=("refuse", "stall"))
            if dark or (f is not None and f.kind == "refuse"):
                conn.close()
                continue
            if f is not None and f.kind == "stall":
                time.sleep(f.stall_s)
            try:
                up = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                up.settimeout(5.0)
                up.connect(self.upstream_path)
                up.settimeout(None)
            except OSError:
                # the upstream daemon is down: the client sees what a dead
                # daemon gives, a connection closed at once
                conn.close()
                continue
            with self._mtx:
                self._conns += [conn, up]
            threading.Thread(target=self._relay, args=(conn, up, "c2s"), daemon=True,
                             name="fault-proxy-c2s").start()
            threading.Thread(target=self._relay, args=(up, conn, "s2c"), daemon=True,
                             name="fault-proxy-s2c").start()

    def _relay(self, src: socket.socket, dst: socket.socket, direction: str) -> None:
        try:
            while not self._stop.is_set():
                hdr = devd._recv_exact(src, 4)
                (n,) = struct.unpack(">I", hdr)
                payload = devd._recv_exact(src, n)
                supported = ["stall", "drop", "truncate", "corrupt"]
                # skew applies only to a frame that is a stream header: it
                # is offered as supported only then, so a due skew rule is
                # never consumed by a frame it cannot apply to
                if direction == "c2s" and self.plan.wants("skew", "c2s") and _is_stream_header(payload):
                    supported.append("skew")
                f = self.plan.pick(direction, supported=supported)
                if f is not None:
                    if f.kind == "stall":
                        time.sleep(f.stall_s)
                    elif f.kind == "drop":
                        return
                    elif f.kind == "truncate":
                        dst.sendall(hdr + payload[: max(1, n // 2)])
                        return
                    elif f.kind == "corrupt" and n > 1:
                        # the structural head only (see FaultSocket.sendall)
                        buf = bytearray(payload)
                        buf[self.plan.corrupt_offset(0, min(n, 9))] ^= 0xFF
                        payload = bytes(buf)
                    elif f.kind == "skew" and direction == "c2s" and _is_stream_header(payload):
                        # answer as a daemon without streaming and swallow the
                        # header: the client must latch single-shot, not hang
                        rep = pickle.dumps({"ok": False, "error": "unknown op (skewed)"})
                        src.sendall(struct.pack(">I", len(rep)) + rep)
                        continue
                dst.sendall(hdr + payload)
        except (ConnectionError, OSError, struct.error):
            pass
        finally:
            for s in (src, dst):
                _kill_sock(s)


# -- daemon churn: the kill and restart arm of a schedule -------------------------


class DaemonSupervisor:
    """Spawn, SIGKILL and restart a device daemon (`python -m
    tendermint_tpu_torch.devd`) on a schedule. Refuses any environment
    that is not ACCEPT_CPU: no harness SIGKILLs the process that owns a
    card mid-op. Kills note `faults_kill` on the plan."""

    def __init__(self, sock_path: str, extra_env: dict | None = None, plan: FaultPlan | None = None):
        env = dict(extra_env or {})
        env.setdefault("TENDERMINT_DEVD_ACCEPT_CPU", "1")
        if env.get("TENDERMINT_DEVD_ACCEPT_CPU") != "1":
            raise ValueError(
                "DaemonSupervisor only supervises ACCEPT_CPU daemons: SIGKILLing the "
                "daemon that owns a card mid-op is what the daemon exists to prevent"
            )
        self.sock_path = sock_path
        self.extra_env = env
        self.plan = plan
        self.proc: subprocess.Popen | None = None
        # the daemon's stderr goes to a file, not a pipe: nothing drains a
        # pipe while the daemon serves, so a chatty daemon would fill it and
        # block in its own logging call. The file is also the death report.
        self.log_path = os.path.join(tempfile.gettempdir(),
                                     f"devd-supervised-{os.getpid()}-{id(self):x}.log")
        self._churn_stop = threading.Event()
        self._churn_thread: threading.Thread | None = None
        self.kills = 0
        self.restarts = 0

    def start(self, wait_held_s: float = 30.0) -> None:
        if self.plan is not None:
            # kills noted on the plan show in the scrape like any plan's
            register(self.plan)
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = {
            **os.environ,
            "TENDERMINT_DEVD_SOCK": self.sock_path,
            "TENDERMINT_DEVD_EXIT_ON_TERM": "1",
            **self.extra_env,
        }
        # a fleet's harness exports the endpoint list; a daemon binds its own
        # socket and never reads the fleet's
        env.pop("TENDERMINT_DEVD_SOCKS", None)
        with open(self.log_path, "ab") as log:
            self.proc = subprocess.Popen([sys.executable, "-m", "tendermint_tpu_torch.devd"],
                                         env=env, cwd=repo, stdout=subprocess.DEVNULL, stderr=log)
        if wait_held_s > 0:
            self.wait_held(wait_held_s)

    def _log_tail(self, nbytes: int = 2000) -> bytes:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - nbytes))
                return f.read()
        except OSError:
            return b""

    def wait_held(self, deadline_s: float) -> dict:
        client = devd.DevdClient(self.sock_path)
        deadline = time.time() + deadline_s
        try:
            while time.time() < deadline:
                if self.proc is not None and self.proc.poll() is not None:
                    raise RuntimeError(f"supervised daemon died: {self._log_tail()!r}")
                try:
                    rep = client.ping(timeout=2.0)
                    if rep.get("held"):
                        return rep
                except Exception:  # noqa: BLE001 - not serving yet
                    pass
                time.sleep(0.1)
            raise TimeoutError(f"daemon on {self.sock_path} never reached serving state")
        finally:
            client.close()

    def kill(self) -> None:
        """SIGKILL: the fault modelled is an unclean death, so no shutdown
        op (and the daemon ignores SIGTERM unless told otherwise)."""
        if self.proc is None:
            return
        try:
            self.proc.kill()
            self.proc.wait(timeout=15)
        except Exception:  # noqa: BLE001 - reaped elsewhere, or gone
            pass
        self.proc = None
        self.kills += 1
        _note_supervisor("kills")
        if self.plan is not None:
            self.plan.note("kill")

    def restart(self, wait_held_s: float = 30.0) -> None:
        self.kill()
        # an unclean kill leaves the socket file behind; the daemon's own
        # start-up handles a stale socket
        self.start(wait_held_s=wait_held_s)
        self.restarts += 1
        _note_supervisor("restarts")

    def churn(self, down_s: float = 0.5, up_s: float = 2.0, cycles: int = 0) -> None:
        """Kill and restart in the background: down for down_s, up for
        up_s, `cycles` times (0: until stop_churn). Always leaves the
        daemon running, so recovery can be seen."""

        def run() -> None:
            n = 0
            while not self._churn_stop.is_set():
                if cycles and n >= cycles:
                    break
                self.kill()
                if self._churn_stop.wait(down_s):
                    break
                try:
                    self.start(wait_held_s=30.0)
                except Exception:  # noqa: BLE001 - a restart raced stop()
                    logger.exception("chaos restart failed")
                    break
                self.restarts += 1
                _note_supervisor("restarts")
                n += 1
                if self._churn_stop.wait(up_s):
                    break
            if self.proc is None and not self._churn_stop.is_set():
                try:
                    self.start(wait_held_s=30.0)
                except Exception:  # noqa: BLE001 - left down; stop() reaps
                    logger.exception("final chaos restart failed")

        self._churn_stop.clear()
        self._churn_thread = threading.Thread(target=run, daemon=True, name="chaos-churn")
        self._churn_thread.start()

    def stop_churn(self, ensure_up: bool = True) -> None:
        self._churn_stop.set()
        if self._churn_thread is not None:
            self._churn_thread.join(timeout=60.0)
            self._churn_thread = None
        if ensure_up and self.proc is None:
            self.start(wait_held_s=30.0)

    def stop(self) -> None:
        self._churn_stop.set()
        if self._churn_thread is not None:
            self._churn_thread.join(timeout=60.0)
        if self.proc is not None:
            try:
                self.proc.kill()
                self.proc.wait(timeout=15)
            except Exception:  # noqa: BLE001 - gone already
                pass
            self.proc = None
        if self.plan is not None:
            unregister(self.plan)


class DaemonFleet:
    """N supervised daemons on their own sockets: the multi-daemon plane's
    harness. ACCEPT_CPU only, as DaemonSupervisor; `socks_env` is the
    TENDERMINT_DEVD_SOCKS value."""

    def __init__(self, n: int, sock_dir: str | None = None, extra_env: dict | None = None):
        base = sock_dir or tempfile.gettempdir()
        self.supervisors = [
            DaemonSupervisor(os.path.join(base, f"devd-fleet-{os.getpid()}-{id(self):x}-{i}.sock"),
                             extra_env=dict(extra_env or {}))
            for i in range(n)
        ]

    @property
    def sock_paths(self) -> list[str]:
        return [s.sock_path for s in self.supervisors]

    @property
    def socks_env(self) -> str:
        """The TENDERMINT_DEVD_SOCKS value for this fleet."""
        return ",".join(self.sock_paths)

    def start(self, wait_held_s: float = 30.0) -> DaemonFleet:
        started = []
        try:
            for s in self.supervisors:
                s.start(wait_held_s=wait_held_s)
                started.append(s)
        except BaseException:
            for s in started:
                s.stop()
            raise
        return self

    def kill(self, i: int) -> None:
        self.supervisors[i].kill()

    def restart(self, i: int, wait_held_s: float = 30.0) -> None:
        self.supervisors[i].restart(wait_held_s=wait_held_s)

    def stop(self) -> None:
        for s in self.supervisors:
            s.stop()


# -- the proxy as its own process ------------------------------------------------


def main(argv=None) -> int:
    """Run a FaultProxy as its own process (multi-process harnesses point
    TENDERMINT_DEVD_SOCK at --listen). The schedule comes from the rate
    flags; the counters print as one JSON line on SIGTERM or SIGINT."""
    ap = argparse.ArgumentParser(description=FaultProxy.__doc__)
    ap.add_argument("--listen", required=True, help="unix socket path to serve")
    ap.add_argument("--upstream", required=True, help="the real daemon's socket")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corrupt-every", type=int, default=0, help="corrupt every Nth daemon->client frame")
    ap.add_argument("--truncate-every", type=int, default=0, help="truncate every Nth client->daemon frame")
    ap.add_argument("--stall-every", type=int, default=0, help="stall every Nth daemon->client frame")
    ap.add_argument("--stall-s", type=float, default=0.5)
    args = ap.parse_args(argv)

    plan = FaultPlan(seed=args.seed)
    big = 1 << 30  # rate rules fire for as long as the proxy runs
    if args.corrupt_every:
        plan.add("corrupt", "s2c", first=args.corrupt_every, every=args.corrupt_every, limit=big)
    if args.truncate_every:
        plan.add("truncate", "c2s", first=args.truncate_every, every=args.truncate_every, limit=big)
    if args.stall_every:
        plan.add("stall", "s2c", first=args.stall_every, every=args.stall_every, limit=big,
                 stall_s=args.stall_s)

    proxy = FaultProxy(args.listen, args.upstream, plan).start()
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    logging.basicConfig(level=logging.INFO)
    logger.info("fault proxy %s -> %s", args.listen, args.upstream)
    done.wait()
    proxy.stop()
    print(json.dumps(plan.stats()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
