"""Service lifecycle, the equivalent of tmlibs/common BaseService.

The reference wraps every long-lived component (Switch, reactors,
ConsensusState, Mempool WAL, ...) in a BaseService with idempotent
Start/Stop and an overridable OnStart/OnStop. We keep the same contract so
the node assembly (node/node.go:310) translates directly.
"""

from __future__ import annotations

import logging
import threading


class BaseService:
    """Idempotent start/stop lifecycle with subclass hooks.

    Contract (mirrors tmlibs BaseService):
    - start() runs on_start() exactly once; a second start() returns False.
    - stop() runs on_stop() exactly once after a successful start.
    - is_running() is True between start and stop.
    - wait() blocks until the service is stopped.
    """

    def __init__(self, name: str | None = None, logger: logging.Logger | None = None):
        self._name = name or type(self).__name__
        self.logger = logger or logging.getLogger(self._name)
        self._started = False
        self._stopped = False
        self._mtx = threading.Lock()
        self._quit = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> bool:
        with self._mtx:
            if self._stopped:
                raise RuntimeError(f"{self._name}: cannot restart a stopped service")
            if self._started:
                return False
            self._started = True
        self.logger.debug("starting %s", self._name)
        try:
            self.on_start()
        except Exception:
            with self._mtx:
                self._started = False
            raise
        return True

    def stop(self) -> bool:
        with self._mtx:
            if not self._started or self._stopped:
                return False
            self._stopped = True
        self.logger.debug("stopping %s", self._name)
        self.on_stop()
        self._quit.set()
        return True

    def is_running(self) -> bool:
        with self._mtx:
            return self._started and not self._stopped

    def wait(self, timeout: float | None = None) -> bool:
        return self._quit.wait(timeout)

    @property
    def quit_event(self) -> threading.Event:
        return self._quit

    # -- subclass hooks ----------------------------------------------------

    def on_start(self) -> None:  # pragma: no cover - trivial default
        pass

    def on_stop(self) -> None:  # pragma: no cover - trivial default
        pass

    def __repr__(self) -> str:
        state = "running" if self.is_running() else ("stopped" if self._stopped else "new")
        return f"<{self._name} [{state}]>"


class Routine:
    """A named daemon thread with a stop event — the goroutine-with-quit-channel
    pattern used throughout the reference (e.g. consensus/state.go:609
    receiveRoutine, p2p/connection.go:293 sendRoutine)."""

    def __init__(self, target, name: str, *args):
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=target, args=(*args,), name=name, daemon=True
        )

    def start(self) -> "Routine":
        self._thread.start()
        return self

    def signal_stop(self) -> None:
        self._stop.set()

    @property
    def stop_event(self) -> threading.Event:
        return self._stop

    def join(self, timeout: float | None = None) -> None:
        self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread.is_alive()
