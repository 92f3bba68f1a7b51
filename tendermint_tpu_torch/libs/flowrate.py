"""Flow-rate monitoring and limiting — equivalent of tmlibs/flowrate, used by
MConnection send/recv throttling (p2p/connection.go:352,410) and the
fast-sync per-peer minimum-rate check (blockchain/pool.go:100-118).
"""

from __future__ import annotations

import threading
import time


class Status:
    def __init__(self, bytes_total: int, avg_rate: float, cur_rate: float):
        self.bytes = bytes_total
        self.avg_rate = avg_rate
        self.cur_rate = cur_rate


class Monitor:
    """EWMA rate monitor with an optional limit() that sleeps to cap the
    average transfer rate."""

    def __init__(self, sample_period: float = 0.1):
        self._mtx = threading.Lock()
        self._start = time.monotonic()
        self._bytes = 0
        self._cur_rate = 0.0
        self._window_start = self._start
        self._window_bytes = 0
        self._sample_period = sample_period

    def update(self, n: int) -> None:
        with self._mtx:
            now = time.monotonic()
            self._bytes += n
            self._window_bytes += n
            dt = now - self._window_start
            if dt >= self._sample_period:
                inst = self._window_bytes / dt
                # EWMA, alpha=0.5 per sample window
                self._cur_rate = inst if self._cur_rate == 0 else (self._cur_rate + inst) / 2
                self._window_start = now
                self._window_bytes = 0

    def limit(self, want: int, rate_limit: float) -> int:
        """Sleep as needed so the *average* rate stays <= rate_limit, then
        return how many bytes the caller may transfer (always `want` here;
        pacing is purely time-based)."""
        if rate_limit <= 0:
            return want
        with self._mtx:
            elapsed = time.monotonic() - self._start
            allowed = rate_limit * elapsed
            excess = self._bytes - allowed
        if excess > 0:
            time.sleep(excess / rate_limit)
        return want

    def status(self) -> Status:
        with self._mtx:
            now = time.monotonic()
            elapsed = max(now - self._start, 1e-9)
            return Status(self._bytes, self._bytes / elapsed, self._cur_rate)
