"""Seeded adversarial stream wrapper (reference: p2p/fuzz.go).

Audited for the adversarial tier: the reference's silent
read/write DROP mode (`prob_drop_rw`) predated the secure transport and
was broken against `SecretConnection` — a silently dropped write
desyncs the AEAD counter nonces, so every LATER frame fails
authentication and the wrapper poisons its own connection forever.
Nothing real was being simulated either: TCP never loses stream bytes
silently (loss is retransmit latency, which `prob_sleep` models, and
which the WAN profiles in ops/netfaults model properly).

The drop mode is therefore replaced by `prob_corrupt`: a seeded
single-byte XOR on outbound writes. Layered where PeerConfig puts this
wrapper — UNDER the SecretConnection — a corrupted write is ciphertext
tamper on the wire, which the remote AEAD flags loudly
(p2p_secretconn_auth_failures_total + peer dropped for cause). That
makes FuzzedStream the adversarial tier's FRAME-CORRUPTION peer: a
hostile-but-fluent peer built over it speaks the real protocol while a
seeded fraction of its frames arrive tampered (docs/netchaos.md,
docs/secure-p2p.md threat model).

Delay modes (`prob_sleep`, `max_delay`) are unchanged — reads are only
ever delayed, never dropped, since dropping reads would desync framing
on our own side.
"""

from __future__ import annotations

import random
import time


class FuzzedStream:
    def __init__(
        self,
        stream,
        prob_corrupt: float = 0.0,
        prob_sleep: float = 0.0,
        max_delay: float = 0.1,
        seed: int | None = None,
    ):
        self.stream = stream
        self.prob_corrupt = prob_corrupt
        self.prob_sleep = prob_sleep
        self.max_delay = max_delay
        self.corrupted_writes = 0  # observable by harnesses/tests
        self._rng = random.Random(seed)

    def _maybe_sleep(self) -> None:
        if self._rng.random() < self.prob_sleep:
            time.sleep(self._rng.random() * self.max_delay)

    def read(self, n: int) -> bytes:
        # reads are only delayed: dropping them would desync framing
        self._maybe_sleep()
        return self.stream.read(n)

    def write(self, data: bytes) -> None:
        self._maybe_sleep()
        if data and self._rng.random() < self.prob_corrupt:
            buf = bytearray(data)
            buf[self._rng.randrange(len(buf))] ^= 0xFF
            data = bytes(buf)
            self.corrupted_writes += 1
        self.stream.write(data)

    def close(self) -> None:
        self.stream.close()

    def remote_addr(self) -> str:
        inner = getattr(self.stream, "remote_addr", None)
        return inner() if inner else "fuzzed"
