"""Authenticated-encryption transport (reference: p2p/secret_connection.go,
spec docs/secure-p2p.md + docs/specification/secure-p2p.rst).

Same STS-like shape as the reference, modern primitives (this framework
defines its own wire protocol, so no nacl-secretbox compatibility):

1. exchange 32-byte ephemeral X25519 pubkeys in the clear;
2. shared = X25519(eph_priv, remote_eph_pub); per-direction keys via
   HKDF-SHA256 over the sorted ephemeral pubkeys (lo||hi transcript) —
   the lexicographically-lower side sends with key1, the higher with key2;
3. all further traffic is ChaCha20-Poly1305 frames with counter nonces
   (distinct per direction via the key split);
4. challenge = SHA256(lo_eph || hi_eph); both sides send
   (node_pubkey, ed25519_sig(challenge)) over the encrypted channel and
   verify — authenticating the node identity key (secret_connection.go:49-101).

Frames: [len:2 BE][ciphertext = plaintext+16B tag], plaintext <=1024B.

The primitives are IN-REPO (crypto/x25519.py, crypto/chacha20poly1305.py
— pure-Python pinned to the RFC 7748/8439 vectors, with `cryptography`
and ctypes-libcrypto fast paths selected via TENDERMINT_SECRETCONN_BACKEND),
so the encrypted transport works on any host. The wire bytes are
backend-independent: both ends may run different backends.

Failure semantics:
- an AEAD authentication failure is TAMPERING, never EOF: the connection
  poisons itself, the stream closes, and every current/later read raises
  SecretConnectionError — a bit-flipped frame surfaces as a loud peer
  error (switch: "stopping peer for error"), not a graceful hangup;
- the handshake is deadline-bounded (TENDERMINT_SECRETCONN_HANDSHAKE_S,
  default 20 s): a stalled or byte-dribbling peer cannot pin the
  handshake thread forever;
- both families count in p2p_secretconn_* telemetry (process-wide
  instruments, materialized by node/telemetry.py like the devd
  histograms).
"""

from __future__ import annotations

import hashlib
import json
import socket
import struct
import threading
import time

from tendermint_tpu_torch.crypto.chacha20poly1305 import ChaCha20Poly1305, InvalidTag
from tendermint_tpu_torch.crypto.keys import PrivKeyEd25519, PubKeyEd25519, SignatureEd25519
from tendermint_tpu_torch.crypto.x25519 import X25519PrivateKey, X25519PublicKey
from tendermint_tpu_torch.libs import telemetry
from tendermint_tpu_torch.libs.envknob import env_number

DATA_MAX_SIZE = 1024
_LEN = struct.Struct(">H")

DEFAULT_HANDSHAKE_S = 20.0


class SecretConnectionError(ConnectionError):
    """Cryptographic failure on the link: tampered/reordered frame,
    bad challenge signature — never a routine peer hangup."""


class HandshakeTimeout(ConnectionError):
    """The key/auth exchange did not complete within the deadline."""


def _counters() -> dict:
    """p2p_secretconn_* counter families (create-or-get from the CURRENT
    default registry each call, so instruments survive test resets —
    node/telemetry.py materializes them so the scrape family set is
    stable from the first height)."""
    reg = telemetry.default_registry()
    return {
        "handshakes": reg.counter(
            "p2p_secretconn_handshakes_total",
            "completed SecretConnection handshakes",
        ),
        "handshake_failures": reg.counter(
            "p2p_secretconn_handshake_failures_total",
            "SecretConnection handshakes failed (bad peer bytes, EOF, "
            "invalid challenge signature)",
        ),
        "handshake_timeouts": reg.counter(
            "p2p_secretconn_handshake_timeouts_total",
            "SecretConnection handshakes abandoned at the deadline",
        ),
        "auth_failures": reg.counter(
            "p2p_secretconn_auth_failures_total",
            "AEAD frame authentication failures (tamper/reorder/desync)",
        ),
        "oversized_frames": reg.counter(
            "p2p_secretconn_oversized_frames_total",
            "frames refused for an illegal length claim before any "
            "payload was buffered (oversized-frame adversary)",
        ),
    }


def _hkdf(secret: bytes, info: bytes, length: int = 64) -> bytes:
    """HKDF-SHA256 (extract with zero salt + expand)."""
    prk = hashlib.sha256(b"\x00" * 32 + secret).digest()
    out, t, i = b"", b"", 1
    while len(out) < length:
        t = hashlib.sha256(prk + t + info + bytes([i])).digest()
        out += t
        i += 1
    return out[:length]


class SecretConnection:
    """Wraps a stream; satisfies the stream interface itself."""

    def __init__(self, stream, priv_key: PrivKeyEd25519,
                 handshake_timeout_s: float | None = None):
        self.stream = stream
        if handshake_timeout_s is None:
            handshake_timeout_s = env_number(
                "TENDERMINT_SECRETCONN_HANDSHAKE_S", DEFAULT_HANDSHAKE_S
            )
        self._deadline = (
            time.monotonic() + handshake_timeout_s
            if handshake_timeout_s and handshake_timeout_s > 0 else None
        )
        # the Switch arms its own admission timeout on the socket BEFORE
        # building the peer (add_peer_from_stream); remember it so the
        # deadline bookkeeping below restores it rather than clearing it
        # — wiping it would leave the NodeInfo half of admission
        # unbounded against a peer that stalls after the secret handshake
        sock = self._sock()
        self._prior_sock_timeout = None
        if sock is not None:
            try:
                self._prior_sock_timeout = sock.gettimeout()
            except OSError:
                pass
        self._poisoned: SecretConnectionError | None = None
        try:
            self._handshake(stream, priv_key)
        except HandshakeTimeout:
            _counters()["handshake_timeouts"].inc()
            _counters()["handshake_failures"].inc()
            raise
        except socket.timeout as exc:
            # a deadline-armed WRITE tripped (sendall past the budget)
            _counters()["handshake_timeouts"].inc()
            _counters()["handshake_failures"].inc()
            raise HandshakeTimeout(
                "secret connection: handshake timed out"
            ) from exc
        except Exception:
            _counters()["handshake_failures"].inc()
            raise
        else:
            _counters()["handshakes"].inc()
        finally:
            self._deadline = None
            self._restore_sock_timeout()

    def _handshake(self, stream, priv_key: PrivKeyEd25519) -> None:
        eph_priv = X25519PrivateKey.generate()
        eph_pub = eph_priv.public_key().public_bytes_raw()
        self.backend = eph_priv.backend

        # 1. ephemeral exchange (concurrent-safe: write then read)
        self._bound_to_deadline()
        stream.write(eph_pub)
        remote_eph = self._read_exact(32)

        shared = eph_priv.exchange(X25519PublicKey.from_public_bytes(remote_eph))
        lo, hi = sorted((eph_pub, remote_eph))
        keys = _hkdf(shared, b"TENDERMINT_TPU_SECRET_CONNECTION" + lo + hi)
        if eph_pub == lo:
            send_key, recv_key = keys[:32], keys[32:]
        else:
            send_key, recv_key = keys[32:], keys[:32]
        self._send_aead = ChaCha20Poly1305(send_key)
        self._recv_aead = ChaCha20Poly1305(recv_key)
        self._send_nonce = 0
        self._recv_nonce = 0
        self._wmtx = threading.Lock()
        self._rmtx = threading.Lock()
        self._recv_buf = b""

        # 4. authenticate node keys over the encrypted channel
        challenge = hashlib.sha256(lo + hi).digest()
        auth = json.dumps(
            {
                "pub_key": priv_key.pub_key().to_json(),
                "sig": priv_key.sign(challenge).to_json(),
            }
        ).encode()
        self._bound_to_deadline()
        self.write(auth)
        remote_auth = json.loads(self._read_msg().decode())
        remote_pub = PubKeyEd25519.from_json(remote_auth["pub_key"])
        remote_sig = SignatureEd25519.from_json(remote_auth["sig"])
        if not remote_pub.verify_bytes(challenge, remote_sig):
            stream.close()
            raise SecretConnectionError(
                "secret connection: challenge signature invalid"
            )
        self._remote_pubkey = remote_pub

    def remote_pubkey(self) -> PubKeyEd25519:
        return self._remote_pubkey

    # -- handshake deadline -------------------------------------------------

    def _sock(self) -> socket.socket | None:
        return getattr(self.stream, "sock", None)

    def _bound_to_deadline(self) -> None:
        """Bound the next blocking socket op by the remaining handshake
        budget (streams without a socket — in-process pipes under test
        fabrics are socketpairs, so they have one — simply stay
        unbounded). A byte-dribbling peer is covered because the
        deadline is ABSOLUTE: every read re-arms with what's left."""
        if self._deadline is None:
            return
        remaining = self._deadline - time.monotonic()
        if remaining <= 0:
            raise HandshakeTimeout("secret connection: handshake timed out")
        sock = self._sock()
        if sock is not None:
            try:
                sock.settimeout(remaining)
            except OSError:
                pass

    def _restore_sock_timeout(self) -> None:
        # put back whatever was armed before our per-read deadlines: the
        # Switch's admission timeout must keep covering the NodeInfo
        # handshake that follows (it clears it itself after admission);
        # for a direct construction this restores None, so no stray
        # timeout leaks onto the data path
        sock = self._sock()
        if sock is not None:
            try:
                sock.settimeout(self._prior_sock_timeout)
            except OSError:
                pass

    # -- framing -----------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            if self._deadline is not None:
                self._bound_to_deadline()
            try:
                chunk = self.stream.read(n - len(buf))
            except socket.timeout as exc:
                raise HandshakeTimeout(
                    "secret connection: handshake timed out"
                ) from exc
            if not chunk:
                # a SocketStream swallows OSError (incl. timeouts) into
                # b"" — distinguish deadline expiry from a peer hangup
                if self._deadline is not None and \
                        time.monotonic() >= self._deadline:
                    raise HandshakeTimeout(
                        "secret connection: handshake timed out"
                    )
                raise ConnectionError("stream closed during secret handshake/read")
            buf += chunk
        return bytes(buf)

    def _nonce12(self, counter: int) -> bytes:
        return counter.to_bytes(12, "big")

    def _write_frame(self, chunk: bytes) -> None:
        ct = self._send_aead.encrypt(self._nonce12(self._send_nonce), chunk, None)
        self._send_nonce += 1
        self.stream.write(_LEN.pack(len(ct)) + ct)

    def _read_msg(self) -> bytes:
        """One frame's plaintext."""
        (clen,) = _LEN.unpack(self._read_exact(_LEN.size))
        if clen > DATA_MAX_SIZE + 16:
            # oversized-frame adversary: our writer never
            # exceeds plaintext DATA_MAX_SIZE + the 16-byte tag, so a
            # larger claim is protocol abuse — refuse BEFORE buffering
            # the claimed payload (the old path read up to 64 KiB of
            # attacker bytes per frame just to fail the AEAD tag)
            _counters()["oversized_frames"].inc()
            _counters()["auth_failures"].inc()
            err = SecretConnectionError(
                f"secret connection: oversized frame claim ({clen} B; "
                f"legal max {DATA_MAX_SIZE + 16})"
            )
            self._poisoned = err
            self.stream.close()
            raise err
        ct = self._read_exact(clen)
        try:
            pt = self._recv_aead.decrypt(self._nonce12(self._recv_nonce), ct, None)
        except InvalidTag as exc:
            # tampering / desync is unrecoverable: poison the connection
            _counters()["auth_failures"].inc()
            err = SecretConnectionError(
                "secret connection: frame authentication failed"
            )
            self._poisoned = err
            self.stream.close()
            raise err from exc
        self._recv_nonce += 1
        return pt

    # -- stream interface --------------------------------------------------

    def write(self, data: bytes) -> None:
        with self._wmtx:
            for off in range(0, len(data), DATA_MAX_SIZE):
                self._write_frame(data[off : off + DATA_MAX_SIZE])
            if not data:
                self._write_frame(b"")

    def read(self, n: int) -> bytes:
        """Up to n plaintext bytes; b"" on clean EOF (peer hangup).
        Tampering is NOT EOF: an authentication failure raises
        SecretConnectionError — here and on every subsequent read (the
        connection is poisoned) — so the mconn recv routine drops the
        peer for cause instead of reading a quiet close."""
        with self._rmtx:
            if self._poisoned is not None:
                raise self._poisoned
            if not self._recv_buf:
                try:
                    self._recv_buf = self._read_msg()
                except SecretConnectionError:
                    raise
                except ConnectionError:
                    return b""
            out, self._recv_buf = self._recv_buf[:n], self._recv_buf[n:]
            return out

    def close(self) -> None:
        self.stream.close()

    def remote_addr(self) -> str:
        inner = getattr(self.stream, "remote_addr", None)
        return inner() if inner else "secret"
