"""The port's secure-transport primitives (crypto/x25519.py,
crypto/chacha20poly1305.py, crypto/_openssl.py) and its
SecretConnection (p2p/secret_connection.py) against the RFC vectors
and against the JAX package's.

The vectors and the backend selection of tests/test_secure_transport.py
run on the port's modules. Beside them: x25519 and the AEAD give the
same bytes in both packages on the same keys and nonces, on every
backend this host has, and a JAX SecretConnection and a port
SecretConnection handshake on a socket pair, either side dialing, and
carry frames both ways.
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest

from tendermint_tpu_torch.crypto import _openssl
from tendermint_tpu_torch.crypto import chacha20poly1305 as aead
from tendermint_tpu_torch.crypto import x25519 as x
from tendermint_tpu_torch.crypto.keys import gen_priv_key_ed25519
from tendermint_tpu_torch.p2p.secret_connection import (
    HandshakeTimeout,
    SecretConnection,
    SecretConnectionError,
)
from tendermint_tpu_torch.p2p.stream import SocketStream, pipe_pair

# -- RFC 7748 X25519 ----------------------------------------------------------


class TestX25519Vectors:
    def test_rfc7748_section_5_2_vector_1(self):
        k = bytes.fromhex("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4")
        u = bytes.fromhex("e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c")
        assert x.x25519(k, u) == bytes.fromhex("c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552")

    def test_rfc7748_section_5_2_vector_2(self):
        k = bytes.fromhex("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d")
        u = bytes.fromhex("e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493")
        assert x.x25519(k, u) == bytes.fromhex("95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957")

    def test_rfc7748_iterated_ladder_one(self):
        assert x.scalar_mult(x.BASE_POINT, x.BASE_POINT) == bytes.fromhex(
            "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079")

    @pytest.mark.slow
    def test_rfc7748_iterated_ladder_1000(self):
        k, u = x.BASE_POINT, x.BASE_POINT
        for _ in range(1000):
            k, u = x.scalar_mult(k, u), k
        assert k == bytes.fromhex("684cf59ba83309552800ef566f2f4d3c1c3887c49360e3875f2eb94d99532c51")

    def test_rfc7748_section_6_1_diffie_hellman(self):
        a = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
        b = bytes.fromhex("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
        a_pub, b_pub = x.public_from_private(a), x.public_from_private(b)
        assert a_pub == bytes.fromhex("8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
        assert b_pub == bytes.fromhex("de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
        shared = bytes.fromhex("4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
        assert x.x25519(a, b_pub) == shared and x.x25519(b, a_pub) == shared

    def test_low_order_point_rejected(self):
        k = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
        with pytest.raises(x.X25519Error):
            x.x25519(k, b"\x00" * 32)

    def test_length_validation(self):
        with pytest.raises(x.X25519Error):
            x.scalar_mult(b"\x01" * 31, x.BASE_POINT)
        with pytest.raises(x.X25519Error):
            x.scalar_mult(b"\x01" * 32, b"\x02" * 33)

    def test_key_objects_roundtrip_any_backend(self):
        a = x.X25519PrivateKey.generate()
        b = x.X25519PrivateKey.generate(backend="pure")
        s1, s2 = a.exchange(b.public_key()), b.exchange(a.public_key())
        assert s1 == s2 and len(s1) == 32


# -- RFC 8439 ChaCha20-Poly1305 -----------------------------------------------

_SUNSCREEN = (
    b"Ladies and Gentlemen of the class of '99: If I could offer you "
    b"only one tip for the future, sunscreen would be it."
)


class TestChaCha20Poly1305Vectors:
    def test_rfc8439_2_3_2_block(self):
        key, nonce = bytes(range(32)), bytes.fromhex("000000090000004a00000000")
        assert aead.chacha20_block(key, 1, nonce) == bytes.fromhex(
            "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9a"
            "c3d46c4ed2826446079faa0914c2d705d98b02a2b5129cd1de164eb9"
            "cbd083e8a2503c4e")

    def test_rfc8439_2_4_2_encryption(self):
        key, nonce = bytes(range(32)), bytes.fromhex("000000000000004a00000000")
        ct = aead.chacha20_xor(key, 1, nonce, _SUNSCREEN)
        assert ct == bytes.fromhex(
            "6e2e359a2568f98041ba0728dd0d6981e97e7aec1d4360c20a27afcc"
            "fd9fae0bf91b65c5524733ab8f593dabcd62b3571639d624e65152ab"
            "8f530c359f0861d807ca0dbf500d6a6156a38e088a22b65e52bc514d"
            "16ccf806818ce91ab77937365af90bbf74a35be6b40b8eedf2785e42"
            "874d")
        assert aead.chacha20_xor(key, 1, nonce, ct) == _SUNSCREEN

    def test_rfc8439_2_5_2_poly1305(self):
        key = bytes.fromhex("85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b")
        tag = aead.poly1305_mac(key, b"Cryptographic Forum Research Group")
        assert tag == bytes.fromhex("a8061dc1305136c6c22b8baf0c0127a9")

    def test_rfc8439_2_8_2_aead_seal_open(self):
        key = bytes(range(0x80, 0xA0))
        nonce = bytes.fromhex("070000004041424344454647")
        aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
        boxed = aead.seal(key, nonce, _SUNSCREEN, aad)
        assert boxed[-16:] == bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")
        assert boxed[:-16] == bytes.fromhex(
            "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a7"
            "36ee62d63dbea45e8ca9671282fafb69da92728b1a71de0a9e060b29"
            "05d6a5b67ecd3b3692ddbd7f2d778b8c9803aee328091b58fab324e4"
            "fad675945585808b4831d7bc3ff4def08e4b7a9de576d26586cec64b"
            "6116")
        assert aead.open_(key, nonce, boxed, aad) == _SUNSCREEN

    def test_tamper_and_truncation_rejected(self):
        key, nonce = bytes(32), bytes(12)
        boxed = aead.seal(key, nonce, b"payload", b"aad")
        for bad in (boxed[:-1] + bytes([boxed[-1] ^ 1]), bytes([boxed[0] ^ 1]) + boxed[1:],
                    boxed[:-1], boxed[:15], b""):
            with pytest.raises(aead.InvalidTag):
                aead.open_(key, nonce, bad, b"aad")
        for args in ((key, nonce, boxed, b"other"), (key, bytes(11) + b"\x01", boxed, b"aad"),
                     (b"\x01" + key[1:], nonce, boxed, b"aad")):
            with pytest.raises(aead.InvalidTag):
                aead.open_(*args)

    def test_empty_plaintext(self):
        boxed = aead.seal(bytes(32), bytes(12), b"", b"")
        assert len(boxed) == 16 and aead.open_(bytes(32), bytes(12), boxed, b"") == b""

    def test_counter_wraps_modulo_2_32(self):
        key, nonce = bytes(range(32)), bytes(12)
        assert aead.chacha20_block(key, 1 << 32, nonce) == aead.chacha20_block(key, 0, nonce)


# -- backend selection and the port's own cross-backend oracle ----------------


def _aead_cases(seed: int):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 15, 16, 17, 64, 1024, 4096):
        yield rng.bytes(32), rng.bytes(12), rng.bytes(n), rng.bytes(7)


class TestBackendSelection:
    @pytest.mark.skipif(not _openssl.available(), reason="parity oracle: no libcrypto")
    def test_openssl_aead_matches_pure(self):
        for key, nonce, pt, ad in _aead_cases(1):
            boxed = aead.seal(key, nonce, pt, ad)
            assert _openssl.aead_seal(key, nonce, pt, ad) == boxed
            assert _openssl.aead_open(key, nonce, boxed, ad) == pt
            assert _openssl.aead_open(key, nonce, boxed[:-1] + bytes([boxed[-1] ^ 0x80]), ad) is None

    @pytest.mark.skipif(not _openssl.available(), reason="parity oracle: no libcrypto")
    def test_openssl_x25519_matches_pure(self):
        rng = np.random.default_rng(2)
        for _ in range(4):
            a, b = rng.bytes(32), rng.bytes(32)
            b_pub = x.public_from_private(b)
            assert _openssl.x25519_public(a) == x.public_from_private(a)
            assert _openssl.x25519_derive(a, b_pub) == x.x25519(a, b_pub)
        assert _openssl.x25519_derive(a, b"\x00" * 32) is None

    @pytest.mark.skipif(not aead.have_native(), reason="parity oracle: cryptography absent")
    def test_native_aead_matches_pure(self):
        for key, nonce, pt, ad in _aead_cases(3):
            nat = aead.ChaCha20Poly1305(key, backend="native")
            pure = aead.ChaCha20Poly1305(key, backend="pure")
            boxed = nat.encrypt(nonce, pt, ad)
            assert boxed == pure.encrypt(nonce, pt, ad)
            assert nat.decrypt(nonce, boxed, ad) == pt == pure.decrypt(nonce, boxed, ad)

    def test_pinned_unavailable_backend_raises(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_SECRETCONN_BACKEND", "native")
        if x.have_native():
            assert x.resolve_backend() == "native"
        else:
            with pytest.raises(RuntimeError):
                x.resolve_backend()

    def test_unknown_backend_value_falls_back(self, monkeypatch):
        monkeypatch.setenv("TENDERMINT_SECRETCONN_BACKEND", "quantum")
        assert x.resolve_backend() in ("pure", "native", "openssl")

    @pytest.mark.parametrize("value", ["", "auto", "pure", "native", "openssl", "quantum"])
    def test_backend_knob_resolves_as_the_jax_package(self, monkeypatch, value):
        """The same TENDERMINT_SECRETCONN_BACKEND value picks the same
        backend in both packages, or raises in both."""
        from tendermint_tpu.crypto import x25519 as jx

        monkeypatch.setenv("TENDERMINT_SECRETCONN_BACKEND", value)

        def resolve(mod):
            try:
                return mod.resolve_backend()
            except RuntimeError as exc:
                return ("raises", type(exc).__name__)

        assert resolve(x) == resolve(jx)


# -- the same bytes as the JAX package ----------------------------------------


def _backends() -> list[str]:
    out = ["pure"]
    if _openssl.available():
        out.append("openssl")
    if aead.have_native():
        out.append("native")
    return out


@pytest.mark.parametrize("backend", _backends())
def test_x25519_bytes_equal_across_packages(backend):
    from tendermint_tpu.crypto import x25519 as jx

    rng = np.random.default_rng(11)
    for _ in range(3):
        a, b = rng.bytes(32), rng.bytes(32)
        pa = x.X25519PrivateKey.from_private_bytes(a, backend=backend)
        ja = jx.X25519PrivateKey.from_private_bytes(a, backend=backend)
        pb_pub = x.X25519PrivateKey.from_private_bytes(b, backend="pure").public_key()
        jb_pub = jx.X25519PrivateKey.from_private_bytes(b, backend="pure").public_key()
        assert pa.public_key().public_bytes_raw() == ja.public_key().public_bytes_raw()
        assert pb_pub.public_bytes_raw() == jb_pub.public_bytes_raw()
        assert pa.exchange(pb_pub) == ja.exchange(jb_pub)
        assert x.x25519(a, pb_pub.public_bytes_raw()) == jx.x25519(a, jb_pub.public_bytes_raw())


@pytest.mark.parametrize("backend", _backends())
def test_aead_bytes_equal_across_packages(backend):
    from tendermint_tpu.crypto import chacha20poly1305 as jaead

    for key, nonce, pt, ad in _aead_cases(12):
        mine = aead.ChaCha20Poly1305(key, backend=backend)
        theirs = jaead.ChaCha20Poly1305(key, backend=backend)
        boxed = mine.encrypt(nonce, pt, ad)
        assert boxed == theirs.encrypt(nonce, pt, ad)
        assert theirs.decrypt(nonce, boxed, ad) == pt == mine.decrypt(nonce, boxed, ad)
        tampered = bytes([boxed[0] ^ 1]) + boxed[1:]
        with pytest.raises(aead.InvalidTag):
            mine.decrypt(nonce, tampered, ad)
        with pytest.raises(jaead.InvalidTag):
            theirs.decrypt(nonce, tampered, ad)
    assert aead.chacha20_block(bytes(range(32)), 7, bytes(12)) == jaead.chacha20_block(bytes(range(32)), 7, bytes(12))
    assert aead.poly1305_mac(bytes(range(32)), _SUNSCREEN) == jaead.poly1305_mac(bytes(range(32)), _SUNSCREEN)


# -- SecretConnection ---------------------------------------------------------


def _handshake_pair(stream_a, stream_b, ka=None, kb=None, cls_a=SecretConnection, cls_b=SecretConnection, **kw):
    ka = ka or gen_priv_key_ed25519()
    kb = kb or gen_priv_key_ed25519()
    out, err = {}, []

    def srv():
        try:
            out["conn"] = cls_b(stream_b, kb, **kw)
        except Exception as exc:  # noqa: BLE001 — surfaced by the test
            err.append(exc)

    t = threading.Thread(target=srv, daemon=True)
    t.start()
    ca = cls_a(stream_a, ka, **kw)
    t.join(10)
    assert not err, err
    return ca, out["conn"]


def _read_n(conn, n: int) -> bytes:
    got = bytearray()
    deadline = time.monotonic() + 10
    while len(got) < n:
        assert time.monotonic() < deadline, f"read {len(got)} of {n} bytes"
        chunk = conn.read(n - len(got))
        assert chunk, "stream closed"
        got += chunk
    return bytes(got)


class TestSecretConnectionSemantics:
    def test_roundtrip_crosses_frames(self):
        a, b = pipe_pair()
        ka, kb = gen_priv_key_ed25519(), gen_priv_key_ed25519()
        ca, cb = _handshake_pair(a, b, ka, kb)
        assert ca.remote_pubkey().raw == kb.pub_key().raw
        assert cb.remote_pubkey().raw == ka.pub_key().raw
        payload = bytes(range(256)) * 20  # 5,120 bytes, several frames
        ca.write(payload)
        assert _read_n(cb, len(payload)) == payload
        cb.write(b"pong")
        assert ca.read(10) == b"pong"
        ca.close()

    def test_cross_backend_wire_parity(self, monkeypatch):
        a, b = pipe_pair()
        kb = gen_priv_key_ed25519()
        out = {}
        t = threading.Thread(target=lambda: out.update(conn=SecretConnection(b, kb)), daemon=True)
        t.start()
        monkeypatch.setenv("TENDERMINT_SECRETCONN_BACKEND", "pure")
        ca = SecretConnection(a, gen_priv_key_ed25519())
        t.join(10)
        assert ca.backend == "pure"
        ca.write(b"hello across backends")
        assert _read_n(out["conn"], 21) == b"hello across backends"
        out["conn"].write(b"pong")
        assert ca.read(16) == b"pong"

    def test_bit_flipped_frame_raises_not_eof(self):
        s1, s2 = socket.socketpair()
        ca, cb = _handshake_pair(SocketStream(s1), SocketStream(s2))
        frames = []
        real_write = ca.stream.write
        ca.stream.write = lambda data: frames.append(bytes(data))
        ca.write(b"legitimate payload")
        ca.stream.write = real_write
        (frame,) = frames
        bad = bytearray(frame)
        bad[4] ^= 0x01
        real_write(bytes(bad))
        with pytest.raises(SecretConnectionError):
            cb.read(64)
        with pytest.raises(SecretConnectionError):
            cb.read(1)
        ca.close()

    def test_clean_eof_still_reads_empty(self):
        s1, s2 = socket.socketpair()
        ca, cb = _handshake_pair(SocketStream(s1), SocketStream(s2))
        ca.close()
        assert cb.read(16) == b""

    def test_handshake_deadline_on_silent_peer(self):
        s1, s2 = socket.socketpair()
        t0 = time.monotonic()
        with pytest.raises(HandshakeTimeout):
            SecretConnection(SocketStream(s1), gen_priv_key_ed25519(), handshake_timeout_s=0.4)
        assert time.monotonic() - t0 < 5.0
        s1.close()
        s2.close()

    def test_handshake_deadline_on_dribbling_peer(self):
        s1, s2 = socket.socketpair()

        def dribble():
            try:
                for i in range(64):
                    s2.sendall(bytes([i]))
                    time.sleep(0.05)
            except OSError:
                pass

        threading.Thread(target=dribble, daemon=True).start()
        t0 = time.monotonic()
        with pytest.raises(HandshakeTimeout):
            SecretConnection(SocketStream(s1), gen_priv_key_ed25519(), handshake_timeout_s=0.5)
        assert time.monotonic() - t0 < 5.0
        s1.close()
        s2.close()

    def test_telemetry_counters_move(self):
        from tendermint_tpu_torch.libs import telemetry

        reg = telemetry.default_registry()
        ok0 = reg.counter("p2p_secretconn_handshakes_total").value
        to0 = reg.counter("p2p_secretconn_handshake_timeouts_total").value
        af0 = reg.counter("p2p_secretconn_auth_failures_total").value
        a, b = pipe_pair()
        ca, cb = _handshake_pair(a, b)
        assert reg.counter("p2p_secretconn_handshakes_total").value >= ok0 + 2
        s1, s2 = socket.socketpair()
        with pytest.raises(HandshakeTimeout):
            SecretConnection(SocketStream(s1), gen_priv_key_ed25519(), handshake_timeout_s=0.2)
        assert reg.counter("p2p_secretconn_handshake_timeouts_total").value == to0 + 1
        ca.stream.write(b"\x00\x20" + b"\x00" * 32)
        with pytest.raises(SecretConnectionError):
            cb.read(8)
        assert reg.counter("p2p_secretconn_auth_failures_total").value == af0 + 1
        s1.close()
        s2.close()
        ca.close()


@pytest.mark.parametrize("port_dials", [True, False], ids=["port-dials-jax", "jax-dials-port"])
@pytest.mark.parametrize("backend", ["pure", "auto"])
def test_secret_connection_handshake_across_packages(monkeypatch, port_dials, backend):
    """A port SecretConnection and a JAX one on a socket pair: the
    handshake completes with either side dialing, each learns the other's
    node key, and frames of one byte to several frames cross both ways."""
    from tendermint_tpu.crypto.keys import gen_priv_key_ed25519 as jgen
    from tendermint_tpu.p2p.secret_connection import SecretConnection as JaxSecretConnection
    from tendermint_tpu.p2p.stream import SocketStream as JaxSocketStream

    monkeypatch.setenv("TENDERMINT_SECRETCONN_BACKEND", backend)
    s1, s2 = socket.socketpair()
    port_key, jax_key = gen_priv_key_ed25519(b"port-node"), jgen(b"jax-node")
    if port_dials:
        port_conn, jax_conn = _handshake_pair(SocketStream(s1), JaxSocketStream(s2), port_key, jax_key,
                                              cls_a=SecretConnection, cls_b=JaxSecretConnection)
    else:
        jax_conn, port_conn = _handshake_pair(JaxSocketStream(s1), SocketStream(s2), jax_key, port_key,
                                              cls_a=JaxSecretConnection, cls_b=SecretConnection)
    try:
        assert port_conn.remote_pubkey().raw == jax_key.pub_key().raw
        assert jax_conn.remote_pubkey().raw == port_key.pub_key().raw
        rng = np.random.default_rng(5)
        for n in (1, 1024, 1025, 5000):
            msg = rng.bytes(n)
            port_conn.write(msg)
            assert _read_n(jax_conn, n) == msg
            jax_conn.write(msg[::-1])
            assert _read_n(port_conn, n) == msg[::-1]
    finally:
        port_conn.close()
        jax_conn.close()
