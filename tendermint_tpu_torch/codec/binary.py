"""Deterministic c-style binary codec: what votes, block IDs, validators,
commits (full and aggregate), headers, blocks and evidence are written
and read with.

Format (the reference's wire-protocol spec,
docs/specification/wire-protocol.rst):

- fixed-width uints: big-endian, 1/2/4/8 bytes
- `uvarint`: 1 length byte then that many big-endian bytes; 0 == b"\\x00"
- `varint`: like uvarint; negative sets the MSB of the length byte
- bytes/string: varint length prefix + raw bytes
- time: int64 nanoseconds since epoch, fixed 8 bytes
- lists: varint count + concatenated items
"""

from __future__ import annotations

import struct


def encode_uvarint(n: int) -> bytes:
    if n < 0:
        raise ValueError("uvarint must be non-negative")
    if n == 0:
        return b"\x00"
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    if len(body) > 255:
        raise ValueError("uvarint too large")
    return bytes([len(body)]) + body


def encode_varint(n: int) -> bytes:
    if n == 0:
        return b"\x00"
    neg = n < 0
    body = abs(n).to_bytes((abs(n).bit_length() + 7) // 8, "big")
    if len(body) > 127:
        raise ValueError("varint too large")
    return bytes([len(body) | (0x80 if neg else 0)]) + body


def encode_bytes(b: bytes) -> bytes:
    return encode_varint(len(b)) + b


def encode_string(s: str) -> bytes:
    return encode_bytes(s.encode("utf-8"))


def decode_bytes(buf: bytes, off: int = 0) -> tuple[bytes, int]:
    d = Decoder(buf, off)
    out = d.read_bytes()
    return out, d.off


class Encoder:
    """Accumulating encoder; all writes are deterministic."""

    def __init__(self):
        self._parts: list[bytes] = []

    def buf(self) -> bytes:
        return b"".join(self._parts)

    def write_raw(self, b: bytes) -> "Encoder":
        self._parts.append(b)
        return self

    def write_u8(self, n: int) -> "Encoder":
        return self.write_raw(struct.pack(">B", n))

    def write_u16(self, n: int) -> "Encoder":
        return self.write_raw(struct.pack(">H", n))

    def write_u32(self, n: int) -> "Encoder":
        return self.write_raw(struct.pack(">I", n))

    def write_u64(self, n: int) -> "Encoder":
        return self.write_raw(struct.pack(">Q", n))

    def write_i64(self, n: int) -> "Encoder":
        return self.write_raw(struct.pack(">q", n))

    def write_uvarint(self, n: int) -> "Encoder":
        return self.write_raw(encode_uvarint(n))

    def write_varint(self, n: int) -> "Encoder":
        return self.write_raw(encode_varint(n))

    def write_bytes(self, b: bytes) -> "Encoder":
        return self.write_raw(encode_bytes(b))

    def write_string(self, s: str) -> "Encoder":
        return self.write_raw(encode_string(s))

    def write_time_ns(self, ns: int) -> "Encoder":
        return self.write_i64(ns)

    def write_list(self, items, write_item) -> "Encoder":
        self.write_varint(len(items))
        for it in items:
            write_item(self, it)
        return self


class Decoder:
    def __init__(self, buf: bytes, off: int = 0):
        self.buf = buf
        self.off = off

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.buf):
            raise ValueError("unexpected end of buffer")
        out = self.buf[self.off : self.off + n]
        self.off += n
        return out

    def read_u8(self) -> int:
        return self._take(1)[0]

    def peek_u8(self) -> int:
        """The next byte without consuming it: format-tag dispatch
        (types.agg_commit.decode_commit reads the aggregate-commit magic
        off it)."""
        if self.off >= len(self.buf):
            raise ValueError("unexpected end of buffer")
        return self.buf[self.off]

    def read_raw(self, n: int) -> bytes:
        """Exactly n bytes, no length prefix: the mirror of
        Encoder.write_raw for fixed-width fields (32-byte points, folded
        scalars, 64-byte signatures)."""
        return self._take(n)

    def read_u16(self) -> int:
        return struct.unpack(">H", self._take(2))[0]

    def read_u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def read_u64(self) -> int:
        return struct.unpack(">Q", self._take(8))[0]

    def read_i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def read_uvarint(self) -> int:
        ln = self.read_u8()
        if ln == 0:
            return 0
        body = self._take(ln)
        if body[0] == 0:
            raise ValueError("non-canonical uvarint (leading zero byte)")
        return int.from_bytes(body, "big")

    def read_varint(self) -> int:
        ln = self.read_u8()
        if ln == 0:
            return 0
        neg = bool(ln & 0x80)
        nbytes = ln & 0x7F
        if nbytes == 0:
            raise ValueError("non-canonical varint (negative zero)")
        body = self._take(nbytes)
        if body[0] == 0:
            raise ValueError("non-canonical varint (leading zero byte)")
        n = int.from_bytes(body, "big")
        return -n if neg else n

    def read_bytes(self) -> bytes:
        ln = self.read_varint()
        if ln < 0:
            raise ValueError("negative byte-slice length")
        return self._take(ln)

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")

    def read_time_ns(self) -> int:
        return self.read_i64()

    def read_list(self, read_item) -> list:
        n = self.read_varint()
        if n < 0:
            raise ValueError("negative list length")
        return [read_item(self) for _ in range(n)]

    def done(self) -> bool:
        return self.off == len(self.buf)
