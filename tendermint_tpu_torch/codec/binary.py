"""Deterministic c-style binary codec: the encoder half that votes, block
IDs and validators use.

Format (the reference's wire-protocol spec,
docs/specification/wire-protocol.rst):

- fixed-width uints: big-endian
- `varint`: 1 length byte then that many big-endian bytes; 0 == b"\\x00";
  negative sets the MSB of the length byte
- bytes: varint length prefix + raw bytes
"""

from __future__ import annotations

import struct


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

    def write_varint(self, n: int) -> "Encoder":
        return self.write_raw(encode_varint(n))

    def write_bytes(self, b: bytes) -> "Encoder":
        return self.write_raw(encode_bytes(b))
