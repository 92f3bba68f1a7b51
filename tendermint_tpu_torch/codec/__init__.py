"""Deterministic encodings: the binary codec, canonical JSON sign bytes and
bounded JSON field decoding (the parts that votes, block IDs and validators
use)."""

from tendermint_tpu_torch.codec.binary import (
    Decoder,
    Encoder,
    decode_bytes,
    encode_bytes,
    encode_string,
    encode_uvarint,
    encode_varint,
)
from tendermint_tpu_torch.codec.canonical import canonical_dumps

__all__ = [
    "Encoder",
    "Decoder",
    "encode_bytes",
    "encode_string",
    "encode_uvarint",
    "encode_varint",
    "decode_bytes",
    "canonical_dumps",
]
