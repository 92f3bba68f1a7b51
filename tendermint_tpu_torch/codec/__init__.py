"""Deterministic encodings: the binary codec, canonical JSON sign bytes and
bounded JSON field decoding (the parts that votes, block IDs and validators
use)."""
