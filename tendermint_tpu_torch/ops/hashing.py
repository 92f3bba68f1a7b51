"""Batched RIPEMD-160 and SHA-256 on the card: the wrappers of the
hand-written CUDA kernels K1 and K2 (`csrc/hash_blocks.cu`: K1 runs a
message's two RIPEMD-160 lines on a pair of warps, K2 one thread a
message) and their plain PyTorch versions.

Layout. A batch of messages is MD-padded on the host and its blocks lie
end to end in one uint32[total_blocks, 16] buffer, with an int32 first
block and block count a message (`pack_ragged`): one join and one
`np.frombuffer`, '<u4' words for RIPEMD-160 and '>u4' for SHA-256. The
JAX package packs a dense uint32[B, max_blocks, 16] tensor instead
(`pack_messages`, kept here byte for byte for the parity tests), which for
one 10,240-byte transaction among 10,000 small ones is 103 MB;
`dense_to_ragged` turns it into this layout.

Plain versions. `ripemd160_words` and `sha256_words` walk the same
layout block by block over the whole batch, freezing finished lanes, as
the JAX package's scans do. PyTorch has no uint32 arithmetic, so a word is
an int64 in [0, 2^32) masked after every add, shift and not.

The wrappers (`ripemd160_lanes`, `sha256_lanes`) take the device of their
arguments: a CUDA tensor launches the kernel on the current stream (and
counts it in `ripemd160_launches` / `sha256_launches`), a CPU tensor runs
the plain version. Digests are int32 rows of the words' bit patterns:
little-endian bytes for RIPEMD-160 (`digests_to_bytes_le`), big-endian for
SHA-256 (`digests_to_bytes_be`).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from tendermint_tpu_torch.crypto.hashing import _K1, _K2, _R1, _R2, _S1, _S2
from tendermint_tpu_torch.ops import kernels, resolve_device

ripemd160_launches = 0  # K1 launches, by the wrapper
sha256_launches = 0  # K2 launches

_M32 = 0xFFFFFFFF
RIPEMD160_ALGO, SHA256_ALGO = 0, 1  # tm_hash_blocks' algo argument

# The least dependent chain a compression needs, in instructions, with
# the two RIPEMD-160 lines side by side: three a step (the round function
# is one LOP3, a + f + (x + K) one IADD3 with x + K summed off the path,
# the rotate and the add of e one LEA.HI) over 80 steps; SHA-256's runs
# through e, three a round (Sigma1's rotates side by side, their xor one
# LOP3, then one IADD3 of Sigma1, Ch and d + h + K + W, a sum ready three
# rounds ahead and so added off the path) over 64 rounds. chip_smoke.py's
# latency bound multiplies them by a measured dependent-issue latency.
RIPEMD160_CHAIN = 3 * 80
SHA256_CHAIN = 3 * 64

# -- host packing ------------------------------------------------------------


def pack_messages(msgs: list[bytes], little_endian: bool, max_blocks: int | None = None):
    """MD-pad each message and pack to (uint32[B, max_blocks, 16], int32[B]
    block counts): the JAX package's dense layout, byte for byte. LE for
    RIPEMD-160, BE for SHA-256."""
    n = len(msgs)
    padded = []
    nblocks = np.empty(n, dtype=np.int32)
    for i, m in enumerate(msgs):
        bitlen = len(m) * 8
        pad_len = (55 - len(m)) % 64
        if little_endian:
            p = m + b"\x80" + b"\x00" * pad_len + struct.pack("<Q", bitlen)
        else:
            p = m + b"\x80" + b"\x00" * pad_len + struct.pack(">Q", bitlen)
        padded.append(p)
        nblocks[i] = len(p) // 64
    mb = max_blocks if max_blocks is not None else int(nblocks.max(initial=1))
    words = np.zeros((n, mb, 16), dtype=np.uint32)
    fmt = "<16I" if little_endian else ">16I"
    for i, p in enumerate(padded):
        for b in range(nblocks[i]):
            words[i, b] = struct.unpack(fmt, p[b * 64 : (b + 1) * 64])
    return words, nblocks


def _md_tail(n: int, little_endian: bool) -> bytes:
    """The MD padding after an n-byte message: 0x80, zeros to 56 mod 64,
    the bit length in 8 bytes."""
    return b"\x80" + bytes((55 - n) % 64) + (8 * n).to_bytes(8, "little" if little_endian else "big")


def pack_ragged(msgs: list[bytes], little_endian: bool):
    """MD-pad each message and lay the blocks end to end: (uint32[T, 16]
    words, int32[B] first block, int32[B] block count), T the sum of the
    block counts."""
    pieces = []
    nblocks = np.empty(len(msgs), dtype=np.int32)
    for i, m in enumerate(msgs):
        pieces.append(m)
        pieces.append(_md_tail(len(m), little_endian))
        nblocks[i] = (len(m) + 72) // 64
    buf = bytearray().join(pieces)
    words = np.frombuffer(buf, dtype="<u4" if little_endian else ">u4").astype(np.uint32, copy=False)
    first = np.zeros(len(msgs), dtype=np.int32)
    np.cumsum(nblocks[:-1], out=first[1:])
    return words.reshape(-1, 16), first, nblocks


def dense_to_ragged(words: np.ndarray, nblocks: np.ndarray):
    """JAX's dense (uint32[B, NB, 16], int32[B]) -> this module's ragged
    (words, first, nblocks)."""
    nblocks = np.asarray(nblocks, dtype=np.int32)
    rows = [words[i, : nblocks[i]] for i in range(len(nblocks))]
    flat = np.concatenate(rows) if rows else np.zeros((0, 16), np.uint32)
    first = np.zeros(len(nblocks), dtype=np.int32)
    np.cumsum(nblocks[:-1], out=first[1:])
    return np.ascontiguousarray(flat, dtype=np.uint32), first, nblocks


def to_device(words: np.ndarray, first: np.ndarray, nblocks: np.ndarray, device):
    """The packed batch on `device`: words as int32 bit patterns, first
    and nblocks as int32."""
    w = torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(device)
    meta = torch.from_numpy(np.stack([first, nblocks]).astype(np.int32)).to(device)
    return w, meta[0], meta[1]


def _u32(digests) -> np.ndarray:
    d = digests.cpu().numpy() if isinstance(digests, torch.Tensor) else np.asarray(digests)
    if d.dtype == np.int64:
        return (d & _M32).astype(np.uint32)
    return d.view(np.uint32) if d.dtype == np.int32 else d.astype(np.uint32)


def _digest_bytes(digests, order: str) -> list[bytes]:
    d = _u32(digests)
    raw = d.astype(order).tobytes()
    w = 4 * d.shape[1] if d.ndim == 2 else 0
    return [raw[w * i : w * i + w] for i in range(d.shape[0])]


def digests_to_bytes_le(digests) -> list[bytes]:
    return _digest_bytes(digests, "<u4")


def digests_to_bytes_be(digests) -> list[bytes]:
    return _digest_bytes(digests, ">u4")


# -- plain versions ----------------------------------------------------------


def _rol(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & _M32


def _ror(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _not(x: torch.Tensor) -> torch.Tensor:
    return x ^ _M32


_RMD_F = (
    lambda x, y, z: x ^ y ^ z,
    lambda x, y, z: (x & y) | (_not(x) & z),
    lambda x, y, z: (x | _not(y)) ^ z,
    lambda x, y, z: (x & z) | (y & _not(z)),
    lambda x, y, z: x ^ (y | _not(z)),
)

INIT_RIPEMD = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
INIT_SHA = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
            0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
_SHA_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)


def ripemd160_block(state: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """One compression. state: int64 (B, 5); words: int64 (B, 16), both
    holding 32-bit values."""
    x = words.unbind(1)
    h = state.unbind(1)
    a1, b1, c1, d1, e1 = h
    a2, b2, c2, d2, e2 = h
    for rnd in range(5):
        f1, f2 = _RMD_F[rnd], _RMD_F[4 - rnd]
        for i in range(16):
            t = _rol((a1 + f1(b1, c1, d1) + x[_R1[rnd][i]] + _K1[rnd]) & _M32, _S1[rnd][i])
            a1, e1, d1, c1, b1 = e1, d1, _rol(c1, 10), b1, (t + e1) & _M32
            t = _rol((a2 + f2(b2, c2, d2) + x[_R2[rnd][i]] + _K2[rnd]) & _M32, _S2[rnd][i])
            a2, e2, d2, c2, b2 = e2, d2, _rol(c2, 10), b2, (t + e2) & _M32
    h0, h1, h2, h3, h4 = h
    return torch.stack(
        [h1 + c1 + d2, h2 + d1 + e2, h3 + e1 + a2, h4 + a1 + b2, h0 + b1 + c2], dim=1
    ) & _M32


def sha256_block(state: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """One compression. state: int64 (B, 8); words: int64 (B, 16)."""
    w = list(words.unbind(1))
    for t in range(16, 64):
        w15, w2 = w[t - 15], w[t - 2]
        s0 = _ror(w15, 7) ^ _ror(w15, 18) ^ (w15 >> 3)
        s1 = _ror(w2, 17) ^ _ror(w2, 19) ^ (w2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state.unbind(1)
    for t in range(64):
        s1 = _ror(e, 6) ^ _ror(e, 11) ^ _ror(e, 25)
        ch = (e & f) ^ (_not(e) & g)
        t1 = (h + s1 + ch + _SHA_K[t] + w[t]) & _M32
        s0 = _ror(a, 2) ^ _ror(a, 13) ^ _ror(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (t1 + s0 + maj) & _M32, a, b, c, (d + t1) & _M32, e, f, g
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=1)) & _M32


def _walk(words, first, nblocks, init, block_fn) -> torch.Tensor:
    """Every message's digest: block b of all still-running lanes at once,
    finished lanes frozen (the JAX scans' masking)."""
    dev = words.device
    w = words.to(torch.int64) & _M32
    first, nblocks = first.to(torch.int64), nblocks.to(torch.int64)
    state = torch.tensor(init, dtype=torch.int64, device=dev).expand(first.shape[0], -1).clone()
    if first.shape[0] == 0:
        return state
    for b in range(int(nblocks.max())):
        active = nblocks > b
        rows = w[torch.where(active, first + b, 0)]
        state = torch.where(active[:, None], block_fn(state, rows), state)
    return state


def ripemd160_words(words, first, nblocks) -> torch.Tensor:
    """Plain version of K1 (JAX: ops/hashing.py:133 ripemd160_words, on
    the ragged layout): int64 (B, 5) little-endian digest words."""
    return _walk(words, first, nblocks, INIT_RIPEMD, ripemd160_block)


def sha256_words(words, first, nblocks) -> torch.Tensor:
    """Plain version of K2 (JAX: ops/hashing.py:232 sha256_words):
    int64 (B, 8) big-endian digest words."""
    return _walk(words, first, nblocks, INIT_SHA, sha256_block)


# -- the kernels' wrappers ---------------------------------------------------


def _launch(algo: int, words, first, nblocks, out) -> None:
    global ripemd160_launches, sha256_launches
    lib = kernels.load("hash_blocks")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tm_hash_blocks(algo, words.data_ptr(), first.data_ptr(), nblocks.data_ptr(),
                                out.data_ptr(), first.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"hash_blocks kernel launch failed: cudaError {rc}")
    if algo == RIPEMD160_ALGO:
        ripemd160_launches += 1
    else:
        sha256_launches += 1


def _lanes(algo: int, width: int, words, first, nblocks, out):
    n = first.shape[0]
    dev = words.device
    if words.dim() != 2 or words.shape[1] != 16:
        raise ValueError(f"words must be (blocks, 16), got {tuple(words.shape)}")
    if first.shape != (n,) or nblocks.shape != (n,):
        raise ValueError("first and nblocks must be (n,)")
    if dev.type == "cpu":
        plain = ripemd160_words if algo == RIPEMD160_ALGO else sha256_words
        got = plain(words, first, nblocks).to(torch.int32)
        if out is None:
            return got
        out.copy_(got)
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t, name in ((words, "words"), (first, "first"), (nblocks, "nblocks")):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
    if out is None:
        out = torch.empty((n, width), dtype=torch.int32, device=dev)
    elif out.shape != (n, width) or out.dtype != torch.int32 or not out.is_contiguous() or out.device != dev:
        raise ValueError(f"out must be a contiguous int32 ({n}, {width}) tensor on {dev}")
    if n:
        _launch(algo, words, first, nblocks, out)
    return out


def ripemd160_lanes(words, first, nblocks, out=None) -> torch.Tensor:
    """RIPEMD-160 of each packed message: int32 (B, 5) digest words on the
    arguments' device, written into `out` (a contiguous int32 (B, 5)
    tensor, such as the first rows of a tree's node buffer) when given.
    A CUDA tensor launches K1 without synchronising; a CPU tensor runs
    `ripemd160_words`."""
    return _lanes(RIPEMD160_ALGO, 5, words, first, nblocks, out)


def sha256_lanes(words, first, nblocks, out=None) -> torch.Tensor:
    """SHA-256 of each packed message: int32 (B, 8) digest words (K2 on a
    CUDA tensor, `sha256_words` on a CPU one)."""
    return _lanes(SHA256_ALGO, 8, words, first, nblocks, out)


def ripemd160_batch(msgs: list[bytes], device=None) -> list[bytes]:
    """RIPEMD-160 digests of arbitrary messages, on the card unless the
    caller passes device="cpu"."""
    if not msgs:
        return []
    dev = resolve_device(device)
    return digests_to_bytes_le(ripemd160_lanes(*to_device(*pack_ragged(msgs, True), dev)))


def sha256_batch(msgs: list[bytes], device=None) -> list[bytes]:
    if not msgs:
        return []
    dev = resolve_device(device)
    return digests_to_bytes_be(sha256_lanes(*to_device(*pack_ragged(msgs, False), dev)))
