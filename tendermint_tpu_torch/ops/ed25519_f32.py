"""Ed25519 verify in fp32 radix-2^8 limbs: the host marshal, the plain
PyTorch version of the device kernel, and the registry kernel `f32`.

Three parts:

- The host marshal (`prepare_batch8` and its helpers), a copy of the JAX
  package's, so the numpy arrays it returns are identical to JAX's for the
  same items: vectorized canonical checks, native batch SHA512(R||A||M)
  mod L digests, native batch decompression of the UNIQUE public keys
  behind a host cache, and pure-Python versions where the native library
  is missing.
- `verify_plain`, the plain PyTorch version of the CUDA ladder in
  `ops/csrc/ed25519_verify.cu`. It keeps the JAX kernel's (32, B) fp32
  radix-2^8 layout, so every field op is bit-for-bit comparable with
  `tendermint_tpu.ops.ed25519_f32`. It is what `ops.ed25519_f32p` runs for
  a tensor on the CPU, and what the kernel is held against on the card.
- `verify_batch` / `verify_batch_async`, the registry name `f32` (B3 of
  the JAX package, `_verify_impl` jitted as XLA there, not Pallas):
  `verify_plain` run as torch operations on the verifier's device, the
  card unless the caller asks for the CPU. Over a mesh, `verify_rows`
  runs per shard in `sharded_bucket` lanes (the JAX package's pjit
  backend, through `ed25519_f32p.ShardedVerify`).

EXACTNESS (the JAX module's argument, unchanged): every fp32 value is an
integer below 2^24, so every sum is exact in any order. Loose limbs after
a 3-pass carry are <= 749 (limb 0) and <= 268 (others); fadd/fsub outputs
are <= 483/521 and <= 262; fmul's anti-diagonal row sums stay below 2^21.5
and the folded rows below 2^21.7. That is why `fmul` sums 32 shifted row
products into a (63, B) buffer with plain fp32 adds and no matmul: a
matmul on the card may run in TF32 and would break the argument.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from tendermint_tpu_torch import native
from tendermint_tpu_torch.crypto import ed25519 as ed_ref
from tendermint_tpu_torch.ops import resolve_device

P = ed_ref.P
L = ed_ref.L
NL = 32  # limbs
R = 256.0  # radix
RINV = 1.0 / 256.0


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------


def _int_to_limbs_const(v: int) -> np.ndarray:
    return np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8).astype(np.float32)


def _make_pad() -> np.ndarray:
    """All-limb pad >= 1024, value == 0 mod p, digits <= 1279: keeps fsub
    non-negative per limb for any loose operand (limbs <= 749)."""
    base = 1024 * sum(1 << (8 * k) for k in range(NL))
    c = (-base) % P
    digits = np.frombuffer(c.to_bytes(32, "little"), dtype=np.uint8).astype(np.float32)
    return digits + 1024.0


def _affine(pt) -> tuple[int, int]:
    zinv = pow(pt[2], P - 2, P)
    return (pt[0] * zinv % P, pt[1] * zinv % P)


_B2_AFF = _affine(ed_ref.point_add(ed_ref.B, ed_ref.B))
_B3_AFF = _affine(ed_ref.point_add(ed_ref.point_add(ed_ref.B, ed_ref.B), ed_ref.B))

_CONSTS = {
    "pad": _make_pad(),
    "d2": _int_to_limbs_const((2 * ed_ref.D) % P),
    "p": _int_to_limbs_const(P),
    "bx": _int_to_limbs_const(ed_ref.B[0]),
    "by": _int_to_limbs_const(ed_ref.B[1]),
    "b2x": _int_to_limbs_const(_B2_AFF[0]),
    "b2y": _int_to_limbs_const(_B2_AFF[1]),
    "b3x": _int_to_limbs_const(_B3_AFF[0]),
    "b3y": _int_to_limbs_const(_B3_AFF[1]),
}
_const_cache: dict = {}


def _const(name: str, like: torch.Tensor) -> torch.Tensor:
    """A (32, 1) limb-constant column on `like`'s device."""
    key = (name, like.device)
    t = _const_cache.get(key)
    if t is None:
        t = _const_cache[key] = torch.from_numpy(_CONSTS[name]).to(like.device)[:, None]
    return t


# ---------------------------------------------------------------------------
# field arithmetic on (32, B) float32
# ---------------------------------------------------------------------------


def _roll38(hi: torch.Tensor) -> torch.Tensor:
    """Carries shift up one limb; the top carry wraps to limb 0 with
    weight 38 (2^256 = 2*19 mod p)."""
    return torch.cat([38.0 * hi[NL - 1 :], hi[: NL - 1]], dim=0)


def _carry1(x: torch.Tensor) -> torch.Tensor:
    hi = torch.floor(x * RINV)
    return x - hi * R + _roll38(hi)


def _carry3(x: torch.Tensor) -> torch.Tensor:
    return _carry1(_carry1(_carry1(x)))


def fadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry1(a + b)


def fsub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry1(a + _const("pad", a) - b)


def fmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook limb multiply: row k of the (63, B) buffer accumulates
    sum_{i+j=k} a_i*b_j as 32 shifted row products, then rows k >= 32
    (weight 2^(8k) = 38*2^(8(k-32)) mod p) fold down with a hi/lo split
    at 2^8 so every addend stays well under 2^24."""
    rows = a.new_zeros((2 * NL - 1, a.shape[-1]))
    for i in range(NL):
        rows[i : i + NL].addcmul_(b, a[i])
    t = rows[NL:]
    t_hi = torch.floor(t * RINV)
    t_lo = t - t_hi * R
    res = rows[:NL].clone()
    res[: NL - 1] += 38.0 * t_lo
    res[1:NL] += 38.0 * t_hi
    return _carry3(res)


def fsq(a: torch.Tensor) -> torch.Tensor:
    return fmul(a, a)


def _rep_sq(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = fsq(x)
    return x


def finv(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2) by the standard 254-squaring addition chain."""
    z2 = fsq(z)
    z9 = fmul(_rep_sq(z2, 2), z)
    z11 = fmul(z9, z2)
    z_5_0 = fmul(fsq(z11), z9)
    z_10_0 = fmul(_rep_sq(z_5_0, 5), z_5_0)
    z_20_0 = fmul(_rep_sq(z_10_0, 10), z_10_0)
    z_40_0 = fmul(_rep_sq(z_20_0, 20), z_20_0)
    z_50_0 = fmul(_rep_sq(z_40_0, 10), z_10_0)
    z_100_0 = fmul(_rep_sq(z_50_0, 50), z_50_0)
    z_200_0 = fmul(_rep_sq(z_100_0, 100), z_100_0)
    z_250_0 = fmul(_rep_sq(z_200_0, 50), z_50_0)
    return fmul(_rep_sq(z_250_0, 5), z11)


def _seq_carry(x: torch.Tensor) -> torch.Tensor:
    """One sequential full carry pass limb 0 -> 31; the carry out of the
    top limb wraps to limb 0 with weight 38. Limbs 1..31 end in [0, 256);
    limb 0 may exceed 255 only by the wrapped 38*carry_top."""
    carry = torch.zeros_like(x[0])
    out = []
    for k in range(NL):
        v = x[k] + carry
        carry = torch.floor(v * RINV)
        out.append(v - carry * R)
    res = torch.stack(out, dim=0)
    res[0] += 38.0 * carry
    return res


def fcanon(x: torch.Tensor) -> torch.Tensor:
    """Fully reduce to canonical digits in [0, 256) representing a value
    in [0, p): three sequential carry passes canonicalize any loose input
    (limbs <= 825), then <= 2 conditional subtractions of p (2^256 < 3p).
    A parallel-only carry chain is not enough: limb 0 could stay above 255
    for a value < p, and the digit-wise equality in verify_plain would
    then reject a valid signature."""
    x = _seq_carry(_seq_carry(_seq_carry(x)))
    p_limbs = _CONSTS["p"]
    for _ in range(2):
        borrow = torch.zeros_like(x[0])
        out = []
        for k in range(NL):
            v = x[k] - float(p_limbs[k]) - borrow
            neg = (v < 0).to(x.dtype)
            out.append(v + neg * R)
            borrow = neg
        sub = torch.stack(out, dim=0)
        x = torch.where((borrow == 0)[None, :], sub, x)
    return x


# ---------------------------------------------------------------------------
# point arithmetic (extended coordinates), complete formulas
# ---------------------------------------------------------------------------


def point_add(p1, p2, d2):
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = fmul(fsub(y1, x1), fsub(y2, x2))
    b = fmul(fadd(y1, x1), fadd(y2, x2))
    c = fmul(fmul(t1, t2), d2)
    zz = fmul(z1, z2)
    d = fadd(zz, zz)
    e = fsub(b, a)
    f = fsub(d, c)
    g = fadd(d, c)
    h = fadd(b, a)
    return (fmul(e, f), fmul(g, h), fmul(f, g), fmul(e, h))


def point_double(p1):
    x1, y1, z1, _ = p1
    a = fsq(x1)
    b = fsq(y1)
    zz = fsq(z1)
    c = fadd(zz, zz)
    h = fadd(a, b)
    e = fsub(h, fsq(fadd(x1, y1)))
    g = fsub(a, b)
    f = fadd(c, g)
    return (fmul(e, f), fmul(g, h), fmul(f, g), fmul(e, h))


# ---------------------------------------------------------------------------
# the plain version of the verify kernel
# ---------------------------------------------------------------------------


def _digits2(limbs_u8: torch.Tensor) -> torch.Tensor:
    """(32, B) int32 byte limbs -> (127, B) int32 2-bit digits MSB-first.
    Scalars < L < 2^253, so digits above 126 are zero."""
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=limbs_u8.device)
    d = (limbs_u8[:, None, :] >> shifts[None, :, None]) & 3  # (32, 4, B)
    d = d.reshape(NL * 4, limbs_u8.shape[-1])[:127]  # little-endian digits
    return d.flip(0)


def verify_plain(ax, ay, r_y, r_sign, s8, h8) -> torch.Tensor:
    """ax/ay: affine public-key limbs (32, B) f32; r_y: R's y limbs
    (canonical); r_sign: (B,) int32 x-parity of R; s8/h8: (32, B) int32
    byte limbs of the scalars. Returns bool[B]: compress([s]B + [h](-A))
    == R, strict and cofactorless.

    Interleaved Straus with 2-bit joint windows: a 16-entry table
    {i*B + j*(-A)}, then 127 x (2 doublings + 1 table add)."""
    batch = ax.shape[-1]
    zeros = torch.zeros_like(ax)
    one = zeros.clone()
    one[0] = 1.0
    d2 = _const("d2", ax).expand(NL, batch)

    def const_pt(xn, yn):
        x = _const(xn, ax).expand(NL, batch)
        y = _const(yn, ax).expand(NL, batch)
        return (x, y, one, fmul(x, y))

    nax = fsub(zeros, ax)
    neg_a = (nax, ay, one, fmul(nax, ay))
    na2 = point_double(neg_a)
    na3 = point_add(na2, neg_a, d2)
    ident = (zeros, one, one, zeros)
    b_row = [ident, const_pt("bx", "by"), const_pt("b2x", "b2y"), const_pt("b3x", "b3y")]
    a_row = [ident, neg_a, na2, na3]
    table = []
    for j in range(4):
        for i in range(4):
            if i == 0:
                table.append(a_row[j])
            elif j == 0:
                table.append(b_row[i])
            else:
                table.append(point_add(b_row[i], a_row[j], d2))
    tcoords = [torch.stack([t[c] for t in table], dim=0) for c in range(4)]  # (16, 32, B)

    sel = (_digits2(s8) + 4 * _digits2(h8)).long()  # (127, B)
    acc = ident
    for step in range(127):
        acc = point_double(point_double(acc))
        idx = sel[step][None, None, :].expand(1, NL, batch)
        addend = tuple(torch.gather(tc, 0, idx)[0] for tc in tcoords)
        acc = point_add(acc, addend, d2)

    px, py, pz, _ = acc
    zinv = finv(pz)
    x_aff = fcanon(fmul(px, zinv))
    y_aff = fcanon(fmul(py, zinv))
    sign = x_aff[0].to(torch.int32) & 1
    return torch.all(y_aff == fcanon(r_y), dim=0) & (sign == r_sign)


# ---------------------------------------------------------------------------
# host marshal: byte-level (radix 2^8 IS the little-endian byte string)
# ---------------------------------------------------------------------------

_pubkey_cache: dict[bytes, tuple[bytes, bytes] | None] = {}

_L_ARR = np.frombuffer(L.to_bytes(32, "little"), dtype=np.uint8)
_P_ARR = np.frombuffer(P.to_bytes(32, "little"), dtype=np.uint8)
_Z32 = b"\x00" * 32
_Z64 = b"\x00" * 64


def _lt_bytes_le(a: np.ndarray, c: np.ndarray) -> np.ndarray:
    """value(a[i]) < value(c) for little-endian byte rows a (n,32) vs a
    constant c (32,) — vectorized big-endian lexicographic compare."""
    diff = a != c[None, :]
    first = diff[:, ::-1].argmax(axis=1)  # offset of most-significant diff
    idx = 31 - first
    less = a[np.arange(len(a)), idx] < c[idx]
    return diff.any(axis=1) & less


def _decompress_rows(pub_parts: list[bytes]):
    """n compressed keys -> ((n,32) x, (n,32) y, ok mask), deduplicating
    repeated keys (a commit is few validators, many messages) through the
    host cache, with native batch decompress for the misses."""
    uniq_index: dict[bytes, int] = {}
    inv = np.empty(len(pub_parts), dtype=np.intp)
    uniq: list[bytes] = []
    for i, key in enumerate(pub_parts):
        j = uniq_index.get(key)
        if j is None:
            j = len(uniq)
            uniq_index[key] = j
            uniq.append(key)
        inv[i] = j
    u = len(uniq)
    ux = np.zeros((u, 32), dtype=np.uint8)
    uy = np.zeros((u, 32), dtype=np.uint8)
    uok = np.zeros(u, dtype=bool)
    misses = []
    for j, key in enumerate(uniq):
        hit = _pubkey_cache.get(key, False)
        if hit is False:
            misses.append(j)
        elif hit is not None:
            ux[j] = np.frombuffer(hit[0], dtype=np.uint8)
            uy[j] = np.frombuffer(hit[1], dtype=np.uint8)
            uok[j] = True
    if misses:
        if native.available():
            flat = np.frombuffer(b"".join(uniq[j] for j in misses), dtype=np.uint8)
            xy, ok = native.ed25519_decompress_batch(np.ascontiguousarray(flat), len(misses))
            midx = np.asarray(misses)
            ux[midx] = xy[:, :32]
            uy[midx] = xy[:, 32:]
            uok[midx] = ok
            for k, j in enumerate(misses):
                if len(_pubkey_cache) < 1_000_000:
                    _pubkey_cache[uniq[j]] = (
                        (xy[k, :32].tobytes(), xy[k, 32:].tobytes()) if ok[k] else None
                    )
        else:
            for j in misses:
                key = uniq[j]
                pt = ed_ref.point_decompress(key)
                res = None if pt is None else (
                    pt[0].to_bytes(32, "little"),
                    pt[1].to_bytes(32, "little"),
                )
                if len(_pubkey_cache) < 1_000_000:
                    _pubkey_cache[key] = res
                if res is not None:
                    ux[j] = np.frombuffer(res[0], dtype=np.uint8)
                    uy[j] = np.frombuffer(res[1], dtype=np.uint8)
                    uok[j] = True
    return ux[inv], uy[inv], uok[inv]


def _hram_rows(
    sigs: np.ndarray, pubs: np.ndarray, msgs: list[bytes], valid: np.ndarray
) -> np.ndarray:
    """(n,32) u8 LE rows of SHA512(R || A || M) mod L."""
    n = len(msgs)
    if native.available():
        offsets = np.zeros(n + 1, dtype=np.uint64)
        total = 0
        for i, m in enumerate(msgs):
            total += len(m)
            offsets[i + 1] = total
        data = np.frombuffer(b"".join(msgs), dtype=np.uint8) if total else np.zeros(1, np.uint8)
        return native.ed25519_hram_batch(
            np.ascontiguousarray(sigs).reshape(-1),
            np.ascontiguousarray(pubs).reshape(-1),
            np.ascontiguousarray(data),
            offsets,
            n,
        )
    h8 = np.zeros((n, 32), dtype=np.uint8)
    for i in range(n):
        if not valid[i]:
            continue
        h = int.from_bytes(
            hashlib.sha512(sigs[i, :32].tobytes() + pubs[i].tobytes() + msgs[i]).digest(),
            "little",
        ) % L
        h8[i] = np.frombuffer(h.to_bytes(32, "little"), dtype=np.uint8)
    return h8


def prepare_batch8(items: list[tuple[bytes, bytes, bytes]], bucket: int):
    """Marshal (pubkey, msg, sig) triples into kernel inputs.

    Returns (ax f32(32,B), ay f32(32,B), ry f32(32,B), r_sign int32(B,),
    s8 int32(32,B), h8 int32(32,B), valid bool(B,)) with B = bucket >= n.
    Invalid rows (bad point, s >= L, R.y >= p, bad lengths) get benign
    placeholders and valid=False: the kernel runs every lane, and the
    verdicts are masked by `valid`."""
    n = len(items)
    pub_parts: list[bytes] = []
    sig_parts: list[bytes] = []
    msgs: list[bytes] = []
    shape_ok = np.ones(n, dtype=bool)
    for i, (pub, msg, sig) in enumerate(items):
        if len(sig) != 64 or len(pub) != 32:
            shape_ok[i] = False
            pub_parts.append(_Z32)
            sig_parts.append(_Z64)
            msgs.append(b"")
        else:
            pub_parts.append(bytes(pub))
            sig_parts.append(bytes(sig))
            msgs.append(bytes(msg))

    pubs = (
        np.frombuffer(b"".join(pub_parts), dtype=np.uint8).reshape(n, 32)
        if n
        else np.zeros((0, 32), dtype=np.uint8)
    )
    sigs = (
        np.frombuffer(b"".join(sig_parts), dtype=np.uint8).reshape(n, 64)
        if n
        else np.zeros((0, 64), dtype=np.uint8)
    )
    s_rows = sigs[:, 32:]
    r_rows = sigs[:, :32].copy()
    top = r_rows[:, 31].copy()
    r_rows[:, 31] &= 0x7F
    rs_rows = (top >> 7).astype(np.int32)

    s_ok = _lt_bytes_le(s_rows, _L_ARR)  # s < L
    r_ok = _lt_bytes_le(r_rows, _P_ARR)  # canonical R.y < p
    ax_rows, ay_rows, a_ok = _decompress_rows(pub_parts)
    valid_n = shape_ok & s_ok & r_ok & a_ok
    h_rows = _hram_rows(sigs, pubs, msgs, valid_n)

    inval = ~valid_n
    ax = np.zeros((bucket, 32), dtype=np.uint8)
    ay = np.zeros((bucket, 32), dtype=np.uint8)
    ay[:, 0] = 1
    ry = np.zeros((bucket, 32), dtype=np.uint8)
    ry[:, 0] = 1
    rs = np.zeros(bucket, dtype=np.int32)
    s8 = np.zeros((bucket, 32), dtype=np.uint8)
    h8 = np.zeros((bucket, 32), dtype=np.uint8)
    valid = np.zeros(bucket, dtype=bool)
    if n:
        ax[:n] = np.where(inval[:, None], 0, ax_rows)
        ay[:n] = np.where(inval[:, None], ay[:n], ay_rows)
        ry[:n] = np.where(inval[:, None], ry[:n], r_rows)
        rs[:n] = np.where(inval, 0, rs_rows)
        s8[:n] = np.where(inval[:, None], 0, s_rows)
        h8[:n] = np.where(inval[:, None], 0, h_rows)
        valid[:n] = valid_n

    return (
        np.ascontiguousarray(ax.T.astype(np.float32)),
        np.ascontiguousarray(ay.T.astype(np.float32)),
        np.ascontiguousarray(ry.T.astype(np.float32)),
        rs,
        np.ascontiguousarray(s8.T.astype(np.int32)),
        np.ascontiguousarray(h8.T.astype(np.int32)),
        valid,
    )


# ---------------------------------------------------------------------------
# the registry kernel `f32`: verify_plain on the verifier's device
# ---------------------------------------------------------------------------


def verify_rows(ax, ay, ry, rsign, s8, h8) -> torch.Tensor:
    """`verify_plain` over the verify kernels' arguments (uint8 byte rows
    (32, n), rsign (n,) int32): (n,) int32 verdicts on their device. The
    per-shard function of the sharded `f32` backend, and B1's plain
    version."""
    return verify_plain(ax.float(), ay.float(), ry.float(), rsign, s8.int(), h8.int()).to(torch.int32)


def verify_batch_async(items: list[tuple[bytes, bytes, bytes]], device=None):
    """Marshal and enqueue `verify_plain` on `device` (the card unless the
    caller asks for the CPU); return a zero-arg resolver for bool[n].
    Lanes the host rejected are masked by `valid`."""
    n = len(items)
    if n == 0:
        return lambda: np.zeros(0, dtype=bool)
    dev = resolve_device(device)
    ax, ay, ry, rs, s8, h8, valid = prepare_batch8(items, n)
    ok = verify_plain(*(torch.from_numpy(a).to(dev) for a in (ax, ay, ry, rs, s8, h8)))
    return lambda: ok.cpu().numpy()[:n] & valid[:n]


def verify_batch(items: list[tuple[bytes, bytes, bytes]], device=None) -> np.ndarray:
    """Batched strict RFC 8032 verify -> bool[n]."""
    return verify_batch_async(items, device)()


def sharded_bucket(n: int, shards: int) -> int:
    """The JAX package's sharded f32 bucket: the next power of two (at
    least 8) above max(n, shards), rounded up to a multiple of `shards`."""
    bucket = 8
    while bucket < max(n, shards):
        bucket <<= 1
    return -(-bucket // shards) * shards
