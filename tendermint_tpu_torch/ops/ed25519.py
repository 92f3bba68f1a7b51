"""Ed25519 in int32 radix-2^15 limbs: the JAX package's int32 family
(`tendermint_tpu/ops/ed25519.py`) in PyTorch, and the wrapper of the
dual-scalar-multiplication kernel behind aggregate commits.

Four parts:

- The limb codecs (`int_to_limbs_np`, `limbs_to_int`, `scalar_bits_np`)
  and the host marshal (`prepare_batch`, `prepare_batch_limbs`), copies of
  the JAX package's, so the numpy arrays are identical for the same items.
- Torch counterparts of those codecs on (32, B) byte rows
  (`limbs_from_bytes`, `bits_from_bytes`, `bytes_from_limbs`): the port's
  kernels read and write bytes, their plain versions work in limbs.
- The field and point ops on (17, B) int32 tensors (`fmul`, `fcanon`,
  `point_add`, ...), bit for bit the JAX package's: every tensor stays
  int32, so products and `>> 15` wrap and shift as they do in JAX.
- `dsm_plain`, the plain version of the dual scalar multiplication
  [a]P + [b]Q (JAX: `_dsm_impl`), and `dsm_batch`, its entry point: on a
  CUDA device it launches the hand-written kernel
  (`csrc/ed25519_dsm.cu`), on the CPU it runs `dsm_plain`. There is no
  fallback between the two.

The JAX module's own verify (`_verify_impl`, registry name `int32`) and
batched decompression (`decompress_batch`) are not ported yet.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from tendermint_tpu_torch.crypto import ed25519 as ed_ref
from tendermint_tpu_torch.ops import kernels, resolve_device

P = ed_ref.P
L = ed_ref.L
M15 = 0x7FFF
NLIMB = 17

# Incremented once per dsm kernel launch (never for the CPU plain
# version): a run reads it to show that its work went through the kernel.
launches = 0

# The dsm kernel's work per lane, summed over the lane's four threads and
# counted from csrc/ed25519_dsm.cu (see its note), for the least time the
# card could take: field multiplications cost 100 32x32->64-bit limb
# products and squarings 55.
MULS_PER_LANE = 2031
SQS_PER_LANE = 1278
PRODUCTS_PER_LANE = 100 * MULS_PER_LANE + 55 * SQS_PER_LANE
BYTES_PER_LANE = 8 * 32  # six byte rows in, two out

# ---------------------------------------------------------------------------
# host <-> limb conversion (host arrays are (B, 17); device layout (17, B))
# ---------------------------------------------------------------------------


def _le_rows(vals: list[int]) -> np.ndarray:
    """ints < 2^256 -> (B, 32) uint8 little-endian rows."""
    if not vals:
        return np.zeros((0, 32), dtype=np.uint8)
    return np.frombuffer(
        b"".join(v.to_bytes(32, "little") for v in vals), dtype=np.uint8
    ).reshape(len(vals), 32)


def int_to_limbs_np(vals: list[int]) -> np.ndarray:
    """list of ints < 2^256 -> int32[17, B] radix-2^15 limb-major limbs."""
    bits = np.unpackbits(_le_rows(vals), axis=1, bitorder="little")  # (B, 256)
    limbs = bits[:, :255].reshape(len(vals), NLIMB, 15)
    weights = (1 << np.arange(15)).astype(np.int32)
    return np.ascontiguousarray((limbs * weights).sum(axis=2).astype(np.int32).T)


def limbs_to_int(limbs: np.ndarray) -> int:
    """int32[17] -> int."""
    return sum(int(limbs[k]) << (15 * k) for k in range(NLIMB))


def scalar_bits_np(vals: list[int], nbits: int = 253) -> np.ndarray:
    """ints -> int32[nbits, B] little-endian bit-major bits."""
    bits = np.unpackbits(_le_rows(vals), axis=1, bitorder="little")
    return np.ascontiguousarray(bits[:, :nbits].astype(np.int32).T)


def _const_limbs(v: int) -> np.ndarray:
    return int_to_limbs_np([v])[:, 0]  # (17,)


_D2 = _const_limbs((2 * ed_ref.D) % P)
_P_LIMBS = np.array([32749] + [32767] * 16, dtype=np.int32)
_PX2 = (2 * _P_LIMBS).astype(np.int32)
_BX = _const_limbs(ed_ref.B[0])
_BY = _const_limbs(ed_ref.B[1])
_BT = _const_limbs((ed_ref.B[0] * ed_ref.B[1]) % P)

_const_cache: dict = {}


def _device_const(arr: np.ndarray, device) -> torch.Tensor:
    """A module-level numpy constant as a tensor on `device`, copied there
    once (keyed by the array's identity: constants live as long as the
    module)."""
    key = (id(arr), device)
    t = _const_cache.get(key)
    if t is None:
        t = _const_cache[key] = torch.from_numpy(arr).to(device)
    return t


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A (17, 1) int32 limb-constant column on `like`'s device."""
    return _device_const(arr, like.device)[:, None]


def _bit_rows(b8: torch.Tensor) -> torch.Tensor:
    """(32, B) byte rows -> (256, B) int32 bits, little-endian."""
    shifts = torch.arange(8, dtype=torch.int32, device=b8.device)
    return ((b8.to(torch.int32)[:, None, :] >> shifts[None, :, None]) & 1).reshape(256, -1)


def limbs_from_bytes(b8: torch.Tensor) -> torch.Tensor:
    """(32, B) little-endian byte rows -> (17, B) int32 radix-2^15 limbs
    (bit 255 dropped): `int_to_limbs_np` on the card's byte layout."""
    bits = _bit_rows(b8)[:255].reshape(NLIMB, 15, -1)
    weights = (1 << torch.arange(15, dtype=torch.int32, device=b8.device))[None, :, None]
    return (bits * weights).sum(dim=1, dtype=torch.int32)


def bits_from_bytes(b8: torch.Tensor, nbits: int = 253) -> torch.Tensor:
    """(32, B) byte rows -> (nbits, B) int32 bits, little-endian:
    `scalar_bits_np` on the card's byte layout."""
    return _bit_rows(b8)[:nbits].contiguous()


def bytes_from_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """(17, B) non-negative limbs of values < 2^255, loose or not ->
    (32, B) uint8 little-endian byte rows of the values."""
    carry = torch.zeros_like(limbs[0])
    digits = []
    for k in range(NLIMB):
        v = limbs[k] + carry
        digits.append(v & M15)
        carry = v >> 15
    d = torch.stack(digits)  # canonical 15-bit digits
    shifts = torch.arange(15, dtype=torch.int32, device=limbs.device)
    bits = ((d[:, None, :] >> shifts[None, :, None]) & 1).reshape(255, -1)
    bits = torch.cat([bits, torch.zeros_like(bits[:1])]).reshape(32, 8, -1)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=limbs.device))[None, :, None]
    return (bits * weights).sum(dim=1, dtype=torch.int32).to(torch.uint8)


# ---------------------------------------------------------------------------
# field arithmetic on (17, B) int32 tensors
# ---------------------------------------------------------------------------


def _roll19(hi: torch.Tensor) -> torch.Tensor:
    """Shift carries up one limb; the top limb's carry wraps to limb 0
    with weight 19 (2^255 = 19 mod p)."""
    return torch.cat([19 * hi[NLIMB - 1 :], hi[: NLIMB - 1]], dim=0)


def _carry(x: torch.Tensor) -> torch.Tensor:
    """Two fully parallel carry passes to the loose range [0, 2^15 + 57]
    (the JAX module's bound argument holds unchanged)."""
    y = (x & M15) + _roll19(x >> 15)
    return (y & M15) + _roll19(y >> 15)


def fadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry(a + b)


def fsub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry(a + _const(_PX2, a) - b)


# (i, j) -> i + j for the 17 x 17 limb products, flattened: where each
# product's low half lands in the 34-limb accumulator (its high half one
# limb above)
_ANTIDIAG = (np.arange(NLIMB)[:, None] + np.arange(NLIMB)[None, :]).reshape(-1)


def _accumulate(prod: torch.Tensor) -> torch.Tensor:
    """(17, 17, B) int32 limb products -> (17, B): the hi/lo split at bit
    15, the anti-diagonal sums into 34 limbs and the x19 fold of limbs
    17..33 (the JAX kernels' row sums; integer sums in any order)."""
    batch = prod.shape[-1]
    idx = _device_const(_ANTIDIAG, prod.device)
    flat = prod.reshape(NLIMB * NLIMB, batch)
    acc = prod.new_zeros((2 * NLIMB, batch))
    acc.index_add_(0, idx, flat & M15)
    acc.index_add_(0, idx + 1, flat >> 15)
    return acc[:NLIMB] + 19 * acc[NLIMB:]


def fmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook multiply, hi/lo split, shift-and-add accumulation:
    (17, B) x (17, B) -> (17, B), all int32."""
    return _carry(_accumulate(a[:, None, :] * b[None, :, :]))


def fsq(a: torch.Tensor) -> torch.Tensor:
    return fmul(a, a)


def finv(z: torch.Tensor, mul=fmul, sq=fsq) -> torch.Tensor:
    """z^(p-2) via the standard 254-squaring addition chain, in the field
    ops `mul`/`sq` (the B2 rows pass their own)."""

    def rep_sq(x, n):
        for _ in range(n):
            x = sq(x)
        return x

    z2 = sq(z)
    z9 = mul(rep_sq(z2, 2), z)
    z11 = mul(z9, z2)
    z_5_0 = mul(sq(z11), z9)
    z_10_0 = mul(rep_sq(z_5_0, 5), z_5_0)
    z_20_0 = mul(rep_sq(z_10_0, 10), z_10_0)
    z_40_0 = mul(rep_sq(z_20_0, 20), z_20_0)
    z_50_0 = mul(rep_sq(z_40_0, 10), z_10_0)
    z_100_0 = mul(rep_sq(z_50_0, 50), z_50_0)
    z_200_0 = mul(rep_sq(z_100_0, 100), z_100_0)
    z_250_0 = mul(rep_sq(z_200_0, 50), z_50_0)
    return mul(rep_sq(z_250_0, 5), z11)


def fcanon(x: torch.Tensor, carry=_carry) -> torch.Tensor:
    """The JAX module's reduction: a carry (`carry`; the B2 rows pass
    their sequential one), then up to two conditional subtractions of p.
    A value below p keeps its (loose) limbs, as in JAX; `bytes_from_limbs`
    and `limbs_to_int` read it exactly."""
    x = carry(x)
    for _ in range(2):
        borrow = 0
        out = []
        for k in range(NLIMB):
            v = x[k] - int(_P_LIMBS[k]) - borrow
            out.append(v & M15)
            borrow = (v >> 15) & 1
        sub = torch.stack(out, dim=0)
        x = torch.where((borrow == 0)[None, :], sub, x)
    return x


# ---------------------------------------------------------------------------
# point arithmetic (extended coordinates X, Y, Z, T), complete formulas
# ---------------------------------------------------------------------------


def point_add(p1, p2):
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = fmul(fsub(y1, x1), fsub(y2, x2))
    b = fmul(fadd(y1, x1), fadd(y2, x2))
    c = fmul(fmul(t1, t2), _const(_D2, t1))
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


def _identity(like: torch.Tensor):
    zeros = torch.zeros_like(like)
    one = zeros.clone()
    one[0] = 1
    return (zeros, one, one, zeros)


def _digits2_from_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """(17, B) 15-bit limbs -> (127, B) 2-bit digits, MSB first. Scalars
    are < L < 2^253, so bits 253 and 254 are zero."""
    shifts = torch.arange(15, dtype=torch.int32, device=limbs.device)
    bits = (limbs[:, None, :] >> shifts[None, :, None]) & 1  # (17, 15, B)
    bits = bits.reshape(NLIMB * 15, limbs.shape[-1])[:254]  # little-endian
    d = bits[0::2] + 2 * bits[1::2]  # (127, B)
    return d.flip(0)


# ---------------------------------------------------------------------------
# dual scalar multiplication [a]P + [b]Q
# ---------------------------------------------------------------------------


def dsm_plain(px, py, qx, qy, a_limbs, b_limbs):
    """px/py, qx/qy: affine point limbs (17, B); a_limbs/b_limbs: (17, B)
    15-bit limb scalars (< L). Returns the affine (x, y) limbs of
    [a]P + [b]Q per lane, reduced as the JAX module's `fcanon` leaves them.

    Interleaved Straus with 2-bit joint windows over a per-lane 16-entry
    table {i*P + j*Q}: 127 x (2 doublings + 1 table add)."""
    ident = _identity(px)
    one = ident[1]
    p1 = (px, py, one, fmul(px, py))
    q1 = (qx, qy, one, fmul(qx, qy))
    p2, q2 = point_double(p1), point_double(q1)
    p3, q3 = point_add(p2, p1), point_add(q2, q1)
    p_row = [ident, p1, p2, p3]
    q_row = [ident, q1, q2, q3]
    table = []
    for j in range(4):  # b digit (multiples of Q)
        for i in range(4):  # a digit (multiples of P)
            if i == 0:
                table.append(q_row[j])
            elif j == 0:
                table.append(p_row[i])
            else:
                table.append(point_add(p_row[i], q_row[j]))
    tcoords = [torch.stack([t[c] for t in table], dim=0) for c in range(4)]  # (16, 17, B)

    sel = (_digits2_from_limbs(a_limbs) + 4 * _digits2_from_limbs(b_limbs)).long()  # (127, B)
    acc = ident
    for step in range(127):
        acc = point_double(point_double(acc))
        idx = sel[step][None, None, :].expand(1, NLIMB, px.shape[-1])
        acc = point_add(acc, tuple(torch.gather(tc, 0, idx)[0] for tc in tcoords))
    ax_, ay_, az_, _ = acc
    zinv = finv(az_)
    return fcanon(fmul(ax_, zinv)), fcanon(fmul(ay_, zinv))


def _check_rows(rows) -> int:
    n = rows[0].shape[-1]
    for t in rows:
        if t.dtype != torch.uint8 or tuple(t.shape) != (32, n) or not t.is_contiguous():
            raise ValueError(
                f"byte rows must be contiguous uint8 (32, {n}); got {t.dtype} {tuple(t.shape)}"
            )
    if any(t.device != rows[0].device for t in rows):
        raise ValueError("all kernel arguments must lie on one device")
    return n


def dsm_lanes(px, py, qx, qy, a8, b8) -> tuple[torch.Tensor, torch.Tensor]:
    """[a]P + [b]Q per lane on (32, n) uint8 little-endian byte rows;
    returns canonical affine (x, y) as (32, n) uint8 rows on the
    arguments' device. A CUDA tensor launches the kernel on the current
    stream without synchronising; a CPU tensor runs `dsm_plain`."""
    global launches
    rows = (px, py, qx, qy, a8, b8)
    n = _check_rows(rows)
    dev = px.device
    if dev.type == "cpu":
        x, y = dsm_plain(*(limbs_from_bytes(r) for r in rows))
        return bytes_from_limbs(x), bytes_from_limbs(y)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((2, 32, n), dtype=torch.uint8, device=dev)
    if n == 0:
        return out[0], out[1]
    lib = kernels.load("ed25519_dsm")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tm_ed25519_dsm(
            *(r.data_ptr() for r in rows), out[0].data_ptr(), out[1].data_ptr(), n, stream
        )
    if rc != 0:
        raise RuntimeError(f"ed25519_dsm kernel launch failed: cudaError {rc}")
    launches += 1
    return out[0], out[1]


def marshal_dsm_args(terms, device=None) -> tuple[torch.Tensor, ...]:
    """terms -> the six (32, n) byte rows (px, py, qx, qy, a, b) on
    `device`, copied in one transfer."""
    cols = (
        [t[1][0] for t in terms], [t[1][1] for t in terms],
        [t[3][0] for t in terms], [t[3][1] for t in terms],
        [t[0] for t in terms], [t[2] for t in terms],
    )
    planes = np.stack([_le_rows(c).T for c in cols])  # (6, 32, n)
    buf = torch.from_numpy(np.ascontiguousarray(planes)).to(resolve_device(device))
    return tuple(buf[k] for k in range(6))


def dsm_batch(
    terms: list[tuple[int, tuple[int, int], int, tuple[int, int]]], device=None
) -> list[tuple[int, int]]:
    """terms: (a, (px, py), b, (qx, qy)) per lane, scalars already reduced
    mod L, points affine and on the curve (the caller validates: the
    aggregate path decompresses through crypto.ed25519.point_decompress).
    Returns per-lane affine [a]P + [b]Q as Python ints. Runs on the card
    unless `device="cpu"`; n lanes, no padding."""
    if not terms:
        return []
    x8, y8 = dsm_lanes(*marshal_dsm_args(terms, device))
    xy = torch.stack([x8, y8]).cpu().numpy()  # (2, 32, n)
    return [
        (int.from_bytes(xy[0, :, i].tobytes(), "little"), int.from_bytes(xy[1, :, i].tobytes(), "little"))
        for i in range(len(terms))
    ]


# ---------------------------------------------------------------------------
# host marshal (int32 limb and bit-row forms)
# ---------------------------------------------------------------------------

_pubkey_cache: dict[bytes, tuple[int, int] | None] = {}


def _decompress_pubkey_cached(pub: bytes) -> tuple[int, int] | None:
    """Affine (x, y) ints for a compressed pubkey; None if invalid.
    Cached: validator pubkeys repeat for every vote and commit."""
    hit = _pubkey_cache.get(pub, False)
    if hit is not False:
        return hit
    pt = ed_ref.point_decompress(pub)
    res = None if pt is None else (pt[0], pt[1])
    if len(_pubkey_cache) < 1_000_000:
        _pubkey_cache[pub] = res
    return res


def _prepare_ints(items: list[tuple[bytes, bytes, bytes]], bucket: int):
    """Shared host validation/marshaling: returns python-int columns
    (ax, ay, ry, r_sign, s, h, valid)."""
    ax_i, ay_i, ry_i = [0] * bucket, [1] * bucket, [1] * bucket
    rs = np.zeros(bucket, dtype=np.int32)
    s_i, h_i = [0] * bucket, [0] * bucket
    valid = np.zeros(bucket, dtype=bool)

    for i, (pub, msg, sig) in enumerate(items):
        if len(sig) != 64 or len(pub) != 32:
            continue
        aff = _decompress_pubkey_cached(bytes(pub))
        if aff is None:
            continue
        r_bytes, s_bytes = sig[:32], sig[32:]
        s = int.from_bytes(s_bytes, "little")
        if s >= L:
            continue
        ry = int.from_bytes(r_bytes, "little")
        r_sign = (ry >> 255) & 1
        ry &= (1 << 255) - 1
        if ry >= P:
            continue
        h = (
            int.from_bytes(
                hashlib.sha512(bytes(r_bytes) + bytes(pub) + bytes(msg)).digest(),
                "little",
            )
            % L
        )
        ax_i[i], ay_i[i], ry_i[i] = aff[0], aff[1], ry
        rs[i] = r_sign
        s_i[i], h_i[i] = s, h
        valid[i] = True
    return ax_i, ay_i, ry_i, rs, s_i, h_i, valid


def prepare_batch(items: list[tuple[bytes, bytes, bytes]], bucket: int):
    """Bit-array form (the JAX Pallas kernel's inputs): returns
    (ax, ay, ry, r_sign, s_bits(253,B), h_bits(253,B), valid)."""
    ax_i, ay_i, ry_i, rs, s_i, h_i, valid = _prepare_ints(items, bucket)
    return (
        int_to_limbs_np(ax_i),
        int_to_limbs_np(ay_i),
        int_to_limbs_np(ry_i),
        rs,
        scalar_bits_np(s_i),
        scalar_bits_np(h_i),
        valid,
    )


def prepare_batch_limbs(items: list[tuple[bytes, bytes, bytes]], bucket: int):
    """Limb form (the JAX int32 verify's inputs): scalars travel as
    (17,B) 15-bit limbs."""
    ax_i, ay_i, ry_i, rs, s_i, h_i, valid = _prepare_ints(items, bucket)
    return (
        int_to_limbs_np(ax_i),
        int_to_limbs_np(ay_i),
        int_to_limbs_np(ry_i),
        rs,
        int_to_limbs_np(s_i),
        int_to_limbs_np(h_i),
        valid,
    )
