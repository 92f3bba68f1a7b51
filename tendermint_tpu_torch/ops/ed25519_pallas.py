"""The B2 verify kernel's wrapper: the hand-written CUDA single-bit
ladder (`csrc/ed25519_verify_b2.cu`, four threads a lane) on a CUDA
tensor, its plain PyTorch version (`verify_plain`) on a CPU tensor.
Selected in the gateway by `TENDERMINT_TPU_KERNEL=pallas`, the JAX
registry's name for it.

Replaces the TPU kernel of tendermint_tpu/ops/ed25519_pallas.py: its
`_verify_kernel` Pallas ladder, in int32 radix-2^15 with 17 limbs, walking
253 single-bit Straus steps over the 4-entry table {0, B, -A, B-A}. The
contract is the JAX module's: `verify_batch(items) -> bool[n]`, with
semantics identical to crypto.ed25519.verify per item; like the JAX
module it has no async form.

The kernel and its plain version take the byte rows that B1 takes
(`ed25519_f32.prepare_batch8` through `ed25519_f32p.marshal_device_args`),
so the host marshal runs once; the kernel extracts the scalar bits itself.
`verify_plain` unpacks the rows into the JAX kernel's (17, B) limbs and
(253, B) bit rows and runs the JAX kernel's row arithmetic, held here as
(17, B) int32 tensors (`_fmul_rows`, `_carry_rows`, ...), bit for bit.

There is no fallback: on a CUDA tensor the kernel launches or the call
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from tendermint_tpu_torch.ops import ed25519 as base
from tendermint_tpu_torch.ops import ed25519_f32p as f32p
from tendermint_tpu_torch.ops import kernels

NLIMB = base.NLIMB
M15 = base.M15

# Incremented once per kernel launch (never for the CPU plain version):
# a run reads it to show that its work went through the kernel.
launches = 0

# The kernel's work per lane, counted from csrc/ed25519_verify_b2.cu (see
# its note), for the least time the card could take: field
# multiplications cost 100 32x32->64-bit limb products and squarings 55.
MULS_PER_LANE = 3062
SQS_PER_LANE = 1266
PRODUCTS_PER_LANE = 100 * MULS_PER_LANE + 55 * SQS_PER_LANE
BYTES_PER_LANE = 5 * 32 + 4 + 4  # five byte rows and the sign in, the verdict out

# ---------------------------------------------------------------------------
# the JAX kernel's row arithmetic, on (17, B) int32 tensors
# ---------------------------------------------------------------------------


def _carry_rows(x: torch.Tensor) -> torch.Tensor:
    """One sequential carry pass limb 0 -> 16; the top carry folds into
    limb 0 with weight 19 and limb 0's carry into limb 1."""
    out = []
    c = None
    for k in range(NLIMB):
        v = x[k] if c is None else x[k] + c
        out.append(v & M15)
        c = v >> 15
    v0 = out[0] + 19 * c
    out[0] = v0 & M15
    out[1] = out[1] + (v0 >> 15)
    return torch.stack(out)


def _fmul_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry_rows(base._accumulate(a[:, None, :] * b[None, :, :]))


# squaring: the diagonal products once, the products above it doubled
# (in int32, as JAX's `2 * (a[i] * a[j])`), none below it
_SQ_COEF = np.triu(np.full((NLIMB, NLIMB), 2, dtype=np.int32), 1) + np.eye(NLIMB, dtype=np.int32)


def _fsq_rows(a: torch.Tensor) -> torch.Tensor:
    coef = base._device_const(_SQ_COEF, a.device)[:, :, None]
    return _carry_rows(base._accumulate(a[:, None, :] * a[None, :, :] * coef))


def _fadd_rows(a, b):
    return _carry_rows(a + b)


def _fsub_rows(a, b):
    return _carry_rows(a + base._const(base._PX2, a) - b)


def _point_add_rows(p1, p2, d2_rows):
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = _fmul_rows(_fsub_rows(y1, x1), _fsub_rows(y2, x2))
    b = _fmul_rows(_fadd_rows(y1, x1), _fadd_rows(y2, x2))
    c = _fmul_rows(_fmul_rows(t1, t2), d2_rows)
    zz = _fmul_rows(z1, z2)
    d = _fadd_rows(zz, zz)
    e = _fsub_rows(b, a)
    f = _fsub_rows(d, c)
    g = _fadd_rows(d, c)
    h = _fadd_rows(b, a)
    return (_fmul_rows(e, f), _fmul_rows(g, h), _fmul_rows(f, g), _fmul_rows(e, h))


def _point_double_rows(p1):
    x1, y1, z1, _ = p1
    a = _fsq_rows(x1)
    b = _fsq_rows(y1)
    zz = _fsq_rows(z1)
    c = _fadd_rows(zz, zz)
    h = _fadd_rows(a, b)
    e = _fsub_rows(h, _fsq_rows(_fadd_rows(x1, y1)))
    g = _fsub_rows(a, b)
    f = _fadd_rows(c, g)
    return (_fmul_rows(e, f), _fmul_rows(g, h), _fmul_rows(f, g), _fmul_rows(e, h))


def _fcanon_rows(x: torch.Tensor) -> torch.Tensor:
    return base.fcanon(x, carry=_carry_rows)


def _finv_rows(z: torch.Tensor) -> torch.Tensor:
    return base.finv(z, mul=_fmul_rows, sq=_fsq_rows)


# ---------------------------------------------------------------------------
# the plain version of the B2 kernel
# ---------------------------------------------------------------------------


def verify_plain(ax8, ay8, ry8, rsign, s8, h8) -> torch.Tensor:
    """ax8/ay8: affine public-key byte rows (32, B); ry8: R's y byte rows
    (host-checked < p); rsign: (B,) int32 x-parity of R; s8/h8: (32, B)
    byte rows of the scalars. Returns bool[B]: compress([s]B + [h](-A))
    == R, strict and cofactorless.

    253 single-bit Straus steps MSB first, each one doubling and one
    addition from {0, B, -A, B-A} indexed by s_bit + 2 h_bit."""
    ax = base.limbs_from_bytes(ax8)
    ay = base.limbs_from_bytes(ay8)
    s_bits = base.bits_from_bytes(s8).flip(0)  # row 0 = bit 252
    h_bits = base.bits_from_bytes(h8).flip(0)
    batch = ax.shape[-1]

    def const_rows(arr):
        return base._const(arr, ax).expand(NLIMB, batch)

    ident = base._identity(ax)
    zeros, one = ident[0], ident[1]
    d2_rows = const_rows(base._D2)
    nax = _fsub_rows(zeros, ax)
    neg_a = (nax, ay, one, _fmul_rows(nax, ay))
    b_pt = (const_rows(base._BX), const_rows(base._BY), one, const_rows(base._BT))
    b_neg_a = _point_add_rows(b_pt, neg_a, d2_rows)
    table = [ident, b_pt, neg_a, b_neg_a]
    tcoords = [torch.stack([t[c] for t in table]) for c in range(4)]  # (4, 17, B)

    sel = (s_bits + 2 * h_bits).long()  # (253, B)
    acc = ident
    for step in range(253):
        acc = _point_double_rows(acc)
        idx = sel[step][None, None, :].expand(1, NLIMB, batch)
        acc = _point_add_rows(acc, tuple(torch.gather(tc, 0, idx)[0] for tc in tcoords), d2_rows)

    px, py, pz, _ = acc
    zinv = _finv_rows(pz)
    x_aff = _fcanon_rows(_fmul_rows(px, zinv))
    y_aff = _fcanon_rows(_fmul_rows(py, zinv))
    ry = _fcanon_rows(base.limbs_from_bytes(ry8))
    return torch.all(y_aff == ry, dim=0) & ((x_aff[0] & 1) == rsign)


def verify_lanes(ax, ay, ry, rsign, s8, h8) -> torch.Tensor:
    """Per-lane verdicts (n,) int32, 1 = accept, on the arguments' device,
    from the arguments of B1's `ed25519_f32p.verify_lanes`. A CUDA tensor
    launches the kernel on the current stream without synchronising; a CPU
    tensor runs the plain version."""
    n = f32p.check_args(ax, ay, ry, rsign, s8, h8)
    if ax.device.type == "cpu":
        return verify_plain(ax, ay, ry, rsign, s8, h8).to(torch.int32)
    if ax.device.type != "cuda":
        raise ValueError(f"unsupported device {ax.device}")
    out = torch.empty(n, dtype=torch.int32, device=ax.device)
    if n == 0:
        return out
    lib = kernels.load("ed25519_verify_b2")
    with torch.cuda.device(ax.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tm_ed25519_verify_b2(
            ax.data_ptr(), ay.data_ptr(), ry.data_ptr(), rsign.data_ptr(),
            s8.data_ptr(), h8.data_ptr(), out.data_ptr(), n, stream,
        )
    if rc != 0:
        raise RuntimeError(f"ed25519_verify_b2 kernel launch failed: cudaError {rc}")
    kernels.count_launch(__name__)
    return out


def verify_batch(items: list[tuple[bytes, bytes, bytes]], device=None) -> np.ndarray:
    """Batched strict RFC 8032 verify -> bool[n], on the card unless
    `device="cpu"`; n lanes, no padding."""
    if not items:
        return np.zeros(0, dtype=bool)
    args, valid, n = f32p.marshal_device_args(items, device)
    return f32p.materialize_verdicts(verify_lanes(*args).cpu(), valid, n)
