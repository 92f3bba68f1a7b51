"""The verify kernel's wrapper: the hand-written CUDA Ed25519 ladder
(`csrc/ed25519_verify.cu`) on a CUDA tensor, its plain PyTorch version
(`ed25519_f32.verify_plain`) on a CPU tensor.

Replaces the TPU path of tendermint_tpu/ops/ed25519_f32p.py: its
`_verify_kernel` Pallas ladder and the `_expand_digits` pass that fed it
(the CUDA kernel extracts the 2-bit digits from the scalar bytes itself).
The contract is the JAX module's: `verify_batch(items) -> bool[n]` and
`verify_batch_async(items) -> resolver`, with semantics identical to
crypto.ed25519.verify per item.

There is no fallback: on a CUDA tensor the kernel launches or the call
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from tendermint_tpu_torch.ops import ed25519_f32 as base
from tendermint_tpu_torch.ops import kernels, resolve_device

NL = base.NL

# Incremented once per kernel launch (never for the CPU plain version):
# a run reads it to show that its work went through the kernel.
launches = 0

# The kernel's work per lane, counted from csrc/ed25519_verify.cu (see its
# note), for the least time the card could take: field multiplications
# cost 100 32x32->64-bit limb products and squarings 55.
MULS_PER_LANE = 2021
SQS_PER_LANE = 1274
PRODUCTS_PER_LANE = 100 * MULS_PER_LANE + 55 * SQS_PER_LANE
BYTES_PER_LANE = 5 * NL + 4 + 4  # five byte rows and the sign in, the verdict out


def marshal_device_args(items: list[tuple[bytes, bytes, bytes]], device=None):
    """Host marshal + host-to-device copy: the kernel's arguments for a
    batch. Returns (args, valid, n): args = (ax, ay, ry, rsign, s8, h8),
    byte rows as (32, n) uint8 and rsign as (n,) int32, on `device`; valid
    masks the lanes the host already rejected."""
    dev = resolve_device(device)
    n = len(items)
    ax, ay, ry, rs, s8, h8, valid = base.prepare_batch8(items, n)
    planes = np.stack([a.astype(np.uint8) for a in (ax, ay, ry, s8, h8)])
    buf = torch.from_numpy(planes).to(dev)  # (5, 32, n): one copy for all rows
    rsign = torch.from_numpy(rs).to(dev)
    return (buf[0], buf[1], buf[2], rsign, buf[3], buf[4]), valid, n


def check_args(ax, ay, ry, rsign, s8, h8) -> int:
    """The lane count of a verify kernel's arguments (B1's and B2's
    alike); raises ValueError on a type, shape, layout or device the
    kernels do not take."""
    n = ax.shape[-1]
    rows = (ax, ay, ry, s8, h8)
    for t in rows:
        if t.dtype != torch.uint8 or tuple(t.shape) != (NL, n) or not t.is_contiguous():
            raise ValueError(
                f"byte rows must be contiguous uint8 ({NL}, {n}); got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if rsign.dtype != torch.int32 or tuple(rsign.shape) != (n,) or not rsign.is_contiguous():
        raise ValueError(f"rsign must be contiguous int32 ({n},); got {rsign.dtype} {tuple(rsign.shape)}")
    if any(t.device != ax.device for t in (*rows, rsign)):
        raise ValueError("all kernel arguments must lie on one device")
    return n


def verify_lanes(ax, ay, ry, rsign, s8, h8) -> torch.Tensor:
    """Per-lane verdicts (n,) int32, 1 = accept, on the arguments' device.
    A CUDA tensor launches the kernel on the current stream without
    synchronising; a CPU tensor runs the plain version."""
    global launches
    n = check_args(ax, ay, ry, rsign, s8, h8)
    if ax.device.type == "cpu":
        ok = base.verify_plain(ax.float(), ay.float(), ry.float(), rsign, s8.int(), h8.int())
        return ok.to(torch.int32)
    if ax.device.type != "cuda":
        raise ValueError(f"unsupported device {ax.device}")
    out = torch.empty(n, dtype=torch.int32, device=ax.device)
    if n == 0:
        return out
    lib = kernels.load("ed25519_verify")
    with torch.cuda.device(ax.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tm_ed25519_verify(
            ax.data_ptr(), ay.data_ptr(), ry.data_ptr(), rsign.data_ptr(),
            s8.data_ptr(), h8.data_ptr(), out.data_ptr(), n, stream,
        )
    if rc != 0:
        raise RuntimeError(f"ed25519_verify kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def materialize_verdicts(ok, valid: np.ndarray, n: int) -> np.ndarray:
    """Per-item booleans from a host verdict array: the one masking tail
    every batched-verify exit shares."""
    if n == 0:
        return np.zeros(0, dtype=bool)
    return (np.asarray(ok).reshape(-1)[:n] != 0) & valid[:n]


def verify_batch_async(items: list[tuple[bytes, bytes, bytes]], device=None):
    """Marshal + launch now; return a zero-arg resolver for bool[n]. On
    the card the verdicts come back through pinned memory, and the
    resolver waits on an event recorded on the current stream after that
    copy, not on the whole device."""
    n = len(items)
    if n == 0:
        return lambda: np.zeros(0, dtype=bool)
    args, valid, n = marshal_device_args(items, device)
    ok = verify_lanes(*args)
    if ok.device.type != "cuda":
        return lambda: materialize_verdicts(ok, valid, n)
    host = torch.empty(n, dtype=torch.int32, pin_memory=True)
    with torch.cuda.device(ok.device):
        host.copy_(ok, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

    def resolve() -> np.ndarray:
        done.synchronize()
        return materialize_verdicts(host, valid, n)

    return resolve


def verify_batch(items: list[tuple[bytes, bytes, bytes]], device=None) -> np.ndarray:
    """Batched strict RFC 8032 verify -> bool[n]."""
    return verify_batch_async(items, device)()
