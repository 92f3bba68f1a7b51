"""The verify kernel's wrapper: the hand-written CUDA Ed25519 ladder
(`csrc/ed25519_verify.cu`) on a CUDA tensor, its plain PyTorch version
(`ed25519_f32.verify_plain`) on a CPU tensor.

Replaces the TPU path of tendermint_tpu/ops/ed25519_f32p.py: its
`_verify_kernel` Pallas ladder and the `_expand_digits` pass that fed it
(the CUDA kernel extracts the 2-bit digits from the scalar bytes itself).
The contract is the JAX module's: `verify_batch(items) -> bool[n]` and
`verify_batch_async(items) -> resolver`, with semantics identical to
crypto.ed25519.verify per item.

The sharded form (`ShardedVerify`, `sharded_verify_arrays`) replaces
`make_sharded_verify.per_shard`, the JAX module's shard_map over the
same Pallas ladder: a batch's lanes split into equal shards over a mesh
of devices, and each shard is one launch of the same CUDA kernel on its
own device and stream. The unsharded `verify_batch_async` is the same
`dispatch` with one shard on the current stream. `dispatch` takes the
per-shard function as an argument: the sharded `f32` backend runs B3's
plain version through it, and the comb pool its kernel.

There is no fallback: on a CUDA tensor the kernel launches or the call
raises.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from tendermint_tpu_torch.ops import ed25519_f32 as base
from tendermint_tpu_torch.ops import kernels, resolve_device

NL = base.NL

# Incremented once per kernel launch (never for the CPU plain version):
# a run reads it to show that its work went through the kernel.
launches = 0

# The kernel's work per lane, summed over the lane's four threads and
# counted from csrc/ed25519_verify.cu (see its note), for the least time
# the card could take: field multiplications cost 100 32x32->64-bit limb
# products and squarings 55.
MULS_PER_LANE = 2021
SQS_PER_LANE = 1274
PRODUCTS_PER_LANE = 100 * MULS_PER_LANE + 55 * SQS_PER_LANE
BYTES_PER_LANE = 5 * NL + 4 + 4  # five byte rows and the sign in, the verdict out


def host_planes(items: list[tuple[bytes, bytes, bytes]], bucket: int):
    """The host marshal for `bucket` >= len(items) lanes: (planes, rsign,
    valid), planes the (5, 32, bucket) uint8 byte rows ax, ay, ry, s8, h8,
    rsign (bucket,) int32. Padding lanes are valid=False."""
    ax, ay, ry, rs, s8, h8, valid = base.prepare_batch8(items, bucket)
    planes = np.stack([a.astype(np.uint8) for a in (ax, ay, ry, s8, h8)])
    return planes, rs, valid


def device_args(planes: np.ndarray, rs: np.ndarray, dev: torch.device, non_blocking=False):
    """One host-to-device copy of contiguous (5, 32, n) planes: the
    kernel's argument tuple (ax, ay, ry, rsign, s8, h8) on `dev`."""
    buf = torch.from_numpy(planes).to(dev, non_blocking=non_blocking)
    rsign = torch.from_numpy(rs).to(dev, non_blocking=non_blocking)
    return buf[0], buf[1], buf[2], rsign, buf[3], buf[4]


def marshal_device_args(items: list[tuple[bytes, bytes, bytes]], device=None):
    """Host marshal + host-to-device copy: the kernel's arguments for a
    batch. Returns (args, valid, n): args = (ax, ay, ry, rsign, s8, h8),
    byte rows as (32, n) uint8 and rsign as (n,) int32, on `device`; valid
    masks the lanes the host already rejected."""
    dev = resolve_device(device)
    n = len(items)
    planes, rs, valid = host_planes(items, n)
    return device_args(planes, rs, dev), valid, n


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
    n = check_args(ax, ay, ry, rsign, s8, h8)
    if ax.device.type == "cpu":
        return base.verify_rows(ax, ay, ry, rsign, s8, h8)
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
    kernels.count_launch(__name__)
    return out


def materialize_verdicts(ok, valid: np.ndarray, n: int) -> np.ndarray:
    """Per-item booleans from a host verdict array: the one masking tail
    every batched-verify exit shares."""
    if n == 0:
        return np.zeros(0, dtype=bool)
    return (np.asarray(ok).reshape(-1)[:n] != 0) & valid[:n]


class ShardedVerdicts:
    """A dispatch in flight (see `dispatch`). `shards` is (device, lanes)
    per shard in mesh order; `wait()` returns the (total,) int32 host
    verdicts once every shard's copy back has landed, re-raising any
    fault."""

    __slots__ = ("host", "shards", "_done")

    def __init__(self, host: torch.Tensor, shards: list[tuple[str, int]], done: list):
        self.host = host
        self.shards = shards
        self._done = done

    def wait(self) -> torch.Tensor:
        for event in self._done:
            event.synchronize()
        return self.host


def dispatch(planes: np.ndarray, rs: np.ndarray, devices: list[torch.device], streams: list,
             verify=None) -> ShardedVerdicts:
    """Run `verify` (B1 unless given: a function of the kernel's argument
    tuple returning (n,) int32 verdicts on the arguments' device, without
    synchronising) on host-marshalled lanes (`host_planes`) split into
    len(devices) equal shards, shard k on devices[k] and streams[k] (None:
    that device's current stream), and start the copies back into one
    pinned host buffer. A CPU shard runs now."""
    verify = verify or verify_lanes
    total = planes.shape[-1]
    per, rem = divmod(total, len(devices))
    if rem:
        raise ValueError(f"{total} lanes do not split into {len(devices)} equal shards")
    on_card = any(d.type == "cuda" for d in devices)
    host = torch.empty(total, dtype=torch.int32, pin_memory=on_card)
    done = []
    for k, (dev, stream) in enumerate(zip(devices, streams)):
        lo, hi = k * per, (k + 1) * per
        # a lane slice of the planes is strided, and the kernel takes
        # contiguous rows: each shard gets its own copy
        shard = np.ascontiguousarray(planes[..., lo:hi])
        rshard = np.ascontiguousarray(rs[lo:hi])
        if dev.type == "cpu":
            host[lo:hi] = verify(*device_args(shard, rshard, dev))
            continue
        # allocate, launch and copy back on the shard's own stream: the
        # caching allocator then hands these blocks out again only to
        # later work on that stream, behind this kernel
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            ok = verify(*device_args(shard, rshard, dev, non_blocking=True))
            host[lo:hi].copy_(ok, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        done.append(event)
    return ShardedVerdicts(host, [(str(d), per) for d in devices], done)


def verify_batch_async(items: list[tuple[bytes, bytes, bytes]], device=None):
    """Marshal + launch now; return a zero-arg resolver for bool[n]. On
    the card the verdicts come back through pinned memory, and the
    resolver waits on an event recorded on the current stream after that
    copy, not on the whole device: a one-shard `dispatch`."""
    n = len(items)
    if n == 0:
        return lambda: np.zeros(0, dtype=bool)
    planes, rs, valid = host_planes(items, n)
    res = dispatch(planes, rs, [resolve_device(device)], [None])
    return lambda: materialize_verdicts(res.wait(), valid, n)


def verify_batch(items: list[tuple[bytes, bytes, bytes]], device=None) -> np.ndarray:
    """Batched strict RFC 8032 verify -> bool[n]."""
    return verify_batch_async(items, device)()


# -- B1': the ladder sharded over a mesh of devices ----------------------------

BLOCK_LANES = 32  # lanes per block of csrc/ed25519_verify.cu: 128 threads, four a lane


def lane_quantum(n_shards: int) -> int:
    """Smallest lane count that splits into equal shards of whole
    blocks of BLOCK_LANES lanes."""
    return n_shards * BLOCK_LANES


def quantum_bucket(n: int, n_shards: int) -> int:
    """B1's sharded bucket: n rounded up to a multiple of `lane_quantum`."""
    q = lane_quantum(n_shards)
    return -(-n // q) * q


def _mesh_device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"mesh device cuda:{index} is not visible: {torch.cuda.device_count()} card(s)"
            )
        dev = torch.device("cuda", index)
    return dev


class ShardedVerify:
    """B1' over a mesh, the counterpart of the JAX module's
    `make_sharded_verify` (jit(shard_map(per_shard)), whose per-shard body
    is B1). A mesh is a sequence of devices (`torch.device` or strings
    such as "cuda:1"), one shard each, in order; a device may appear more
    than once. Pure data parallelism, as in the JAX module: no
    device-to-device copy and no collective. One stream per card shard,
    made once here.

    `verify` and `bucket` choose another per-shard function and its lane
    count (`dispatch`'s `verify`; bucket(n, shards) lanes in all): the
    sharded `f32` backend runs B3's `verify_plain` per shard."""

    def __init__(self, mesh: Sequence, verify=None, bucket=quantum_bucket):
        if len(mesh) == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = [_mesh_device(d) for d in mesh]
        self.streams = [
            torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in self.devices
        ]
        self.verify = verify
        self.bucket = bucket

    def __len__(self) -> int:
        return len(self.devices)

    def dispatch(self, planes: np.ndarray, rs: np.ndarray) -> ShardedVerdicts:
        """`dispatch` over this mesh's devices and streams."""
        return dispatch(planes, rs, self.devices, self.streams, self.verify)


def sharded_verify_arrays(items: list[tuple[bytes, bytes, bytes]], sharded: ShardedVerify):
    """Marshal once on the host and dispatch through `sharded`: returns
    (ShardedVerdicts, valid, n), the verdicts still in flight (None for an
    empty batch). The bucket is `sharded.bucket(n, shards)` lanes
    (`quantum_bucket` for B1); padding lanes are valid=False."""
    n = len(items)
    if n == 0:
        return None, np.zeros(0, dtype=bool), 0
    planes, rs, valid = host_planes(items, sharded.bucket(n, len(sharded)))
    return sharded.dispatch(planes, rs), valid, n
