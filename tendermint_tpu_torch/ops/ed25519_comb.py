"""Doubling-free batched Ed25519 verify (registry name `comb`): per-validator
comb tables in a device-resident pool and a fixed-base table for B.

Replaces tendermint_tpu/ops/ed25519_comb.py (B4 of the JAX package, jitted
XLA there): the same validator keys sign every block, so a table of
windowed multiples of each key's -A, built once, lets every later verify
of that key skip the doublings:

    [s]B + [h](-A)  ==  sum_p T_B[p][s_p]  +  sum_p T_A[p][h_p]

with 4-bit windows: 64 positions a scalar, 16 entries each, so a verify is
128 table lookups and 128 mixed (niels) additions from the identity, then
the RFC 8032 compare with R, exactly as the JAX kernel.

Two hand-written CUDA kernels carry it on the card, each behind a wrapper
that runs its plain PyTorch version for a CPU tensor:

- `comb_lanes` (`csrc/ed25519_comb.cu`; plain version `verify_comb_plain`,
  JAX `_verify_comb_impl`): 64 gathers from the pool and 64 from the B
  table, summed as two chains of mixed additions on two groups of four
  threads and joined, while a ninth thread decodes R; the compare with R
  is projective, with no inversion.
- `build_lanes` (`csrc/ed25519_comb_tables.cu`; plain version
  `build_tables_plain`, JAX `_build_tables_impl` and `_scatter_tables`):
  the 64 x 16 niels entries of each new key, one thread a (key, position),
  one Montgomery batch a block of two keys whose inversion runs in a
  launch of its own, written straight into its pool slot as canonical
  bytes.

The pool (`CombPool`) is the JAX package's with the dtype changed: rows
of 96 canonical radix-2^8 limbs ((y-x, y+x, 2dxy), 32 each), stored as
uint8 where JAX stores bf16, 1024 rows (98,304 bytes) a slot, slot 0
reserved and zero. Where JAX rebuilds the pool array functionally, the
port writes it in place: every pool write (growth, table builds) and every
comb launch of one pool runs on the pool's own stream, so stream order
keeps an earlier launch ahead of a later rebuild of one of its slots, and
a resolver holds the pool tensor it launched on until its verdicts are
back.

Lane routing is the JAX module's (the second-sight policy below): lanes
whose key has a table, or is seen for the MIN_SIGHT-th time, ride comb;
the rest, malformed lanes and a batch the pool cannot hold
(`PoolExhausted`) verify on the ladder. The port's ladder is B1
(`ed25519_f32p.verify_batch_async`), which computes B3's ladder in one
launch on the card and is `verify_plain` itself on the CPU. There is no
other fallback: a failed build or launch of either kernel raises.

Field arithmetic of the plain versions is `ed25519_f32`'s fp32 radix-2^8
(its EXACTNESS ARGUMENT; the niels addition's bounds are the JAX module's
`_niels_add` note), so the CPU tests hold them against JAX bit for bit.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
from collections import OrderedDict

import numpy as np
import torch

from tendermint_tpu_torch.crypto import ed25519 as ed_ref
from tendermint_tpu_torch.ops import ed25519_f32 as base
from tendermint_tpu_torch.ops import ed25519_f32p as f32p
from tendermint_tpu_torch.ops import kernels, resolve_device

logger = logging.getLogger("tendermint_tpu_torch.ops.ed25519_comb")

P = base.P
NL = base.NL
W_POS = 64  # 4-bit windows over 256 bits
W_ENT = 16  # entries per window (digit values 0..15)
COORD_ROWS = 3 * NL  # niels coords per entry: (y-x, y+x, 2dxy), 32 limbs each
ROWS_PER_SLOT = W_POS * W_ENT

# Incremented once per launch of each kernel (never for the CPU plain
# versions): a run reads them to show that its work went through the kernels.
launches = 0  # the comb verify kernel
table_launches = 0  # the table-build kernel

# The least work each function needs, for the least time the card could
# take: field multiplications cost 100 32x32->64-bit limb products and
# squarings 55. Each kernel's own count, in its source's note, is larger.
# A verify: 127 mixed additions x 7 (the first entry, added to the
# identity, needs only its T: 1), the inversion (11, 254 squarings),
# affine x and y (2). The kernel does 934 and 255: all 128 entries as two
# chains and their join, R's decoding in place of the inversion.
MULS_PER_LANE = 903
SQS_PER_LANE = 254
PRODUCTS_PER_LANE = 100 * MULS_PER_LANE + 55 * SQS_PER_LANE
# A key's table: the 64 bases 16^p * Q (820, 1,008 squarings); 64 x 14
# additions of the base's cached form (8 each, 1 for its 2dT); one
# Montgomery batch over the key's 960 Z values (3 x 959), as the JAX
# package's `_build_tables_impl`, whose inversion the table-build kernel
# shares between keys (one for two), so none is counted here; each entry's
# affine x, y, x*y and 2dxy (4 x 960).
MULS_PER_KEY = 14_769
SQS_PER_KEY = 1_008
PRODUCTS_PER_KEY = 100 * MULS_PER_KEY + 55 * SQS_PER_KEY
# The table-build kernel's own count (its source's note): 31,471
# multiplications and 2,270 squarings for two keys.
KERNEL_PRODUCTS_PER_KEY = (100 * 31_471 + 55 * 2_270) // 2
# Its scratch a key, in Fe of ten int32 limbs: the 64 bases' four
# coordinates, the 64 positions' Z products, their 15 entries' three
# values, and at most one block product: 3,201 Fe, 128,040 bytes, so 1.28
# GB for a 10,000-key build, which the caching allocator keeps for reuse.
TABLE_SCRATCH_FE_PER_KEY = 4 * W_POS + W_POS + 3 * (W_ENT - 1) * W_POS + 1
BYTES_PER_KEY = 2 * NL + ROWS_PER_SLOT * COORD_ROWS + 4  # Q in, the slot's rows out, the slot


# ---------------------------------------------------------------------------
# fixed-base table for B (host-computed once, python ints)
# ---------------------------------------------------------------------------

_b_table_cache: list = []
_b_table_lock = threading.Lock()


def _niels_rows_np(x: int, y: int) -> np.ndarray:
    """(96,) float32 canonical limbs of ((y-x) mod p, (y+x) mod p,
    (2d*x*y) mod p)."""
    t2 = (2 * ed_ref.D % P) * x % P * y % P
    out = np.empty(COORD_ROWS, dtype=np.float32)
    out[:NL] = base._int_to_limbs_const((y - x) % P)
    out[NL : 2 * NL] = base._int_to_limbs_const((y + x) % P)
    out[2 * NL :] = base._int_to_limbs_const(t2)
    return out


def b_table() -> np.ndarray:
    """(W_POS, W_ENT, 96) float32 niels table of v * 16^p * B. Entry 0 is
    the identity in niels form: (1, 1, 0)."""
    with _b_table_lock:
        if _b_table_cache:
            return _b_table_cache[0]
        tab = np.zeros((W_POS, W_ENT, COORD_ROWS), dtype=np.float32)
        ident = np.zeros(COORD_ROWS, dtype=np.float32)
        ident[0] = 1.0
        ident[NL] = 1.0
        gp = ed_ref.B  # extended (X, Y, Z=1, T)
        for p in range(W_POS):
            tab[p, 0] = ident
            acc = gp
            for v in range(1, W_ENT):
                ax, ay = base._affine(acc)
                tab[p, v] = _niels_rows_np(ax, ay)
                if v + 1 < W_ENT:
                    acc = ed_ref.point_add(acc, gp)
            for _ in range(4):  # gp <- 16 * gp
                gp = ed_ref.point_add(gp, gp)
        _b_table_cache.append(tab)
        return tab


# ---------------------------------------------------------------------------
# the plain versions of the two kernels
# ---------------------------------------------------------------------------


def _digits4(limbs_u8: torch.Tensor) -> torch.Tensor:
    """(32, B) int byte limbs -> (64, B) 4-bit digits, little-endian
    position order (position p has weight 16^p)."""
    lo = limbs_u8 & 15
    hi = (limbs_u8 >> 4) & 15
    return torch.stack([lo, hi], dim=1).reshape(2 * NL, limbs_u8.shape[-1])


def _niels_add(acc, my, py, t2):
    """Mixed addition acc + N where N is a niels-form affine point
    (my = y-x, py = y+x, t2 = 2d*x*y; implicit z = 1). Bounds: the JAX
    module's `_niels_add` note (canonical my/py/t2 are tighter than any
    operand the f32 EXACTNESS ARGUMENT covers)."""
    x1, y1, z1, t1 = acc
    a = base.fmul(base.fsub(y1, x1), my)
    b = base.fmul(base.fadd(y1, x1), py)
    c = base.fmul(t1, t2)
    d = base.fadd(z1, z1)
    e = base.fsub(b, a)
    f = base.fsub(d, c)
    g = base.fadd(d, c)
    h = base.fadd(b, a)
    return (base.fmul(e, f), base.fmul(g, h), base.fmul(f, g), base.fmul(e, h))


def verify_comb_plain(pool, t_b, slots, r_y, r_sign, s8, h8) -> torch.Tensor:
    """pool: (C*1024, 96) per-validator niels rows (of -A); t_b: (64, 16,
    96) or (1024, 96) fixed-base rows; slots: (B,) pool slot per lane;
    r_y: R's y limbs (32, B) f32; r_sign: (B,) int32; s8/h8: (32, B) int
    byte limbs of the scalars. Returns bool[B].

    The JAX kernel's sum W = [s]B + [h](-A) as 128 niels lookups and 128
    mixed additions from the identity (no doublings), then the compare
    with R. The B rows are gathered by digit, where JAX multiplies a
    one-hot by the table: the same rows, exactly."""
    batch = slots.shape[0]
    dh = _digits4(h8).long()  # (64, B) digits of h -> per-validator pool
    ds = _digits4(s8).long()  # (64, B) digits of s -> fixed-base table
    pos = torch.arange(W_POS, device=slots.device)[:, None]  # (64, 1)

    def gather(table, rows):
        got = table.reshape(-1, COORD_ROWS)[rows.reshape(-1)]  # (64*B, 96)
        return got.reshape(W_POS, batch, COORD_ROWS).to(torch.float32).permute(0, 2, 1)

    rows_a = gather(pool, (slots.long()[None, :] * W_POS + pos) * W_ENT + dh)
    rows_b = gather(t_b, pos * W_ENT + ds)
    stream = torch.cat([rows_a, rows_b], dim=0).contiguous()  # (128, 96, B)

    zeros = torch.zeros_like(stream[0, :NL])
    one = zeros.clone()
    one[0] = 1.0
    acc = (zeros, one, one, zeros)
    for row in stream:
        acc = _niels_add(acc, row[:NL], row[NL : 2 * NL], row[2 * NL :])

    px, py_, pz, _ = acc
    zinv = base.finv(pz)
    x_aff = base.fcanon(base.fmul(px, zinv))
    y_aff = base.fcanon(base.fmul(py_, zinv))
    sign = x_aff[0].to(torch.int32) & 1
    return torch.all(y_aff == base.fcanon(r_y), dim=0) & (sign == r_sign)


def build_tables_plain(qx, qy) -> torch.Tensor:
    """qx/qy: (32, n) f32 canonical affine limbs of Q = -A per key.
    Returns (n, W_POS*W_ENT, 96) float32 niels tables (canonical limbs).

    The table-build kernel's points: the 64 bases Q_p = 16^p * Q (four
    doublings apart), then for every (position, key) at once the 15
    extended multiples v*Q_p (a chain of additions); here one Montgomery
    batch inversion of each position's 15 Zs (the kernel batches two
    keys' 1,920, the JAX package a key's 960), and canonical niels rows. Every entry is canonical, so the bytes equal the kernel's
    and the JAX package's `_build_tables_impl` whatever the batching."""
    n = qx.shape[-1]
    zeros = torch.zeros_like(qx)
    one = zeros.clone()
    one[0] = 1.0
    q = (qx, qy, one, base.fmul(qx, qy))
    bases = [q]
    for _ in range(W_POS - 1):
        for _ in range(4):
            q = base.point_double(q)
        bases.append(q)
    # lane p*n + j: key j's position p
    qp = tuple(torch.cat([b[c] for b in bases], dim=1) for c in range(4))
    wide = W_POS * n
    d2 = base._const("d2", qx).expand(NL, wide)
    entries = [qp]
    for _ in range(W_ENT - 2):
        entries.append(base.point_add(entries[-1], qp, d2))

    # Montgomery batch inversion of each lane's 15 Zs: prefix products,
    # one inversion, and the unwind
    zs = [e[2] for e in entries]
    prefix = [zs[0]]
    for z in zs[1:]:
        prefix.append(base.fmul(prefix[-1], z))
    inv = base.finv(prefix[-1])
    zinvs = [None] * len(zs)
    for v in range(len(zs) - 1, 0, -1):
        zinvs[v] = base.fmul(inv, prefix[v - 1])
        inv = base.fmul(inv, zs[v])
    zinvs[0] = inv

    # canonical niels rows of all 15 x 64 x n entries at once, lane
    # v*wide + p*n + j for multiple v + 1
    zinv = torch.cat(zinvs, dim=1)
    x = base.fmul(torch.cat([e[0] for e in entries], dim=1), zinv)
    y = base.fmul(torch.cat([e[1] for e in entries], dim=1), zinv)
    t2 = base.fmul(base.fmul(x, y), base._const("d2", qx).expand(NL, x.shape[-1]))
    niels = torch.stack([base.fcanon(base.fsub(y, x)), base.fcanon(base.fadd(y, x)),
                         base.fcanon(t2)])  # (3, 32, 15 * 64 * n)
    niels = niels.reshape(3, NL, W_ENT - 1, W_POS, n).permute(4, 3, 2, 0, 1)
    niels = niels.reshape(n, W_POS, W_ENT - 1, COORD_ROWS)
    ident = torch.zeros((n, W_POS, 1, COORD_ROWS), dtype=torch.float32, device=qx.device)
    ident[..., 0] = 1.0
    ident[..., NL] = 1.0
    return torch.cat([ident, niels], dim=2).reshape(n, ROWS_PER_SLOT, COORD_ROWS)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _check_rows(rows, n: int) -> None:
    for t in rows:
        if t.dtype != torch.uint8 or tuple(t.shape) != (NL, n) or not t.is_contiguous():
            raise ValueError(f"byte rows must be contiguous uint8 ({NL}, {n}); got "
                             f"{t.dtype} {tuple(t.shape)}")


def _check_int32(t: torch.Tensor, n: int, what: str) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous int32 ({n},); got {t.dtype} {tuple(t.shape)}")


def _check_pool(pool: torch.Tensor) -> int:
    """The pool's slot count; raises on a pool the kernels do not take."""
    if (pool.dtype != torch.uint8 or pool.dim() != 2 or pool.shape[1] != COORD_ROWS
            or pool.shape[0] % ROWS_PER_SLOT or not pool.is_contiguous()):
        raise ValueError(f"the pool must be contiguous uint8 (C*{ROWS_PER_SLOT}, {COORD_ROWS}); "
                         f"got {pool.dtype} {tuple(pool.shape)}")
    return pool.shape[0] // ROWS_PER_SLOT


def _check_device(tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all kernel arguments must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def comb_lanes(pool, t_b, slots, ry, rsign, s8, h8) -> torch.Tensor:
    """Per-lane verdicts (n,) int32, 1 = accept, on the arguments' device:
    pool (C*1024, 96) and t_b (1024, 96) uint8 niels rows, slots (n,)
    int32 (each below C), ry/s8/h8 (32, n) uint8 byte rows, rsign (n,)
    int32. A CUDA tensor launches the comb kernel on the current stream
    without synchronising; a CPU tensor runs `verify_comb_plain`."""
    global launches
    n = slots.shape[0]
    c = _check_pool(pool)
    if t_b.dtype != torch.uint8 or tuple(t_b.shape) != (ROWS_PER_SLOT, COORD_ROWS) or not t_b.is_contiguous():
        raise ValueError(f"the B table must be contiguous uint8 ({ROWS_PER_SLOT}, {COORD_ROWS})")
    _check_int32(slots, n, "slots")
    _check_int32(rsign, n, "rsign")
    _check_rows((ry, s8, h8), n)
    dev = _check_device((pool, t_b, slots, ry, rsign, s8, h8))
    if dev.type == "cpu":
        if n == 0:
            return torch.zeros(0, dtype=torch.int32)
        if int(slots.min()) < 0 or int(slots.max()) >= c:
            raise ValueError(f"slots must lie in [0, {c})")
        return verify_comb_plain(pool, t_b, slots, ry.float(), rsign, s8.int(), h8.int()).to(torch.int32)
    if pool.data_ptr() % 16 or t_b.data_ptr() % 16:
        raise ValueError("the kernel reads table rows 16 bytes at a time: align the tables to 16 bytes")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = kernels.load("ed25519_comb")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tm_ed25519_comb(
            pool.data_ptr(), t_b.data_ptr(), slots.data_ptr(), ry.data_ptr(), rsign.data_ptr(),
            s8.data_ptr(), h8.data_ptr(), out.data_ptr(), n, c, stream,
        )
    if rc != 0:
        raise RuntimeError(f"ed25519_comb kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def build_lanes(pool, qx8, qy8, slots) -> None:
    """Write the niels tables of the keys Q = (qx8, qy8) ((32, k) uint8
    canonical affine byte rows of -A) into pool slots `slots` ((k,) int32,
    distinct, each in [1, C)), in place. A CUDA tensor launches the table-build
    kernel on the current stream without synchronising; a CPU tensor runs
    `build_tables_plain` and scatters its rows."""
    global table_launches
    k = slots.shape[0]
    c = _check_pool(pool)
    _check_int32(slots, k, "slots")
    _check_rows((qx8, qy8), k)
    dev = _check_device((pool, qx8, qy8, slots))
    if dev.type == "cpu":
        if k and (int(slots.min()) < 1 or int(slots.max()) >= c):
            raise ValueError(f"slots must lie in [1, {c})")
        tables = build_tables_plain(qx8.float(), qy8.float())
        pool.view(c, ROWS_PER_SLOT, COORD_ROWS)[slots.long()] = tables.to(torch.uint8)
        return
    if pool.data_ptr() % 16:
        raise ValueError("the kernel writes table rows 16 bytes at a time: align the pool to 16 bytes")
    if k == 0:
        return
    # the bases, products and entry values of each key (Fe of ten int32
    # limbs), between the kernel's passes
    scratch = torch.empty((k, TABLE_SCRATCH_FE_PER_KEY, 10), dtype=torch.int32, device=dev)
    lib = kernels.load("ed25519_comb_tables")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tm_ed25519_comb_tables(
            qx8.data_ptr(), qy8.data_ptr(), slots.data_ptr(), pool.data_ptr(),
            scratch.data_ptr(), k, c, stream,
        )
    if rc != 0:
        raise RuntimeError(f"ed25519_comb_tables kernel launch failed: cudaError {rc}")
    table_launches += 1


# ---------------------------------------------------------------------------
# the pool manager
# ---------------------------------------------------------------------------


class PoolExhausted(RuntimeError):
    """One batch references more distinct validator keys than the pool's
    maximum capacity; the caller should use a ladder kernel instead."""


def _neg_x_bytes(x_le: bytes) -> bytes:
    x = int.from_bytes(x_le, "little")
    return ((P - x) % P).to_bytes(32, "little")


def _pool_device(device=None) -> torch.device:
    """`resolve_device`, with a card's index made explicit: one pool per
    device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class CombPool:
    """Device-resident LRU pool of per-validator comb tables.

    Slots are leased to pubkeys on first sight; the table build runs on
    the device, batched across all new keys in the request. Capacity grows
    by doubling up to `cap` (env TENDERMINT_TPU_COMB_CAP, default 12288
    slots, 1.2 GB of uint8 rows). Eviction is LRU and never takes a slot
    of the batch being assembled. Growth copies the rows into a new
    tensor; builds write the pool in place. Both, and every comb launch on
    this pool, run on the pool's own stream (see the module note)."""

    def __init__(self, capacity: int | None = None, max_capacity: int | None = None, device=None):
        self.device = _pool_device(device)
        self.cap = int(max_capacity or os.environ.get("TENDERMINT_TPU_COMB_CAP", 12288))
        c0 = int(capacity or min(self.cap, 256))
        self._c = c0
        self._stream = torch.cuda.Stream(device=self.device) if self.device.type == "cuda" else None
        with self.on_stream():
            self._pool = torch.zeros((c0 * ROWS_PER_SLOT, COORD_ROWS), dtype=torch.uint8,
                                     device=self.device)
            self._tb = torch.from_numpy(b_table().reshape(ROWS_PER_SLOT, COORD_ROWS)
                                        .astype(np.uint8)).to(self.device)
        self._lru: OrderedDict[bytes, int] = OrderedDict()
        self._free: list[int] = list(range(c0 - 1, 0, -1))  # slot 0 reserved
        # reentrant: a dispatch holds it across ensure() and its launch
        self._lock = threading.RLock()
        self.stats = {"builds": 0, "build_keys": 0, "evictions": 0, "grows": 0}

    @property
    def capacity(self) -> int:
        return self._c

    def on_stream(self):
        """Context for work on this pool: its device and stream on a card."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def load_rows(self, rows: np.ndarray, lru) -> None:
        """Take over another pool's state: its (C*1024, 96) rows (any
        numeric dtype holding byte values, such as a JAX pool's bf16 rows
        read back as numpy) and its key -> slot map in LRU order. Every
        other slot but 0 is free."""
        c = rows.shape[0] // ROWS_PER_SLOT
        with self._lock, self.on_stream():
            self._pool = torch.from_numpy(np.asarray(rows, dtype=np.float32).astype(np.uint8)).to(self.device)
            _check_pool(self._pool)
            self._c = c
            self._lru = OrderedDict(lru)
            used = set(self._lru.values())
            self._free = [s for s in range(c - 1, 0, -1) if s not in used]

    def _grow(self) -> None:
        new_c = min(self._c * 2, self.cap)
        if new_c == self._c:
            return
        with self.on_stream():
            grown = torch.zeros((new_c * ROWS_PER_SLOT, COORD_ROWS), dtype=torch.uint8,
                                device=self.device)
            grown[: self._pool.shape[0]].copy_(self._pool)
        self._pool = grown
        self._free.extend(range(new_c - 1, self._c - 1, -1))
        self._c = new_c
        self.stats["grows"] += 1

    def _take_slot(self, pinned: set[int]) -> int:
        if not self._free:
            self._grow()
        if self._free:
            return self._free.pop()
        # evict LRU (front of the OrderedDict) — but never a slot leased
        # to another lane of the batch currently being assembled: that
        # lane's slots[] entry would silently point at the new key's
        # table and reject a valid signature.
        for key, slot in self._lru.items():
            if slot not in pinned:
                del self._lru[key]
                self.stats["evictions"] += 1
                return slot
        raise PoolExhausted(
            f"batch needs more distinct validator keys than the comb "
            f"pool's max capacity ({self.cap} slots)"
        )

    def ensure(self, keys: list[bytes], xs: np.ndarray, ys: np.ndarray):
        """Lease slots for decompressed keys. keys[i] is the 32-byte
        compressed pubkey; xs/ys are (n, 32) u8 canonical affine limbs of
        A (NOT negated — negation happens here). Returns (slots int32
        (n,), the pool tensor). Caller must pass only keys whose
        decompression succeeded. Raises PoolExhausted when one batch holds
        more distinct keys than max capacity, after rolling back this
        call's leases (the gateway backend falls back to the ladder)."""
        with self._lock:
            missing: dict[bytes, int] = {}
            first_at: dict[bytes, int] = {}
            pinned: set[int] = set()
            slots = np.zeros(len(keys), dtype=np.int32)
            try:
                for i, k in enumerate(keys):
                    s = self._lru.get(k)
                    if s is not None:
                        self._lru.move_to_end(k)
                        slots[i] = s
                        pinned.add(s)
                        continue
                    s = missing.get(k)
                    if s is None:
                        s = self._take_slot(pinned)
                        missing[k] = s
                        first_at[k] = i
                        self._lru[k] = s
                        pinned.add(s)
                    slots[i] = s
            except PoolExhausted:
                # roll back this call's leases: the tables were never
                # built, and a leaked _lru entry would route the key's
                # NEXT batch onto a garbage slot table
                for k, s in missing.items():
                    if self._lru.get(k) == s:
                        del self._lru[k]
                    self._free.append(s)
                raise
            if missing:
                uniq = list(missing.keys())
                qx = np.zeros((NL, len(uniq)), dtype=np.uint8)
                qy = np.zeros((NL, len(uniq)), dtype=np.uint8)
                for j, k in enumerate(uniq):
                    i = first_at[k]
                    qx[:, j] = np.frombuffer(_neg_x_bytes(xs[i].tobytes()), dtype=np.uint8)
                    qy[:, j] = ys[i]
                tslots = np.asarray([missing[k] for k in uniq], dtype=np.int32)
                with self.on_stream():
                    build_lanes(self._pool, *(torch.from_numpy(a).to(self.device)
                                              for a in (qx, qy, tslots)))
                self.stats["builds"] += 1
                self.stats["build_keys"] += len(uniq)
            return slots, self._pool

    def table_b(self) -> torch.Tensor:
        return self._tb

    def launch(self, slots: np.ndarray, planes: np.ndarray, rs: np.ndarray):
        """Launch the comb kernel on this pool's stream over host-marshalled
        lanes (`ed25519_f32p.host_planes`; `slots` from `ensure`). Returns a
        zero-arg resolver for the (n,) int32 verdicts, which keeps the pool
        tensor and the slots alive until they are back: a one-shard
        `ed25519_f32p.dispatch` on the pool's stream."""
        with self._lock:
            pool, keep = self._pool, []

            def comb(_ax, _ay, ry, rsign, s8, h8):
                keep.append(torch.from_numpy(slots).to(ry.device))
                return comb_lanes(pool, self._tb, keep[0], ry, rsign, s8, h8)

            res = f32p.dispatch(planes, rs, [self.device], [self._stream], comb)

        def resolve(keep=(pool, keep)) -> np.ndarray:
            return res.wait().numpy()  # until here `keep` holds what the kernel reads

        return resolve


_default_pools: dict[str, CombPool] = {}
_default_pool_lock = threading.Lock()


def default_pool(device=None) -> CombPool:
    """The process-wide pool of `device` (the card unless the caller asks
    for the CPU)."""
    dev = _pool_device(device)
    with _default_pool_lock:
        pool = _default_pools.get(str(dev))
        if pool is None:
            pool = _default_pools[str(dev)] = CombPool(device=dev)
        return pool


def set_default_pool(pool: CombPool) -> None:
    with _default_pool_lock:
        _default_pools[str(pool.device)] = pool


def reset_default_pool() -> None:
    """Drop every process-wide pool (tests; also frees device memory) and
    the second-sight counts."""
    with _default_pool_lock:
        _default_pools.clear()
    with _seen_lock:
        _seen.clear()


# -- second-sight build policy ------------------------------------------------
#
# Building a key's comb table costs the limb products of about six B1
# verifies (KERNEL_PRODUCTS_PER_KEY against ed25519_f32p's), paid off
# only if the key is seen again (validator keys sign every block; a
# mempool user key may never recur). Policy: build tables only for keys on
# their >= MIN_SIGHT-th batch appearance (env TENDERMINT_TPU_COMB_MIN_SIGHT,
# default 2); lanes whose key has no table yet verify on the ladder in the
# same call. Commits go all-comb from their second block, one-shot keys
# never trigger a build.

_seen: OrderedDict[bytes, int] = OrderedDict()
_seen_lock = threading.Lock()
_SEEN_CAP = 1 << 18


def _min_sight() -> int:
    return int(os.environ.get("TENDERMINT_TPU_COMB_MIN_SIGHT", "2"))


def _bump_seen(keys: set[bytes]) -> dict[bytes, int]:
    out = {}
    with _seen_lock:
        for k in keys:
            c = _seen.pop(k, 0) + 1
            _seen[k] = c
            out[k] = c
        while len(_seen) > _SEEN_CAP:
            _seen.popitem(last=False)
    return out


# ---------------------------------------------------------------------------
# gateway backend API
# ---------------------------------------------------------------------------


def _dispatch_comb(items, kidx, keys, pool_mgr: CombPool):
    """Marshal + launch the comb kernel for items[kidx] (whose keys are
    all pool-eligible). Returns a resolver for bool[len(kidx)]. Leasing
    and launching hold the pool's lock together, so no other batch can
    rebuild a slot in between."""
    sub = [items[i] for i in kidx]
    n = len(sub)
    planes, rs, valid = f32p.host_planes(sub, n)
    slots = np.zeros(n, dtype=np.int32)
    vidx = np.flatnonzero(valid[:n])
    with pool_mgr._lock:
        if len(vidx):
            leased, _ = pool_mgr.ensure([keys[i] for i in vidx], planes[0].T[vidx], planes[1].T[vidx])
            slots[vidx] = leased
        resolve = pool_mgr.launch(slots, planes, rs)
    return lambda: f32p.materialize_verdicts(resolve(), valid, n)


def verify_batch_async(items: list[tuple[bytes, bytes, bytes]], device=None):
    """Marshal + enqueue; returns a zero-arg resolver for bool[n] — the
    standard kernel contract (see ed25519_f32p.verify_batch_async).

    Lane routing (see the second-sight policy note above): lanes whose
    key already has a pool table — or has now been seen MIN_SIGHT times —
    ride the comb kernel (building tables as needed); the rest, plus any
    malformed lanes, verify on the ladder (B1) in the same call. Both
    dispatches are enqueued before either resolves, so device work
    overlaps."""
    n = len(items)
    if n == 0:
        return lambda: np.zeros(0, dtype=bool)
    pool_mgr = default_pool(device)
    keys = [
        bytes(p) if len(p) == 32 and len(s) == 64 else None
        for p, _m, s in items
    ]
    counts = _bump_seen({k for k in keys if k is not None})
    min_sight = _min_sight()
    with pool_mgr._lock:
        in_pool = {k for k in counts if k in pool_mgr._lru}
    comb_idx = [
        i
        for i, k in enumerate(keys)
        if k is not None and (k in in_pool or counts[k] >= min_sight)
    ]
    cset = set(comb_idx)
    ladder_idx = [i for i in range(n) if i not in cset]
    resolvers: list[tuple[list[int], object]] = []
    if comb_idx:
        try:
            r = _dispatch_comb(items, comb_idx, [keys[i] for i in comb_idx], pool_mgr)
            resolvers.append((comb_idx, r))
        except PoolExhausted:
            logger.warning("comb pool exhausted (%d lanes); ladder fallback", len(comb_idx))
            ladder_idx = sorted(ladder_idx + comb_idx)
    if ladder_idx:
        r = f32p.verify_batch_async([items[i] for i in ladder_idx], pool_mgr.device)
        resolvers.append((ladder_idx, r))

    def resolve():
        out = np.zeros(n, dtype=bool)
        for idx, r in resolvers:
            out[np.asarray(idx)] = np.asarray(r())
        return out

    return resolve


def verify_batch(items: list[tuple[bytes, bytes, bytes]], device=None) -> np.ndarray:
    """Drop-in gateway backend (same contract as ed25519_f32p.verify_batch)."""
    return verify_batch_async(items, device)()
