"""Time the port's B1 (csrc/ed25519_verify.cu), B2 (csrc/ed25519_verify_b2.cu),
dsm (csrc/ed25519_dsm.cu), comb verify (csrc/ed25519_comb.cu), comb
table-build (csrc/ed25519_comb_tables.cu), K1 RIPEMD-160 and K2 SHA-256
(csrc/hash_blocks.cu) and K3 Merkle tree (csrc/merkle_tree.cu) kernels
beside the same kernels of other checkouts, on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 scripts/torch_kernel_compare.py --against LABEL=DIR [--against LABEL=DIR ...]
        [--only KERNEL ...] [--profile]

Each `--against LABEL=DIR` adds the seven sources of another checkout DIR
(for example the parent commit, unpacked with `git archive`); `--only`
keeps the named kernels (source names, as in ENTRIES). This checkout's
kernels and every other one are built at once into build/kernels/compare/
and ptxas's registers and spills are printed; every other checkout's
output must equal this one's on the same inputs (the verdicts, the dsm
points, the comb pool's rows, the digests, the tree's nodes, byte for
byte). Each is timed with CUDA events (median of 7 after 2 warm-ups) at the
main path's shapes (lane counts; the table build at COMB_KEYS keys; K1 and
K2 on HASH_BATCHES, K3 on trees of TREE_LEAVES leaves), the checkouts taking
turns, twice in opposite orders; `--profile` adds each kernel's device
time (torch.profiler) per checkout. One JSON line per measurement; the
card's name and power limit on the first line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import random
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

VERIFY_LANES = (100, 1024, 4096, 10_000, 16_384)
DSM_LANES = (101, 401, 1025, 4096)
COMB_KEYS = (1, 100, 1000, 10_000)
COMB_DISTINCT_KEYS = 256  # keys made and signed here; larger key counts repeat them
# K1's batches on the block paths: block_1mb's and block_cap's 64 KB parts,
# and block_cap's tx leaves (types/params.py's caps: 10,000 transactions of
# 1 to 4,096 bytes, every 1,000th at 10,240, length-prefixed); K2's
# ("sha256:"): block_1mb's tx leaves (BASELINE.json's 4,000 transactions of
# 250 bytes) and block_cap's
HASH_BATCHES = ("parts_16", "parts_318", "tx_leaves_10000", "sha256:tx_leaves_4000",
                "sha256:tx_leaves_10000")
TREE_LEAVES = (16, 318, 4000, 10_000)  # K3: both blocks' part and tx trees
PART_BYTES, TXS, TX_CAP = 65_536, 10_000, 10_240
BLOCK_1MB_TXS, BLOCK_1MB_TX_BYTES = 4000, 250
SEED = 9
ENTRIES = {"ed25519_verify": "tm_ed25519_verify", "ed25519_verify_b2": "tm_ed25519_verify_b2",
           "ed25519_dsm": "tm_ed25519_dsm", "ed25519_comb": "tm_ed25519_comb",
           "ed25519_comb_tables": "tm_ed25519_comb_tables", "hash_blocks": "tm_hash_blocks",
           "merkle_tree": "tm_merkle_tree"}
HERE = "this"


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def checkouts(against: list[str]) -> dict[str, str]:
    """label -> csrc directory, this checkout's first."""
    from tendermint_tpu_torch.ops import kernels

    out = {HERE: kernels._CSRC}
    for spec in against:
        label, _, root = spec.partition("=")
        out[label] = os.path.join(root, "tendermint_tpu_torch", "ops", "csrc")
    return out


def build(name: str, label: str, csrc: str) -> tuple[str, str]:
    from tendermint_tpu_torch.ops import kernels

    out_dir = os.path.join(kernels.BUILD_DIR, "compare")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{name}_{label}.so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out,
                           os.path.join(csrc, f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} ({label}):\n{proc.stderr}")
    return out, proc.stdout + proc.stderr


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_times(fn, calls: int = 1) -> dict[str, float]:
    """Device ms of each CUDA kernel one call of fn() launches (once each),
    by kernel name, over `calls` calls (torch.profiler, after a warm-up
    call): a mean over the launches the trace holds, since the profiler
    drops a trace's device events now and then. A trace with no kernel in
    it is taken again, up to three traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            dev_us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
            if dev_us and "kernel" in evt.key.lower():
                out[evt.key] = dev_us / 1e3 / evt.count
        if out:
            break
    return out


def verify_args(n: int):
    """n lanes over 64 keys, every fourth signature tampered, on the card,
    the verdict buffer, and no count after n."""
    import torch

    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    seeds = [bytes([i + 1]) * 32 for i in range(64)]
    base = []
    for k, s in enumerate(seeds):
        msg = b"compare-%d" % k
        sig = ed.sign(s, msg)
        base.append((ed.public_key(s), msg if k % 4 else msg + b"!", sig))
    args, _, _ = f32p.marshal_device_args((base * (n // 64 + 1))[:n], "cuda")
    return list(args), [torch.empty(n, dtype=torch.int32, device="cuda")], []


def dsm_args(n: int):
    """n lanes of 32 distinct (a, P, b, Q) terms on the card, the two
    output rows, and no count after n."""
    import torch

    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.ops import ed25519 as ed32

    rnd = random.Random(7)

    def affine():
        x, y, z, _ = ed.scalar_mult(rnd.randrange(1, ed.L), ed.B)
        zinv = pow(z, ed.P - 2, ed.P)
        return x * zinv % ed.P, y * zinv % ed.P

    base = [(rnd.randrange(ed.L), affine(), rnd.randrange(ed.L), affine()) for _ in range(32)]
    rows = ed32.marshal_dsm_args((base * (n // 32 + 1))[:n], "cuda")
    return list(rows), [torch.empty((32, n), dtype=torch.uint8, device="cuda") for _ in range(2)], []


_comb_keys: list = []


def comb_keys():
    """COMB_DISTINCT_KEYS signed items (every fourth tampered), one key
    each, and (32, k) uint8 rows of each key's Q = -A, made once."""
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.ops import ed25519_comb as comb
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    if not _comb_keys:
        items = []
        for k in range(COMB_DISTINCT_KEYS):
            seed = k.to_bytes(2, "little") * 16
            msg = b"comb-compare-%d" % k
            items.append((ed.public_key(seed), msg if k % 4 else msg + b"!", ed.sign(seed, msg)))
        planes, _, _ = f32p.host_planes(items, len(items))
        qx = np.stack([np.frombuffer(comb._neg_x_bytes(planes[0, :, i].tobytes()), dtype=np.uint8)
                       for i in range(len(items))], axis=1)
        _comb_keys.extend([items, np.ascontiguousarray(qx), np.ascontiguousarray(planes[1])])
    return _comb_keys


def comb_args(n: int):
    """n lanes of comb_keys()' items (lane i the key i mod 256, in slot
    i mod 256 + 1 of a pool the plain version built), the verdict buffer,
    and the pool's slot count after n."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_comb as comb
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    items, qx, qy = comb_keys()[:3]
    k = len(items)
    if len(_comb_keys) == 3:  # the pool, built once
        pool = torch.zeros(((k + 1) * comb.ROWS_PER_SLOT, comb.COORD_ROWS), dtype=torch.uint8, device="cuda")
        tables = comb.build_tables_plain(torch.from_numpy(qx).cuda().float(), torch.from_numpy(qy).cuda().float())
        pool.view(k + 1, comb.ROWS_PER_SLOT, comb.COORD_ROWS)[1:] = tables.to(torch.uint8)
        _comb_keys.append(pool)
    pool = _comb_keys[3]
    lanes = [items[i % k] for i in range(n)]
    planes, rs, valid = f32p.host_planes(lanes, n)
    slots = np.where(valid, np.arange(n) % k + 1, 0).astype(np.int32)
    btab = torch.from_numpy(comb.b_table().reshape(-1, comb.COORD_ROWS).astype(np.uint8)).cuda()
    ins = [pool, btab] + [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                          for a in (slots, planes[2], rs, planes[3], planes[4])]
    return ins, [torch.empty(n, dtype=torch.int32, device="cuda")], [k + 1]


def comb_tables_args(n: int):
    """n keys (comb_keys()' repeated) into slots 1..n of a zero pool: the
    keys' rows, the slots, the pool and the scratch (the larger of every
    checkout's: this one's ed25519_comb.TABLE_SCRATCH_FE_PER_KEY Fe a key,
    the 64 x 4 of the kernels before it), and the pool's slot count after
    n. The pool is the output."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_comb as comb

    _, qx, qy = comb_keys()[:3]
    reps = n // qx.shape[1] + 1
    kx, ky = (torch.from_numpy(np.ascontiguousarray(np.tile(a, reps)[:, :n])).cuda() for a in (qx, qy))
    slots = torch.arange(1, n + 1, dtype=torch.int32, device="cuda")
    pool = torch.zeros(((n + 1) * comb.ROWS_PER_SLOT, comb.COORD_ROWS), dtype=torch.uint8, device="cuda")
    scratch = torch.empty((n, max(comb.TABLE_SCRATCH_FE_PER_KEY, 4 * comb.W_POS), 10), dtype=torch.int32,
                          device="cuda")
    return [kx, ky, slots], [pool, scratch], [n + 1]


def hash_args(batch: str):
    """K1, or K2 for a batch named "sha256:...", on one of HASH_BATCHES,
    made from SEED: its packed blocks on the card and the digest rows; the
    algo first, the message count last."""
    import torch

    from tendermint_tpu_torch.codec.binary import encode_bytes
    from tendermint_tpu_torch.ops import hashing as th

    rng = np.random.default_rng(SEED)
    sha = batch.startswith("sha256:")
    kind, count = batch.removeprefix("sha256:").rsplit("_", 1)
    if kind == "parts":
        msgs = [rng.bytes(PART_BYTES) for _ in range(int(count))]
    elif int(count) == BLOCK_1MB_TXS:
        msgs = [encode_bytes(rng.bytes(BLOCK_1MB_TX_BYTES)) for _ in range(BLOCK_1MB_TXS)]
    else:
        lengths = rng.integers(1, 4097, size=int(count))
        lengths[999::1000] = TX_CAP
        msgs = [encode_bytes(rng.bytes(int(k))) for k in lengths]
    words, first, nblocks = th.to_device(*th.pack_ragged(msgs, not sha), "cuda")
    out = torch.empty((len(msgs), 8 if sha else 5), dtype=torch.int32, device="cuda")
    algo = th.SHA256_ALGO if sha else th.RIPEMD160_ALGO
    args = [algo] + [t.data_ptr() for t in (words, first, nblocks, out)] + [len(msgs)]
    return args, [out], None, (words, first, nblocks)


def tree_args(n: int):
    """K3 on a tree of n random leaf digests (from SEED): the node buffer,
    the device schedule, its rounds and stride, and the block's threads as
    ops/merkle.py's wrapper gives them; the leaves are restored before
    each compared launch."""
    import torch

    from tendermint_tpu_torch.ops import merkle as tm

    rng = np.random.default_rng(SEED + n)
    leaves = torch.from_numpy(np.frombuffer(rng.bytes(20 * n), dtype="<u4").view(np.int32).reshape(n, 5).copy())
    nodes = torch.zeros((2 * n, 5), dtype=torch.int32)
    nodes[:n] = leaves
    nodes = nodes.cuda()
    filled = nodes.clone()
    left, right, out, widths = tm._device_schedule(n, "cuda")
    args = ([t.data_ptr() for t in (nodes, left, right, out, widths)]
            + [left.shape[0], left.shape[1], tm.block_threads(left.shape[1])])
    return args, [nodes], lambda: nodes.copy_(filled), (filled,)


def ed25519_args(make):
    """An ed25519 maker's (ins, outs, after) as launch arguments: the
    pointers, the lane count, the counts after it; the outputs compared
    (the table build's pool, not its scratch)."""

    def made(n):
        ins, outs, after = make(n)
        args = [t.data_ptr() for t in ins + outs] + [n] + after
        return args, outs[:1] if make is comb_tables_args else outs, None, (ins, outs)

    return made


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[], metavar="LABEL=DIR",
                    help="another checkout whose kernel sources to time beside these")
    ap.add_argument("--only", action="append", default=[], metavar="KERNEL", choices=sorted(ENTRIES),
                    help="time only this kernel (a source name; repeatable)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace each checkout's launches (torch.profiler) and print each device "
                         "kernel's time: the comb kernels at their largest count (the table build's "
                         "passes one by one), K1, K2 and K3 at every shape")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    from tendermint_tpu_torch.ops import kernels

    vs = checkouts(opts.against)
    names = [name for name in ENTRIES if not opts.only or name in opts.only]
    jobs = [(name, label, vs[label]) for name in names for label in vs]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    fns = {}
    for (name, label, _), (path, text) in zip(jobs, built):
        ptxas = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        log({"phase": "build", "kernel": name, "checkout": label, "ptxas": ptxas})
        fn = getattr(ctypes.CDLL(path), ENTRIES[name])
        fn.argtypes = kernels._ENTRIES[name][1]
        fn.restype = ctypes.c_int
        fns[name, label] = fn

    def launch(fn, args):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    plan = (("ed25519_verify", VERIFY_LANES, ed25519_args(verify_args), "lanes"),
            ("ed25519_verify_b2", VERIFY_LANES, ed25519_args(verify_args), "lanes"),
            ("ed25519_dsm", DSM_LANES, ed25519_args(dsm_args), "lanes"),
            ("ed25519_comb", VERIFY_LANES, ed25519_args(comb_args), "lanes"),
            ("ed25519_comb_tables", COMB_KEYS, ed25519_args(comb_tables_args), "keys"),
            ("hash_blocks", HASH_BATCHES, hash_args, "batch"),
            ("merkle_tree", TREE_LEAVES, tree_args, "leaves"))
    for name, counts, make, unit in plan:
        if name not in names:
            continue
        for n in counts:
            # `keep` holds the inputs the pointers in `args` point at
            args, outs, reset, keep = make(n)
            results = {}
            for label in vs:
                if reset is None:
                    for o in outs:
                        o.zero_()
                else:
                    reset()
                launch(fns[name, label], args)
                torch.cuda.synchronize()
                results[label] = [o.clone() for o in outs]
            for label, res in results.items():
                if not all(torch.equal(a, b) for a, b in zip(res, results[HERE])):
                    raise AssertionError(f"{name} of {label} disagrees with {HERE} at {unit} {n}")
            del results
            log({"phase": "equal", "kernel": name, unit: n, "checkouts": list(vs)})
            ms = {label: [] for label in vs}
            for order in (list(vs), list(vs)[::-1]):
                for label in order:
                    ms[label].append(cuda_ms(lambda: launch(fns[name, label], args)))
            for label in vs:
                log({"phase": "time", "kernel": name, "card": card, unit: n, "checkout": label,
                     "ms": ms[label]})
            hashes = name in ("hash_blocks", "merkle_tree")
            if opts.profile and (hashes or (name.startswith("ed25519_comb") and n == counts[-1])):
                for order in (list(vs), list(vs)[::-1]) if hashes else (list(vs),):
                    for label in order:
                        log({"phase": "profile", "kernel": name, "card": card, "count": n,
                             "checkout": label,
                             "device_ms": device_times(lambda: launch(fns[name, label], args),
                                                       calls=5 if hashes else 1)})
            del keep
    return 0


if __name__ == "__main__":
    sys.exit(main())
