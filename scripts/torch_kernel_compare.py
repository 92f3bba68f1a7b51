"""Time the port's B1 (csrc/ed25519_verify.cu), B2 (csrc/ed25519_verify_b2.cu)
and dsm (csrc/ed25519_dsm.cu) kernels beside the same kernels of other
checkouts, on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 scripts/torch_kernel_compare.py --against LABEL=DIR [--against LABEL=DIR ...]

Each `--against LABEL=DIR` adds the three sources of another checkout DIR
(for example the parent commit, unpacked with `git archive`). This
checkout's kernels and every other one are built at once into
build/kernels/compare/ and ptxas's registers and spills are printed; every
other checkout's output must equal this one's on the same inputs. Each is
timed with CUDA events (median of 7 after 2 warm-ups) at the main path's
lane counts, the checkouts taking turns, twice in opposite orders. One
JSON line per measurement; the card's name and power limit on the first
line.
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

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

VERIFY_LANES = (100, 1024, 4096, 10_000, 16_384)
DSM_LANES = (101, 401, 1025, 4096)
ENTRIES = {"ed25519_verify": "tm_ed25519_verify", "ed25519_verify_b2": "tm_ed25519_verify_b2",
           "ed25519_dsm": "tm_ed25519_dsm"}
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


def verify_args(n: int):
    """n lanes over 64 keys, every fourth signature tampered, on the card,
    and the verdict buffer."""
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
    return list(args), [torch.empty(n, dtype=torch.int32, device="cuda")]


def dsm_args(n: int):
    """n lanes of 32 distinct (a, P, b, Q) terms on the card, and the two
    output rows."""
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
    return list(rows), [torch.empty((32, n), dtype=torch.uint8, device="cuda") for _ in range(2)]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[], metavar="LABEL=DIR",
                    help="another checkout whose B1, B2 and dsm sources to time beside these")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    from tendermint_tpu_torch.ops import kernels

    vs = checkouts(opts.against)
    jobs = [(name, label, vs[label]) for name in ENTRIES for label in vs]
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

    def launch(fn, ptrs, n):
        rc = fn(*ptrs, n, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    for name, lane_counts, make in (("ed25519_verify", VERIFY_LANES, verify_args),
                                    ("ed25519_verify_b2", VERIFY_LANES, verify_args),
                                    ("ed25519_dsm", DSM_LANES, dsm_args)):
        for n in lane_counts:
            ins, outs = make(n)
            ptrs = [t.data_ptr() for t in ins + outs]
            results = {}
            for label in vs:
                launch(fns[name, label], ptrs, n)
                torch.cuda.synchronize()
                results[label] = [o.clone() for o in outs]
            for label, res in results.items():
                if not all(torch.equal(a, b) for a, b in zip(res, results[HERE])):
                    raise AssertionError(f"{name} of {label} disagrees with {HERE} at {n} lanes")
            ms = {label: [] for label in vs}
            for order in (list(vs), list(vs)[::-1]):
                for label in order:
                    ms[label].append(cuda_ms(lambda: launch(fns[name, label], ptrs, n)))
            for label in vs:
                log({"phase": "time", "kernel": name, "card": card, "lanes": n, "checkout": label,
                     "ms": ms[label]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
