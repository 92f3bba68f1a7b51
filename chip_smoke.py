"""Drive tendermint_tpu_torch's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Card and build: the card's name and power limit, the torch and CUDA
   versions, the nvcc build of the verify kernel (seconds, registers).
2. Kernel vs plain version on the card: 4096 lanes mixing valid,
   tampered, malformed and repeated-key signatures, then the main path's
   own lane counts (100, 4 x 1000, 10,000): the kernel's verdicts must
   equal `verify_plain`'s lane for lane, and a 256-lane sample must equal
   `crypto.ed25519.verify`.
3. Main path: commits through `ValidatorSet` and `Verifier` on the card —
   a 100-validator `verify_commit`, fast sync's grouped dispatch of four
   1000-validator commits (`verify_commits_async`), one 10,000-validator
   `verify_commit`, a forged commit and a sub-quorum commit, which must
   both be refused. The kernel's launch count is reset just before and
   read just after; no lane of it may fall to the CPU.
4. Times (CUDA events, median of 7 after a warm-up): the kernel at 1024,
   4096 and 16,384 lanes, `verify_plain` at 4096, the native CPU batch
   verifier on a fixed 512-signature sample (best of 3), and the commit
   phases' wall times. Each line carries the card's name and power limit.

The last lines are the kernels' JSON summary, the card line, and
{"ok": true, "device": {...}}. Weights are keys made from a numpy seed;
no network, one card.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
CHAIN_ID = "chip-smoke"
DEVICE = "cuda"
SET_SIZES = (100, 1000, 10_000)  # BASELINE.json: VerifyCommit, fast sync, north star
MIXED_LANES = 4096
TIME_LANES = (1024, 4096, 16384)
INT_MUL_PER_S = 67e12 / 2 / 2  # H100 SXM: 32-bit multiplies at half the fp32 FMA rate
HBM_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = "tendermint_tpu_torch/ops/csrc/ed25519_verify.cu"
TPU_KERNEL = "tendermint_tpu/ops/ed25519_f32p.py:301"


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median device time of fn() over `reps` runs, CUDA events around each."""
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


def bound_ms(lanes: int) -> tuple[float, str]:
    """The least time the card could take: the kernel's limb products over
    the integer multiply rate, or its bytes over the memory rate."""
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    ops_ms = 1e3 * f32p.PRODUCTS_PER_LANE * lanes / INT_MUL_PER_S
    bytes_ms = 1e3 * f32p.BYTES_PER_LANE * lanes / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# -- set-up: keys, signatures, commits ---------------------------------------


def mixed_items(pool, rng, seeds, pubs, n: int):
    """n lanes mixing the verify families of the JAX package's tests:
    valid, tampered sig, tampered msg, wrong pub, s >= L, non-canonical
    R.y, short pub, long sig, invalid point, and one key over many
    messages."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    n_keys = min(64, len(seeds))
    fam = rng.integers(0, 10, size=n)
    keys = rng.integers(0, n_keys, size=n)
    keys[fam == 9] = 0  # identical keys, many messages
    msgs = [b"smoke-%d-%d" % (i, int(rng.integers(1 << 30))) for i in range(n)]
    sigs = pool.starmap(ed.sign, [(seeds[k], m) for k, m in zip(keys, msgs)], chunksize=64)
    items = []
    for i in range(n):
        k, pub, msg, sig = int(keys[i]), pubs[int(keys[i])], msgs[i], sigs[i]
        f = int(fam[i])
        if f == 1:
            j = int(rng.integers(64))
            sig = sig[:j] + bytes([sig[j] ^ (1 << int(rng.integers(8)))]) + sig[j + 1 :]
        elif f == 2:
            msg = msg + b"!"
        elif f == 3:
            pub = pubs[(k + 1) % n_keys]
        elif f == 4:
            sig = sig[:32] + (int.from_bytes(sig[32:], "little") + ed.L).to_bytes(32, "little")
        elif f == 5:
            sig = (ed.P + int(rng.integers(1, 19))).to_bytes(32, "little") + sig[32:]
        elif f == 6:
            pub = pub[:31]
        elif f == 7:
            sig = sig + b"\x00"
        elif f == 8:
            pub = b"\x01" * 32
        items.append((pub, msg, sig))
    return items


def make_commit(pool, vs, seed_of, height: int, tag: bytes):
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto.keys import SignatureEd25519
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, Vote

    bid = BlockID(
        hashlib.sha256(tag + b"%d" % height).digest()[:20],
        PartSetHeader(1, hashlib.sha256(b"parts" + tag).digest()[:20]),
    )
    votes = [
        Vote(v.address, idx, height, 0, VOTE_TYPE_PRECOMMIT, bid)
        for idx, v in enumerate(vs.validators)
    ]
    sb = votes[0].sign_bytes(CHAIN_ID)  # identical for every validator
    sigs = pool.starmap(ed.sign, [(seed_of[v.address], sb) for v in vs.validators], chunksize=64)
    return bid, Commit(bid, [v.with_signature(SignatureEd25519(s)) for v, s in zip(votes, sigs)])


def recorded_items(vs, height, bid, commit):
    """The exact batch verify_commit hands its batch verifier."""
    seen = []
    vs.verify_commit(
        CHAIN_ID, bid, height, commit,
        batch_verifier=lambda items: (seen.append(items), [True] * len(items))[1],
    )
    return seen[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto.keys import PubKeyEd25519, SignatureEd25519
    from tendermint_tpu_torch.ops import ed25519_f32 as f32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import kernels
    from tendermint_tpu_torch.ops.gateway import Verifier
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import CommitError, ValidatorSet

    # -- phase 1: card and build ---------------------------------------------
    card = card_line()
    name, power = [s.strip() for s in card.split(",", 1)]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    build_s = kernels.build("ed25519_verify")
    log({"phase": "build", "kernel": "ed25519_verify", "seconds": build_s})
    for line in kernels.build_log.get("ed25519_verify", "").splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            log(f"ptxas: {line.strip()}")
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("native host library did not build (make -C native)")
    log({"phase": "build", "kernel": "native host library", "seconds": time.perf_counter() - t0})

    # -- set-up: keys, signatures and commits from one seed ---------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    n_small, n_mid, n_keys = SET_SIZES
    seeds = [rng.bytes(32) for _ in range(n_keys)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes=min(8, os.cpu_count() or 1)) as pool:
        pubs = pool.map(ed.public_key, seeds, chunksize=128)
        seed_of = {}
        validators = []
        for s, p in zip(seeds, pubs):
            v = Validator.new(PubKeyEd25519(p), 10)
            seed_of[v.address] = s
            validators.append(v)
        mixed = mixed_items(pool, rng, seeds, pubs, MIXED_LANES)
        vs100 = ValidatorSet(validators[:n_small])
        vs1000 = ValidatorSet(validators[:n_mid])
        vs10k = ValidatorSet(validators)
        bid100, c100 = make_commit(pool, vs100, seed_of, 1, b"c100")
        group = [(*make_commit(pool, vs1000, seed_of, h, b"c1000"), h) for h in range(1, 5)]
        bid10k, c10k = make_commit(pool, vs10k, seed_of, 1, b"c10k")
    log({"phase": "setup", "keys": n_keys, "signatures": MIXED_LANES + n_small + 4 * n_mid + n_keys,
         "seconds": time.perf_counter() - t0})

    # -- phase 2: kernel vs plain version on the card ---------------------------
    group_items = [it for bid, c, h in group for it in recorded_items(vs1000, h, bid, c)]
    shapes = {
        "mixed": mixed,
        "commit_small": recorded_items(vs100, 1, bid100, c100),
        "fast_sync_group": group_items,
        "commit_large": recorded_items(vs10k, 1, bid10k, c10k),
    }
    max_err = 0
    for label, items in shapes.items():
        args, valid, n = f32p.marshal_device_args(items, DEVICE)
        t0 = time.perf_counter()
        got = f32p.verify_lanes(*args)
        want = f32.verify_plain(args[0].float(), args[1].float(), args[2].float(), args[3],
                                args[4].int(), args[5].int()).to(torch.int32)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        max_err = max(max_err, err)
        verdicts = f32p.materialize_verdicts(got.cpu(), valid, n)
        log({"phase": "kernel_vs_plain", "shape": label, "lanes": n, "accepted": int(verdicts.sum()),
             "max_abs_err": err, "seconds": time.perf_counter() - t0})
        if err != 0:
            bad = torch.nonzero(got != want).flatten()[:10].tolist()
            raise AssertionError(f"{label}: kernel disagrees with verify_plain at lanes {bad}")
        if label == "mixed":
            sample = rng.choice(n, size=min(256, n), replace=False)
            ref = np.array([ed.verify(*items[i]) for i in sample])
            if not np.array_equal(verdicts[sample], ref):
                raise AssertionError("mixed: kernel verdicts disagree with crypto.ed25519.verify")
            families = sorted({bool(x) for x in ref})
            log({"phase": "reference_sample", "lanes": len(sample), "verdicts_seen": families})
        elif not verdicts.all():
            raise AssertionError(f"{label}: a valid commit signature was rejected")
    torch.cuda.synchronize()

    # -- phase 3: the main path through ValidatorSet and Verifier ---------------
    forged = Commit(bid100, list(c100.precommits))
    p7 = forged.precommits[7]
    raw = bytearray(p7.signature.raw)
    raw[5] ^= 0x20
    forged.precommits[7] = p7.with_signature(SignatureEd25519(bytes(raw)))
    keep = 2 * n_small // 3  # exactly 2/3 of the power: not more than 2/3
    sub_quorum = Commit(bid100, [p if i < keep else None for i, p in enumerate(c100.precommits)])

    v = Verifier(device=DEVICE)
    wall = {}
    f32p.launches = 0
    t0 = time.perf_counter()
    vs100.verify_commit(CHAIN_ID, bid100, 1, c100, batch_verifier=v.commit_batch_verifier())
    wall["commit_small"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    finishers = vs1000.verify_commits_async(
        CHAIN_ID, [(bid, h, c) for bid, c, h in group], v.verify_batch_async
    )
    for finish in finishers:
        finish()
    wall["fast_sync_group"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vs10k.verify_commit(CHAIN_ID, bid10k, 1, c10k, batch_verifier=v.commit_batch_verifier())
    wall["commit_large"] = time.perf_counter() - t0
    refusals = {}
    for label, commit, want in (("forged", forged, "invalid signature"),
                                ("sub_quorum", sub_quorum, "insufficient voting power")):
        try:
            vs100.verify_commit(CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier())
        except CommitError as exc:
            if not str(exc).startswith(want):
                raise AssertionError(f"{label}: wrong refusal {exc}") from exc
            refusals[label] = str(exc)[:60]
        else:
            raise AssertionError(f"{label} commit was accepted")
    main_launches = f32p.launches
    stats = v.stats()
    log({"phase": "main_path", "launches": main_launches, "stats": stats,
         "wall_s": wall, "refused": refusals})
    if main_launches != 5 or stats["tpu_batches"] != 5:
        raise AssertionError(f"expected 5 device batches, got {main_launches} launches, {stats}")
    if stats["cpu_sigs"] != 0:
        raise AssertionError(f"{stats['cpu_sigs']} main-path signatures fell to the CPU")

    # -- phase 4: times ---------------------------------------------------------
    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    warm = {
        "commit_small": lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, c100, batch_verifier=v.commit_batch_verifier()),
        "fast_sync_group": lambda: [f() for f in vs1000.verify_commits_async(
            CHAIN_ID, [(bid, h, c) for bid, c, h in group], v.verify_batch_async)],
        "commit_large": lambda: vs10k.verify_commit(
            CHAIN_ID, bid10k, 1, c10k, batch_verifier=v.commit_batch_verifier()),
    }
    for label, fn in warm.items():
        log({"phase": "commit_time", "card": name, "power_limit": power, "commit": label,
             "validators": {"commit_small": n_small, "fast_sync_group": 4 * n_mid,
                            "commit_large": n_keys}[label],
             "first_s": wall[label], "warm_best_of_3_s": min(timed(fn) for _ in range(3))})

    kernel_ms = {}
    for lanes in TIME_LANES:
        items = (mixed * (lanes // len(mixed) + 1))[:lanes]
        args, _, _ = f32p.marshal_device_args(items, DEVICE)
        ms = cuda_ms(lambda: f32p.verify_lanes(*args))
        kernel_ms[lanes] = ms
        b_ms, b_by = bound_ms(lanes)
        log({"phase": "kernel_time", "card": name, "power_limit": power, "lanes": lanes,
             "ms": ms, "sigs_per_s": lanes / ms * 1e3, "bound_ms": b_ms, "bound_by": b_by})
    args, _, _ = f32p.marshal_device_args(mixed, DEVICE)
    plain_args = (args[0].float(), args[1].float(), args[2].float(), args[3],
                  args[4].int(), args[5].int())
    plain_ms = cuda_ms(lambda: f32.verify_plain(*plain_args), reps=3, warmup=1)
    log({"phase": "plain_time", "card": name, "power_limit": power, "lanes": MIXED_LANES,
         "ms": plain_ms})

    # where a warm large commit's wall time goes, stage by stage
    large = shapes["commit_large"]
    args, _, _ = f32p.marshal_device_args(large, DEVICE)
    log({"phase": "commit_breakdown", "card": name, "power_limit": power, "lanes": len(large),
         "structural_and_tally_s": min(timed(lambda: recorded_items(vs10k, 1, bid10k, c10k))
                                       for _ in range(3)),
         "prepare_batch8_s": min(timed(lambda: f32.prepare_batch8(large, len(large)))
                                 for _ in range(3)),
         "marshal_and_copy_s": min(timed(lambda: f32p.marshal_device_args(large, DEVICE))
                                   for _ in range(3)),
         "kernel_s": cuda_ms(lambda: f32p.verify_lanes(*args)) / 1e3})

    sample = large[:512]
    best = min(timed(lambda: native.ed25519_verify_batch(sample)) for _ in range(3))
    log({"phase": "cpu_baseline", "card": name, "power_limit": power,
         "method": "native batch verifier, fixed 512 signatures, best of 3",
         "sigs_per_s": len(sample) / best})

    b_ms, b_by = bound_ms(MIXED_LANES)
    log({"kernels": [{
        "name": "ed25519_verify", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": main_launches, "max_abs_err": max_err,
        "ms": kernel_ms[MIXED_LANES], "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "lanes": MIXED_LANES,
    }]})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
