"""Drive tendermint_tpu_torch's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Card and build: the card's name and power limit, the torch and CUDA
   versions, the nvcc builds of the three kernels, all started together
   (seconds, registers, spills).
2. Kernel vs plain version on the card: 4096 lanes mixing valid,
   tampered, malformed and repeated-key signatures, then the main path's
   own lane counts (100, 4 x 1000, 10,000): the kernel's verdicts must
   equal `verify_plain`'s lane for lane, and a 256-lane sample must equal
   `crypto.ed25519.verify`.
3. Main path: commits through `ValidatorSet` and `Verifier` on the card —
   a 100-validator `verify_commit`, fast sync's grouped dispatch of four
   1000-validator commits (`verify_commits_async`), one 10,000-validator
   `verify_commit`, a forged commit and a sub-quorum commit, which must
   both be refused. The kernels' launch counts are reset just before and
   read just after: B1 launches once per batch, B2 and dsm never, and no
   lane may fall to the CPU.
4. Times (CUDA events, median of 7 after a warm-up): the kernel at 1024,
   4096 and 16,384 lanes, `verify_plain` at 4096, the native CPU batch
   verifier on a fixed 512-signature sample (best of 3), and the commit
   phases' wall times. Each line carries the card's name and power limit.
5. B2 (`ed25519_pallas`, the single-bit ladder) on the card: its verdicts
   equal its plain version's on the 4096 mixed lanes, B1's on every shape
   of phase 2, and `crypto.ed25519.verify` on a 256-lane sample.
6. The dsm kernel (`ed25519.dsm_batch`) on the card: 1025 lanes (the
   last 128-thread block partial) of random scalars and key points with the
   edge lanes (Q = identity, a = 0, b = 0, P == Q, P == -Q) and the real
   terms of a 100-validator aggregate commit equal `dsm_plain`'s bytes
   exactly; 64 lanes equal the pure-Python group law.
7. The main path through B2: the phase-3 commits through a
   `Verifier` built under TENDERMINT_TPU_KERNEL=pallas. B2's launch count
   must equal the device batches; B1's must stay 0.
8. The aggregate path: 100- and 400-validator `AggregateCommit`s (the JAX
   package's upgrade bench sizes) through `ValidatorSet.verify_commit` and
   `verify_commits_async`, which reach `default_verifier()` on the card,
   and a forged, a dropped-signer and a sub-quorum aggregate, which must be
   refused. Every lane must run on the card. After the counts are read,
   the dsm kernel is held against `dsm_plain` on the exact terms of both
   aggregates (101 and 401 lanes), bytes exactly.
9. Times: B2 and dsm against their bounds, their plain versions, the
   aggregate verify split into host and device stages, and the B2 path's
   commit wall times.
10. B1' (`ed25519_f32p.ShardedVerify`: B1 launched once per shard,
   each shard on its own device and stream) on two meshes, every visible
   card and 4 shards over cuda:0: on the 4099-lane quorum batch of
   `multichip.quorum_batch` and on every lane set of phase 2 (the 4096
   mixed lanes, the 100- and 10,000-validator commits and the 4 x 1000
   group, which give phase 11's shard geometries), its verdicts equal
   the unsharded kernel's and `verify_plain`'s lane for lane, the forged
   lanes are exactly (0, 1777, 4096, 4098), and the layout has one entry
   per shard with equal lanes. Then `multichip.dryrun_multichip` over
   every visible card.
11. The sharded main path: a `ShardedVerifier` on 4 shards over cuda:0
   verifies the 10,000-validator commit, the 4 x 1000 fast-sync group,
   the refused forged and sub-quorum commits, a primed 100-validator batch
   (`prime_cache_async` / `verify_one`) and a 100-validator commit whose
   set mixes 96 ed25519 and 4 secp256k1 keys, made with the port's
   `VoteSet`. B1 launches 4 times a device batch, B2 and dsm never, and
   exactly the secp256k1 lanes run on the CPU.
12. Times: the mesh's own window on the card (one start event, every
   shard stream waiting on it, the current stream waiting on every
   shard's end) at 4096 and 16,384 lanes on 1 and on 4 shards over
   cuda:0, the host's time to issue one launch, the 10,000-validator
   commit through `Verifier` and through `ShardedVerifier` on 1 and 4
   shards, and the sharded dispatch of its lanes stage by stage.

Each path's launch counts are set to 0 just before it and read just after.
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
AGG_SIZES = (100, 400)  # BENCH_r22.json rows wire:n=100, wire:n=400
MIXED_LANES = 4096
DSM_LANES = 1025  # not a multiple of the 128-thread block: the last block is partial
DSM_TIME_LANES = (101, 401, DSM_LANES, 4096)
TIME_LANES = (1024, 4096, 16384)
INT_MUL_PER_S = 67e12 / 2 / 2  # H100 SXM: 32-bit multiplies at half the fp32 FMA rate
HBM_BYTES_PER_S = 3.35e12
CSRC = "tendermint_tpu_torch/ops/csrc/"
KERNEL_NAMES = ("ed25519_verify", "ed25519_verify_b2", "ed25519_dsm")
# the TPU (or XLA) kernel each one replaces, by file:line of its body
REPLACES = {
    "ed25519_verify": "tendermint_tpu/ops/ed25519_f32p.py:301",
    "ed25519_verify_b2": "tendermint_tpu/ops/ed25519_pallas.py:186",
    "ed25519_dsm": "tendermint_tpu/ops/ed25519.py:542",
    # B1' is B1's kernel launched per shard: its pallas_call under shard_map
    "ed25519_verify_sharded": "tendermint_tpu/ops/ed25519_f32p.py:468",
}
SHARDS = 4  # B1' on one card: 4 shards over cuda:0
MIXED_SECP = 4  # secp256k1 validators of the 100-validator mixed commit


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


def bound_ms(module, lanes: int) -> tuple[float, str]:
    """The least time the card could take for a kernel module's lanes: its
    limb products over the integer multiply rate, or its bytes over the
    memory rate, whichever is larger."""
    ops_ms = 1e3 * module.PRODUCTS_PER_LANE * lanes / INT_MUL_PER_S
    bytes_ms = 1e3 * module.BYTES_PER_LANE * lanes / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def expect_refusal(label: str, fn, want: str) -> str:
    """Run fn, which must raise CommitError starting with `want`."""
    from tendermint_tpu_torch.types.validator_set import CommitError

    try:
        fn()
    except CommitError as exc:
        if not str(exc).startswith(want):
            raise AssertionError(f"{label}: wrong refusal {exc}") from exc
        return str(exc)[:60]
    raise AssertionError(f"{label} was accepted")


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
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32 as f32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops import kernels
    from tendermint_tpu_torch.ops.gateway import Verifier
    from tendermint_tpu_torch.types.block import Commit
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    # -- phase 1: card and build ---------------------------------------------
    card = card_line()
    name, power = [s.strip() for s in card.split(",", 1)]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    for kname, build_s in kernels.build_all(KERNEL_NAMES).items():
        log({"phase": "build", "kernel": kname, "seconds": build_s})
        for line in kernels.build_log.get(kname, "").splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                log(f"ptxas {kname}: {line.strip()}")
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
        vs400 = ValidatorSet(validators[: AGG_SIZES[1]])
        bid400, c400 = make_commit(pool, vs400, seed_of, 1, b"c400")
    log({"phase": "setup", "keys": n_keys,
         "signatures": MIXED_LANES + n_small + 4 * n_mid + n_keys + AGG_SIZES[1],
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
    whole = {}  # per shape, B1's and the plain version's lanes, for phase 10
    for label, items in shapes.items():
        args, valid, n = f32p.marshal_device_args(items, DEVICE)
        t0 = time.perf_counter()
        got = f32p.verify_lanes(*args)
        want = f32.verify_plain(args[0].float(), args[1].float(), args[2].float(), args[3],
                                args[4].int(), args[5].int()).to(torch.int32)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        max_err = max(max_err, err)
        whole[label] = {"b1": got.cpu(), "plain": want.cpu()}
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
    f32p.launches = b2.launches = ed32.launches = 0
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
        refusals[label] = expect_refusal(label, lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier()), want)
    main_launches = f32p.launches
    others = {"b2": b2.launches, "dsm": ed32.launches}
    stats = v.stats()
    log({"phase": "main_path", "launches": main_launches, "other_launches": others,
         "stats": stats, "wall_s": wall, "refused": refusals})
    if main_launches != 5 or stats["tpu_batches"] != 5 or others != {"b2": 0, "dsm": 0}:
        raise AssertionError(f"expected 5 B1 batches and no other launch: {main_launches} "
                             f"launches, {others}, {stats}")
    if stats["cpu_sigs"] != 0:
        raise AssertionError(f"{stats['cpu_sigs']} main-path signatures fell to the CPU")

    # -- phase 4: times ---------------------------------------------------------
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
        b_ms, b_by = bound_ms(f32p, lanes)
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

    # -- phases 5 to 9: B2, the dsm kernel, and the paths they carry ----------
    commits = {"commit_small": (vs100, bid100, c100), "fast_sync_group": (vs1000, group),
               "commit_large": (vs10k, bid10k, c10k), "agg_100": (vs100, bid100, c100),
               "agg_400": (vs400, bid400, c400)}
    b2_err = check_b2(shapes, rng)
    dsm_terms, dsm_err = check_dsm(rng, pubs[:256], commits["agg_100"])
    b2_launches, b2_runs, b2_wall = b2_main_path(commits, forged, sub_quorum)
    dsm_launches = aggregate_path(commits, sub_quorum)
    dsm_err = max(dsm_err, check_dsm_path_shapes(commits))
    b2_ms, b2_plain_ms, dsm_ms, dsm_plain_ms = time_b2_and_dsm(
        name, power, mixed, dsm_terms, commits, b2_runs, b2_wall)

    # -- phases 10 to 12: B1' and the sharded main path ------------------------
    sharded_err = check_sharded(shapes, whole)
    mixed_commit = make_mixed_commit(validators[: n_small - MIXED_SECP], seed_of, rng)
    sharded_launches = sharded_main_path(commits, forged, sub_quorum, mixed_commit)
    sharded_ms = time_sharded(name, power, mixed, commits)

    entries = []
    for kname, module, launches, err, ms, p_ms, lanes in (
            ("ed25519_verify", f32p, main_launches, max_err, kernel_ms[MIXED_LANES], plain_ms,
             MIXED_LANES),
            ("ed25519_verify_b2", b2, b2_launches, b2_err, b2_ms, b2_plain_ms, MIXED_LANES),
            ("ed25519_dsm", ed32, dsm_launches, dsm_err, dsm_ms, dsm_plain_ms, DSM_LANES)):
        b_ms, b_by = bound_ms(module, lanes)
        entries.append({
            "name": kname, "route": "cuda", "source": f"{CSRC}{kname}.cu",
            "replaces": REPLACES[kname], "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "lanes": lanes,
        })
    # B1' on one card: the work of B1 over the same lanes, split 4 ways;
    # its plain version is verify_plain over those lanes (phase 4's time)
    b_ms, b_by = bound_ms(f32p, MIXED_LANES)
    entries.append({
        "name": "ed25519_verify_sharded", "route": "cuda", "source": f"{CSRC}ed25519_verify.cu",
        "replaces": REPLACES["ed25519_verify_sharded"], "launches": sharded_launches,
        "max_abs_err": sharded_err, "ms": sharded_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms / len(set(shard_meshes()["one_card"])), "bound_by": b_by, "library_ms": None,
        "lanes": MIXED_LANES, "shards": SHARDS,
    })
    log({"kernels": entries})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


def check_b2(shapes, rng) -> int:
    """Phase 5: B2's verdicts equal its plain version's on the mixed lanes,
    B1's on every shape, and crypto.ed25519.verify on a sample. Returns
    the largest difference seen (0 when all agree)."""
    import torch

    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2

    max_err = 0
    for label, items in shapes.items():
        args, valid, n = f32p.marshal_device_args(items, DEVICE)
        t0 = time.perf_counter()
        got = b2.verify_lanes(*args)
        against = {"b1": f32p.verify_lanes(*args)}
        if label == "mixed":
            against["plain"] = b2.verify_plain(*args).to(torch.int32)
        torch.cuda.synchronize()
        errs = {k: int((got - w).abs().max().item()) for k, w in against.items()}
        max_err = max(max_err, *errs.values())
        verdicts = f32p.materialize_verdicts(got.cpu(), valid, n)
        log({"phase": "b2_vs_plain_and_b1", "shape": label, "lanes": n,
             "accepted": int(verdicts.sum()), "max_abs_err": errs,
             "seconds": time.perf_counter() - t0})
        for k, w in against.items():
            if errs[k] != 0:
                bad = torch.nonzero(got != w).flatten()[:10].tolist()
                raise AssertionError(f"{label}: B2 disagrees with {k} at lanes {bad}")
        if label == "mixed":
            sample = rng.choice(n, size=min(256, n), replace=False)
            ref = np.array([ed.verify(*items[i]) for i in sample])
            if not np.array_equal(verdicts[sample], ref):
                raise AssertionError("mixed: B2 verdicts disagree with crypto.ed25519.verify")
        elif not verdicts.all():
            raise AssertionError(f"{label}: B2 rejected a valid commit signature")
    return max_err


def _aggregate_args(vs, agg):
    """(pubs, msgs, rs, s_agg): what AggregateCommit.verify hands the
    aggregate verifier."""
    pubs = [vs.get_by_index(i)[1].pub_key.raw for i in agg.signers.indices()]
    return pubs, [agg.sign_message(CHAIN_ID)] * len(pubs), agg.rs, agg.s_agg


def _affine(pt) -> tuple[int, int]:
    from tendermint_tpu_torch.crypto import ed25519 as ed

    zinv = pow(pt[2], ed.P - 2, ed.P)
    return (pt[0] * zinv % ed.P, pt[1] * zinv % ed.P)


def check_dsm(rng, pubs, agg_case):
    """Phase 6: the dsm kernel against dsm_plain, bytes exactly, on
    DSM_LANES lanes from the seed (random scalars below L, validator key
    points, the edge lanes) ending in the real terms of a 100-validator
    aggregate commit; then 64 lanes against the pure-Python group law.
    Returns (terms, largest byte difference)."""
    import torch

    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    vs, _, commit = agg_case
    real = ed25519_agg.aggregate_terms(
        *_aggregate_args(vs, AggregateCommit.from_commit(commit, CHAIN_ID, vs)))
    points = [_affine(ed.point_decompress(p)) for p in pubs]

    def scalar() -> int:
        return int.from_bytes(rng.bytes(32), "little") % ed.L

    terms = []
    for i in range(DSM_LANES - len(real)):
        p, q = points[int(rng.integers(len(points)))], points[int(rng.integers(len(points)))]
        a, b = scalar(), scalar()
        kind = i % 8  # the edge lanes the complete formulas must cover
        if kind == 1:
            q = (0, 1)
        elif kind == 2:
            a = 0
        elif kind == 3:
            b = 0
        elif kind == 4:
            q = p
        elif kind == 5:
            q = ((-p[0]) % ed.P, p[1])
        elif kind == 6:
            a = b = 0
        terms.append((a, p, b, q))
    terms += real

    t0 = time.perf_counter()
    rows = ed32.marshal_dsm_args(terms, DEVICE)
    x8, y8 = ed32.dsm_lanes(*rows)
    px, py = ed32.dsm_plain(*(ed32.limbs_from_bytes(r) for r in rows))
    want = torch.stack([ed32.bytes_from_limbs(px), ed32.bytes_from_limbs(py)])
    got = torch.stack([x8, y8])
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max().item())
    log({"phase": "dsm_vs_plain", "lanes": len(terms), "real_aggregate_lanes": len(real),
         "max_abs_err": err, "seconds": time.perf_counter() - t0})
    if err != 0:
        bad = torch.nonzero((got != want).any(dim=(0, 1))).flatten()[:10].tolist()
        raise AssertionError(f"dsm kernel disagrees with dsm_plain at lanes {bad}")
    xy = got.cpu().numpy()
    sample = min(64, len(terms))
    for i in range(sample):
        a, p, b, q = terms[i]
        ref = _affine(ed.point_add(ed.scalar_mult(a, (p[0], p[1], 1, p[0] * p[1] % ed.P)),
                                   ed.scalar_mult(b, (q[0], q[1], 1, q[0] * q[1] % ed.P))))
        lane = tuple(int.from_bytes(xy[k, :, i].tobytes(), "little") for k in range(2))
        if lane != ref:
            raise AssertionError(f"dsm lane {i} disagrees with the pure-Python group law")
    log({"phase": "dsm_reference_sample", "lanes": sample, "equal": True})
    return terms, err


def b2_main_path(commits, forged, sub_quorum):
    """Phase 7: the phase-3 commits through a Verifier built under
    TENDERMINT_TPU_KERNEL=pallas. Returns (B2 launches, the commit runs,
    their first wall times)."""
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops.gateway import Verifier

    before = os.environ.get("TENDERMINT_TPU_KERNEL")
    os.environ["TENDERMINT_TPU_KERNEL"] = "pallas"
    try:
        v = Verifier(device=DEVICE)
    finally:
        if before is None:
            del os.environ["TENDERMINT_TPU_KERNEL"]
        else:
            os.environ["TENDERMINT_TPU_KERNEL"] = before
    if v.kernel != "pallas":
        raise AssertionError(f"TENDERMINT_TPU_KERNEL=pallas built a {v.kernel} verifier")
    vs100, bid100, c100 = commits["commit_small"]
    vs1000, group = commits["fast_sync_group"]
    vs10k, bid10k, c10k = commits["commit_large"]
    runs = {
        "commit_small": lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, c100, batch_verifier=v.commit_batch_verifier()),
        "fast_sync_group": lambda: [f() for f in vs1000.verify_commits_async(
            CHAIN_ID, [(bid, h, c) for bid, c, h in group], v.verify_batch_async)],
        "commit_large": lambda: vs10k.verify_commit(
            CHAIN_ID, bid10k, 1, c10k, batch_verifier=v.commit_batch_verifier()),
    }
    f32p.launches = b2.launches = ed32.launches = 0
    wall = {label: timed(fn) for label, fn in runs.items()}
    refusals = {}
    for label, commit, want in (("forged", forged, "invalid signature"),
                                ("sub_quorum", sub_quorum, "insufficient voting power")):
        refusals[label] = expect_refusal(label, lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier()), want)
    launches = {"b2": b2.launches, "b1": f32p.launches, "dsm": ed32.launches}
    stats = v.stats()
    log({"phase": "b2_main_path", "kernel": v.kernel, "launches": launches, "stats": stats,
         "wall_s": wall, "refused": refusals})
    if launches != {"b2": 5, "b1": 0, "dsm": 0} or stats["tpu_batches"] != 5:
        raise AssertionError(f"expected 5 B2 batches and no other launch: {launches}, {stats}")
    if stats["cpu_sigs"] != 0:
        raise AssertionError(f"{stats['cpu_sigs']} B2-path signatures fell to the CPU")
    return launches["b2"], runs, wall


def aggregate_path(commits, sub_quorum) -> int:
    """Phase 8: 100- and 400-validator aggregate commits through
    ValidatorSet.verify_commit and verify_commits_async on the default
    verifier (the card), and three refusals. Returns the dsm launches."""
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.libs.bitarray import BitArray
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    dv = gateway.default_verifier()
    if dv.device.type != DEVICE:
        raise AssertionError(f"the default verifier runs on {dv.device}")
    aggs = {label: AggregateCommit.from_commit(commits[label][2], CHAIN_ID, commits[label][0])
            for label in ("agg_100", "agg_400")}
    vs100, bid100, c100 = commits["agg_100"]
    forged = AggregateCommit.from_bytes(aggs["agg_100"].to_bytes())
    forged.s_agg = ((int.from_bytes(forged.s_agg, "little") + 1) % ed.L).to_bytes(32, "little")
    dropped = AggregateCommit.from_bytes(aggs["agg_100"].to_bytes())
    dropped.signers.set_index(0, False)
    dropped.rs = dropped.rs[1:]
    keep = [i for i, p in enumerate(sub_quorum.precommits) if p is not None]
    rs, s_agg = ed25519_agg.aggregate([
        (vs100.get_by_index(i)[1].pub_key.raw, c100.precommits[i].sign_bytes(CHAIN_ID),
         c100.precommits[i].signature.raw) for i in keep])
    thin = AggregateCommit(bid100, 1, 0, BitArray.from_indices(vs100.size(), keep), rs, s_agg)

    before = dv.stats()
    f32p.launches = b2.launches = ed32.launches = 0
    wall, want_lanes = {}, 0
    for label, agg in aggs.items():
        vs, bid, _ = commits[label]
        wall[label] = timed(lambda: vs.verify_commit(CHAIN_ID, bid, 1, agg))
        fin = vs.verify_commits_async(CHAIN_ID, [(bid, 1, agg)], dv.verify_batch_async)
        fin[0]()
        want_lanes += 2 * (agg.num_signers() + 1)
    refusals = {
        "forged_s_agg": expect_refusal("forged aggregate", lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, forged), "aggregate signature failed verification"),
        "dropped_signer": expect_refusal("dropped-signer aggregate", lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, dropped), "aggregate signature failed verification"),
        "sub_quorum_aggregation": expect_refusal(
            "sub-quorum aggregation", lambda: AggregateCommit.from_commit(
                sub_quorum, CHAIN_ID, vs100), "aggregable precommits carry only"),
        "sub_quorum_aggregate": expect_refusal("sub-quorum aggregate", lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, thin), "insufficient voting power"),
    }
    want_lanes += (forged.num_signers() + 1) + (dropped.num_signers() + 1)
    launches = {"dsm": ed32.launches, "b1": f32p.launches, "b2": b2.launches}
    after = dv.stats()
    grew = {k: after[k] - before[k] for k in ("agg_batches", "agg_lanes_device", "agg_lanes_cpu")}
    log({"phase": "aggregate_path", "validators": [a.size() for a in aggs.values()],
         "signers": [a.num_signers() for a in aggs.values()], "launches": launches,
         "stats_grew": grew, "wall_s": wall, "refused": refusals})
    if grew != {"agg_batches": 6, "agg_lanes_device": want_lanes, "agg_lanes_cpu": 0}:
        raise AssertionError(f"expected 6 device aggregates of {want_lanes} lanes: {grew}")
    if launches != {"dsm": 6, "b1": 0, "b2": 0}:
        raise AssertionError(f"expected 6 dsm launches and no other: {launches}")
    return launches["dsm"]


def check_dsm_path_shapes(commits) -> int:
    """The dsm kernel against dsm_plain, bytes exactly, on the exact terms
    of the aggregate path's 100- and 400-validator commits (101 and 401
    lanes, so the last block is partial). Runs after the path's launch
    counts are read. Returns the largest byte difference."""
    import torch

    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    max_err = 0
    for label in ("agg_100", "agg_400"):
        vs, _, commit = commits[label]
        terms = ed25519_agg.aggregate_terms(
            *_aggregate_args(vs, AggregateCommit.from_commit(commit, CHAIN_ID, vs)))
        rows = ed32.marshal_dsm_args(terms, DEVICE)
        got = torch.stack(ed32.dsm_lanes(*rows))
        px, py = ed32.dsm_plain(*(ed32.limbs_from_bytes(r) for r in rows))
        want = torch.stack([ed32.bytes_from_limbs(px), ed32.bytes_from_limbs(py)])
        err = int((got.int() - want.int()).abs().max().item())
        log({"phase": "dsm_vs_plain_path_shape", "shape": label, "lanes": len(terms),
             "max_abs_err": err})
        if err != 0:
            bad = torch.nonzero((got != want).any(dim=(0, 1))).flatten()[:10].tolist()
            raise AssertionError(f"{label}: dsm kernel disagrees with dsm_plain at lanes {bad}")
        max_err = max(max_err, err)
    return max_err


def time_b2_and_dsm(name, power, mixed, dsm_terms, commits, b2_runs, b2_wall):
    """Phase 9: B2 and dsm against their bounds and plain versions, the
    aggregate verify split by stage, and the B2 path's commit times.
    Returns (B2 ms and plain ms at MIXED_LANES, dsm ms and plain ms at
    DSM_LANES)."""
    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    tag = {"card": name, "power_limit": power}
    b2_ms = {}
    for lanes in TIME_LANES:
        args, _, _ = f32p.marshal_device_args((mixed * (lanes // len(mixed) + 1))[:lanes], DEVICE)
        b2_ms[lanes] = cuda_ms(lambda: b2.verify_lanes(*args))
        b_ms, b_by = bound_ms(b2, lanes)
        log({"phase": "b2_time", **tag, "lanes": lanes, "ms": b2_ms[lanes],
             "sigs_per_s": lanes / b2_ms[lanes] * 1e3, "bound_ms": b_ms, "bound_by": b_by})
    args, _, _ = f32p.marshal_device_args(mixed, DEVICE)
    b2_plain_ms = cuda_ms(lambda: b2.verify_plain(*args), reps=3, warmup=0)
    log({"phase": "b2_plain_time", **tag, "lanes": MIXED_LANES, "ms": b2_plain_ms})

    dsm_ms = {}
    for lanes in DSM_TIME_LANES:
        rows = ed32.marshal_dsm_args((dsm_terms * (lanes // len(dsm_terms) + 1))[:lanes], DEVICE)
        dsm_ms[lanes] = cuda_ms(lambda: ed32.dsm_lanes(*rows))
        b_ms, b_by = bound_ms(ed32, lanes)
        log({"phase": "dsm_time", **tag, "lanes": lanes, "ms": dsm_ms[lanes],
             "bound_ms": b_ms, "bound_by": b_by})
    rows = ed32.marshal_dsm_args(dsm_terms[:DSM_LANES], DEVICE)
    limbs = [ed32.limbs_from_bytes(r) for r in rows]
    dsm_plain_ms = cuda_ms(lambda: ed32.dsm_plain(*limbs), reps=3, warmup=0)
    log({"phase": "dsm_plain_time", **tag, "lanes": DSM_LANES, "ms": dsm_plain_ms})

    dv = gateway.default_verifier()
    for label in ("agg_100", "agg_400"):
        vs, bid, commit = commits[label]
        agg = AggregateCommit.from_commit(commit, CHAIN_ID, vs)
        agg_args = _aggregate_args(vs, agg)
        terms = ed25519_agg.aggregate_terms(*agg_args)
        points = ed32.dsm_batch(terms, DEVICE)
        rows = ed32.marshal_dsm_args(terms, DEVICE)
        log({"phase": "aggregate_time", **tag, "validators": vs.size(), "lanes": len(terms),
             "verify_commit_warm_best_of_3_s": min(
                 timed(lambda: vs.verify_commit(CHAIN_ID, bid, 1, agg)) for _ in range(3)),
             "aggregate_terms_host_s": min(
                 timed(lambda: ed25519_agg.aggregate_terms(*agg_args)) for _ in range(3)),
             "dsm_batch_s": min(timed(lambda: ed32.dsm_batch(terms, DEVICE)) for _ in range(3)),
             "dsm_kernel_s": cuda_ms(lambda: ed32.dsm_lanes(*rows)) / 1e3,
             "finish_from_points_host_s": min(
                 timed(lambda: ed25519_agg.finish_from_points(points)) for _ in range(3)),
             "stats": dv.stats()})

    for label, fn in b2_runs.items():
        log({"phase": "b2_commit_time", **tag, "commit": label, "first_s": b2_wall[label],
             "warm_best_of_3_s": min(timed(fn) for _ in range(3))})
    return b2_ms[MIXED_LANES], b2_plain_ms, dsm_ms[DSM_LANES], dsm_plain_ms


def shard_meshes() -> dict[str, list[str]]:
    """B1''s meshes: every visible card, and SHARDS shards over one."""
    import torch

    return {"cards": [f"cuda:{i}" for i in range(torch.cuda.device_count())],
            "one_card": ["cuda:0"] * SHARDS}


def check_sharded(shapes, whole) -> int:
    """Phase 10: B1' against the unsharded kernel and verify_plain, lane
    for lane, over both meshes, on the quorum batch and on every shape of
    phase 2 (whose B1 and plain lanes `whole` holds), so every shard
    geometry of phase 11 is compared; then dryrun_multichip over every
    card. Returns the largest difference."""
    import torch

    from tendermint_tpu_torch import multichip
    from tendermint_tpu_torch.ops import ed25519_f32 as f32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    quorum, forged_at = multichip.quorum_batch()
    args, _, _ = f32p.marshal_device_args(quorum, DEVICE)
    whole = {"quorum": {"b1": f32p.verify_lanes(*args).cpu(),
                        "plain": f32.verify_plain(args[0].float(), args[1].float(), args[2].float(),
                                                  args[3], args[4].int(), args[5].int())
                        .to(torch.int32).cpu()},
             **whole}
    meshes = {mname: f32p.ShardedVerify(mesh) for mname, mesh in shard_meshes().items()}
    max_err = 0
    for label, items in (("quorum", quorum), *shapes.items()):
        n = len(items)
        for mname, mesh in shard_meshes().items():
            t0 = time.perf_counter()
            res, valid_s, _ = f32p.sharded_verify_arrays(items, meshes[mname])
            got = res.wait()[:n].clone()
            errs = {k: int((got - w).abs().max().item()) for k, w in whole[label].items()}
            max_err = max(max_err, *errs.values())
            verdicts = f32p.materialize_verdicts(got, valid_s, n)
            lanes = {sz for _, sz in res.shards}
            log({"phase": "sharded_vs_b1_and_plain", "inputs": label, "mesh": mname,
                 "lanes": n, "layout": res.shards, "accepted": int(verdicts.sum()),
                 "max_abs_err": errs, "seconds": time.perf_counter() - t0})
            for k, w in whole[label].items():
                if errs[k] != 0:
                    bad = torch.nonzero(got != w).flatten()[:10].tolist()
                    raise AssertionError(f"{label} on {mname}: B1' disagrees with {k} at lanes {bad}")
            if [d for d, _ in res.shards] != mesh or len(lanes) != 1:
                raise AssertionError(f"{label} on {mname}: layout {res.shards}")
            rejected = tuple(int(i) for i in np.flatnonzero(~verdicts))
            if label == "quorum" and rejected != forged_at:
                raise AssertionError(f"quorum on {mname}: rejected {rejected[:10]}")
            if label not in ("quorum", "mixed") and rejected:
                raise AssertionError(f"{label} on {mname}: valid lanes rejected at {rejected[:10]}")
    multichip.dryrun_multichip(torch.cuda.device_count())
    return max_err


def make_mixed_commit(ed_validators, seed_of, rng):
    """A 100-validator commit whose set mixes len(ed_validators) ed25519
    keys with MIXED_SECP secp256k1 keys from the seed, made through the
    port's VoteSet. Returns (set, block id, commit)."""
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.crypto.keys import SignatureEd25519, gen_priv_key_secp256k1
    from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet
    from tendermint_tpu_torch.types.vote import VOTE_TYPE_PRECOMMIT, Vote
    from tendermint_tpu_torch.types.vote_set import VoteSet

    secp = [gen_priv_key_secp256k1(rng.bytes(32)) for _ in range(MIXED_SECP)]
    vs = ValidatorSet(list(ed_validators) + [Validator.new(k.pub_key(), 10) for k in secp])
    secp_of = {k.pub_key().address(): k for k in secp}
    bid = BlockID(hashlib.sha256(b"mixed").digest()[:20],
                  PartSetHeader(1, hashlib.sha256(b"mixed-parts").digest()[:20]))
    votes = VoteSet(CHAIN_ID, 1, 0, VOTE_TYPE_PRECOMMIT, vs)
    for idx, v in enumerate(vs.validators):
        vote = Vote(v.address, idx, 1, 0, VOTE_TYPE_PRECOMMIT, bid)
        sb = vote.sign_bytes(CHAIN_ID)
        sig = (secp_of[v.address].sign(sb) if v.address in secp_of
               else SignatureEd25519(ed.sign(seed_of[v.address], sb)))
        if not votes.add_vote(vote.with_signature(sig)):
            raise AssertionError(f"mixed commit: vote {idx} was not added")
    return vs, bid, votes.make_commit()


def sharded_main_path(commits, forged, sub_quorum, mixed_commit) -> int:
    """Phase 11: the main path through a ShardedVerifier on SHARDS shards
    over cuda:0. Returns the B1 launches of the run."""
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops.gateway import ShardedVerifier

    v = ShardedVerifier(shard_meshes()["one_card"])
    vs100, bid100, c100 = commits["commit_small"]
    vs1000, group = commits["fast_sync_group"]
    vs10k, bid10k, c10k = commits["commit_large"]
    vs_mix, bid_mix, c_mix = mixed_commit
    primed = recorded_items(vs100, 1, bid100, c100)
    f32p.launches = b2.launches = ed32.launches = 0
    wall = {}
    wall["commit_large"] = timed(lambda: vs10k.verify_commit(
        CHAIN_ID, bid10k, 1, c10k, batch_verifier=v.commit_batch_verifier()))
    wall["fast_sync_group"] = timed(lambda: [f() for f in vs1000.verify_commits_async(
        CHAIN_ID, [(bid, h, c) for bid, c, h in group], v.verify_batch_async)])
    refusals = {}
    for label, commit, want in (("forged", forged, "invalid signature"),
                                ("sub_quorum", sub_quorum, "insufficient voting power")):
        refusals[label] = expect_refusal(label, lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier()), want)
    v.prime_cache_async(primed)
    if not all(v.verify_one(*it) for it in primed):
        raise AssertionError("a primed valid signature was rejected")
    wall["commit_mixed"] = timed(lambda: vs_mix.verify_commit(
        CHAIN_ID, bid_mix, 1, c_mix, batch_verifier=v.commit_batch_verifier()))
    launches = {"b1": f32p.launches, "b2": b2.launches, "dsm": ed32.launches}
    stats = v.stats()
    log({"phase": "sharded_main_path", "mesh": [str(d) for d in v.mesh], "launches": launches,
         "stats": stats, "layout": v.last_shard_layout, "wall_s": wall, "refused": refusals})
    if launches != {"b1": SHARDS * 6, "b2": 0, "dsm": 0} or stats["tpu_batches"] != 6:
        raise AssertionError(f"expected 6 sharded batches of {SHARDS} B1 launches and no other "
                             f"launch: {launches}, {stats}")
    if stats["cpu_sigs"] != MIXED_SECP:
        raise AssertionError(f"expected exactly the {MIXED_SECP} secp256k1 lanes on the CPU: {stats}")
    if len(v.last_shard_layout) != SHARDS or len({sz for _, sz in v.last_shard_layout}) != 1:
        raise AssertionError(f"layout {v.last_shard_layout}")
    return launches["b1"]


def mesh_window_ms(sharded, shard_args, reps: int = 7, warmup: int = 2) -> float:
    """Median device time of one launch per shard, in a single window: a
    start event on the current stream, every shard stream waiting on it,
    the current stream waiting on every shard's end event, then the stop
    event."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    def window() -> float:
        cur = torch.cuda.current_stream()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(cur)
        for dev, stream, args in zip(sharded.devices, sharded.streams, shard_args):
            stream.wait_event(start)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                f32p.verify_lanes(*args)
                end = torch.cuda.Event()
                end.record(stream)
            cur.wait_event(end)
        stop.record(cur)
        stop.synchronize()
        return start.elapsed_time(stop)

    for _ in range(warmup):
        window()
    return statistics.median(window() for _ in range(reps))


def time_sharded(name, power, mixed, commits) -> float:
    """Phase 12: B1' on 1 and SHARDS shards over cuda:0 at 4096 and
    16,384 lanes, the host's time to issue one launch, the
    10,000-validator commit through Verifier and through ShardedVerifier
    on 1 and SHARDS shards, and the sharded dispatch of its lanes by
    stage. Returns the SHARDS-shard time at MIXED_LANES."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops.gateway import ShardedVerifier, Verifier

    tag = {"card": name, "power_limit": power}
    window = {}
    for lanes in (MIXED_LANES, TIME_LANES[-1]):
        planes, rs, _ = f32p.host_planes((mixed * (lanes // len(mixed) + 1))[:lanes], lanes)
        b_ms, b_by = bound_ms(f32p, lanes)
        for shards in (1, SHARDS):
            sharded = f32p.ShardedVerify(shard_meshes()["one_card"][:1] * shards)
            per = lanes // shards
            shard_args = [f32p.device_args(np.ascontiguousarray(planes[..., k * per:(k + 1) * per]),
                                           np.ascontiguousarray(rs[k * per:(k + 1) * per]),
                                           sharded.devices[k]) for k in range(shards)]
            window[lanes, shards] = mesh_window_ms(sharded, shard_args)
            log({"phase": "sharded_time", **tag, "lanes": lanes, "shards": shards,
                 "ms": window[lanes, shards], "sigs_per_s": lanes / window[lanes, shards] * 1e3,
                 "bound_ms": b_ms, "bound_by": b_by})
    torch.cuda.synchronize()
    # the host's cost of issuing one launch, which staggers the shards'
    # start inside the window
    args, _, _ = f32p.marshal_device_args(mixed, DEVICE)
    t0 = time.perf_counter()
    for _ in range(20):
        f32p.verify_lanes(*args)
    issue_s = (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    log({"phase": "launch_issue_time", **tag, "lanes": MIXED_LANES, "host_us_per_launch": issue_s * 1e6})

    vs10k, bid10k, c10k = commits["commit_large"]
    verifiers = {"verifier_b1": Verifier(device=DEVICE),
                 "sharded_verifier_1": ShardedVerifier(shard_meshes()["one_card"][:1]),
                 f"sharded_verifier_{SHARDS}": ShardedVerifier(shard_meshes()["one_card"])}
    best = {label: [] for label in verifiers}
    for _ in range(4):
        for label, ver in verifiers.items():
            best[label].append(timed(lambda: vs10k.verify_commit(
                CHAIN_ID, bid10k, 1, c10k, batch_verifier=ver.commit_batch_verifier())))
    log({"phase": "sharded_commit_time", **tag, "validators": vs10k.size(),
         "warm_best_of_4_s": {label: min(t) for label, t in best.items()}})

    # where the sharded dispatch of that commit's lanes goes, stage by stage
    large = recorded_items(vs10k, 1, bid10k, c10k)
    sharded = f32p.ShardedVerify(shard_meshes()["one_card"])
    bucket = -(-len(large) // f32p.lane_quantum(SHARDS)) * f32p.lane_quantum(SHARDS)
    planes, rs, _ = f32p.host_planes(large, bucket)
    stages = {"host_planes_s": [], "dispatch_s": [], "wait_s": []}
    for _ in range(3):
        stages["host_planes_s"].append(timed(lambda: f32p.host_planes(large, bucket)))
        t0 = time.perf_counter()
        res = sharded.dispatch(planes, rs)
        stages["dispatch_s"].append(time.perf_counter() - t0)
        stages["wait_s"].append(timed(res.wait))
    log({"phase": "sharded_dispatch_breakdown", **tag, "lanes": len(large), "bucket": bucket,
         "shards": SHARDS, **{k: min(t) for k, t in stages.items()},
         "b1_marshal_and_copy_s": min(timed(lambda: f32p.marshal_device_args(large, DEVICE))
                                      for _ in range(3))})
    return window[MIXED_LANES, SHARDS]


if __name__ == "__main__":
    sys.exit(main())
