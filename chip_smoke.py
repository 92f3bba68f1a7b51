"""Drive tendermint_tpu_torch's main path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Card and build: the card's name and power limit, the torch and CUDA
   versions, the nvcc builds of every kernel source and of the rate
   probe, all started together (seconds; registers, stack frame and
   spills per kernel). Then the bound's yardstick: the IMAD.WIDE count of
   one field multiplication and one squaring in the SASS (cuobjdump), the
   limb products per lane that gives for B1, B2 and dsm, each kernel's
   longest loop (one ladder step) counted on its own, and the measured
   rates of a saturating IMAD.WIDE and a 32-bit IMAD microkernel.
2. Kernel vs plain version on the card: 4096 lanes mixing valid,
   tampered, malformed and repeated-key signatures, then the main path's
   own lane counts (100, 4 x 1000, 10,000), then the ragged lane counts
   1, 7, 9, 33, 100 and 1025 (a partial last warp and block): the
   kernel's verdicts must equal `verify_plain`'s lane for lane, and a
   256-lane sample must equal `crypto.ed25519.verify`.
3. Main path: commits through `ValidatorSet` and `Verifier` on the card —
   a 100-validator `verify_commit`, fast sync's grouped dispatch of four
   1000-validator commits (`verify_commits_async`), one 10,000-validator
   `verify_commit`, a forged commit and a sub-quorum commit, which must
   both be refused. The kernels' launch counts are reset just before and
   read just after: B1 launches once per batch, B2 and dsm never, and no
   lane may fall to the CPU.
4. Times (CUDA events, median of 7 after a warm-up): the kernel at 100,
   1024, 4096, 10,000 and 16,384 lanes, `verify_plain` at 4096, the
   native CPU batch verifier on a fixed 512-signature sample (best of
   3), and the commit
   phases' wall times. Each line carries the card's name and power limit.
5. B2 (`ed25519_pallas`, the single-bit ladder, four threads a lane) on
   the card: its verdicts equal its plain version's on the 4096 mixed
   lanes, B1's on every shape of phase 2, both at the ragged lane counts
   1, 7, 9, 33, 100 and 1025, and `crypto.ed25519.verify` on a 256-lane
   sample.
6. The dsm kernel (`ed25519.dsm_batch`) on the card: 1025 lanes (the
   last 32-lane block partial) of random scalars and key points with the
   edge lanes (Q = identity, a = 0, b = 0, P == Q, P == -Q) and the real
   terms of a 100-validator aggregate commit equal `dsm_plain`'s bytes
   exactly, and so do their first 1, 7, 9, 33 and 100 lanes; 64 lanes
   equal the pure-Python group law.
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

13. The comb kernels (`ed25519_comb`: B4's verify against per-key tables;
   `ed25519_comb_tables`: the table build) against their plain versions on
   the card: the tables of 1, 7, 33, 64, 65 and 1000 keys, bytes exactly;
   every table of the 10,000-validator set built in one launch, bytes
   exactly too, and 8 sampled keys' rows equal to a pure-Python niels
   table; the comb verdicts on every lane set of
   phase 2 and at the ragged lane counts equal `verify_comb_plain`'s raw
   verdicts and B1's masked ones.
14. The main path through comb: the phase-3 commits under
   TENDERMINT_TPU_KERNEL=comb, each twice, after `reset_default_pool()`,
   then the forged and sub-quorum commits. Every pass's B1, comb and
   table-build launches must be the second-sight policy's: a lane whose
   key is seen for the first time rides B1, a key's second sight builds
   its table (one launch a pass), and every second pass runs on comb
   alone; one table a distinct key.
15. A 64-slot pool on the card: eviction, a batch of more keys than the
   pool holds (PoolExhausted: the lanes ride B1), and a rebuild of evicted
   keys, every verdict right.
16. The torch compositions: the 100-validator commit under
   TENDERMINT_TPU_KERNEL=f32 (B3) and int32 (B5's verify), and through a
   4-shard f32 `ShardedVerifier`, with no kernel launched; int32's
   `decompress_batch` and both verifies on the card equal to the CPU and
   the reference.
17. Times: the comb kernel at 100 to 16,384 lanes of commit signatures,
   the table build at 1, 100, 1000 and 10,000 keys, their plain versions,
   the comb path's commit wall times, and f32 and int32 per batch.

18. The hash kernels against their plain versions on the card: K1
   (RIPEMD-160) and K2 (SHA-256), `csrc/hash_blocks.cu`, at 1, 7, 33, 100
   and 1,025 messages whose first lanes have the lengths 0, 55, 56, 63, 64,
   119, 120, 10,240 and 65,536, digest words equal to the plain version's
   (run once over the widest batch) and to crypto.hashing.ripemd160 /
   hashlib.sha256, lane for lane; K3 (the Merkle tree), `csrc/merkle_tree.cu`,
   at 2 to 10,000 leaves, every node equal to `_run_tree` and to
   FlatTree.from_leaf_digests, slot for slot.
19. The main path of the hash plane: `Block.make_block` wired as
   consensus wires its Hasher (`set_batch_tx_root(h.tx_merkle_root)`, the
   part hashers and the tree submitter), with a fresh `Hasher()` on the
   card, for `block_1mb` (BASELINE.json's 1 MB block of 64 KB parts: 4,000
   transactions of 250 bytes) and `block_cap` (types/params.py's caps:
   10,000 transactions of 1 to 4,096 bytes, every 1,000th at 10,240; about
   21 MB, 318 parts), the phase-3 100-validator commit as last commit.
   Launches reset before and read after each build (K1 2, K3 2, nothing
   else), `stats()` (one part batch, one tx root, no CPU leaf, one
   submitted job), the block equal to the same block built under
   TENDERMINT_TPU_HASHES=0 (bytes, header, data hash, part-set header,
   every proof), `Block.from_bytes` of its bytes hashing the same, a
   PartSet from its header accepting every part, and a flipped byte
   refused. Then K2's path, `ops.hashing.sha256_batch`, once. Every
   kernel call of these paths is recorded (its inputs and output), and
   after the counts are read each is held against its plain version on
   the card: K1 on both blocks' tx leaves and parts, K2 on the
   transactions, K3 on the four real trees (16, 318, 4,000 and 10,000
   leaves).
20. Times: the ALU yardsticks (`imad_rate.cu`'s LOP3/IADD3/SHF rate and
   one dependent instruction's latency), K1 on both blocks' part and
   tx-leaf batches, K2 on the tx leaves, K3 on phase 19's four trees
   (CUDA events around a call, and the kernel's device time from the
   profiler), each with its bound (`hash_bound`) and the native host
   library's time on the same input, the plain versions where a run is
   short (their results held against the kernel's too), and
   `make_block`'s wall time through the card and the host floor with
   where a card build's time goes.

21. The device daemon: `python3 -m tendermint_tpu_torch.devd` on the
   card (a socket in a short directory under /tmp, SIGTERM honoured,
   TENDERMINT_DEVD_KERNEL unset so its claim-time bake-off of comb against
   B1 runs), serving within DEVD_HELD_S; with TENDERMINT_DEVD_SOCK set and
   TENDERMINT_TPU_KERNEL unset, `kernel_name()` must answer "devd", and a
   default `Verifier` and `Hasher` route through it. The phase-3 commits
   through it (the forged and sub-quorum ones refused), their lanes and a
   10,000-lane verify_stream lane for lane equal to B1's in process,
   `agg_100`'s terms through the agg op equal to the dsm kernel's points,
   block_cap's parts through hash_stream with the tree frame equal to K1's
   and K3's in process, and both blocks built through it equal to the host
   floor. The daemon's counts (read through its `stats` op, before and
   after) must show every lane on the card and none on its CPU, each of
   the path's kernels launched, and the breaker CLOSED throughout; the
   daemon is shut down (killed after DEVD_STOP_S) whatever happens.
22. Times: the daemon's claim and build seconds, its bake-off rates and
   the kernel and chunk width it chose, the `bench` op's sigs/s, each
   path's wall time through the daemon beside the same call in process,
   and hash_stream's MB/s on block_cap's parts.

23. The multi-daemon plane: two daemons on cuda:0, each its own process
   and CUDA context (B1 pinned, a 1,024-lane warm-up, phase 21's chunk
   width), behind TENDERMINT_DEVD_SOCKS, with a default `Verifier` and
   `Hasher` slicing every batch over both (ops/devd_shard.py). The phase-3
   commits (the forged and sub-quorum ones refused), their lanes again,
   `agg_100` and `agg_400` (their commits and their dsm points), a
   10,000-lane `verify_batch_async`, both blocks and block_cap's parts
   through `hash_tree`: every lane, point, digest, node and block byte
   equal to the in-process kernels' and the host floor's. Both endpoints
   serve; the two daemons' `tpu_sigs` grow by exactly the lanes sent and
   their `cpu_sigs` not at all; no lane, leaf or aggregate lane on this
   process's CPU; every breaker CLOSED; each daemon launched B1, dsm and
   K1, and no B2, K2, comb or K3 (the fleet builds a tree's internal nodes
   on the host from the gathered digests). Then chaos: a `FaultProxy` in
   front of endpoint 1 is blacked out while the 10,000-lane batch and the
   block_cap build run, again and again until endpoint 1's breaker opens
   (endpoint 0's stays CLOSED), every result still equal and nothing on
   the CPU; after the blackout traffic re-closes the breaker and endpoint
   1 serves again; `Verifier.stats()` carries the `faults_*` counters; and
   `DaemonSupervisor` refuses a card daemon's environment.
24. Times: warm best of 3 of `commit_large`, `fast_sync_group`, the
   10,000-lane batch, `make_block` at block_cap and the parts' tree through
   the fleet, beside phase 22's one daemon and the same call in process,
   with the fleet's slice plan for each (slices, lanes and steals an
   endpoint); then where a wide path's time through a daemon goes: the
   client's chunk encoding, the daemon's decoding (run here on the same
   bytes), the commit check and the in-process marshal and kernel, and
   what is left (the socket and the daemon's scheduling), for
   `commit_large`, `make_block` at block_cap and the parts' stream.

Each path's launch counts are set to 0 just before it and read just after
(the daemons', in phases 21 and 23, read from their logs before and after).
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
DSM_LANES = 1025  # not a multiple of the 32-lane block: the last block is partial
DSM_TIME_LANES = (101, 401, DSM_LANES, 4096)
# lane counts that end in a partial warp (8 lanes) and a partial block (32)
RAGGED_LANES = (1, 7, 9, 33, 100, 1025)
TIME_LANES = (100, 1024, 4096, 10_000, 16_384)
# The limb products' rate: IMAD.WIDE (signed 32x32->64 with a 64-bit
# addend, one per limb product in the SASS), the plateau of phase 1's
# probe swept over chains and blocks an SM, whose loop holds IMAD.WIDE and
# nothing else but its counter and branch, on an H100 80GB HBM3 at 700 W:
# 8.35e12/s, half the 32-bit IMAD rate there (16.63e12/s; NVIDIA's 67
# TFLOP/s fp32 / 2 / 2 = 16.75e12): a wide product takes two multiply
# slots. Phase 1 logs this run's sweep beside it.
INT_MUL_PER_S = 8.35e12
HBM_BYTES_PER_S = 3.35e12
CSRC = "tendermint_tpu_torch/ops/csrc/"
KERNEL_NAMES = ("ed25519_verify", "ed25519_verify_b2", "ed25519_dsm")
COMB_NAMES = ("ed25519_comb", "ed25519_comb_tables")  # phases 13-17
COMB_TABLE_KEYS = (1, 100, 1000, 10_000)  # table builds timed in phase 17
COMB_JSON_KEYS = 100  # the table build of the kernels line: the 100-validator commit's
COMB_RAGGED_KEYS = (1, 7, 33, 64, 65, 1000)  # table builds held against the plain version in phase 13
COMB_PLAIN_CHUNK = 2500  # keys a plain build of phase 13's 10,000-key check
SMALL_POOL = 64  # phase 15's pool: 63 usable slots
# int32 decompress_plain's work a key, counted from its code (19
# multiplications, 255 squarings), in radix-2^25.5 limb products: the
# least time of a decompression on the card (phase 16)
DECOMPRESS_PRODUCTS_PER_KEY = 100 * 19 + 55 * 255
# phase 15's batches, lane ranges of the 100-validator commit: 40 keys; 50
# keys of which 40 new (so at least 40 - (63 - 40) = 17 evictions); all 100
# (more than the pool holds); 10 keys evicted by the second batch
SMALL_POOL_BATCHES = ((0, 40), (30, 80), (0, 100), (0, 10))
PROBE = "imad_rate"  # the multiply-rate probe of phase 1, not a kernel of any path
# the TPU (or XLA) kernel each one replaces, by file:line of its body
REPLACES = {
    "ed25519_verify": "tendermint_tpu/ops/ed25519_f32p.py:301",
    "ed25519_verify_b2": "tendermint_tpu/ops/ed25519_pallas.py:186",
    "ed25519_dsm": "tendermint_tpu/ops/ed25519.py:542",
    "ed25519_comb": "tendermint_tpu/ops/ed25519_comb.py:151",
    "ed25519_comb_tables": "tendermint_tpu/ops/ed25519_comb.py:208",
    # B1' is B1's kernel launched per shard: its pallas_call under shard_map
    "ed25519_verify_sharded": "tendermint_tpu/ops/ed25519_f32p.py:468",
    # B6, XLA: the hash kernels (K1, K2) and the tree rounds (K3)
    "ripemd160": "tendermint_tpu/ops/hashing.py:133",
    "sha256": "tendermint_tpu/ops/hashing.py:232",
    "merkle_tree": "tendermint_tpu/ops/merkle.py:126",
}
# phases 18-20: the hash plane (B6)
HASH_NAMES = ("hash_blocks", "merkle_tree")  # K1 and K2 share a source; K3
HASH_COUNTS = (1, 7, 33, 100, 1025)  # messages a K1 / K2 batch in phase 18
# where the block count changes (55/56, 119/120), the empty message, the
# tx cap and a 64 KB part: the first lanes of every phase-18 batch
HASH_EDGE_LENGTHS = (0, 55, 56, 63, 64, 119, 120, 10_240, 65_536)
# K3 against its plain version in phase 18; 336 is the part count of a
# block at the byte cap (22,020,096 / 65,536); around K3's cut (a round
# wider than one block's sweep of 512 nodes runs on a grid): 1,024 and
# 1,536 leaves, whose widest round is 512 (one block), 1,537 (513: the
# smallest tree on a grid) and 4,000 (two rounds on a grid)
TREE_LEAVES = (2, 3, 5, 7, 16, 33, 100, 336, 1024, 1536, 1537, 4000, 10_000)
# the kernels line's shapes: block_1mb's tx leaves (K1, K2) and part tree (K3)
HASH_JSON_BATCH, TREE_JSON_BATCH = ("block_1mb", "tx_leaves"), ("block_1mb", "part_tree")
# BASELINE.json's "PartSet Merkle-root + SimpleProof verify, 1MB block / 64KB
# parts": 4,000 transactions of 250 bytes
BLOCK_1MB_TXS, BLOCK_1MB_TX_BYTES = 4000, 250
BLOCK_TIME_NS = 1_760_000_000_000_000_000
APP_HASH = b"\x5a" * 20
# the hash kernels' instructions in the SASS, by opcode (LEA.HI and VIADD
# carry RIPEMD-160's rotate-and-add and its constants)
ALU_OPS = ("LOP3", "IADD3", "SHF", "LEA", "VIADD", "LDG", "STG")
# a RIPEMD-160 line's round constants as SASS immediates: the innermost
# loop that holds one runs that line (K1 and K3 run each line on a warp of
# its own, in a loop of its own or behind a branch on the warp)
RMD_LINE_MARKS = {"left": r"0x(5a827999|6ed9eba1|8f1bbcdc|a953fd4e)\b",
                  "right": r"0x(50a28be6|5c4dd124|6d703ef3|7a6d76e9)\b"}
SHARDS = 4  # B1' on one card: 4 shards over cuda:0
PROFILE_TRIES = 3  # traces device_ms takes before it gives up on a kernel
MIXED_SECP = 4  # secp256k1 validators of the 100-validator mixed commit
DEVD_HELD_S = 180  # phase 21: the daemon's start, probe, build, warm-up and bake-off
DEVD_STOP_S = 30  # the daemon's exit after the shutdown op, before it is killed
FLEET = 2  # phase 23: daemons on cuda:0 behind TENDERMINT_DEVD_SOCKS
FLEET_WARM = "1024"  # their warm-up shape (phase 21 ran the bake-off)
FLEET_BLACKOUT_S = 3.0  # phase 23: endpoint 1 dark behind its FaultProxy
FLEET_WAIT_S = 60.0  # the bound on endpoint 1's breaker opening, and re-closing
# phase 21's daemon launches beside each kernel's entry in the kernels line
DEVD_LAUNCH_KEYS = {"ed25519_verify": "b1", "ed25519_comb": "comb", "ed25519_comb_tables": "tables",
                    "ed25519_dsm": "dsm", "ripemd160": "ripemd160", "merkle_tree": "merkle_tree"}


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


def device_ms(fn, kernel: str, calls: int = 5) -> float:
    """The device time of one launch of the CUDA kernel whose name holds
    `kernel`, over `calls` calls of fn() (torch.profiler, after a warm-up
    call): the kernel alone, without the host's launch path that a CUDA
    event pair around a short kernel also holds. A trace that holds no
    event of the kernel (the profiler drops a trace's device events now
    and then) is taken again, up to PROFILE_TRIES traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum((getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0))
                    for e in prof.key_averages() if kernel in e.key)
        if total:
            return total / 1e3 / calls
        log({"phase": "profiler_retry", "kernel": kernel, "trace": attempt + 1})
    raise RuntimeError(f"the profiler saw no device time for {kernel} in {PROFILE_TRIES} traces")


def bound_ms(module, lanes: int) -> tuple[float, str]:
    """The least time the card could take for a kernel module's lanes: its
    limb products over the integer multiply rate, or its bytes over the
    memory rate, whichever is larger."""
    ops_ms = 1e3 * module.PRODUCTS_PER_LANE * lanes / INT_MUL_PER_S
    bytes_ms = 1e3 * module.BYTES_PER_LANE * lanes / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def ptxas_summary(build_log: str) -> list[dict]:
    """Per entry function of a build's `-Xptxas -v` output: registers,
    stack frame, spill stores and spill loads, static shared memory
    (bytes)."""
    import re

    out, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)'?", line)
        if m and "entry function" in line:
            cur = {"function": m.group(1)}
            out.append(cur)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and cur is not None:
            cur["static_smem_bytes"] = int(m.group(1))
    return out


def sass_counts(lib_path: str, marks: dict[str, str] | None = None) -> dict[str, dict]:
    """Per function in a library's SASS (cuobjdump): IMAD.WIDE of two
    registers (a limb product), IMAD.WIDE by an immediate (address
    arithmetic), other IMAD, the hash kernels' ALU_OPS (by opcode), and all
    instructions; and the same counts, with shuffles and local loads and
    stores, inside the function's longest loop (the widest backward branch:
    in B1 and dsm, one ladder step). With `marks` (label -> regex), also
    under "marked_loops" each label's loop: of the innermost loops around
    the instructions that match, the widest, with its addresses. The
    listing is kept beside the library (lib<name>.so.sass)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    with open(lib_path + ".sass", "w") as f:
        f.write(sass)
    listing, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            listing[fn] = []
        elif fn is not None and (m := re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)):
            listing[fn].append((int(m.group(1), 16), m.group(2)))

    def tally(instrs) -> dict[str, int]:
        c = {"IMAD.WIDE": 0, "IMAD.WIDE_imm": 0, "IMAD": 0, "SHFL": 0, "LDL": 0, "STL": 0,
             **{op: 0 for op in ALU_OPS}, "instructions": len(instrs)}
        for _, ins in instrs:
            if "IMAD.WIDE" in ins:
                c["IMAD.WIDE_imm" if re.search(r"IMAD\.WIDE\S* [^;]*, 0x", ins) else "IMAD.WIDE"] += 1
            else:
                for op in ("IMAD", "SHFL", "LDL", "STL"):
                    c[op] += op in ins
            # the hash kernels' ALU work, by opcode (a predicate guard first)
            base = ins.split()[1 if ins.startswith("@") else 0].split(".")[0]
            if base in ALU_OPS:
                c[base] += 1
        return c

    counts = {}
    for fn, instrs in listing.items():
        back = [(addr - int(m.group(1), 16), int(m.group(1), 16), addr) for addr, ins in instrs
                if (m := re.search(r"BRA\s+0x([0-9a-f]+)", ins)) and int(m.group(1), 16) < addr]
        counts[fn] = tally(instrs)
        if back:
            _, lo, hi = max(back)
            counts[fn]["longest_loop"] = tally([(a, ins) for a, ins in instrs if lo <= a <= hi])
        for label, pattern in (marks or {}).items():
            inner = {min(loop for loop in back if loop[1] <= addr <= loop[2])
                     for addr, ins in instrs
                     if re.search(pattern, ins) and any(lo <= addr <= hi for _, lo, hi in back)}
            if inner:
                _, lo, hi = max(inner)
                counts[fn].setdefault("marked_loops", {})[label] = {
                    "start": lo, "end": hi, **tally([(a, ins) for a, ins in instrs if lo <= a <= hi])}
    return counts


def check_multiply_rate(name: str, power: str) -> None:
    """Phase 1's check of the bound's yardstick. In the SASS: how many
    IMAD.WIDE one field multiplication and one squaring compile to, and so
    the limb products a B1, a B2 and a dsm lane issue; the static IMAD.WIDE count
    of each kernel library, and each probe loop's (one product a step, and
    nothing else but its counter and branch). On the card: the rate of the
    IMAD.WIDE microkernel and of a 32-bit IMAD one, in products per second
    over the whole card, swept over 4, 8, 16 and 32 chains a thread and 1,
    2, 4 and 8 blocks of 256 threads an SM; the plateau (the highest rate) is
    the yardstick, logged beside INT_MUL_PER_S."""
    import re

    import torch

    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops import kernels

    lib_of = {k: os.path.join(kernels.BUILD_DIR, f"lib{k}.so") for k in (PROBE, *KERNEL_NAMES)}
    probe = sass_counts(lib_of[PROBE])
    per_mul = next(c["IMAD.WIDE"] for f, c in probe.items() if "fe_mul_probe" in f)
    per_sq = next(c["IMAD.WIDE"] for f, c in probe.items() if "fe_sq_probe" in f)
    per_lane = {kname: {"sass": module.MULS_PER_LANE * per_mul + module.SQS_PER_LANE * per_sq,
                        "counted": module.PRODUCTS_PER_LANE}
                for kname, module in (("ed25519_verify", f32p), ("ed25519_verify_b2", b2),
                                      ("ed25519_dsm", ed32))}
    libs = {k: sass_counts(lib_of[k]) for k in KERNEL_NAMES}
    static = {k: sum(c["IMAD.WIDE"] for c in fns.values()) for k, fns in libs.items()}
    # the kernel function's longest loop: one two-bit ladder step of one
    # thread (B1, dsm) or one single-bit step (B2)
    loops = {k: next(c.get("longest_loop") for f, c in fns.items() if f"{k}_kernel" in f)
             for k, fns in libs.items()}
    log({"phase": "sass", "imad_wide_per_fe_mul": per_mul, "imad_wide_per_fe_sq": per_sq,
         "limb_products_per_lane": per_lane, "static_imad_wide_per_library": static,
         "kernel_longest_loop": loops, "probe_functions": probe})

    lib = kernels.load(PROBE)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, per_sm_products = 256, 256 * 8192 * 64  # the same work at every point of the sweep
    out = torch.empty(8 * sms * threads, dtype=torch.int64, device=DEVICE)
    # each probe loop's SASS: its products (IMAD.WIDE of two registers, or
    # IMAD; two a step wide, one narrow) and every other instruction (the
    # loop's counter and branch)
    loop_sass = {}
    for f, c in probe.items():
        m = re.search(r"imad_rate_kernelILb([01])ELi(\d+)E", f)
        if m and "longest_loop" in c:
            loop = c["longest_loop"]
            made = loop["IMAD.WIDE" if m.group(1) == "1" else "IMAD"]
            loop_sass[f"{'wide' if m.group(1) == '1' else 'narrow'}x{m.group(2)}"] = {
                "products": made, "other": loop["instructions"] - made}
    sweep, plateau = [], {}
    for wide, label in ((1, "imad_wide_per_s"), (0, "imad_per_s")):
        for chains in (4, 8, 16, 32):
            for per_sm in (1, 2, 4, 8):
                per_thread = per_sm_products // (per_sm * threads)
                blocks, iters = per_sm * sms, per_thread // (chains * (1 + wide))

                def launch() -> None:
                    rc = lib.tm_imad_rate(wide, chains, out.data_ptr(), iters, blocks, threads,
                                          torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"imad_rate launch failed: cudaError {rc}")

                rate = blocks * threads * iters * chains * (1 + wide) / (cuda_ms(launch) / 1e3)
                sweep.append({"wide": wide, "chains": chains, "blocks_per_sm": per_sm, "per_s": rate})
                plateau[label] = max(plateau.get(label, 0.0), rate)
    log({"phase": "multiply_rate", "card": name, "power_limit": power, "sms": sms,
         "threads": threads, "loop_sass": loop_sass, "sweep": sweep, **plateau,
         "wide_over_narrow": plateau["imad_wide_per_s"] / plateau["imad_per_s"],
         "int_mul_per_s": INT_MUL_PER_S,
         "int_mul_per_s_over_plateau": INT_MUL_PER_S / plateau["imad_wide_per_s"]})


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
    ptxas = {}
    for kname, build_s in kernels.build_all(KERNEL_NAMES + COMB_NAMES + HASH_NAMES + (PROBE,)).items():
        log({"phase": "build", "kernel": kname, "seconds": build_s})
        ptxas[kname] = ptxas_summary(kernels.build_log.get(kname, ""))
        for entry in ptxas[kname]:
            log({"phase": "ptxas", "kernel": kname, **entry})
    check_multiply_rate(name, power)
    for kname in COMB_NAMES:  # IMAD.WIDE a comb step (two stages: 200 a thread) and a table addition
        log({"phase": "sass", "kernel": kname,
             "functions": sass_counts(os.path.join(kernels.BUILD_DIR, f"lib{kname}.so"))})
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
    for n in RAGGED_LANES:
        args, _, _ = f32p.marshal_device_args(mixed[:n], DEVICE)
        got = f32p.verify_lanes(*args)
        want = f32.verify_plain(args[0].float(), args[1].float(), args[2].float(), args[3],
                                args[4].int(), args[5].int()).to(torch.int32)
        err = int((got - want).abs().max().item())
        max_err = max(max_err, err)
        log({"phase": "kernel_vs_plain", "shape": "ragged", "lanes": n, "max_abs_err": err})
        if err != 0:
            bad = torch.nonzero(got != want).flatten()[:10].tolist()
            raise AssertionError(f"ragged {n}: kernel disagrees with verify_plain at lanes {bad}")
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

    # -- phases 13 to 17: the comb path and the torch compositions --------------
    comb_pool, comb_err = check_comb(shapes, whole, pubs, rng)
    comb_launches = comb_main_path(name, power, commits, forged, sub_quorum)
    comb_small_pool(commits)
    registry_compositions(name, power, commits, mixed)
    comb_times = time_comb(name, power, comb_pool, shapes, group_items, pubs)
    del comb_pool

    # -- phases 18 to 20: the hash plane ----------------------------------------
    hash_err, hash_plain_s = check_hash_kernels(rng)
    block_txs, params = make_block_txs(rng)
    hash_launches, built, hash_calls = hash_main_path(commits["commit_small"], block_txs, params)
    path_err = check_path_kernels(hash_calls, block_txs)
    hash_entries = time_hashes(name, power, commits["commit_small"], block_txs, built, hash_calls,
                               params, hash_plain_s)
    del hash_calls

    # -- phases 21 and 22: the device daemon --------------------------------------
    one_daemon = devd_phase(name, power, commits, forged, sub_quorum, shapes, block_txs, params)
    devd_launches = one_daemon["launches"]

    # -- phases 23 and 24: the multi-daemon plane ----------------------------------
    fleet_launches = fleet_phase(name, power, commits, forged, sub_quorum, shapes, block_txs, params,
                                 one_daemon)

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
    for kname in COMB_NAMES:
        entries.append({
            "name": kname, "route": "cuda", "source": f"{CSRC}{kname}.cu",
            "replaces": REPLACES[kname], "launches": comb_launches[kname], "max_abs_err": comb_err[kname],
            **comb_times[kname], "library_ms": None, "ptxas": ptxas[kname],
        })
    # a hash kernel's difference: the largest over phase 18's batches, the
    # main path's own calls and phase 20's compared runs (the line's shape)
    for entry in hash_entries:
        kname = entry["name"]
        err = max(hash_err[kname], path_err[kname], entry.pop("max_abs_err"))
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"{CSRC}{'merkle_tree' if kname == 'merkle_tree' else 'hash_blocks'}.cu",
            "replaces": REPLACES[kname], "launches": hash_launches[kname],
            "max_abs_err": err, **entry,
            "ptxas": ptxas["merkle_tree" if kname == "merkle_tree" else "hash_blocks"],
        })
    for entry in entries:
        if entry["name"] in DEVD_LAUNCH_KEYS:
            entry["devd_launches"] = devd_launches[DEVD_LAUNCH_KEYS[entry["name"]]]
            entry["fleet_launches"] = fleet_launches[DEVD_LAUNCH_KEYS[entry["name"]]]
    log({"kernels": entries})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


def check_b2(shapes, rng) -> int:
    """Phase 5: B2's verdicts equal its plain version's on the mixed lanes,
    B1's on every shape, both on the first RAGGED_LANES of the mixed lanes
    (partial warps and blocks), and crypto.ed25519.verify on a sample.
    Returns the largest difference seen (0 when all agree)."""
    import torch

    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2

    max_err = 0
    plain_mixed = None
    for label, items in shapes.items():
        args, valid, n = f32p.marshal_device_args(items, DEVICE)
        t0 = time.perf_counter()
        got = b2.verify_lanes(*args)
        against = {"b1": f32p.verify_lanes(*args)}
        if label == "mixed":
            against["plain"] = plain_mixed = b2.verify_plain(*args).to(torch.int32)
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
    # a lane's verdict depends on its own inputs only, so the plain version's
    # first n mixed lanes are its verdicts on mixed[:n]
    for n in RAGGED_LANES:
        args, _, _ = f32p.marshal_device_args(shapes["mixed"][:n], DEVICE)
        got = b2.verify_lanes(*args)
        against = {"b1": f32p.verify_lanes(*args), "plain": plain_mixed[:n]}
        errs = {k: int((got - w).abs().max().item()) for k, w in against.items()}
        max_err = max(max_err, *errs.values())
        log({"phase": "b2_vs_plain_and_b1", "shape": "ragged", "lanes": n, "max_abs_err": errs})
        for k, w in against.items():
            if errs[k] != 0:
                bad = torch.nonzero(got != w).flatten()[:10].tolist()
                raise AssertionError(f"ragged {n}: B2 disagrees with {k} at lanes {bad}")
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
    for n in RAGGED_LANES[:-1]:  # 1025 is DSM_LANES, just compared
        part = ed32.marshal_dsm_args(terms[:n], DEVICE)
        got_n = torch.stack(ed32.dsm_lanes(*part))
        err_n = int((got_n.int() - want[..., :n].int()).abs().max().item())
        log({"phase": "dsm_vs_plain", "shape": "ragged", "lanes": n, "max_abs_err": err_n})
        if err_n != 0:
            bad = torch.nonzero((got_n != want[..., :n]).any(dim=(0, 1))).flatten()[:10].tolist()
            raise AssertionError(f"ragged {n}: dsm kernel disagrees with dsm_plain at lanes {bad}")
        err = max(err, err_n)
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

    v = verifier_under("pallas", lambda: Verifier(device=DEVICE))
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


# -- phases 13 to 17: the comb path (B4) and the torch compositions (B3, B5) ---


def key_rows(pubs):
    """(k, 32) uint8 canonical affine x and y rows of compressed keys
    (native batch decompression)."""
    from tendermint_tpu_torch.ops import ed25519_f32 as f32

    xs, ys, ok = f32._decompress_rows([bytes(p) for p in pubs])
    if not ok.all():
        raise AssertionError("a validator key did not decompress")
    return xs, ys


def comb_key_rows(pubs):
    """(32, k) uint8 canonical affine rows of Q = -A, as CombPool.ensure
    hands them to the table build."""
    from tendermint_tpu_torch.ops import ed25519_comb as comb

    xs, ys = key_rows(pubs)
    qx = np.stack([np.frombuffer(comb._neg_x_bytes(x.tobytes()), dtype=np.uint8) for x in xs], axis=1)
    return np.ascontiguousarray(qx), np.ascontiguousarray(ys.T)


def niels_reference(pub: bytes) -> np.ndarray:
    """A key's (1024, 96) comb table from the pure-Python group law: entry
    v of position p is v * 16^p * (-A) in niels form."""
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.ops import ed25519_comb as comb

    x, y = _affine(ed.point_decompress(pub))
    gp = ((-x) % ed.P, y, 1, (-x) * y % ed.P)
    rows = np.zeros((comb.W_POS, comb.W_ENT, comb.COORD_ROWS), dtype=np.uint8)
    for p in range(comb.W_POS):
        rows[p, 0, 0] = rows[p, 0, 32] = 1
        acc = gp
        for v in range(1, comb.W_ENT):
            rows[p, v] = comb._niels_rows_np(*_affine(acc)).astype(np.uint8)
            acc = ed.point_add(acc, gp)
        for _ in range(4):
            gp = ed.point_add(gp, gp)
    return rows.reshape(-1, comb.COORD_ROWS)


def comb_lane_args(pool, items):
    """Lease (building tables where needed) and marshal items for the comb
    kernel: (the kernel's args after the tables, valid, slots)."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    n = len(items)
    planes, rs, valid = f32p.host_planes(items, n)
    slots = np.zeros(n, dtype=np.int32)
    vidx = np.flatnonzero(valid)
    if len(vidx):
        slots[vidx], _ = pool.ensure([items[i][0] for i in vidx], planes[0].T[vidx], planes[1].T[vidx])
    with pool.on_stream():
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
                for a in (slots, planes[2], rs, planes[3], planes[4])]
    torch.cuda.synchronize()
    return args, valid, slots, planes


def check_comb(shapes, whole, pubs, rng):
    """Phase 13: both comb kernels against their plain versions. Returns
    (the pool holding every validator's table, the largest difference per
    kernel)."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_comb as comb
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    err = {"ed25519_comb_tables": 0, "ed25519_comb": 0}
    # the tables of 1 to 1000 keys (two 32-position blocks a key), bytes
    # exactly, slot 0 untouched
    for k in COMB_RAGGED_KEYS:
        qx, qy = comb_key_rows(pubs[:k])
        pool = torch.zeros(((k + 1) * comb.ROWS_PER_SLOT, comb.COORD_ROWS), dtype=torch.uint8, device=DEVICE)
        kx, ky = torch.from_numpy(qx).to(DEVICE), torch.from_numpy(qy).to(DEVICE)
        comb.build_lanes(pool, kx, ky, torch.arange(1, k + 1, dtype=torch.int32, device=DEVICE))
        want = comb.build_tables_plain(kx.float(), ky.float()).to(torch.uint8)
        got = pool.view(k + 1, comb.ROWS_PER_SLOT, comb.COORD_ROWS)
        torch.cuda.synchronize()
        e = int((got[1:].int() - want.int()).abs().max().item())
        err["ed25519_comb_tables"] = max(err["ed25519_comb_tables"], e, int(got[0].int().abs().max().item()))
        log({"phase": "comb_tables_vs_plain", "keys": k, "max_abs_err": e, "slot0_zero": not got[0].any().item()})
        if err["ed25519_comb_tables"]:
            bad = torch.nonzero((got[1:] != want).any(dim=(1, 2))).flatten()[:10].tolist()
            raise AssertionError(f"table kernel disagrees with build_tables_plain at {k} keys: keys {bad} "
                                 "(or slot 0 written)")
        del pool, want, got

    # every validator's table in one launch, in the pool the verdicts use
    cpool = comb.CombPool(capacity=len(pubs) + 128, max_capacity=len(pubs) + 128, device=DEVICE)
    t0 = time.perf_counter()
    leased, _ = cpool.ensure(list(pubs), *key_rows(pubs))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rows = cpool._pool.view(-1, comb.ROWS_PER_SLOT, comb.COORD_ROWS)
    sample = rng.choice(len(pubs), size=8, replace=False)
    equal = [torch.equal(rows[int(leased[j])], torch.from_numpy(niels_reference(pubs[j])).to(DEVICE))
             for j in sample]
    log({"phase": "comb_tables_vs_reference", "keys": len(pubs), "sampled": [int(j) for j in sample],
         "equal": equal, "ensure_and_build_s": build_s, "stats": cpool.stats})
    if not all(equal):
        raise AssertionError("the 10,000-key table build disagrees with the pure-Python niels table")
    # and every one of its tables byte for byte the plain version's, in
    # chunks the plain version's intermediates fit
    qx, qy = comb_key_rows(pubs)
    slot_of = torch.from_numpy(np.asarray(leased, dtype=np.int64)).to(DEVICE)
    e = 0
    for lo in range(0, len(pubs), COMB_PLAIN_CHUNK):
        hi = min(lo + COMB_PLAIN_CHUNK, len(pubs))
        want = comb.build_tables_plain(*(torch.from_numpy(np.ascontiguousarray(a[:, lo:hi])).to(DEVICE).float()
                                         for a in (qx, qy))).to(torch.uint8)
        e = max(e, int((rows[slot_of[lo:hi]].int() - want.int()).abs().max().item()))
        del want
    err["ed25519_comb_tables"] = max(err["ed25519_comb_tables"], e)
    log({"phase": "comb_tables_vs_plain", "keys": len(pubs), "max_abs_err": e})
    if e:
        raise AssertionError(f"the {len(pubs)}-key table build disagrees with build_tables_plain")

    # verdicts: every phase-2 lane set and the ragged counts
    cases = [(label, items, whole[label]["b1"]) for label, items in shapes.items()]
    cases += [(f"ragged_{n}", shapes["mixed"][:n], whole["mixed"]["b1"][:n]) for n in RAGGED_LANES]
    for label, items, b1_raw in cases:
        n = len(items)
        args, valid, _, _ = comb_lane_args(cpool, items)
        t0 = time.perf_counter()
        with cpool.on_stream():
            got = comb.comb_lanes(cpool._pool, cpool.table_b(), *args)
            plain = comb.verify_comb_plain(cpool._pool, cpool.table_b(), args[0], args[1].float(),
                                           args[2], args[3].int(), args[4].int()).to(torch.int32)
        torch.cuda.synchronize()
        e = int((got - plain).abs().max().item()) if n else 0
        err["ed25519_comb"] = max(err["ed25519_comb"], e)
        verdicts = f32p.materialize_verdicts(got.cpu(), valid, n)
        b1 = f32p.materialize_verdicts(b1_raw, valid, n)
        log({"phase": "comb_vs_plain_and_b1", "shape": label, "lanes": n, "accepted": int(verdicts.sum()),
             "max_abs_err": e, "b1_disagree": int((verdicts != b1).sum()),
             "seconds": time.perf_counter() - t0})
        if e:
            bad = torch.nonzero(got != plain).flatten()[:10].tolist()
            raise AssertionError(f"{label}: comb kernel disagrees with verify_comb_plain at lanes {bad}")
        if (verdicts != b1).any():
            raise AssertionError(f"{label}: comb verdicts disagree with B1's at {np.flatnonzero(verdicts != b1)[:10]}")
        if label in ("commit_small", "fast_sync_group", "commit_large") and not verdicts.all():
            raise AssertionError(f"{label}: comb rejected a valid commit signature")
    return cpool, err


def comb_expected(keys, seen: dict, built: set) -> dict:
    """The launches one comb batch of these lanes' keys makes under the
    second-sight policy (MIN_SIGHT 2), updating `seen` and `built` as the
    module does: B1 for lanes whose key has no table and is seen for the
    first time, comb for the rest, one table-build launch if any of their
    keys has no table yet."""
    for k in set(keys):
        seen[k] = seen.get(k, 0) + 1
    comb_keys = {k for k in keys if k in built or seen[k] >= 2}
    new = comb_keys - built
    built |= comb_keys
    return {"b1": int(any(k not in comb_keys for k in keys)), "comb": int(bool(comb_keys)),
            "tables": int(bool(new)), "new_keys": len(new)}


def comb_main_path(name, power, commits, forged, sub_quorum) -> dict[str, int]:
    """Phase 14: the phase-3 commits through a Verifier built under
    TENDERMINT_TPU_KERNEL=comb, each twice after reset_default_pool(),
    then the refused commits. Returns the launches of each comb kernel."""
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_comb as comb
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops.gateway import Verifier

    v = verifier_under("comb", lambda: Verifier(device=DEVICE))
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
    keys_of = {"commit_small": [vs100.get_by_index(i)[1].pub_key.raw for i in range(vs100.size())],
               "fast_sync_group": [vs1000.get_by_index(i)[1].pub_key.raw for i in range(vs1000.size())],
               "commit_large": [vs10k.get_by_index(i)[1].pub_key.raw for i in range(vs10k.size())]}
    comb.reset_default_pool()
    seen, built, passes, wall = {}, set(), [], {}

    def counts():
        return {"b1": f32p.launches, "comb": comb.launches, "tables": comb.table_launches,
                "b2": b2.launches, "dsm": ed32.launches}

    f32p.launches = b2.launches = ed32.launches = comb.launches = comb.table_launches = 0
    for label, fn in runs.items():
        for rep in (1, 2):
            want = comb_expected(keys_of[label], seen, built)
            before = counts()
            wall[label, rep] = timed(fn)
            got = {k: counts()[k] - before[k] for k in before}
            passes.append({"commit": label, "pass": rep, "launches": got, "expected": want,
                           "wall_s": wall[label, rep]})
            if got != {"b1": want["b1"], "comb": want["comb"], "tables": want["tables"], "b2": 0, "dsm": 0}:
                raise AssertionError(f"{label} pass {rep}: launches {got}, expected {want}")
            if rep == 2 and got["b1"]:
                raise AssertionError(f"{label}: a second pass launched B1")
    refusals = {}
    for label, commit, want in (("forged", forged, "invalid signature"),
                                ("sub_quorum", sub_quorum, "insufficient voting power")):
        refusals[label] = expect_refusal(label, lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier()), want)
    launches = counts()
    stats, pool = v.stats(), comb.default_pool(DEVICE)
    log({"phase": "comb_main_path", "kernel": v.kernel, "passes": passes, "launches": launches,
         "stats": stats, "pool": pool.stats, "capacity": pool.capacity, "refused": refusals})
    if launches != {"b1": 3, "comb": 7, "tables": 3, "b2": 0, "dsm": 0}:
        raise AssertionError(f"expected 3 B1, 7 comb and 3 table-build launches: {launches}")
    if pool.stats["build_keys"] != len(keys_of["commit_large"]) or stats["cpu_sigs"] != 0:
        raise AssertionError(f"expected one table a distinct key and no CPU lane: {pool.stats}, {stats}")
    # where a warm comb commit's host time goes, stage by stage (every key
    # has its table): the sight counts, the marshal, the leases, the launch
    large = recorded_items(vs10k, 1, bid10k, c10k)
    keys = [it[0] for it in large]
    planes, rs, _ = f32p.host_planes(large, len(large))
    xs, ys = planes[0].T, planes[1].T
    slots, _ = pool.ensure(keys, xs, ys)
    log({"phase": "comb_commit_breakdown", "card": name, "power_limit": power, "lanes": len(large),
         "structural_and_tally_s": min(timed(lambda: recorded_items(vs10k, 1, bid10k, c10k))
                                       for _ in range(3)),
         "bump_seen_s": min(timed(lambda: comb._bump_seen(set(keys))) for _ in range(3)),
         "host_planes_s": min(timed(lambda: f32p.host_planes(large, len(large))) for _ in range(3)),
         "ensure_s": min(timed(lambda: pool.ensure(keys, xs, ys)) for _ in range(3)),
         "launch_and_resolve_s": min(timed(lambda: pool.launch(slots, planes, rs)()) for _ in range(3)),
         "verify_batch_s": min(timed(lambda: comb.verify_batch(large, DEVICE)) for _ in range(3))})
    for label, fn in runs.items():
        log({"phase": "comb_commit_time", "card": name, "power_limit": power, "commit": label, "first_pass_s": wall[label, 1],
             "second_pass_s": wall[label, 2], "warm_best_of_3_s": min(timed(fn) for _ in range(3))})
    return {"ed25519_comb": launches["comb"], "ed25519_comb_tables": launches["tables"]}


def verifier_under(kernel: str, make):
    """make(), a Verifier, built under TENDERMINT_TPU_KERNEL=kernel (the
    knob is read once, at construction) and checked to run that kernel."""
    before = os.environ.get("TENDERMINT_TPU_KERNEL")
    os.environ["TENDERMINT_TPU_KERNEL"] = kernel
    try:
        v = make()
    finally:
        if before is None:
            del os.environ["TENDERMINT_TPU_KERNEL"]
        else:
            os.environ["TENDERMINT_TPU_KERNEL"] = before
    if v.kernel != kernel:
        raise AssertionError(f"TENDERMINT_TPU_KERNEL={kernel} built a {v.kernel} verifier")
    return v


def comb_small_pool(commits) -> None:
    """Phase 15: a SMALL_POOL-slot pool as the card's default pool, after
    phase 14 has seen every key twice, through SMALL_POOL_BATCHES: evictions,
    a batch of more keys than the pool holds (PoolExhausted: B1, no comb
    launch), then evicted keys again (rebuilt). Every verdict must be
    right."""
    from tendermint_tpu_torch.ops import ed25519_comb as comb
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p

    vs100, bid100, c100 = commits["commit_small"]
    items = recorded_items(vs100, 1, bid100, c100)
    pool = comb.CombPool(capacity=SMALL_POOL, max_capacity=SMALL_POOL, device=DEVICE)
    comb.set_default_pool(pool)
    steps = []
    (a_lo, a_hi), (b_lo, b_hi), _, _ = SMALL_POOL_BATCHES
    min_evictions = (b_hi - a_hi) - (SMALL_POOL - 1 - (a_hi - a_lo))
    for (lo, hi), want in zip(SMALL_POOL_BATCHES, ((0, 1, 1), (0, 1, 1), (1, 0, 0), (0, 1, 1))):
        label = f"keys {lo}-{hi - 1}"
        before = (f32p.launches, comb.launches, comb.table_launches)
        ok = comb.verify_batch(items[lo:hi], DEVICE)
        got = tuple(a - b for a, b in zip((f32p.launches, comb.launches, comb.table_launches), before))
        steps.append({"batch": label, "launches_b1_comb_tables": got, "stats": dict(pool.stats),
                      "all_accepted": bool(ok.all())})
        if got != want or not ok.all():
            raise AssertionError(f"small pool, {label}: launches {got} (expected {want}), "
                                 f"accepted {int(ok.sum())} of {hi - lo}")
    log({"phase": "comb_small_pool", "slots": SMALL_POOL, "steps": steps})
    if pool.stats["evictions"] < min_evictions or pool.stats["grows"]:
        raise AssertionError(f"expected evictions and no growth: {pool.stats}")
    comb.reset_default_pool()


def registry_compositions(name, power, commits, mixed) -> None:
    """Phase 16: the 100-validator commit under f32 and int32 and through
    a 4-shard f32 ShardedVerifier (torch compositions: no kernel
    launches); f32's, int32's and decompress_batch's outputs on the card
    against the reference and the CPU."""
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_comb as comb
    from tendermint_tpu_torch.ops import ed25519_f32 as f32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import ed25519_pallas as b2
    from tendermint_tpu_torch.ops.gateway import ShardedVerifier, Verifier

    tag = {"card": name, "power_limit": power}
    vs100, bid100, c100 = commits["commit_small"]
    sample = mixed[:256]
    ref = [ed.verify(*it) for it in sample]
    for label, module in (("f32", f32), ("int32", ed32)):
        if list(module.verify_batch(sample, DEVICE)) != ref:
            raise AssertionError(f"{label} on the card disagrees with crypto.ed25519.verify")
    keys = [vs100.get_by_index(i)[1].pub_key.raw for i in range(vs100.size())] + [b"\xff" * 32]
    for a, b in zip(ed32.decompress_batch(keys, DEVICE), ed32.decompress_batch(keys, "cpu")):
        if not np.array_equal(a, b):
            raise AssertionError("int32 decompress_batch on the card disagrees with the CPU")
    log({"phase": "composition_time", **tag, "keys": len(keys), "lanes": len(mixed),
         "decompress_batch_s": min(timed(lambda: ed32.decompress_batch(keys, DEVICE)) for _ in range(3)),
         "decompress_bound_ms": 1e3 * DECOMPRESS_PRODUCTS_PER_KEY * len(keys) / INT_MUL_PER_S,
         "f32_verify_batch_s": timed(lambda: f32.verify_batch(mixed, DEVICE)),
         "int32_verify_batch_s": timed(lambda: ed32.verify_batch(mixed, DEVICE))})

    for label, v in (("f32", verifier_under("f32", lambda: Verifier(device=DEVICE))),
                     ("int32", verifier_under("int32", lambda: Verifier(device=DEVICE))),
                     (f"sharded_f32_{SHARDS}",
                      verifier_under("f32", lambda: ShardedVerifier(shard_meshes()["one_card"])))):
        f32p.launches = b2.launches = ed32.launches = comb.launches = comb.table_launches = 0
        run = lambda: vs100.verify_commit(  # noqa: E731
            CHAIN_ID, bid100, 1, c100, batch_verifier=v.commit_batch_verifier())
        first = timed(run)
        launches = {"b1": f32p.launches, "b2": b2.launches, "dsm": ed32.launches,
                    "comb": comb.launches, "tables": comb.table_launches}
        stats = v.stats()
        log({"phase": "composition_path", **tag, "kernel": label, "validators": vs100.size(),
             "launches": launches, "stats": stats, "layout": getattr(v, "last_shard_layout", None),
             "first_s": first, "warm_best_of_3_s": min(timed(run) for _ in range(3))})
        if any(launches.values()) or stats["tpu_batches"] != 1 or stats["cpu_sigs"]:
            raise AssertionError(f"{label}: expected one device batch and no kernel: {launches}, {stats}")


def comb_bound_ms(pool, args, lanes: int) -> tuple[float, float]:
    """The comb verify's least time on these inputs, by operations (its
    limb products over the multiply rate) and by bytes (the distinct table
    rows its lanes gather, the lane arguments and the verdicts over the
    memory rate); the bound is the larger."""
    from tendermint_tpu_torch.ops import ed25519_comb as comb

    slots, ry, rs, s8, h8 = (a.cpu().numpy() for a in args)
    pos = np.arange(comb.W_POS)[:, None]

    def digits(b8):
        return np.stack([b8 & 15, b8 >> 4], axis=1).reshape(comb.W_POS, -1).astype(np.int64)

    rows_a = np.unique((slots[None, :].astype(np.int64) * comb.W_POS + pos) * comb.W_ENT + digits(h8))
    rows_b = np.unique(pos * comb.W_ENT + digits(s8))
    moved = (len(rows_a) + len(rows_b)) * comb.COORD_ROWS + lanes * (3 * 32 + 3 * 4)
    return 1e3 * comb.PRODUCTS_PER_LANE * lanes / INT_MUL_PER_S, 1e3 * moved / HBM_BYTES_PER_S


def larger(ops_ms: float, bytes_ms: float) -> tuple[float, str]:
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def time_comb(name, power, pool, shapes, group_items, pubs) -> dict[str, dict]:
    """Phase 17: the comb kernel at TIME_LANES lanes of commit signatures
    (the 10,000-validator commit's, then the fast-sync group's: one key a
    lane, every table in `pool`), the table build at COMB_TABLE_KEYS keys,
    and both plain versions. Returns the kernels line's numbers per
    kernel."""
    import torch

    from tendermint_tpu_torch.ops import ed25519_comb as comb

    tag = {"card": name, "power_limit": power}
    lanes_src = (shapes["commit_large"] + group_items) * 2
    out = {}
    for lanes in TIME_LANES:
        args, _, _, _ = comb_lane_args(pool, lanes_src[:lanes])
        with pool.on_stream():
            ms = cuda_ms(lambda: comb.comb_lanes(pool._pool, pool.table_b(), *args))
        ops_ms, bytes_ms = comb_bound_ms(pool, args, lanes)
        b_ms, b_by = larger(ops_ms, bytes_ms)
        log({"phase": "comb_time", **tag, "lanes": lanes, "ms": ms, "sigs_per_s": lanes / ms * 1e3,
             "bound_ms": b_ms, "bound_by": b_by, "ops_ms": ops_ms, "bytes_ms": bytes_ms})
        if lanes == MIXED_LANES:
            with pool.on_stream():
                plain_ms = cuda_ms(lambda: comb.verify_comb_plain(
                    pool._pool, pool.table_b(), args[0], args[1].float(), args[2], args[3].int(),
                    args[4].int()), reps=3, warmup=1)
            log({"phase": "comb_plain_time", **tag, "lanes": lanes, "ms": plain_ms})
            out["ed25519_comb"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                   "lanes": lanes}

    qx, qy = comb_key_rows(pubs[: max(COMB_TABLE_KEYS)])
    for keys in COMB_TABLE_KEYS:
        rows = torch.zeros(((keys + 1) * comb.ROWS_PER_SLOT, comb.COORD_ROWS), dtype=torch.uint8,
                           device=DEVICE)
        kx, ky = (torch.from_numpy(np.ascontiguousarray(a[:, :keys])).to(DEVICE) for a in (qx, qy))
        slots = torch.arange(1, keys + 1, dtype=torch.int32, device=DEVICE)
        ms = cuda_ms(lambda: comb.build_lanes(rows, kx, ky, slots), reps=5, warmup=1)
        ops_ms = 1e3 * comb.PRODUCTS_PER_KEY * keys / INT_MUL_PER_S
        bytes_ms = 1e3 * comb.BYTES_PER_KEY * keys / HBM_BYTES_PER_S
        b_ms, b_by = larger(ops_ms, bytes_ms)
        # the kernel's own products (one inversion a position) at the same rate
        kernel_ops_ms = 1e3 * comb.KERNEL_PRODUCTS_PER_KEY * keys / INT_MUL_PER_S
        log({"phase": "comb_tables_time", **tag, "keys": keys, "ms": ms, "keys_per_s": keys / ms * 1e3,
             "bound_ms": b_ms, "bound_by": b_by, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
             "kernel_ops_ms": kernel_ops_ms})
        if keys == COMB_JSON_KEYS:
            plain_ms = cuda_ms(lambda: comb.build_tables_plain(kx.float(), ky.float()), reps=3, warmup=1)
            log({"phase": "comb_tables_plain_time", **tag, "keys": keys, "ms": plain_ms})
            out["ed25519_comb_tables"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                          "bound_by": b_by, "keys": keys}
        del rows
    torch.cuda.synchronize()
    return out


# -- phases 18 to 20: the hash plane (B6) -------------------------------------

_M32 = 0xFFFFFFFF


def hash_messages(rng, n: int) -> list[bytes]:
    """n messages: HASH_EDGE_LENGTHS first (from 7 messages on every batch
    holds the block-count edges, from 9 on a 10,240-byte transaction and a
    64 KB part), then random lengths up to 2,000 bytes."""
    lengths = list(HASH_EDGE_LENGTHS) + [int(x) for x in rng.integers(0, 2001, size=n)]
    return [rng.bytes(k) for k in lengths[:n]]


def check_hash_kernels(rng) -> tuple[dict[str, int], dict[str, float]]:
    """Phase 18: K1 and K2 at HASH_COUNTS messages against their plain
    versions (run once, on the card, over the widest batch: a lane's digest
    depends on its own message only) and against crypto.hashing.ripemd160
    / hashlib.sha256, lane for lane; K3 at TREE_LEAVES leaves against
    `_run_tree` on the card and FlatTree.from_leaf_digests, slot for slot.
    Returns the largest difference a kernel and the plain versions'
    seconds over the widest batch."""
    import torch

    from tendermint_tpu_torch.crypto.hashing import ripemd160
    from tendermint_tpu_torch.merkle.simple import FlatTree, leaf_hash
    from tendermint_tpu_torch.ops import hashing as th
    from tendermint_tpu_torch.ops import merkle as tm

    msgs = hash_messages(rng, max(HASH_COUNTS))
    errs, plain_s = {}, {}
    for kname, le, lanes, plain, to_bytes, ref in (
            ("ripemd160", True, th.ripemd160_lanes, th.ripemd160_words, th.digests_to_bytes_le,
             ripemd160),
            ("sha256", False, th.sha256_lanes, th.sha256_words, th.digests_to_bytes_be,
             lambda m: hashlib.sha256(m).digest())):
        args = th.to_device(*th.pack_ragged(msgs, le), DEVICE)
        t0 = time.perf_counter()
        want = plain(*args)
        torch.cuda.synchronize()
        plain_s[kname] = time.perf_counter() - t0
        log({"phase": "hash_plain_run", "kernel": kname, "messages": len(msgs),
             "max_blocks": int(args[2].max().item()), "seconds": plain_s[kname]})
        refs = [ref(m) for m in msgs]
        errs[kname] = 0
        for c in HASH_COUNTS:
            got = lanes(*th.to_device(*th.pack_ragged(msgs[:c], le), DEVICE))
            err = int(((got.long() & _M32) - want[:c]).abs().max().item())
            equal_ref = to_bytes(got) == refs[:c]
            log({"phase": "hash_vs_plain", "kernel": kname, "messages": c,
                 "lengths": sorted({len(m) for m in msgs[:c]} & set(HASH_EDGE_LENGTHS)),
                 "max_abs_err": err, "equal_reference": equal_ref})
            if err or not equal_ref:
                raise AssertionError(f"{kname} at {c} messages disagrees with its plain version "
                                     f"({err}) or the reference ({equal_ref})")
            errs[kname] = max(errs[kname], err)
    errs["merkle_tree"] = 0
    for n in TREE_LEAVES:
        digests = [leaf_hash(b"leaf-%d" % i) for i in range(n)]
        nodes = tm._digest_rows(digests, torch.device(DEVICE))
        left, right, out, _, _, _, rounds = tm._dense_schedule(n)
        sched = [torch.from_numpy(a).long().to(DEVICE) for a in (left, right, out)]
        want = tm._run_tree(nodes.long() & _M32, *sched, rounds)[: 2 * n - 1]
        got = tm.tree_lanes(nodes, n)[: 2 * n - 1]
        err = int(((got.long() & _M32) - want).abs().max().item())
        equal_flat = th.digests_to_bytes_le(got) == FlatTree.from_leaf_digests(digests).nodes
        log({"phase": "merkle_vs_plain", "leaves": n, "rounds": rounds, "max_width": left.shape[1],
             "max_abs_err": err, "equal_flat_tree": equal_flat})
        if err or not equal_flat:
            raise AssertionError(f"merkle_tree at {n} leaves disagrees with its plain version "
                                 f"({err}) or FlatTree ({equal_flat})")
    torch.cuda.synchronize()
    return errs, plain_s


def make_block_txs(rng):
    """({label: txs}, ConsensusParams): `block_1mb`, BASELINE.json's 1 MB
    block of 64 KB parts (BLOCK_1MB_TXS transactions of BLOCK_1MB_TX_BYTES),
    and `block_cap`, types/params.py's caps: max_txs transactions of 1 to
    4,096 bytes, every 1,000th at the tx cap of 10,240."""
    from tendermint_tpu_torch.types.params import ConsensusParams

    params = ConsensusParams()
    raw = rng.bytes(BLOCK_1MB_TXS * BLOCK_1MB_TX_BYTES)
    small = [raw[i * BLOCK_1MB_TX_BYTES:(i + 1) * BLOCK_1MB_TX_BYTES] for i in range(BLOCK_1MB_TXS)]
    lengths = rng.integers(1, 4097, size=params.block_size.max_txs)
    lengths[999::1000] = params.tx_size.max_bytes
    buf = rng.bytes(int(lengths.sum()))
    ends = np.cumsum(lengths)
    cap = [buf[e - k:e] for e, k in zip(ends.tolist(), lengths.tolist())]
    return {"block_1mb": small, "block_cap": cap}, params


def host_hasher():
    """A Hasher built under TENDERMINT_TPU_HASHES=0: the operator's host
    floor (the native library and hashlib), no device."""
    from tendermint_tpu_torch.ops.gateway import Hasher

    before = os.environ.get("TENDERMINT_TPU_HASHES")
    os.environ["TENDERMINT_TPU_HASHES"] = "0"
    try:
        h = Hasher()
    finally:
        if before is None:
            del os.environ["TENDERMINT_TPU_HASHES"]
        else:
            os.environ["TENDERMINT_TPU_HASHES"] = before
    if h.device is not None:
        raise AssertionError("TENDERMINT_TPU_HASHES=0 built a device Hasher")
    return h


def make_block_with(h, txs, commit_args, part_size):
    """Block.make_block wired to h as consensus wires its Hasher
    (consensus/state.py:944-959): the tx root through set_batch_tx_root,
    the part set through the part hashers and the tree submitter."""
    from tendermint_tpu_torch.types import tx as ptx
    from tendermint_tpu_torch.types.block import Block

    vs, bid, commit = commit_args
    ptx.set_batch_tx_root(h.tx_merkle_root)
    return Block.make_block(
        2, CHAIN_ID, txs, commit, bid, vs.hash(), APP_HASH, part_size, time_ns=BLOCK_TIME_NS,
        part_hasher=h.part_leaf_hashes, part_tree_hasher=h.part_set_tree,
        part_tree_submitter=h.submit_part_set_tree,
    )


def reset_launches() -> None:
    import importlib

    from tendermint_tpu_torch.ops import kernels

    for module, attr in kernels.LAUNCH_COUNTERS.values():
        setattr(importlib.import_module(module), attr, 0)


def read_launches() -> dict[str, int]:
    from tendermint_tpu_torch.ops import kernels

    return kernels.launch_counts()


class capture_hash_calls:
    """Inside the block, record every K1 / K2 / K3 wrapper call: the kernel,
    the block it serves, its inputs as passed (copied before the launch)
    and its output (copied after), on the caller's stream. The wrappers
    still launch and count; the copies cost a few device copies a call."""

    def __init__(self, calls: list, label: str):
        self.calls, self.label = calls, label

    def __enter__(self):
        from tendermint_tpu_torch.ops import hashing as th
        from tendermint_tpu_torch.ops import merkle as tm

        self.real = (th.ripemd160_lanes, th.sha256_lanes, tm.tree_lanes)
        calls, label = self.calls, self.label

        def hashes(kname, wrapper):
            def spy(words, first, nblocks, out=None):
                args = (words.clone(), first.clone(), nblocks.clone())
                got = wrapper(words, first, nblocks, out=out)
                calls.append({"kernel": kname, "block": label, "args": args, "got": got.clone()})
                return got
            return spy

        def tree(nodes, n):
            before = nodes.clone()
            got = self.real[2](nodes, n)
            calls.append({"kernel": "merkle_tree", "block": label, "leaves": n, "args": before,
                          "got": got.clone()})
            return got

        th.ripemd160_lanes = hashes("ripemd160", self.real[0])
        th.sha256_lanes = hashes("sha256", self.real[1])
        tm.tree_lanes = tree
        return self

    def __exit__(self, *exc):
        from tendermint_tpu_torch.ops import hashing as th
        from tendermint_tpu_torch.ops import merkle as tm

        th.ripemd160_lanes, th.sha256_lanes, tm.tree_lanes = self.real
        return False


def check_path_kernels(calls, block_txs) -> dict[str, int]:
    """Phase 19's kernel calls against their plain versions on the card, on
    the main path's own inputs as recorded: all K1 calls of both blocks
    (tx leaves and parts) in one plain walk, whose cost the longest
    message sets (a 1,025-block part, as phase 18's widest batch); K2's
    call; each K3 tree. Labels each call's batch (tx_leaves, parts, txs,
    tx_tree, part_tree) for phase 20 and returns the largest difference a
    kernel."""
    import torch

    from tendermint_tpu_torch.ops import hashing as th
    from tendermint_tpu_torch.ops import merkle as tm

    want_calls = {"ripemd160": 2 * len(block_txs), "sha256": 1, "merkle_tree": 2 * len(block_txs)}
    got_calls = {k: sum(c["kernel"] == k for c in calls) for k in want_calls}
    if got_calls != want_calls:
        raise AssertionError(f"recorded kernel calls {got_calls}, expected {want_calls}")
    errs = {}
    for kname, plain in (("ripemd160", th.ripemd160_words), ("sha256", th.sha256_words)):
        mine = [c for c in calls if c["kernel"] == kname]
        firsts, base = [], 0
        for c in mine:
            firsts.append(c["args"][1] + base)
            base += c["args"][0].shape[0]
        nblocks = torch.cat([c["args"][2] for c in mine])
        t0 = time.perf_counter()
        want = plain(torch.cat([c["args"][0] for c in mine]), torch.cat(firsts), nblocks)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = torch.cat([c["got"] for c in mine]).long() & _M32
        errs[kname], lo = 0, 0
        for c in mine:
            n = c["args"][1].shape[0]
            c["batch"] = ("txs" if kname == "sha256"
                          else "tx_leaves" if n == len(block_txs[c["block"]]) else "parts")
            err = int((got[lo:lo + n] - want[lo:lo + n]).abs().max().item())
            log({"phase": "path_vs_plain", "kernel": kname, "block": c["block"], "batch": c["batch"],
                 "messages": n, "max_blocks": int(c["args"][2].max().item()), "max_abs_err": err,
                 "plain_walk_s": seconds})
            errs[kname] = max(errs[kname], err)
            lo += n
    errs["merkle_tree"] = 0
    for c in calls:
        if c["kernel"] != "merkle_tree":
            continue
        n = c["leaves"]
        c["batch"] = "tx_tree" if n == len(block_txs[c["block"]]) else "part_tree"
        left, right, out, _, _, _, rounds = tm._dense_schedule(n)
        sched = [torch.from_numpy(a).long().to(DEVICE) for a in (left, right, out)]
        want = tm._run_tree(c["args"].long() & _M32, *sched, rounds)[: 2 * n - 1]
        err = int(((c["got"][: 2 * n - 1].long() & _M32) - want).abs().max().item())
        log({"phase": "path_vs_plain", "kernel": "merkle_tree", "block": c["block"],
             "batch": c["batch"], "leaves": n, "rounds": rounds, "max_abs_err": err})
        errs["merkle_tree"] = max(errs["merkle_tree"], err)
    if any(errs.values()):
        raise AssertionError(f"the main path's kernel calls disagree with their plain versions: {errs}")
    return errs


def hash_main_path(commit_args, block_txs, params):
    """Phase 19: each block built through `Block.make_block` with a fresh
    Hasher on the card, its launches reset just before and read just after
    (K1 twice, tx leaves and part leaves; K3 once a tree; nothing else),
    its stats checked, and the block held against the same block built on
    the host floor (bytes, header, data and part-set hashes, every proof),
    through its own bytes, and through a PartSet filled part by part (a
    flipped byte refused). Then K2's path, its entry point
    `ops.hashing.sha256_batch` on block_1mb's transactions. Every kernel
    call on the card is recorded (`capture_hash_calls`). Returns the
    launches a kernel over these paths, per block its objects and the
    builds' wall seconds, and the recorded calls."""
    import torch

    from tendermint_tpu_torch.crypto import hashing as crypto_hashing
    from tendermint_tpu_torch.ops import hashing as th
    from tendermint_tpu_torch.ops.gateway import Hasher
    from tendermint_tpu_torch.types import tx as ptx
    from tendermint_tpu_torch.types.block import Block
    from tendermint_tpu_torch.types.part_set import InvalidProofError, Part, PartSet

    part_size = params.block_gossip.block_part_size_bytes
    total = {"ripemd160": 0, "sha256": 0, "merkle_tree": 0}
    built, calls = {}, []
    for label, txs in block_txs.items():
        h = Hasher()
        with capture_hash_calls(calls, label):
            reset_launches()
            t0 = time.perf_counter()
            block, ps = make_block_with(h, txs, commit_args, part_size)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
        stats = h.stats()
        data = block.to_bytes()
        if len(txs) > params.block_size.max_txs or len(data) > params.block_size.max_bytes:
            raise AssertionError(f"{label}: {len(txs)} txs, {len(data)} bytes: over the caps")
        want = {"ripemd160": 2, "sha256": 0, "merkle_tree": 2, "b1": 0, "b2": 0, "dsm": 0,
                "comb": 0, "tables": 0}
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, expected {want}")
        got_stats = {k: stats[k] for k in ("tpu_part_batches", "tpu_tx_roots", "cpu_leaves",
                                           "submitted_jobs")}
        if got_stats != {"tpu_part_batches": 1, "tpu_tx_roots": 1, "cpu_leaves": 0, "submitted_jobs": 1}:
            raise AssertionError(f"{label}: Hasher stats {stats}")
        for k in total:
            total[k] += launches[k]

        h_host = host_hasher()
        t0 = time.perf_counter()
        ref, ref_ps = make_block_with(h_host, txs, commit_args, part_size)
        wall_host = time.perf_counter() - t0
        same = {
            "bytes": data == ref.to_bytes(),
            "header_hash": block.hash() == ref.hash() != b"",
            "data_hash": block.header.data_hash == ref.header.data_hash,
            "part_set_header": ps.header() == ref_ps.header(),
            "proofs": all(ps.get_part(i).proof == ref_ps.get_part(i).proof for i in range(ps.total)),
        }
        ptx.set_batch_tx_root(h.tx_merkle_root)
        same["from_bytes"] = Block.from_bytes(data).hash() == block.hash()
        fresh = PartSet.from_header(ps.header())
        same["parts_accepted"] = all(fresh.add_part(Part.from_json(ps.get_part(i).to_json()))
                                     for i in range(ps.total))
        same["reassembled"] = fresh.is_complete() and fresh.get_data() == data
        part = ps.get_part(ps.total // 2)
        flipped = bytearray(part.bytes_)
        flipped[len(flipped) // 3] ^= 0x10
        try:
            PartSet.from_header(ps.header()).add_part(Part(part.index, bytes(flipped), part.proof))
            same["flipped_refused"] = False
        except InvalidProofError:
            same["flipped_refused"] = True
        log({"phase": "hash_main_path", "block": label, "txs": len(txs), "bytes": len(data),
             "parts": ps.total, "launches": launches, "stats": stats, "checks": same,
             "wall_s": wall, "host_floor_wall_s": wall_host,
             "hashlib_ripemd160": crypto_hashing._RIPEMD_TEMPLATE is not None})
        if not all(same.values()):
            raise AssertionError(f"{label}: {same}")
        built[label] = {"block": block, "data": data, "parts": ps.total, "wall_s": wall,
                        "host_wall_s": wall_host}
    ptx.set_batch_tx_root(None)

    # K2's path: no block path hashes with SHA-256 (nor in the JAX
    # package); its entry point on block_1mb's transactions
    msgs = block_txs["block_1mb"]
    with capture_hash_calls(calls, "block_1mb"):
        reset_launches()
        digests = th.sha256_batch(msgs)
        launches = read_launches()
    ok = digests == [hashlib.sha256(m).digest() for m in msgs]
    log({"phase": "sha256_entry_point", "messages": len(msgs), "launches": launches, "equal_hashlib": ok})
    if not ok or launches["sha256"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"sha256_batch: {launches}, equal to hashlib: {ok}")
    total["sha256"] = launches["sha256"]
    return total, built, calls


def alu_yardsticks(name: str, power: str) -> dict[str, float]:
    """Phase 20's yardsticks, from imad_rate.cu's ALU probes: the card's
    rate of the hash kernels' instruction mix (LOP3, IADD3, SHF.L.W),
    swept over chains a thread and blocks an SM, each loop's SASS counted;
    and one dependent instruction's latency, one thread on one chain, in
    SM cycles (clock64) and in ns (CUDA events)."""
    import re

    import torch

    from tendermint_tpu_torch.ops import kernels

    lib_path = os.path.join(kernels.BUILD_DIR, f"lib{PROBE}.so")
    sass = sass_counts(lib_path)
    loops = {}
    for f, c in sass.items():
        m = re.search(r"alu_rate_kernelILi(\d+)E", f)
        if m and "longest_loop" in c:
            loops[int(m.group(1))] = c["longest_loop"]
        if "alu_chain_kernel" in f and "longest_loop" in c:
            loops["chain"] = c["longest_loop"]
    lib = kernels.load(PROBE)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, per_sm_steps = 256, 1 << 28
    out = torch.empty(8 * sms * threads, dtype=torch.int64, device=DEVICE)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    sweep, rate = [], 0.0
    for chains in (8, 16, 32):
        loop = loops[chains]
        alu_per_iter = sum(loop[op] for op in ("LOP3", "IADD3", "SHF"))
        for per_sm in (2, 4, 8):
            blocks = per_sm * sms
            iters = per_sm_steps // (per_sm * threads * chains)

            def launch() -> None:
                rc = lib.tm_imad_rate(2, chains, out.data_ptr(), iters, blocks, threads, stream())
                if rc != 0:
                    raise RuntimeError(f"alu_rate launch failed: cudaError {rc}")

            r = blocks * threads * iters * alu_per_iter / (cuda_ms(launch) / 1e3)
            sweep.append({"chains": chains, "blocks_per_sm": per_sm, "alu_per_s": r})
            rate = max(rate, r)
    chain = loops["chain"]
    iadd_on_chain = chain["IADD3"] - 1 if chain["IADD3"] > chain["LOP3"] else chain["IADD3"]
    per_iter = chain["LOP3"] + chain["SHF"] + iadd_on_chain
    iters = 50_000

    def launch_chain() -> None:
        rc = lib.tm_imad_rate(3, 1, out.data_ptr(), iters, 1, 1, stream())
        if rc != 0:
            raise RuntimeError(f"alu_chain launch failed: cudaError {rc}")

    chain_ms = cuda_ms(launch_chain, reps=5)
    cycles = int(out[1].item())
    yard = {"alu_per_s": rate, "dep_ns": chain_ms * 1e6 / (iters * per_iter),
            "dep_cycles": cycles / (iters * per_iter)}
    log({"phase": "alu_rate", "card": name, "power_limit": power, "sms": sms, "threads": threads,
         "loop_sass": {str(k): v for k, v in loops.items()}, "chain_instructions_per_iter": per_iter,
         "sweep": sweep, **yard})
    return yard


def rmd_compression(sass: dict, function: str) -> dict:
    """The SASS of one RIPEMD-160 compression in a K1 or K3 kernel: the
    loop of each line (RMD_LINE_MARKS), both lines' instructions summed
    over their distinct loops (one loop when a branch on the warp keeps
    both lines in it), each loop holding its line's exchange, join and
    loads."""
    c = next(c for f, c in sass.items() if function in f)
    lines = c.get("marked_loops", {})
    if set(lines) != set(RMD_LINE_MARKS):
        raise AssertionError(f"{function}: no loop holds each RIPEMD-160 line ({sorted(lines)})")
    distinct = {(v["start"], v["end"]): v for v in lines.values()}
    return {"instructions": sum(v["instructions"] for v in distinct.values()),
            "loops": len(distinct), "per_line": lines}


def hash_bound(yard, compressions: int, chain_blocks: int, chain: int, instrs: int,
               moved_bytes: int) -> dict:
    """The least time of a hash batch: the largest of (a) its compressions'
    SASS instructions over the measured ALU rate, (b) its bytes over the
    memory rate, (c) its longest serial chain (blocks in sequence x the
    compression's dependent instructions) at the measured dependent
    latency. bound_by is "bytes" for (b) and "operations" for (a) and (c);
    bound_term names the term."""
    terms = {
        "issue": 1e3 * compressions * instrs / yard["alu_per_s"],
        "bytes": 1e3 * moved_bytes / HBM_BYTES_PER_S,
        "chain": 1e-6 * chain_blocks * chain * yard["dep_ns"],
    }
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term], "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, **{f"{k}_ms": v for k, v in terms.items()}}


def time_hashes(name, power, commit_args, block_txs, built, calls, params, plain_18_s) -> list[dict]:
    """Phase 20: K1 on both blocks' part batches and tx-leaf batches, K2 on
    the tx-leaf batches, K3 on phase 19's recorded trees (their own leaf
    digests), each with its bound and the native host library's time on
    the same input; the plain versions where a run is short (block_1mb's
    tx leaves, the trees), their results held against the kernel's; the
    make_block wall time through the card's Hasher and through the host
    floor (a fresh Hasher each run: no tx-root cache), and where a card
    build's time goes. Returns the kernels line's entries."""
    import torch

    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.codec.binary import encode_bytes
    from tendermint_tpu_torch.merkle.simple import FlatTree
    from tendermint_tpu_torch.ops import hashing as th
    from tendermint_tpu_torch.ops import kernels
    from tendermint_tpu_torch.ops import merkle as tm
    from tendermint_tpu_torch.ops.gateway import Hasher
    from tendermint_tpu_torch.types import tx as ptx
    from tendermint_tpu_torch.types.part_set import PartSet

    tag = {"card": name, "power_limit": power}
    yard = alu_yardsticks(name, power)
    hash_sass = sass_counts(os.path.join(kernels.BUILD_DIR, "libhash_blocks.so"), RMD_LINE_MARKS)
    tree_sass = sass_counts(os.path.join(kernels.BUILD_DIR, "libmerkle_tree.so"), RMD_LINE_MARKS)
    per_block = {"ripemd160": rmd_compression(hash_sass, "hash_blocks_kernelILi0E"),
                 "sha256": next(c["longest_loop"] for f, c in hash_sass.items()
                                if "hash_blocks_kernelILi1E" in f)}
    per_node = rmd_compression(tree_sass, "merkle_tree_kernel")
    log({"phase": "hash_sass", "per_block_loop": per_block, "per_node_loop": per_node,
         "functions": {"hash_blocks": hash_sass, "merkle_tree": tree_sass}})
    chains = {"ripemd160": th.RIPEMD160_CHAIN, "sha256": th.SHA256_CHAIN}
    width = {"ripemd160": 20, "sha256": 32}
    best3 = lambda fn: 1e3 * min(timed(fn) for _ in range(3))  # noqa: E731
    part_size = params.block_gossip.block_part_size_bytes
    json_shape = {}

    def time_batch(kname, label, batch, msgs, native_fn, plain=False):
        le = kname == "ripemd160"
        words, first, nblocks = th.pack_ragged(msgs, le)
        args = th.to_device(words, first, nblocks, DEVICE)
        lanes = th.ripemd160_lanes if le else th.sha256_lanes
        ms = cuda_ms(lambda: lanes(*args))
        dev_ms = device_ms(lambda: lanes(*args), "hash_blocks_kernel")
        moved = 64 * len(words) + 8 * len(msgs) + width[kname] * len(msgs)
        b = hash_bound(yard, len(words), int(nblocks.max()), chains[kname],
                       per_block[kname]["instructions"], moved)
        row = {"phase": "hash_time", **tag, "kernel": kname, "block": label, "batch": batch,
               "messages": len(msgs), "bytes": sum(map(len, msgs)), "compressions": len(words),
               "max_blocks": int(nblocks.max()), "ms": ms, "device_ms": dev_ms, **b,
               "native_ms": best3(native_fn)}
        if plain:
            fn = th.ripemd160_words if le else th.sha256_words
            row["plain_ms"] = cuda_ms(lambda: fn(*args), reps=3, warmup=1)
            got = lanes(*args).long() & _M32
            row["max_abs_err"] = int((got - fn(*args)).abs().max().item())
            if row["max_abs_err"]:
                raise AssertionError(f"{kname} on {label}'s {batch} disagrees with its plain version")
        log(row)
        if (label, batch) == HASH_JSON_BATCH:
            json_shape[kname] = row

    for label, txs in block_txs.items():
        data = built[label]["data"]
        chunks = [data[i:i + part_size] for i in range(0, len(data), part_size)]
        time_batch("ripemd160", label, "parts", chunks, lambda: native.ripemd160_batch(chunks))
        leaves = [encode_bytes(t) for t in txs]
        first = label == "block_1mb"
        time_batch("ripemd160", label, "tx_leaves", leaves, lambda: native.merkle_leaf_hashes(txs),
                   plain=first)
        time_batch("sha256", label, "tx_leaves", leaves, lambda: native.sha256_batch(leaves),
                   plain=first)

    # K3 on the main path's own trees: each recorded call's node buffer,
    # its leaf digests filled
    for c in calls:
        if c["kernel"] != "merkle_tree":
            continue
        n, filled = c["leaves"], c["args"]
        nodes = filled.clone()
        digests = th.digests_to_bytes_le(filled[:n])
        ms = cuda_ms(lambda: tm.tree_lanes(nodes, n))
        dev_ms = device_ms(lambda: tm.tree_lanes(nodes, n), "merkle_tree_kernel")
        left, right, out, _, _, _, rounds = tm._dense_schedule(n)
        sched = [torch.from_numpy(a).long().to(DEVICE) for a in (left, right, out)]
        plain_nodes = filled.long() & _M32
        moved = 20 * n + 12 * (n - 1) + 4 * rounds + 20 * (n - 1)
        b = hash_bound(yard, n - 1, rounds, th.RIPEMD160_CHAIN, per_node["instructions"], moved)
        want = tm._run_tree(plain_nodes, *sched, rounds)[: 2 * n - 1]
        err = int(((nodes[: 2 * n - 1].long() & _M32) - want).abs().max().item())
        if err:
            raise AssertionError(f"merkle_tree on {c['block']}'s {c['batch']} disagrees with its plain version")
        row = {"phase": "merkle_time", **tag, "block": c["block"], "batch": c["batch"], "leaves": n,
               "rounds": rounds, "ms": ms, "device_ms": dev_ms, **b,
               "plain_ms": cuda_ms(lambda: tm._run_tree(plain_nodes, *sched, rounds), reps=3, warmup=1),
               "max_abs_err": err,
               "native_root_ms": best3(lambda: native.merkle_root_from_leaf_digests(digests)),
               "host_flat_tree_ms": best3(lambda: FlatTree.from_leaf_digests(digests))}
        log(row)
        if (c["block"], c["batch"]) == TREE_JSON_BATCH:
            json_shape["merkle_tree"] = row

    for label, txs in block_txs.items():
        block = built[label]["block"]
        walls = {}
        for kind, make in (("card", Hasher), ("host_floor", host_hasher)):
            runs = []
            for _ in range(3):
                h = make()
                t0 = time.perf_counter()
                make_block_with(h, txs, commit_args, part_size)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            walls[kind] = min(runs)
        # where a card build's time goes, stage by stage (each timed alone)
        h = Hasher()
        leaves = [encode_bytes(t) for t in txs]
        packed = th.pack_ragged(leaves, True)
        stages = {
            "tx_encode_s": min(timed(lambda: [encode_bytes(t) for t in txs]) for _ in range(3)),
            "tx_pack_s": min(timed(lambda: th.pack_ragged(leaves, True)) for _ in range(3)),
            "tx_copy_s": min(timed(lambda: (th.to_device(*packed, DEVICE), torch.cuda.synchronize()))
                             for _ in range(3)),
            "tx_root_s": min(timed(lambda: Hasher().tx_merkle_root(txs)) for _ in range(3)),
            "to_bytes_s": min(timed(block.to_bytes) for _ in range(3)),
            "part_set_s": min(timed(lambda: PartSet.from_data(
                built[label]["data"], part_size, tree_submitter=h.submit_part_set_tree)) for _ in range(3)),
        }
        log({"phase": "make_block_time", **tag, "block": label, "txs": len(txs),
             "bytes": len(built[label]["data"]), "parts": built[label]["parts"],
             "first_card_s": built[label]["wall_s"], "first_host_floor_s": built[label]["host_wall_s"],
             "card_best_of_3_s": walls["card"], "host_floor_best_of_3_s": walls["host_floor"],
             "card_stages": stages})
    ptx.set_batch_tx_root(None)

    entries = []
    for kname in ("ripemd160", "sha256", "merkle_tree"):
        row = json_shape[kname]
        shape = {"block": row["block"], "batch": row["batch"],
                 **({"leaves": row["leaves"]} if kname == "merkle_tree" else {"messages": row["messages"]})}
        entries.append({"name": kname, "ms": row["ms"], "device_ms": row["device_ms"],
                        "plain_ms": row["plain_ms"], "max_abs_err": row["max_abs_err"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "bound_term": row["bound_term"], "library_ms": None,
                        "native_ms": row.get("native_ms", row.get("native_root_ms")), **shape,
                        "plain_widest_batch_s": plain_18_s.get(kname)})
    return entries


# -- phases 21 and 22: the device daemon ---------------------------------------


class DaemonOnCard:
    """`python3 -m tendermint_tpu_torch.devd` on the card, on a socket in a
    short directory under /tmp, with SIGTERM honoured and the kernel left
    to its claim-time bake-off unless `knobs` pins it (the daemon's
    TENDERMINT_DEVD_* settings). `stop()` sends the shutdown op and kills
    the process if it is still alive after DEVD_STOP_S."""

    def __init__(self, knobs: dict | None = None):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="tmd", dir="/tmp")
        self.sock = os.path.join(self.dir, "devd.sock")
        self.log_path = os.path.join(self.dir, "devd.log")
        root = os.path.dirname(os.path.abspath(__file__))
        env = {k: v for k, v in os.environ.items() if k not in (
            "TENDERMINT_TPU_KERNEL", "TENDERMINT_DEVD_KERNEL", "TENDERMINT_DEVD_CHUNK",
            "TENDERMINT_DEVD_ACCEPT_CPU", "TENDERMINT_DEVD_SIM_RATE", "TENDERMINT_DEVD_SOCKS",
            "TENDERMINT_DEVD_WARM")}
        env.update(TENDERMINT_DEVD_SOCK=self.sock, TENDERMINT_DEVD_EXIT_ON_TERM="1",
                   PYTHONPATH=os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p))
        env.update(knobs or {})
        self.log = open(self.log_path, "wb")
        self.started = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", "tendermint_tpu_torch.devd"], env=env,
                                     cwd=root, stdout=subprocess.DEVNULL, stderr=self.log)

    def log_text(self) -> str:
        self.log.flush()
        with open(self.log_path, "rb") as f:
            return f.read().decode(errors="replace")

    def wait_held(self) -> float:
        """Seconds from the start to `ping` reporting the card held."""
        from tendermint_tpu_torch import devd

        client = devd.DevdClient(self.sock, connect_timeout=1.0, io_timeout=10.0)
        deadline = self.started + DEVD_HELD_S
        try:
            while time.perf_counter() < deadline:
                if self.proc.poll() is not None:
                    break
                try:
                    if client.ping(timeout=2.0).get("held"):
                        return time.perf_counter() - self.started
                except (OSError, devd.DevdError):
                    pass
                time.sleep(0.5)
        finally:
            client.close()
        raise AssertionError(f"devd not serving after {time.perf_counter() - self.started:.0f} s "
                             f"(exit {self.proc.poll()}):\n{self.log_text()[-4000:]}")

    def launches(self, client) -> dict[str, int]:
        """The daemon's kernel launch counts, from the line its `stats` op
        writes to its log."""
        client.stats()
        for _ in range(50):
            lines = [ln for ln in self.log_text().splitlines() if "kernel launches " in ln]
            if lines:
                return json.loads(lines[-1].split("kernel launches ", 1)[1])
            time.sleep(0.1)
        raise AssertionError("devd logged no kernel launches")

    def stop(self) -> None:
        from tendermint_tpu_torch import devd

        if self.proc.poll() is None:
            client = devd.DevdClient(self.sock, connect_timeout=1.0, io_timeout=5.0)
            try:
                client.shutdown()
            except (OSError, devd.DevdError, EOFError):
                pass
            finally:
                client.close()
            try:
                self.proc.wait(timeout=DEVD_STOP_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=DEVD_STOP_S)
        self.log.close()


def claim_log(text: str) -> dict:
    """The claim's numbers from the daemon's log: build seconds, each
    bake-off candidate's pipelined rate, the kernel served, the chunk
    width and the claim's seconds."""
    import re

    out: dict = {"bake_off_sigs_per_s": {}, "chunk_sigs_per_s": {}}
    for line in text.splitlines():
        if m := re.search(r"kernels built in ([0-9.]+)s", line):
            out["build_s"] = float(m.group(1))
        elif m := re.search(r"serving kernel: (\w+) \(bake-off (.*)\)$", line):
            out["kernel"] = m.group(1)
            out["bake_off_sigs_per_s"] = json.loads(m.group(2))
        elif m := re.search(r"chunk (\d+): ([0-9.]+) sigs/s pipelined", line):
            out["chunk_sigs_per_s"][int(m.group(1))] = float(m.group(2))
        elif m := re.search(r"stream chunk width: (\d+)", line):
            out["chunk"] = int(m.group(1))
        elif m := re.search(r"device held \((.*)\) in ([0-9.]+)s of claim", line):
            out["held"], out["claim_s"] = m.group(1), float(m.group(2))
    return out


class routed_to:
    """Inside the block this process's gateway routes to the daemon at the
    one socket given (TENDERMINT_DEVD_SOCK), or to the fleet of several
    (TENDERMINT_DEVD_SOCKS), with TENDERMINT_TPU_KERNEL unset and the
    backend's client, the fleet's endpoints, the probe cache and the
    breakers fresh. All are put back after."""

    KEYS = ("TENDERMINT_DEVD_SOCK", "TENDERMINT_DEVD_SOCKS", "TENDERMINT_TPU_KERNEL")

    def __init__(self, *socks: str):
        self.socks = socks

    def _fresh(self) -> None:
        from tendermint_tpu_torch import devd
        from tendermint_tpu_torch.ops import devd_backend, devd_shard, gateway

        if devd_backend._client is not None:
            devd_backend._client.close()
        devd_backend._client = None
        devd_backend.reset_stream_latches()
        devd_shard.reset()
        devd.bust_avail_cache()
        gateway.reset_devd_breaker()
        gateway._rtt_cache.clear()

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.KEYS}
        for k in self.KEYS:
            os.environ.pop(k, None)
        if len(self.socks) == 1:
            os.environ["TENDERMINT_DEVD_SOCK"] = self.socks[0]
        else:
            os.environ["TENDERMINT_DEVD_SOCKS"] = ",".join(self.socks)
        self._fresh()
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self._fresh()
        return False


def devd_phase(name, power, commits, forged, sub_quorum, shapes, block_txs, params) -> dict:
    """Phases 21 and 22: the device daemon on the card. Start it, route a
    default Verifier and Hasher through it, and hold every result against
    the same call in process: the commits' verdicts lane for lane against
    B1's, a 10,000-lane verify_stream, the agg op's points against the dsm
    kernel's, block_cap's parts and tree through hash_stream against the
    in-process K1 and K3, and both blocks against the host floor. The
    daemon's counts must show every lane on the card, its kernels'
    launches each path's kernels, and the breaker CLOSED throughout.
    Returns the daemon's launches a kernel over the phase, phase 22's warm
    times through it and the chunk width it chose."""
    import shutil

    tag = {"card": name, "power_limit": power}
    daemon = DaemonOnCard()
    try:
        held_s = daemon.wait_held()
        claim = claim_log(daemon.log_text())
        log({"phase": "devd_claim", **tag, "held_after_s": held_s, **claim})
        if claim.get("kernel") not in ("comb", "f32p") or set(claim["bake_off_sigs_per_s"]) != {"comb", "f32p"}:
            raise AssertionError(f"devd bake-off: {claim}")
        with routed_to(daemon.sock):
            return _devd_paths(daemon, tag, claim, commits, forged, sub_quorum, shapes, block_txs, params)
    finally:
        daemon.stop()
        log({"phase": "devd_stopped", "exit": daemon.proc.returncode})
        shutil.rmtree(daemon.dir, ignore_errors=True)


def _devd_paths(daemon, tag, claim, commits, forged, sub_quorum, shapes, block_txs, params) -> dict:
    import threading

    from tendermint_tpu_torch import devd
    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import gateway
    from tendermint_tpu_torch.ops import merkle as ops_merkle
    from tendermint_tpu_torch.types import tx as ptx
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    client = devd.DevdClient(daemon.sock)
    if gateway.kernel_name() != "devd":
        raise AssertionError(f"kernel_name() is {gateway.kernel_name()!r} beside a serving daemon")
    v = gateway.Verifier()
    local = gateway.Verifier(device=DEVICE)
    if v.kernel != "devd" or v.device is not None:
        raise AssertionError(f"default Verifier: kernel {v.kernel}, device {v.device}")
    vs100, bid100, c100 = commits["commit_small"]
    vs1000, group = commits["fast_sync_group"]
    vs10k, bid10k, c10k = commits["commit_large"]
    part_size = params.block_gossip.block_part_size_bytes
    agg = AggregateCommit.from_commit(c100, CHAIN_ID, vs100)
    idxs = agg.signers.indices()
    terms = ed25519_agg.aggregate_terms([vs100.get_by_index(i)[1].pub_key.raw for i in idxs],
                                        [agg.sign_message(CHAIN_ID)] * len(idxs), agg.rs, agg.s_agg)
    big = shapes["commit_large"]

    hashers = {}

    def block_path(label, h, route):
        hashers[label, route] = h
        out = make_block_with(h, block_txs[label], commits["commit_small"], part_size)
        ptx.set_batch_tx_root(None)
        return out

    # each path: (through the daemon, the same call in process)
    paths = {
        "commit_small": [lambda ver=ver: vs100.verify_commit(
            CHAIN_ID, bid100, 1, c100, batch_verifier=ver.commit_batch_verifier()) for ver in (v, local)],
        "fast_sync_group": [lambda ver=ver: [f() for f in vs1000.verify_commits_async(
            CHAIN_ID, [(bid, h, c) for bid, c, h in group], ver.verify_batch_async)] for ver in (v, local)],
        "commit_large": [lambda ver=ver: vs10k.verify_commit(
            CHAIN_ID, bid10k, 1, c10k, batch_verifier=ver.commit_batch_verifier()) for ver in (v, local)],
        "verify_stream_10k": [lambda: client.verify_stream(big),
                              lambda: [bool(b) for b in f32p.verify_batch(big, DEVICE)]],
        "agg_100": [lambda ver=ver: agg.verify(CHAIN_ID, vs100, agg_verifier=ver.verify_aggregate)
                    for ver in (v, local)],
        **{f"make_block_{label}": [lambda label=label: block_path(label, gateway.Hasher(), "devd"),
                                   lambda label=label: block_path(label, gateway.Hasher(device=DEVICE), "local")]
           for label in block_txs},
    }

    # -- phase 21: the paths through the daemon, its counts read before and after
    stats0, status0 = client.stats(), client.status()
    launches0 = daemon.launches(client)
    first, first_local, out = {}, {}, {}
    for label, (through, here) in paths.items():
        t0 = time.perf_counter()
        out[label] = through()
        first[label] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out[label, "local"] = here()
        first_local[label] = time.perf_counter() - t0
    refusals = {}
    for label, commit, want in (("forged", forged, "invalid signature"),
                                ("sub_quorum", sub_quorum, "insufficient voting power")):
        refusals[label] = expect_refusal(label, lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier()), want)
    # the commits' lanes again, each verdict against B1's in process
    lane_sets = {**{k: shapes[k] for k in ("commit_small", "fast_sync_group", "commit_large")},
                 "forged": recorded_items(vs100, 1, bid100, forged)}
    differ, alone = {}, {}
    for label, items in lane_sets.items():
        got = v.verify_batch(items)
        want = [bool(b) for b in f32p.verify_batch(items, DEVICE)]
        differ[label] = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        alone[label] = want
        if want.count(False) != (1 if label == "forged" else 0):
            raise AssertionError(f"{label}: B1 refused {want.count(False)} lanes")
    streamed = out["verify_stream_10k"]
    differ["verify_stream_10k"] = (sum(a != b for a, b in zip(streamed, out["verify_stream_10k", "local"]))
                                   + abs(len(streamed) - len(big)))
    points = client.agg_batch(terms)
    alone["agg_100"] = ed32.dsm_batch(terms, DEVICE)
    differ["agg_100_points"] = sum(a != b for a, b in zip(points, alone["agg_100"])) + abs(len(points) - len(terms))
    hashed = {}
    for label in block_txs:
        block, ps = out[f"make_block_{label}"]
        h = hashers[label, "devd"]
        if h._route != "devd":
            raise AssertionError(f"default Hasher route {h._route!r} beside a serving daemon")
        ref, ref_ps = block_path(label, host_hasher(), "host")
        same = (block.to_bytes() == ref.to_bytes() and ps.header() == ref_ps.header()
                and all(ps.get_part(i).proof == ref_ps.get_part(i).proof for i in range(ps.total)))
        stats = h.stats()
        hashed[label] = {"parts": ps.total, "host_floor_equal": same,
                         **{k: stats[k] for k in ("tpu_part_batches", "tpu_tx_roots", "cpu_leaves",
                                                  "breaker_state")}}
        if hashed[label] != {"parts": ps.total, "host_floor_equal": True, "tpu_part_batches": 1,
                             "tpu_tx_roots": 1, "cpu_leaves": 0, "breaker_state": 0}:
            raise AssertionError(f"{label} through devd: {hashed[label]}")
    data = out["make_block_block_cap"][0].to_bytes()
    parts = [data[i:i + part_size] for i in range(0, len(data), part_size)]
    n_bytes = sum(map(len, parts))
    t0 = time.perf_counter()
    digests, nodes = client.hash_stream(parts, mode="part", tree=True, chunk=8)
    first["hash_stream_parts"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    alone["parts"] = ops_merkle.part_set_nodes(parts, DEVICE)
    first_local["hash_stream_parts"] = time.perf_counter() - t0
    want_digests, want_nodes = alone["parts"]
    differ["block_cap_parts"] = (sum(a != b for a, b in zip(digests, want_digests))
                                 + sum(a != b for a, b in zip(nodes, want_nodes[len(parts):]))
                                 + abs(len(digests) - len(parts)) + abs(len(nodes) - (len(parts) - 1)))
    # several clients at once, a connection and a daemon thread each, the
    # daemon's one Verifier and hasher shared: each gets what it got alone
    jobs = {
        "verify_stream_10k": lambda c: c.verify_stream(big),
        "fast_sync_group": lambda c: c.verify_batch(lane_sets["fast_sync_group"]),
        "agg_100": lambda c: c.agg_batch(terms),
        "parts": lambda c: c.hash_stream(parts, mode="part", tree=True, chunk=8),
    }
    want_jobs = {"verify_stream_10k": alone["commit_large"], "fast_sync_group": alone["fast_sync_group"],
                 "agg_100": alone["agg_100"], "parts": (want_digests, want_nodes[len(parts):])}
    got_jobs, errors = {}, []

    def run(label):
        c = devd.DevdClient(daemon.sock)
        try:
            got_jobs[label] = jobs[label](c)
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(f"{label}: {exc!r}")
        finally:
            c.close()

    threads = [threading.Thread(target=run, args=(label,)) for label in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent devd clients: {errors}")
    differ["concurrent"] = sum(got_jobs[k] != w for k, w in want_jobs.items())

    launches1 = daemon.launches(client)
    stats1, status1 = client.stats(), client.status()
    launches = {k: launches1[k] - launches0[k] for k in launches1}
    mine = v.stats()
    sent = mine["tpu_sigs"] + 2 * len(big) + len(lane_sets["fast_sync_group"])
    grew = {k: stats1[k] - stats0[k] for k in ("tpu_sigs", "cpu_sigs")}
    stream_grew = {k: status1["stream"][k] - status0["stream"][k] for k in ("streams", "chunks", "lanes")}
    hash_grew = {k: status1["hash_stream"][k] - status0["hash_stream"][k]
                 for k in ("streams", "chunks", "lanes", "trees")}
    breakers = gateway.devd_breaker_states()
    log({"phase": "devd_path", **tag, "kernel": claim["kernel"], "launches": launches,
         "verifier_stats": mine, "daemon_grew": grew, "stream_grew": stream_grew,
         "hash_stream_grew": hash_grew, "lanes_sent": sent, "differ": differ, "hashed": hashed,
         "breakers": breakers, "refused": refusals})
    if any(differ.values()):
        raise AssertionError(f"devd results differ from the in-process kernels: {differ}")
    if grew["tpu_sigs"] != sent or grew["cpu_sigs"] != 0 or mine["cpu_sigs"] != 0 \
            or mine["agg_lanes_cpu"] != 0:
        raise AssertionError(f"devd lanes: sent {sent}, daemon grew {grew}, verifier {mine}")
    if set(breakers.values()) != {gateway.CircuitBreaker.CLOSED} or mine["breaker_state"] != 0:
        raise AssertionError(f"devd breakers {breakers}")
    # two blocks (a tx tree and a part tree each) and the parts twice
    if stream_grew["chunks"] < 2 or hash_grew["trees"] != 6:
        raise AssertionError(f"devd streams: {stream_grew}, {hash_grew}")
    want_kernels = ["dsm", "ripemd160", "merkle_tree", "b1"] + (["comb", "tables"] if claim["kernel"] == "comb" else [])
    idle = [k for k in want_kernels if launches[k] <= 0]
    if idle or launches["b2"] or launches["sha256"] or (claim["kernel"] == "f32p" and launches["comb"]):
        raise AssertionError(f"devd kernel launches {launches}: {idle} never launched")

    # -- phase 22: times -------------------------------------------------------
    paths["hash_stream_parts"] = [lambda: jobs["parts"](client), lambda: ops_merkle.part_set_nodes(parts, DEVICE)]
    warm = {label: min(timed(through) for _ in range(3)) for label, (through, _) in paths.items()}
    warm_local = {label: min(timed(here) for _ in range(3)) for label, (_, here) in paths.items()}
    bench = client.bench(batch=8192, n_batches=8)
    log({"phase": "devd_time", **tag, "kernel": claim["kernel"], "claim_s": claim.get("claim_s"),
         "build_s": claim.get("build_s"),
         "bake_off_sigs_per_s": claim["bake_off_sigs_per_s"], "chunk": claim.get("chunk"),
         "chunk_sigs_per_s": claim["chunk_sigs_per_s"], "bench_sigs_per_s": bench["sigs_per_sec"],
         "bench": {k: bench[k] for k in ("batch", "n_batches", "elapsed_s", "all_ok", "kernel")},
         "first_devd_s": first, "first_in_process_s": first_local,
         "warm_best_of_3_devd_s": warm, "warm_best_of_3_in_process_s": warm_local,
         "hash_stream_mb_per_s": n_bytes / warm["hash_stream_parts"] / 1e6, "parts_bytes": n_bytes})
    if not bench["all_ok"]:
        raise AssertionError(f"devd bench: {bench}")
    client.close()
    return {"launches": launches, "warm": warm, "chunk": claim.get("chunk")}


# -- phases 23 and 24: the multi-daemon plane ----------------------------------


def fleet_phase(name, power, commits, forged, sub_quorum, shapes, block_txs, params, one) -> dict:
    """Phases 23 and 24: FLEET daemons on cuda:0 behind TENDERMINT_DEVD_SOCKS.
    `one` is phase 22's: the one daemon's warm times and chunk width.
    Returns the fleet's launches a kernel over phase 23's paths (summed over
    the daemons)."""
    import shutil

    import torch

    tag = {"card": name, "power_limit": power}
    knobs = {"TENDERMINT_DEVD_KERNEL": "f32p", "TENDERMINT_DEVD_WARM": FLEET_WARM}
    if one.get("chunk"):
        knobs["TENDERMINT_DEVD_CHUNK"] = str(one["chunk"])
    fleet = []
    try:
        for _ in range(FLEET):
            fleet.append(DaemonOnCard(knobs))
        held = [d.wait_held() for d in fleet]
        claims = [claim_log(d.log_text()) for d in fleet]
        free, total = torch.cuda.mem_get_info()
        log({"phase": "devd_fleet_claim", **tag, "daemons": FLEET, "held_after_s": held, "claims": claims,
             "mem_free_bytes": free, "mem_total_bytes": total})
        if any(c.get("kernel") != "f32p" for c in claims):
            raise AssertionError(f"fleet daemons serve {[c.get('kernel') for c in claims]}, not f32p")
        with routed_to(*[d.sock for d in fleet]):
            launches, ctx = _fleet_paths(fleet, tag, commits, forged, sub_quorum, shapes, block_txs, params)
        _fleet_chaos(fleet, tag, ctx)
        _fleet_times(fleet, tag, ctx, one)
        return launches
    finally:
        for d in fleet:
            d.stop()
            log({"phase": "devd_fleet_stopped", "exit": d.proc.returncode})
            shutil.rmtree(d.dir, ignore_errors=True)


def _fleet_paths(fleet, tag, commits, forged, sub_quorum, shapes, block_txs, params):
    """Phase 23's paths through the fleet, each against the in-process
    kernels; the daemons' counts read before and after. Returns their
    launches a kernel and what the chaos and the times reuse."""
    from tendermint_tpu_torch import devd
    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.ops import devd_backend, devd_shard, gateway
    from tendermint_tpu_torch.ops import ed25519 as ed32
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import merkle as ops_merkle
    from tendermint_tpu_torch.types import tx as ptx
    from tendermint_tpu_torch.types.agg_commit import AggregateCommit

    if not devd_shard.enabled() or gateway.kernel_name() != "devd":
        raise AssertionError(f"TENDERMINT_DEVD_SOCKS={os.environ.get('TENDERMINT_DEVD_SOCKS')!r}: "
                             f"shard {devd_shard.enabled()}, kernel {gateway.kernel_name()!r}")
    clients = [devd.DevdClient(d.sock) for d in fleet]
    v = gateway.Verifier()
    local = gateway.Verifier(device=DEVICE)
    if v.kernel != "devd" or v.device is not None:
        raise AssertionError(f"default Verifier under the fleet: kernel {v.kernel}, device {v.device}")
    vs100, bid100, c100 = commits["commit_small"]
    vs1000, group = commits["fast_sync_group"]
    vs10k, bid10k, c10k = commits["commit_large"]
    part_size = params.block_gossip.block_part_size_bytes
    aggs, terms = {}, {}
    for label in ("agg_100", "agg_400"):
        vs, _, c = commits[label]
        agg = aggs[label] = AggregateCommit.from_commit(c, CHAIN_ID, vs)
        idxs = agg.signers.indices()
        terms[label] = ed25519_agg.aggregate_terms([vs.get_by_index(i)[1].pub_key.raw for i in idxs],
                                                   [agg.sign_message(CHAIN_ID)] * len(idxs), agg.rs, agg.s_agg)
    big = shapes["commit_large"]
    hashers = {}

    def block_path(label, h, route):
        hashers[label, route] = h
        out = make_block_with(h, block_txs[label], commits["commit_small"], part_size)
        ptx.set_batch_tx_root(None)
        return out

    paths = {
        "commit_small": [lambda ver=ver: vs100.verify_commit(
            CHAIN_ID, bid100, 1, c100, batch_verifier=ver.commit_batch_verifier()) for ver in (v, local)],
        "fast_sync_group": [lambda ver=ver: [f() for f in vs1000.verify_commits_async(
            CHAIN_ID, [(bid, h, c) for bid, c, h in group], ver.verify_batch_async)] for ver in (v, local)],
        "commit_large": [lambda ver=ver: vs10k.verify_commit(
            CHAIN_ID, bid10k, 1, c10k, batch_verifier=ver.commit_batch_verifier()) for ver in (v, local)],
        "verify_batch_10k": [lambda: [bool(b) for b in v.verify_batch_async(big)()],
                             lambda: [bool(b) for b in f32p.verify_batch(big, DEVICE)]],
        **{label: [lambda label=label, ver=ver: aggs[label].verify(
            CHAIN_ID, commits[label][0], agg_verifier=ver.verify_aggregate) for ver in (v, local)]
           for label in aggs},
        **{f"make_block_{label}": [lambda label=label: block_path(label, gateway.Hasher(), "fleet"),
                                   lambda label=label: block_path(label, gateway.Hasher(device=DEVICE), "local")]
           for label in block_txs},
    }

    stats0 = [c.stats() for c in clients]
    launches0 = [d.launches(c) for d, c in zip(fleet, clients)]
    out = {}
    for label, (through, here) in paths.items():
        out[label] = through()
        out[label, "local"] = here()
    refusals = {}
    for label, commit, want in (("forged", forged, "invalid signature"),
                                ("sub_quorum", sub_quorum, "insufficient voting power")):
        refusals[label] = expect_refusal(label, lambda: vs100.verify_commit(
            CHAIN_ID, bid100, 1, commit, batch_verifier=v.commit_batch_verifier()), want)
    lane_sets = {**{k: shapes[k] for k in ("commit_small", "fast_sync_group", "commit_large")},
                 "forged": recorded_items(vs100, 1, bid100, forged)}
    differ, alone = {}, {}
    for label, items in lane_sets.items():
        got = v.verify_batch(items)
        want = [bool(b) for b in f32p.verify_batch(items, DEVICE)]
        differ[label] = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
        alone[label] = want
        if want.count(False) != (1 if label == "forged" else 0):
            raise AssertionError(f"{label}: B1 refused {want.count(False)} lanes")
    differ["verify_batch_10k"] = (sum(a != b for a, b in zip(out["verify_batch_10k"], alone["commit_large"]))
                                  + abs(len(out["verify_batch_10k"]) - len(big)))
    for label in aggs:
        if out[label] != out[label, "local"]:
            raise AssertionError(f"{label}: {out[label]!r} through the fleet, {out[label, 'local']!r} here")
        points = devd_backend.agg_batch(terms[label])
        want = ed32.dsm_batch(terms[label], DEVICE)
        differ[f"{label}_points"] = sum(a != b for a, b in zip(points, want)) + abs(len(points) - len(want))
    hashed = {}
    for label in block_txs:
        block, ps = out[f"make_block_{label}"]
        h = hashers[label, "fleet"]
        if h._route != "devd":
            raise AssertionError(f"default Hasher route {h._route!r} under the fleet")
        ref, ref_ps = block_path(label, host_hasher(), "host")
        same = (block.to_bytes() == ref.to_bytes() and ps.header() == ref_ps.header()
                and all(ps.get_part(i).proof == ref_ps.get_part(i).proof for i in range(ps.total)))
        stats = h.stats()
        hashed[label] = {"parts": ps.total, "host_floor_equal": same,
                         **{k: stats[k] for k in ("tpu_part_batches", "tpu_tx_roots", "cpu_leaves",
                                                  "breaker_state")}}
        if hashed[label] != {"parts": ps.total, "host_floor_equal": True, "tpu_part_batches": 1,
                             "tpu_tx_roots": 1, "cpu_leaves": 0, "breaker_state": 0}:
            raise AssertionError(f"{label} through the fleet: {hashed[label]}")
    cap_block, cap_ps = out["make_block_block_cap"]
    data = cap_block.to_bytes()
    parts = [data[i:i + part_size] for i in range(0, len(data), part_size)]
    digests, nodes = devd_backend.hash_tree(parts, "part")
    want_digests, want_nodes = ops_merkle.part_set_nodes(parts, DEVICE)
    differ["block_cap_parts"] = (sum(a != b for a, b in zip(digests, want_digests))
                                 + sum(a != b for a, b in zip(nodes, want_nodes[len(parts):]))
                                 + abs(len(digests) - len(parts)) + abs(len(nodes) - (len(parts) - 1)))

    launches1 = [d.launches(c) for d, c in zip(fleet, clients)]
    stats1 = [c.stats() for c in clients]
    per_daemon = [{k: b[k] - a[k] for k in b} for a, b in zip(launches0, launches1)]
    launches = {k: sum(d[k] for d in per_daemon) for k in per_daemon[0]}
    grew = [{k: b[k] - a[k] for k in ("tpu_sigs", "cpu_sigs")} for a, b in zip(stats0, stats1)]
    mine = v.stats()
    endpoints = devd_shard.endpoint_stats()
    breakers = gateway.devd_breaker_states()
    log({"phase": "devd_fleet_path", **tag, "launches": per_daemon, "daemon_grew": grew,
         "lanes_sent": mine["tpu_sigs"], "verifier_stats": mine, "endpoints": endpoints,
         "plane": devd_shard.plane_stats(), "differ": differ, "hashed": hashed, "breakers": breakers,
         "refused": refusals})
    if any(differ.values()):
        raise AssertionError(f"fleet results differ from the in-process kernels: {differ}")
    if sum(g["tpu_sigs"] for g in grew) != mine["tpu_sigs"] or any(g["cpu_sigs"] for g in grew) \
            or mine["cpu_sigs"] or mine["agg_lanes_cpu"]:
        raise AssertionError(f"fleet lanes: sent {mine['tpu_sigs']}, daemons grew {grew}, verifier {mine}")
    if any(e["sigs"] <= 0 or e["hash_bytes"] <= 0 for e in endpoints.values()):
        raise AssertionError(f"an endpoint served nothing: {endpoints}")
    if set(breakers.values()) != {gateway.CircuitBreaker.CLOSED} or len(breakers) < FLEET:
        raise AssertionError(f"fleet breakers {breakers}")
    for i, got in enumerate(per_daemon):
        idle = [k for k in ("b1", "dsm", "ripemd160") if got[k] <= 0]
        if idle or any(got[k] for k in ("b2", "sha256", "comb", "tables", "merkle_tree")):
            raise AssertionError(f"fleet daemon {i} launches {got}: {idle} never launched")
    for c in clients:
        c.close()
    ctx = {"paths": paths, "big": big, "want_big": alone["commit_large"], "parts": parts, "cap_bytes": data,
           "cap_header": cap_ps.header(), "cap_proofs": [cap_ps.get_part(i).proof for i in range(cap_ps.total)],
           "block_path": block_path, "commits": commits, "block_txs": block_txs}
    return launches, ctx


def _fleet_chaos(fleet, tag, ctx) -> None:
    """Phase 23's chaos: endpoint 1 behind a FaultProxy, blacked out while
    the 10,000-lane batch and the block_cap build run, until its breaker
    opens; endpoint 0 absorbs every slice, nothing takes the CPU, and after
    the blackout traffic re-closes endpoint 1's breaker and it serves
    again. Then the supervisor's refusal of a card daemon."""
    import threading

    from tendermint_tpu_torch.ops import devd_shard, faults, gateway

    proxy_sock = os.path.join(fleet[1].dir, "proxy.sock")
    proxy = faults.FaultProxy(proxy_sock, fleet[1].sock).start()
    rounds, errors = [], []
    try:
        with routed_to(fleet[0].sock, proxy_sock):
            v = gateway.Verifier()
            big, want_big = ctx["big"], ctx["want_big"]
            cpu_leaves = []

            def chaos_round() -> None:
                got = [bool(b) for b in v.verify_batch_async(big)()]
                h = gateway.Hasher()
                block, ps = ctx["block_path"]("block_cap", h, "chaos")
                cpu_leaves.append(h.stats()["cpu_leaves"])
                same = (got == want_big and block.to_bytes() == ctx["cap_bytes"]
                        and ps.header() == ctx["cap_header"]
                        and [ps.get_part(i).proof for i in range(ps.total)] == ctx["cap_proofs"])
                rounds.append(same)

            def first_round() -> None:
                try:
                    chaos_round()
                except Exception as exc:  # noqa: BLE001 - raised below
                    errors.append(repr(exc))

            br1 = gateway.devd_breaker(proxy_sock)
            br0 = gateway.devd_breaker(fleet[0].sock)
            chaos_round()  # both endpoints serving, through the proxy
            t0 = time.perf_counter()
            during = threading.Thread(target=first_round)
            during.start()
            time.sleep(0.01)
            proxy.blackout(FLEET_BLACKOUT_S)
            dark_from = time.perf_counter()
            during.join(timeout=FLEET_WAIT_S)
            if errors or during.is_alive():
                raise AssertionError(f"chaos round under the blackout: {errors}")
            while br1.state != br1.OPEN:
                if time.perf_counter() - t0 > FLEET_WAIT_S:
                    raise AssertionError(f"endpoint 1's breaker never opened: {br1.stats()}")
                if time.perf_counter() - dark_from > FLEET_BLACKOUT_S / 2:
                    # endpoint 1 stays dark until its breaker opens
                    proxy.blackout(FLEET_BLACKOUT_S)
                    dark_from = time.perf_counter()
                chaos_round()
            opened_s = time.perf_counter() - t0
            states_open = {"endpoint_0": br0.state, "endpoint_1": br1.state}
            time.sleep(max(0.0, FLEET_BLACKOUT_S - (time.perf_counter() - dark_from)))
            while br1.state != br1.CLOSED:
                if time.perf_counter() - t0 > 2 * FLEET_WAIT_S:
                    raise AssertionError(f"endpoint 1's breaker never re-closed: {br1.stats()}")
                chaos_round()
                time.sleep(0.05)
            closed_s = time.perf_counter() - t0
            served_before = devd_shard.endpoint_stats()[proxy_sock]["sigs"]
            chaos_round()
            endpoints = devd_shard.endpoint_stats()
            mine = v.stats()
            fault_counts = {k: val for k, val in mine.items() if k.startswith("faults_")}
            log({"phase": "devd_fleet_chaos", **tag, "blackout_s": FLEET_BLACKOUT_S, "rounds": len(rounds),
                 "rounds_equal": sum(rounds), "opened_after_s": opened_s, "closed_after_s": closed_s,
                 "states_while_open": states_open, "breaker_1": br1.stats(), "breaker_0": br0.stats(),
                 "endpoints": endpoints, "cpu_sigs": mine["cpu_sigs"], "cpu_leaves": sum(cpu_leaves),
                 "faults": fault_counts, "proxy": proxy.plan.stats()})
            if not all(rounds):
                raise AssertionError(f"{rounds.count(False)} of {len(rounds)} chaos rounds differ")
            if states_open != {"endpoint_0": 0, "endpoint_1": 2} or br0.stats()["breaker_opens"]:
                raise AssertionError(f"breakers under the blackout: {states_open}, {br0.stats()}")
            if mine["cpu_sigs"] or sum(cpu_leaves):
                raise AssertionError(f"chaos took the CPU: {mine['cpu_sigs']} sigs, {sum(cpu_leaves)} leaves")
            if fault_counts.get("faults_kill", 0) < 1 or endpoints[proxy_sock]["redispatches"] < 1:
                raise AssertionError(f"faults {fault_counts}, endpoints {endpoints}")
            if endpoints[proxy_sock]["sigs"] <= served_before:
                raise AssertionError(f"endpoint 1 serves no lanes after re-closing: {endpoints}")
    finally:
        proxy.stop()
    refusal = None
    for accept in ("", "0"):
        try:
            faults.DaemonSupervisor(os.path.join(fleet[0].dir, "card.sock"),
                                    {"TENDERMINT_DEVD_ACCEPT_CPU": accept})
        except ValueError as exc:
            if "ACCEPT_CPU" not in str(exc):
                raise
            refusal = str(exc)[:60]
        else:
            raise AssertionError(f"DaemonSupervisor took a card daemon (ACCEPT_CPU={accept!r})")
    log({"phase": "devd_fleet_supervisor", "refused": refusal})


def _fleet_times(fleet, tag, ctx, one) -> None:
    """Phase 24: each path's slice plan through the fleet; warm best of 3
    through the fleet, through one of its daemons alone and in process, in
    turns (a warm-up turn first), beside phase 22's one daemon; and the
    split of the wide paths' time through a daemon."""
    from tendermint_tpu_torch import devd
    from tendermint_tpu_torch.ops import devd_backend, devd_shard
    from tendermint_tpu_torch.ops import ed25519_f32p as f32p
    from tendermint_tpu_torch.ops import merkle as ops_merkle

    paths, parts, big = ctx["paths"], ctx["parts"], ctx["big"]
    vs10k, bid10k, c10k = ctx["commits"]["commit_large"]
    timed_paths = {
        **{label: paths[label] for label in ("commit_large", "fast_sync_group", "verify_batch_10k",
                                             "make_block_block_cap")},
        "parts_tree": [lambda: devd_backend.hash_tree(parts, "part"),
                       lambda: ops_merkle.part_set_nodes(parts, DEVICE)],
    }
    # phase 22's name of the same call through one daemon
    one_name = {"verify_batch_10k": "verify_stream_10k", "parts_tree": "hash_stream_parts"}
    routes = {"fleet": [d.sock for d in fleet], "one_daemon": [fleet[0].sock]}
    plans = {}
    with routed_to(*routes["fleet"]):
        for label, (through, _) in timed_paths.items():
            before = devd_shard.endpoint_stats()
            through()
            after = devd_shard.endpoint_stats()
            plans[label] = [{k: after[p][k] - before[p][k] for k in
                             ("dispatched_slices", "stolen_slices", "redispatches", "sigs", "hash_bytes")}
                            for p in after]
    best: dict[str, dict[str, float]] = {route: {} for route in (*routes, "in_process")}
    for turn in range(4):
        for route, socks in routes.items():
            with routed_to(*socks):
                for label, (through, _) in timed_paths.items():
                    t = timed(through)
                    if turn:
                        best[route][label] = min(best[route].get(label, t), t)
        for label, (_, here) in timed_paths.items():
            t = timed(here)
            if turn:
                best["in_process"][label] = min(best["in_process"].get(label, t), t)
    warm, warm_one, warm_local = best["fleet"], best["one_daemon"], best["in_process"]
    log({"phase": "devd_fleet_time", **tag, "daemons": FLEET, "warm_best_of_3_fleet_s": warm,
         "warm_best_of_3_one_daemon_s": warm_one, "warm_best_of_3_in_process_s": warm_local,
         "phase22_one_daemon_s": {label: one["warm"].get(one_name.get(label, label)) for label in timed_paths},
         "slice_plan": plans})

    # where a wide path's time through a daemon goes: each piece alone on
    # the same payload, best of 3
    client = devd.DevdClient(fleet[0].sock)
    width = client.stream_chunk()
    client.close()

    def chunks(items, w):
        return [items[i:i + w] for i in range(0, len(items), w)]

    def best(fn) -> float:
        return min(timed(fn) for _ in range(3))

    txs = ctx["block_txs"]["block_cap"]
    verify_frames = [devd._pack_chunk(c) for c in chunks(big, width)]
    tx_frames = [devd._pack_hash_chunk(c) for c in chunks(txs, width)]
    part_frames = [devd._pack_hash_chunk(c) for c in chunks(parts, devd_backend._hash_chunk("part"))]
    pieces = {
        "commit_large": {
            "encode_s": best(lambda: [devd._pack_chunk(c) for c in chunks(big, width)]),
            "decode_s": best(lambda: [devd._unpack_chunk(f) for f in verify_frames]),
            "commit_check_s": best(lambda: recorded_items(vs10k, 1, bid10k, c10k)),
            "marshal_and_kernel_s": best(lambda: f32p.verify_batch(big, DEVICE)),
        },
        "make_block_block_cap": {
            "encode_s": best(lambda: ([devd._pack_hash_chunk(c) for c in chunks(txs, width)],
                                      [devd._pack_hash_chunk(c) for c in chunks(parts, 8)])),
            "decode_s": best(lambda: [devd._unpack_hash_chunk(f) for f in tx_frames + part_frames]),
            "in_process_build_s": warm_local["make_block_block_cap"],
        },
        "parts_stream": {
            "encode_s": best(lambda: [devd._pack_hash_chunk(c) for c in chunks(parts, 8)]),
            "decode_s": best(lambda: [devd._unpack_hash_chunk(f) for f in part_frames]),
            "marshal_and_kernel_s": warm_local["parts_tree"],
        },
    }
    for label, key in (("commit_large", "commit_large"), ("make_block_block_cap", "make_block_block_cap"),
                       ("parts_stream", "parts_tree")):
        known = sum(pieces[label].values())
        pieces[label].update(one_daemon_s=warm_one[key], fleet_s=warm[key],
                             left_one_daemon_s=warm_one[key] - known, left_fleet_s=warm[key] - known)
    log({"phase": "devd_wide_split", **tag, "chunk": width, "frames": {
        "verify": len(verify_frames), "tx": len(tx_frames), "parts": len(part_frames)}, "pieces": pieces})


if __name__ == "__main__":
    sys.exit(main())
