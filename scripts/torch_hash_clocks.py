"""Clock the port's K2 (SHA-256, csrc/hash_blocks.cu) from inside, on one
NVIDIA GPU: where a block's cycles go.

Run from the repository root on a machine with a card:

    python3 scripts/torch_hash_clocks.py [--reps N]

Builds, beside the kernel, two probes from the kernel's own device code
(build/kernels/clocks/): K2's block walk (`sha256_pair`, both warps) with
the SM clock (clock64) and the global timer read around each warp's walk,
and the SM (%smid) and warp slot (%warpid, whose value mod 4 is the warp's
sub-partition) each warp ran on; and the compression warp's 64 rounds
alone (`sha_rounds` on sums in shared memory, N blocks in sequence on one
warp, nothing else on its SM). The walk runs over block_cap's tx leaves
(types/params.py's caps: 10,000 transactions of 1 to 4,096 bytes, every
1,000th at 10,240, length-prefixed; the same batch as
scripts/torch_kernel_compare.py's) and its digests must equal hashlib's.
One JSON line per measurement, the card's name and power limit first:
each CUDA block holding a message of the batch's largest block count
(its warps' cycles a SHA-256 block, SM, warp slots, the co-resident
blocks' largest block counts), the clock (cycles per ns), and the rounds
alone in cycles a block and a round.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

TXS, TX_CAP, SEED = 10_000, 10_240, 9

PROBES = r"""
#include "hash_blocks.cu"

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned warp_slot() {
  unsigned r;
  asm volatile("mov.u32 %0, %%warpid;" : "=r"(r));
  return r;
}

// K2's block with each warp's walk clocked; rec: 5 words a warp (cycles,
// ns, block count walked, SM, warp slot)
__global__ void __launch_bounds__(2 * kThreads)
    k2_clocked(const uint4* words, const int32_t* first, const int32_t* nblocks, uint32_t* out, int n,
               long long* rec) {
  __shared__ ShaShared sh;
  const int m0 = blockIdx.x * kPairLanes;
  const int lane = threadIdx.x % kPairLanes;
  const long long c0 = clock64();
  const unsigned long long g0 = global_ns();
  if (threadIdx.x < kPairLanes) {
    sha256_pair<0>(sh, words, first, nblocks, out, n, m0, lane);
  } else {
    sha256_pair<1>(sh, words, first, nblocks, out, n, m0, lane);
  }
  const long long c1 = clock64();
  const unsigned long long g1 = global_ns();
  const int nb = m0 + lane < n ? nblocks[m0 + lane] : 0;
  const int most = __reduce_max_sync(0xFFFFFFFFu, nb);
  if (lane == 0) {
    long long* r = rec + 5 * (2 * blockIdx.x + threadIdx.x / kPairLanes);
    r[0] = c1 - c0;
    r[1] = static_cast<long long>(g1 - g0);
    r[2] = most;
    r[3] = sm_id();
    r[4] = warp_slot();
  }
}

// the compression warp's rounds alone: `reps` blocks on one warp, sums
// from shared memory; rec: cycles, ns
__global__ void rounds_alone(int reps, uint32_t* out, long long* rec) {
  __shared__ uint4 wk[16][kPairLanes];
  const int lane = threadIdx.x;
  for (int q = 0; q < 16; ++q) wk[q][lane] = make_uint4(4 * q + lane, 5 * q + lane, 6 * q + lane, 7 * q + lane);
  __syncwarp();
  uint32_t h[8];
  sha256_init(h);
  const long long c0 = clock64();
  const unsigned long long g0 = global_ns();
#pragma unroll 1
  for (int b = 0; b < reps; ++b) {
    uint32_t s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = h[k];
    sha_rounds(s, &wk[0][lane], kPairLanes);
#pragma unroll
    for (int k = 0; k < 8; ++k) h[k] += s[k];
  }
  const long long c1 = clock64();
  const unsigned long long g1 = global_ns();
  for (int k = 0; k < 8; ++k) out[8 * lane + k] = h[k];
  if (lane == 0) {
    rec[0] = c1 - c0;
    rec[1] = static_cast<long long>(g1 - g0);
  }
}

}  // namespace

extern "C" int k2_clocked_launch(const void* words, const int32_t* first, const int32_t* nblocks,
                                 uint32_t* out, int n, long long* rec, void* stream) {
  k2_clocked<<<(n + kPairLanes - 1) / kPairLanes, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(words), first, nblocks, out, n, rec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rounds_alone_launch(int reps, uint32_t* out, long long* rec, void* stream) {
  rounds_alone<<<1, kPairLanes, 0, static_cast<cudaStream_t>(stream)>>>(reps, out, rec);
  return static_cast<int>(cudaGetLastError());
}
"""


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def build():
    from tendermint_tpu_torch.ops import kernels

    out_dir = os.path.join(kernels.BUILD_DIR, "clocks")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "k2_clocks.cu"), os.path.join(out_dir, "libk2_clocks.so")
    with open(src, "w") as f:
        f.write(PROBES)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels._CSRC, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the probes:\n{proc.stderr}")
    dll = ctypes.CDLL(lib)
    ptr = ctypes.c_void_p
    dll.k2_clocked_launch.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int, ptr, ptr]
    dll.rounds_alone_launch.argtypes = [ctypes.c_int, ptr, ptr, ptr]
    for fn in (dll.k2_clocked_launch, dll.rounds_alone_launch):
        fn.restype = ctypes.c_int
    return dll


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2000, help="blocks the rounds-alone probe walks")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_hash_clocks: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    from tendermint_tpu_torch.codec.binary import encode_bytes
    from tendermint_tpu_torch.ops import hashing as th

    dll = build()
    stream = torch.cuda.current_stream().cuda_stream

    rng = np.random.default_rng(SEED)
    lengths = rng.integers(1, 4097, size=TXS)
    lengths[999::1000] = TX_CAP
    msgs = [encode_bytes(rng.bytes(int(k))) for k in lengths]
    words, first, nblocks = th.to_device(*th.pack_ragged(msgs, False), "cuda")
    out = torch.empty((len(msgs), 8), dtype=torch.int32, device="cuda")
    grid = -(-len(msgs) // 32)
    rec = torch.zeros((grid, 2, 5), dtype=torch.int64, device="cuda")
    for _ in range(3):  # the last walk's clocks are read
        if dll.k2_clocked_launch(words.data_ptr(), first.data_ptr(), nblocks.data_ptr(), out.data_ptr(),
                                 len(msgs), rec.data_ptr(), stream):
            raise RuntimeError("k2_clocked launch failed")
    torch.cuda.synchronize()
    if th.digests_to_bytes_be(out) != [hashlib.sha256(m).digest() for m in msgs]:
        raise AssertionError("the clocked K2 walk disagrees with hashlib")
    r = rec.cpu().numpy()
    most = int(r[:, 0, 2].max())
    per_sm: dict[int, list[int]] = {}
    for b in range(grid):
        per_sm.setdefault(int(r[b, 0, 3]), []).append(b)
    for b in np.flatnonzero(r[:, 0, 2] == most):
        sm = int(r[b, 0, 3])
        log({"phase": "k2_long_block", "card": card, "block": int(b), "blocks_walked": most, "sm": sm,
             "warp_slots": [int(r[b, w, 4]) for w in range(2)],
             "cycles_per_block": [float(r[b, w, 0]) / most for w in range(2)],
             "co_resident_most": [int(r[o, 0, 2]) for o in per_sm[sm] if o != b]})
    walk = r[r[:, 0, 2] == most, 0]
    log({"phase": "k2_walk", "card": card, "messages": len(msgs), "blocks": grid, "most": most,
         "cycles_per_block_median": float(np.median(walk[:, 0])) / most,
         "cycles_per_block_max": float(walk[:, 0].max()) / most,
         "cycles_per_ns": float(np.median(walk[:, 0] / walk[:, 1]))})

    rout = torch.empty((32, 8), dtype=torch.int32, device="cuda")
    rrec = torch.zeros(2, dtype=torch.int64, device="cuda")
    for _ in range(3):
        if dll.rounds_alone_launch(opts.reps, rout.data_ptr(), rrec.data_ptr(), stream):
            raise RuntimeError("rounds_alone launch failed")
    torch.cuda.synchronize()
    cycles, ns = (int(x) for x in rrec.cpu())
    log({"phase": "k2_rounds_alone", "card": card, "blocks": opts.reps,
         "cycles_per_block": cycles / opts.reps, "cycles_per_round": cycles / opts.reps / 64,
         "cycles_per_ns": cycles / ns})
    return 0


if __name__ == "__main__":
    sys.exit(main())
