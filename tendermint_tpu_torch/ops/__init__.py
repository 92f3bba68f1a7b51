"""Device plane of the port: the CUDA kernels, their plain PyTorch
versions, and the gateway the commit path talks to.

- `ed25519_f32`: the host marshal and `verify_plain`, the plain PyTorch
  version of the B1 verify ladder, which is also the registry's `f32`
  (B3) on the card.
- `ed25519_f32p`: the wrapper of the hand-written CUDA ladder B1
  (`csrc/ed25519_verify.cu`), and B1′, the same kernel launched once per
  shard over a mesh of devices (`ShardedVerify`).
- `ed25519`: the int32 radix-2^15 family: limb codecs, field and point
  ops, the registry's `int32` verify and `decompress_batch`, and
  `dsm_batch`, the wrapper of the dual-scalar-multiplication kernel
  (`csrc/ed25519_dsm.cu`) with its plain version `dsm_plain`.
- `ed25519_comb`: the registry's `comb` (B4): the device-resident pool
  of per-validator comb tables, the wrappers of the table-build and comb
  verify kernels (`csrc/ed25519_comb_tables.cu`, `csrc/ed25519_comb.cu`)
  with their plain versions, and the second-sight lane routing.
- `ed25519_pallas`: the wrapper of the single-bit CUDA ladder B2
  (`csrc/ed25519_verify_b2.cu`) with its plain version `verify_plain`.
- `hashing`: the wrappers of the RIPEMD-160 and SHA-256 kernels K1 and
  K2 (`csrc/hash_blocks.cu`, over a ragged block buffer: K1 a message's
  two lines on a pair of warps, K2 one thread a message) with their plain versions `ripemd160_words` / `sha256_words`.
- `merkle`: the wrapper of the Merkle tree kernel K3
  (`csrc/merkle_tree.cu`) with its plain version `_run_tree`, and the
  part-set and tx-root paths that chain K1 into K3 on the card.
- `kernels`: builds the `csrc/` sources with nvcc and binds them.
- `gateway`: `Verifier`, the batching gateway with its size gate, its
  kernel registry and the aggregate-commit verify; `ShardedVerifier`,
  which runs its device batches through B1′ (or B3's `verify_plain` per
  shard under `f32`); and `Hasher`, the hash plane's gateway behind
  `Block.make_block`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Asking for the card where there is none is an error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain version"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
