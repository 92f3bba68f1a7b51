"""tendermint-tpu on PyTorch and CUDA: the port of `tendermint_tpu` to an
NVIDIA H100.

The port keeps the JAX package's module names so each module's
counterpart is easy to find. It imports `torch`, never `jax`, and nothing
of `tendermint_tpu`: what it needs from the JAX package's host modules it
carries as its own copy.

The port verifies commits on the card: `types.ValidatorSet.verify_commit`
hands every signature of a commit to `ops.gateway.Verifier`, which marshals
them on the host (`ops.ed25519_f32.prepare_batch8`) and runs them through
a hand-written CUDA Ed25519 kernel: the 2-bit ladder B1 (`ops.ed25519_f32p`,
`ops/csrc/ed25519_verify.cu`) by default, or the single-bit ladder B2
(`ops.ed25519_pallas`, `ops/csrc/ed25519_verify_b2.cu`) under
`TENDERMINT_TPU_KERNEL=pallas`. An aggregate commit
(`types.agg_commit.AggregateCommit`) verifies as one half-aggregate
equation whose n + 1 dual scalar multiplications run in a third CUDA kernel
(`ops.ed25519.dsm_batch`, `ops/csrc/ed25519_dsm.cu`).
`ops.gateway.ShardedVerifier` splits a batch over a mesh of devices, B1
launched once per shard (`multichip.dryrun_multichip` drives it).
secp256k1 validator keys (`crypto.secp256k1`) verify on the CPU.

The port also builds blocks on the card: `types.block.Block.make_block`,
wired to `ops.gateway.Hasher`, hashes the tx root and the part set's leaves
and Merkle tree with hand-written CUDA kernels (`ops.hashing`,
`ops/csrc/hash_blocks.cu`; `ops.merkle`, `ops/csrc/merkle_tree.cu`).

Entry points run on the card unless the caller passes `device="cpu"`;
there each kernel's plain PyTorch version runs instead. A missing card is
an error, never a silent CPU fallback.
"""
