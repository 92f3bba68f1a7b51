"""tendermint-tpu on PyTorch and CUDA: the port of `tendermint_tpu` to an
NVIDIA H100.

The port keeps the JAX package's module names so each module's
counterpart is easy to find. It imports `torch`, never `jax`, and nothing
of `tendermint_tpu`: what it needs from the JAX package's host modules it
carries as its own copy.

This slice verifies commits on the card: `types.ValidatorSet.verify_commit`
hands every signature of a commit to `ops.gateway.Verifier`, which marshals
them on the host (`ops.ed25519_f32.prepare_batch8`) and runs them through
the hand-written CUDA Ed25519 ladder (`ops.ed25519_f32p`,
`ops/csrc/ed25519_verify.cu`).

Entry points run on the card unless the caller passes `device="cpu"`;
there the kernel's plain PyTorch version (`ops.ed25519_f32.verify_plain`)
runs instead. A missing card is an error, never a silent CPU fallback.
"""
