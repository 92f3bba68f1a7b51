"""Device plane of the port: the verify kernel, its plain PyTorch version,
and the gateway the commit path talks to.

- `ed25519_f32`: the host marshal and `verify_plain`, the plain PyTorch
  version of the verify ladder.
- `ed25519_f32p`: the wrapper of the hand-written CUDA ladder
  (`csrc/ed25519_verify.cu`), built and bound by `kernels`.
- `gateway`: `Verifier`, the batching gateway with its size gate.
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
