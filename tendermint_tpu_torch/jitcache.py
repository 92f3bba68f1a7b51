"""Build cache and device probes of the port, under the JAX package's
`jitcache` names.

- `enable()` builds every CUDA source in `ops/csrc/` (one nvcc each, all
  started together; `ops.kernels.build_all`) into `build/kernels/`, so a
  process that calls it at start-up never compiles on a verify or hash
  path. A library newer than its source and the shared headers is kept:
  the build is keyed by mtime, and the libraries are built for `sm_90a`
  only, so no host key is needed.
- `probe_device(timeout_s)` dials the card in a daemon thread and returns
  its name, or None when there is no card or it does not answer in time.
- `probe_rtt_ms(timeout_s)` times one tiny synchronised op on the card.
- `platform_label()` names the platform for bench and status output.

The probes initialise CUDA in the calling process; the device daemon runs
`probe_device` in a throwaway subprocess (`devd.subprocess_probe`) and
initialises CUDA only after it answered.
"""

from __future__ import annotations

import os
import threading
import time


def _csrc_names() -> list[str]:
    from tendermint_tpu_torch.ops import kernels

    csrc = os.path.join(os.path.dirname(os.path.abspath(kernels.__file__)), "csrc")
    return sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))


def enable() -> dict[str, float]:
    """Build every `ops/csrc/*.cu` that is missing or stale; the seconds
    each took (0.0 for a library that was current). Raises when nvcc fails
    or is missing."""
    from tendermint_tpu_torch.ops import kernels

    return kernels.build_all(_csrc_names())


def _bounded(fn, timeout_s: float):
    """fn() in a daemon thread; its value, or None when it raised or had
    not returned within timeout_s (a hung dial parks the thread, not the
    caller)."""
    out: list = []

    def run():
        try:
            out.append(fn())
        except Exception:  # noqa: BLE001 - an unreachable device counts as absent
            pass

    t = threading.Thread(target=run, daemon=True, name="jitcache-probe")
    t.start()
    t.join(timeout_s)
    return out[0] if out else None


def probe_device(timeout_s: float = 90.0) -> str | None:
    """The card's name once a tiny op on it has completed, or None."""

    def dial():
        import torch

        if not torch.cuda.is_available():
            return None
        torch.zeros((8, 128), device="cuda").sum().item()
        return torch.cuda.get_device_name(0)

    return _bounded(dial, timeout_s)


def probe_rtt_ms(timeout_s: float = 60.0, device="cuda") -> float | None:
    """The device's dispatch round trip: the least of 3 tiny synchronised
    ops after one warm-up, in ms, or None if the device did not answer
    within the bound. `device="cpu"` times the same op on the host."""

    def dial():
        import torch

        x = torch.zeros((8, 128), device=device)
        x.sum().item()  # allocation and first launch off the clock
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            x.sum().item()
            dt = (time.perf_counter() - t0) * 1e3
            best = dt if best is None else min(best, dt)
        return best

    return _bounded(dial, timeout_s)


def platform_label() -> str:
    """Platform name for bench output: the serving device daemon's (from
    its ping), else this process's card, without dialing a card the
    operator disabled."""
    if os.environ.get("TENDERMINT_TPU_DISABLE", "") == "1":
        return "cpu (TENDERMINT_TPU_DISABLE)"
    from tendermint_tpu_torch import devd

    rep = devd.available()
    if rep is not None:
        return f"{rep.get('platform')} (via devd)"
    name = probe_device(60.0)
    return f"cuda ({name})" if name else "unknown (device unreachable)"
