"""A dry run of the sharded verify path on an n-device mesh.

    python -c "from tendermint_tpu_torch.multichip import dryrun_multichip; dryrun_multichip(2, 'cpu')"

On `device="cuda"` the mesh is cuda:0..n-1, and fewer visible cards is
an error: the mesh never shrinks. On `device="cpu"` it is n CPU shards,
each running the kernel's plain version.
"""

from __future__ import annotations

import torch


def _mesh(n_devices: int, device: str) -> list[str]:
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, not {n_devices}")
    if device == "cpu":
        return ["cpu"] * n_devices
    if device != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, have {have}")
    return [f"cuda:{i}" for i in range(n_devices)]


def _check(cond: bool, what) -> None:
    if not cond:
        raise AssertionError(what)


def quorum_batch(n: int = 4099) -> tuple[list, tuple[int, ...]]:
    """(items, forged lanes): n signatures over 64 distinct messages
    repeated (by default the 4096-lane production batch plus a remainder
    that does not divide), forged at the head, the middle and the
    remainder's tail."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    seed = b"\x02" * 32
    pub = ed.public_key(seed)
    base = [(pub, b"h=%d" % k, ed.sign(seed, b"h=%d" % k)) for k in range(64)]
    items = [base[i % 64] for i in range(n)]
    forged_at = (0, 1777, 4096, 4098)
    for i in forged_at:
        items[i] = (pub, b"forged-%d" % i, b"\x11" * 64)
    return items, forged_at


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Drive ShardedVerifier over an n-device mesh, asserting as it goes:

    1. plumbing pass: 2n signatures plus one forged lane;
    2. quorum pass: the 4099 signatures of `quorum_batch`; the verdicts,
       the stats (one device batch of 4099, nothing on the CPU) and the
       layout (one entry per mesh device, equal lanes).

    The JAX package's second plumbing backend ("f32", B3 under pjit) is
    not ported, so there is one plumbing pass."""
    from tendermint_tpu_torch.crypto import ed25519 as ed
    from tendermint_tpu_torch.ops.gateway import ShardedVerifier

    mesh = _mesh(n_devices, device)
    seed = b"\x02" * 32
    pub = ed.public_key(seed)
    items = [
        (pub, b"height=1/round=0/precommit/%d" % i, ed.sign(seed, b"height=1/round=0/precommit/%d" % i))
        for i in range(2 * n_devices)
    ]
    bad = (pub, b"forged", b"\x00" * 64)
    v = ShardedVerifier(mesh, min_tpu_batch=1)
    ok = v.verify_batch(items + [bad])
    _check(all(ok[:-1]) and not ok[-1], f"plumbing pass: sharded mismatch: {ok}")
    _check(v.stats()["tpu_batches"] == 1, v.stats())

    big, forged_at = quorum_batch()
    n = len(big)
    v = ShardedVerifier(mesh, min_tpu_batch=1)
    ok = v.verify_batch(big)
    rejected = [i for i in range(n) if not ok[i]]
    _check(rejected == list(forged_at), ("quorum pass: verdicts wrong", rejected[:10]))
    layout = v.last_shard_layout
    _check(layout is not None and [d for d, _ in layout] == mesh, ("layout", layout))
    lanes = {sz for _, sz in layout}
    _check(len(lanes) == 1, ("uneven shards", layout))
    stats = v.stats()
    _check((stats["tpu_batches"], stats["tpu_sigs"], stats["cpu_sigs"]) == (1, n, 0), stats)
    print(
        f"dryrun_multichip: quorum pass ok — {n} sigs over {n_devices} {device} "
        f"shards, {lanes.pop()} lanes/shard, forged lanes rejected at {forged_at}"
    )
