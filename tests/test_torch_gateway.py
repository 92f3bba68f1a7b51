"""The port's gateway beyond plain batches: the kernel registry behind
TENDERMINT_TPU_KERNEL, the verify-ahead path (prime_cache_async /
pop_primed) and its failure contract, and the kernel build's
dependency check."""

from __future__ import annotations

import os
import subprocess
import threading

import pytest

from test_torch_verify import FAMILIES
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.ops import ed25519_f32p as tf32p
from tendermint_tpu_torch.ops import ed25519_pallas as tb2
from tendermint_tpu_torch.ops import gateway, kernels
from tendermint_tpu_torch.ops.gateway import Verifier


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(f"{module.__name__.rsplit('.', 1)[-1]}.{name}")
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.fixture
def routes(monkeypatch):
    """The kernel modules' entry points each Verifier batch went through."""
    calls: list[str] = []
    _spy(monkeypatch, tf32p, "verify_batch_async", calls)
    _spy(monkeypatch, tb2, "verify_batch", calls)
    return calls


def test_default_kernel_is_f32p(monkeypatch, routes):
    monkeypatch.delenv("TENDERMINT_TPU_KERNEL", raising=False)
    assert gateway.kernel_name() == "f32p"
    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", "")
    v = Verifier(min_tpu_batch=1, device="cpu")
    assert v.kernel == "f32p"
    items = FAMILIES["odd"]()
    assert v.verify_batch(items) == [ted.verify(*it) for it in items]
    assert routes == ["ed25519_f32p.verify_batch_async"]


def test_pallas_selects_b2_once_per_verifier(monkeypatch, routes):
    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", "pallas")
    v = Verifier(min_tpu_batch=1, device="cpu")
    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", "f32p")  # read once: no effect now
    items = FAMILIES["odd"]()
    resolve = v.verify_batch_async(items)  # B2 verifies now, the resolver returns it
    assert routes == ["ed25519_pallas.verify_batch"]
    assert resolve() == [ted.verify(*it) for it in items]
    assert v.kernel == "pallas" and Verifier(device="cpu").kernel == "f32p"
    assert v.stats()["tpu_batches"] == 1 and v.stats()["tpu_sigs"] == len(items)


PORTED = r"\['comb', 'devd', 'f32', 'f32p', 'int32', 'pallas'\]"


@pytest.mark.parametrize("name", ["comb", "f32", "int32", "devd"])
def test_jax_only_kernels_raise_naming_the_ported_ones(monkeypatch, name):
    """No JAX-only name is left: the registry has every name of the JAX
    package's, devd included. `name` builds a Verifier of that kernel, and
    a name neither registry has raises naming every one of them."""
    from tendermint_tpu.ops import gateway as jgateway

    assert sorted(gateway.KERNELS) == sorted(jgateway.KERNELS)
    assert not hasattr(gateway, "_NOT_PORTED")
    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", name)
    assert Verifier(device="cpu").kernel == name
    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", name + "x")
    with pytest.raises(ValueError, match=r"expected one of " + PORTED):
        Verifier(device="cpu")


def test_unknown_kernel_raises_as_in_jax(monkeypatch):
    from tendermint_tpu.ops import gateway as jgateway

    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", "cuda")
    with pytest.raises(ValueError, match=r"expected one of " + PORTED) as mine:
        gateway.kernel_name()
    with pytest.raises(ValueError) as theirs:
        jgateway.kernel_name()
    assert str(mine.value).split(":")[0] == str(theirs.value).split(":")[0]


def _families() -> list:
    """Every verify family of tests/test_torch_verify.py in one batch."""
    return [it for name in sorted(FAMILIES) for it in FAMILIES[name]()]


def test_f32_selects_b3_on_the_verifier_device(monkeypatch, routes):
    """`f32` runs B3's verify_plain on the verifier's device, with the JAX
    package's f32 kernel's verdicts, and pipelines like f32p."""
    from tendermint_tpu.ops import ed25519_f32 as jf32
    from tendermint_tpu_torch.ops import ed25519_f32 as tf32

    _spy(monkeypatch, tf32, "verify_batch_async", routes)
    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", "f32")
    v = Verifier(min_tpu_batch=1, device="cpu")
    items = FAMILIES["tampered"]()
    assert v.kernel == "f32"
    got = v.verify_batch_async(items)()
    assert routes == ["ed25519_f32.verify_batch_async"]
    assert got == [bool(b) for b in jf32.verify_batch(items)] == [ted.verify(*it) for it in items]
    # the two bad-length lanes verify on the CPU (the key-type split)
    assert v.stats() | {"tpu_batches": 1, "tpu_sigs": 8, "cpu_sigs": 2} == v.stats()


def test_int32_selects_the_int32_verify(monkeypatch, routes):
    """`int32` runs verify_int32_plain synchronously, as JAX's int32 module
    does; its verdicts against the JAX int32 kernel are
    tests/test_torch_int32.py's."""
    from tendermint_tpu_torch.ops import ed25519 as ted32

    _spy(monkeypatch, ted32, "verify_batch", routes)
    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", "int32")
    v = Verifier(min_tpu_batch=1, device="cpu")
    items = _families()
    resolve = v.verify_batch_async(items)
    assert routes == ["ed25519.verify_batch"]
    assert resolve() == [ted.verify(*it) for it in items]
    ed_lanes = sum(gateway._ed25519_lane(it) for it in items)
    assert v.kernel == "int32" and v.stats()["tpu_sigs"] == ed_lanes < len(items)


def test_comb_selects_b4_with_the_jax_routing(monkeypatch, routes):
    """`comb` under the default second-sight policy: a commit's first block
    rides the ladder (B1), its second the comb kernel, with the JAX comb
    kernel's verdicts and pool stats on the same call sequence."""
    from tendermint_tpu.ops import ed25519_comb as jcomb
    from tendermint_tpu_torch.ops import ed25519_comb as tcomb

    _spy(monkeypatch, tcomb, "_dispatch_comb", routes)
    monkeypatch.delenv("TENDERMINT_TPU_COMB_MIN_SIGHT", raising=False)
    monkeypatch.setenv("TENDERMINT_TPU_KERNEL", "comb")
    tcomb.reset_default_pool()
    jcomb.reset_default_pool()
    try:
        v = Verifier(min_tpu_batch=1, device="cpu")
        for block in (FAMILIES["tampered"](), FAMILIES["tampered"]()):
            got = v.verify_batch(block)
            assert got == [bool(b) for b in jcomb.verify_batch(block)]
            assert got == [ted.verify(*it) for it in block]
        # the bad-length lanes never reach the kernel (the key-type split)
        assert routes == ["ed25519_f32p.verify_batch_async", "ed25519_comb._dispatch_comb"]
        assert tcomb.default_pool("cpu").stats == jcomb.default_pool().stats
        # the keys of the lanes the host marshal accepts: pubs 0-3 and 01..01
        assert tcomb.default_pool("cpu").stats["build_keys"] == 5
    finally:
        tcomb.reset_default_pool()
        jcomb.reset_default_pool()


def _signed(n, salt):
    seeds = [bytes([salt + i + 1]) * 32 for i in range(n)]
    return [(ted.public_key(s), b"p%d-%d" % (salt, i), ted.sign(s, b"p%d-%d" % (salt, i)))
            for i, s in enumerate(seeds)]


def test_prime_cache_async_then_pop_in_any_order_single_use():
    v = Verifier(min_tpu_batch=4, device="cpu")
    first, second = _signed(6, 0), _signed(5, 40)
    second[2] = (second[2][0], second[2][1], b"\x00" * 64)
    done = []
    v.prime_cache_async(first, on_done=done.append)
    v.prime_cache_async(second)
    v.prime_cache_async([])
    assert [v.pop_primed(it) for it in reversed(second)] == [True, True, False, True, True]
    assert [v.verify_one(*it) for it in first] == [True] * 6
    assert len(done) == 1 and done[0] >= 0.0
    assert v.pop_primed(first[0]) is None  # single use
    assert v.pop_primed(_signed(1, 90)[0]) is None  # never primed
    s = v.stats()
    assert s["tpu_batches"] == 2 and s["tpu_sigs"] == 11 and s["cpu_sigs"] == 0


def test_failed_prime_batch_reraises_instead_of_unpriming(monkeypatch):
    """JAX unprimes the items of a failed batch, so verify_one re-verifies
    them on the CPU; the port re-raises the failure where it is read."""
    v = Verifier(min_tpu_batch=1, device="cpu")
    release = threading.Event()

    def failing_resolve():
        release.wait(5)
        raise RuntimeError("ed25519_verify kernel launch failed: cudaError 700")

    monkeypatch.setattr(v, "verify_batch_async", lambda items: failing_resolve)
    items = _signed(3, 60)
    v.prime_cache_async(items)
    release.set()
    for it in items[:2]:
        with pytest.raises(RuntimeError, match="cudaError 700"):
            v.pop_primed(it)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        v.verify_one(*items[2])
    assert v.stats()["cpu_sigs"] == 0


@pytest.mark.parametrize("where", ["launch", "read-back", "dsm"])
def test_kernel_failure_raises_device_error(where, monkeypatch):
    """A kernel failure on the in-process route raises DeviceError, a
    RuntimeError that keeps the cause's message, at the launch, at the
    read-back, and in the aggregate verify's dsm launch: what consensus
    stops on instead of reading it as a bad vote or block."""
    from tendermint_tpu_torch.crypto import ed25519_agg
    from tendermint_tpu_torch.ops import ed25519 as ted32

    def boom(*args, **kwargs):
        raise RuntimeError("kernel launch failed: cudaError 700")

    v = Verifier(min_tpu_batch=1, device="cpu")
    items = _signed(3, 70)
    if where == "launch":
        monkeypatch.setattr(tf32p, "verify_batch_async", boom)
        call = lambda: v.verify_batch(items)  # noqa: E731
    elif where == "read-back":
        monkeypatch.setattr(tf32p, "verify_batch_async", lambda items, device: boom)
        call = lambda: v.verify_batch(items)  # noqa: E731
    else:
        monkeypatch.setattr(ted32, "dsm_batch", boom)
        rs, s_agg = ed25519_agg.aggregate(items)
        call = lambda: v.verify_aggregate([i[0] for i in items], [i[1] for i in items], rs, s_agg)  # noqa: E731
    with pytest.raises(gateway.DeviceError, match="cudaError 700") as exc:
        call()
    assert isinstance(exc.value, RuntimeError)
    assert v.stats()["cpu_sigs"] == 0 and v.stats()["agg_lanes_cpu"] == 0


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    """kernels.build against a temporary csrc/ and a stub compiler that
    writes the library and records each compile."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// shared\n")
    (csrc / "other.cu").write_text("\n")
    compiles = []

    def fake_run(cmd, capture_output, text):
        target = cmd[cmd.index("-o") + 1]
        with open(target, "w") as f:
            f.write("lib")
        compiles.append(os.path.basename(cmd[-1]))
        return subprocess.CompletedProcess(cmd, 0, "ptxas info : Used 96 registers", "")

    monkeypatch.setattr(kernels, "_CSRC", str(csrc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(out))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "run", fake_run)
    return csrc, out, compiles


def _mtimes(*pairs):
    for path, t in pairs:
        os.utime(path, (t, t))


def test_build_rebuilds_when_a_header_is_newer(stub_build):
    csrc, out, compiles = stub_build
    cu, cuh, lib = csrc / "k.cu", csrc / "shared.cuh", out / "libk.so"
    kernels.build("k")
    assert compiles == ["k.cu"] and lib.exists()
    assert "96 registers" in kernels.build_log["k"]
    t = os.stat(lib).st_mtime
    _mtimes((cu, t - 100), (cuh, t - 100))
    assert kernels.build("k") == 0.0 and compiles == ["k.cu"]  # current
    _mtimes((cuh, t + 100))  # the header is edited
    kernels.build("k")
    assert compiles == ["k.cu", "k.cu"]
    _mtimes((lib, t), (cuh, t - 100), (cu, t + 100))  # the source is edited
    kernels.build("k")
    assert compiles == ["k.cu"] * 3


def test_build_all_compiles_each_source(stub_build):
    _, out, compiles = stub_build
    took = kernels.build_all(["k", "other"])
    assert sorted(took) == ["k", "other"] and sorted(compiles) == ["k.cu", "other.cu"]
    assert (out / "libother.so").exists()
