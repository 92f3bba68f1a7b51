"""The port stands alone: tendermint_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package, and the port's entry points refuse to
run on a card that is not there."""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tendermint_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(ROOT).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path}: imports {mod}"
        assert top != "tendermint_tpu", f"{path}: imports {mod}"


def test_every_module_imports_with_jax_blocked():
    """A fresh interpreter where `import jax` fails imports every port
    module and chip_smoke."""
    names = [_module_name(p) for p in PORT_FILES]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tendermint_tpu'] = None\n"
        f"import importlib\nfor n in {names!r}:\n    importlib.import_module(n)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m])\n"
        "print('ok', len(" + repr(names) + "))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_default_device_verifier_needs_a_card(monkeypatch):
    from tendermint_tpu_torch.ops import ed25519_f32p
    from tendermint_tpu_torch.ops.gateway import Verifier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Verifier()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ed25519_f32p.verify_batch([(b"\x00" * 32, b"", b"\x00" * 64)])
    assert Verifier(device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, chip_smoke.py exits non-zero and prints no
    result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, str(lone)], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
