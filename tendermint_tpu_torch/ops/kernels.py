"""Build and bind the port's CUDA kernels.

Each source in `csrc/` compiles with nvcc into a shared library with a
plain C interface, loaded with ctypes: pointers and the stream pass as
`c_void_p`, counts as `c_int`. The build runs at first use into
`build/kernels/` at the repository root, and again whenever the source is
newer than the library. Nothing here runs at import: the CPU tests import
every module on machines with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "kernels",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # nvcc's output (-Xptxas -v: registers, spills) per source


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def build(name: str) -> float:
    """Compile csrc/<name>.cu into build/kernels/lib<name>.so if the
    library is missing or older than its source. Returns the seconds spent
    compiling (0.0 when the library was current)."""
    src = os.path.join(_CSRC, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True
    )
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{build_log[name]}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return time.perf_counter() - t0


_vp, _i32 = ctypes.c_void_p, ctypes.c_int
# (C entry, argtypes) per source in csrc/
_ENTRIES = {
    # ax, ay, ry, rsign, s8, h8, out, n, stream
    "ed25519_verify": ("tm_ed25519_verify", [_vp] * 7 + [_i32, _vp]),
}


def load(name: str) -> ctypes.CDLL:
    """The bound library for csrc/<name>.cu, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
            entry, argtypes = _ENTRIES[name]
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = _i32
            _libs[name] = lib
        return lib
