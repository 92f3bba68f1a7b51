"""Build and bind the port's CUDA kernels.

Each source in `csrc/` compiles with nvcc into a shared library with a
plain C interface, loaded with ctypes: pointers and the stream pass as
`c_void_p`, counts as `c_int`. The build runs at first use into
`build/kernels/` at the repository root, and again whenever the source or
any shared header (`csrc/*.cuh`) is newer than the library. Nothing here
runs at import: the CPU tests import every module on machines with no nvcc
and no card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

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


def _newest_input(src: str) -> float:
    """mtime of the source or of the newest shared header it may include."""
    headers = [os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith(".cuh")]
    return max(os.path.getmtime(f) for f in [src, *headers])


def build(name: str) -> float:
    """Compile csrc/<name>.cu into build/kernels/lib<name>.so if the
    library is missing or older than its source or a csrc/*.cuh header.
    Returns the seconds spent compiling (0.0 when the library was
    current)."""
    src = os.path.join(_CSRC, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= _newest_input(src):
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


def build_all(names) -> dict[str, float]:
    """build() every source at once, one nvcc process each; the seconds
    each took."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


_vp, _i32 = ctypes.c_void_p, ctypes.c_int
# (C entry, argtypes) per source in csrc/
_ENTRIES = {
    # ax, ay, ry, rsign, s8, h8, out, n, stream
    "ed25519_verify": ("tm_ed25519_verify", [_vp] * 7 + [_i32, _vp]),
    # the same arguments (B2's 253 single-bit steps)
    "ed25519_verify_b2": ("tm_ed25519_verify_b2", [_vp] * 7 + [_i32, _vp]),
    # px, py, qx, qy, a8, b8, x8, y8, n, stream
    "ed25519_dsm": ("tm_ed25519_dsm", [_vp] * 8 + [_i32, _vp]),
    # wide, chains, out, iters, blocks, threads, stream: the multiply-rate probe
    "imad_rate": ("tm_imad_rate", [_i32, _i32, _vp, _i32, _i32, _i32, _vp]),
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
