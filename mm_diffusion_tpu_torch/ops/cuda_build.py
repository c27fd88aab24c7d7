"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use, in ``build/kernels/<hash>/`` at the
root of the checkout, keyed by a hash of the sources, so a fresh checkout
builds everything from its own sources and a rebuilt source never loads a
stale library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("attention_common.cuh", "self_attention.cu", "banded_attention.cu")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libmmdiff_attention.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points (see the .cu files).
SIGNATURES = {
    "mmdiff_self_attention_fwd": [_P, _P, _P] + [_I] * 8 + [_P],
    "mmdiff_banded_attention_fwd": [_P, _P, _P, _P] + [_I] * 9 + [_P],
}


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date library was found
    log: str  # nvcc's output (ptxas register / shared-memory report)


_lock = threading.Lock()
_loaded: BuiltLibrary | None = None


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the attention "
        "kernels are built from source with the CUDA toolkit"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile the library unless an up-to-date one exists.  Returns its
    path, the seconds spent compiling and nvcc's output."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib_path.exists():
        return lib_path, 0.0, log_path.read_text() if log_path.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(CSRC / s) for s in SOURCES if s.endswith(".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, seconds, log


def load() -> BuiltLibrary:
    """Build on first use and load the library (once per process)."""
    global _loaded
    with _lock:
        if _loaded is None:
            path, seconds, log = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded = BuiltLibrary(lib, path, seconds, log)
        return _loaded
