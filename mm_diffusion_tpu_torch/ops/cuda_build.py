"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use, in ``build/kernels/<hash>/`` at the
root of the checkout, keyed by a hash of the sources, so a fresh checkout
builds everything from its own sources and a rebuilt source never loads a
stale library.  Processes that start together (the ranks of a
``torchrun`` launch) build once: the first takes a lock on the build
directory and compiles, the others wait for it and load its library.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "attention_common.cuh",
    "attention_bwd_common.cuh",
    "attention_sm90.cuh",
    "banded_sm90.cuh",
    "self_attention.cu",
    "banded_attention.cu",
    "self_attention_bwd.cu",
    "banded_attention_bwd.cu",
    "flash_mha.cu",
    "skip_gemm.cu",
    "conv3x3_chw.cu",
    "group_norm_silu.cu",
)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libmmdiff_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (see the .cu files).  The attention
# entries take the logit scale after the head dims.
SIGNATURES = {
    "mmdiff_self_attention_fwd": [_P, _P, _P] + [_I] * 5 + [_F] + [_I] * 4 + [_P],
    "mmdiff_banded_attention_fwd": [_P, _P, _P, _P] + [_I] * 7 + [_F] + [_I] * 3 + [_P],
    "mmdiff_self_attention_bwd": [_P] * 6 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
    "mmdiff_banded_attention_bwd": [_P] * 8 + [_I] * 7 + [_F] + [_I] * 3 + [_P],
    "mmdiff_banded_attention_bwd_frames_per_tile": [_I] * 4,
    "mmdiff_self_attention_variant_fwd": [_P, _P] + [_I] * 5 + [_F] + [_I] * 6 + [_P],
    "mmdiff_self_attention_rows_blocks_per_sm": [_I],
    "mmdiff_flash_mha_fwd": [_P] * 5 + [_I] * 6 + [_F] + [_L] * 9 + [_I, _P],
    "mmdiff_flash_mha_fwd_mma": [_P] * 5 + [_I] * 6 + [_F] + [_L] * 9 + [_I, _P],
    "mmdiff_flash_mha_bwd": [_P] * 10 + [_I] * 6 + [_F] + [_L] * 9 + [_I, _P],
    "mmdiff_flash_mha_bwd_mma": [_P] * 10 + [_I] * 6 + [_F] + [_L] * 9 + [_I, _P],
    "mmdiff_gemm_bf16": [_P, _L, _L, _I] * 2 + [_P, _L, _L, _P, _L, _L] + [_I] * 4 + [_P],
    "mmdiff_conv3x3_chw": [_P] * 3 + [_I] * 5 + [_P],
    "mmdiff_channels_last_halo": [_P] * 2 + [_I] * 5 + [_P],
    "mmdiff_group_norm_silu": [_P] * 6 + [_L] + [_I] * 4 + [_L, _F, _I, _I, _P],
    "mmdiff_group_norm_silu_cl": [_P] * 6 + [_L] + [_I] * 4 + [_L, _F, _I, _P],
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
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the port's "
        "kernels are built from source with the CUDA toolkit"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands side by side; returns [(cmd, returncode, output)]."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    outputs = [(cmd, p.communicate()[0]) for cmd, p in procs]
    return [(cmd, p.returncode, out) for (cmd, out), (_, p) in zip(outputs, procs)]


def build() -> tuple[Path, float, str]:
    """Compile the library unless an up-to-date one exists.  Returns its
    path, the seconds spent compiling and nvcc's output.  One process
    compiles at a time (an ``flock`` on ``build.lock``, released by the
    kernel if the process dies); one that waited finds the library."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib_path.exists():
        return lib_path, 0.0, log_path.read_text() if log_path.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return lib_path, 0.0, log_path.read_text() if log_path.exists() else ""
        return _compile(out_dir, lib_path, log_path)


def _compile(out_dir: Path, lib_path: Path, log_path: Path) -> tuple[Path, float, str]:
    """Every source by its own nvcc, side by side, then one link."""
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    sources = [s for s in SOURCES if s.endswith(".cu")]
    objects = [out_dir / f"{s}.{tag}.o" for s in sources]
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
        for src, obj in zip(sources, objects)
    ]
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    t0 = time.perf_counter()
    results = _run_all(compiles)
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objects)]])
    seconds = time.perf_counter() - t0
    log = "".join(out for _, _, out in results)
    for obj in objects:
        obj.unlink(missing_ok=True)
    failed = [(cmd, rc, out) for cmd, rc, out in results if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
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
