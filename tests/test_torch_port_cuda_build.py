"""The kernel build's lock, on the CPU with a stand-in for nvcc: two
processes that build at once (the ranks of a torchrun launch) compile
the sources once; the second waits and finds the first's library.  And the
C boundary: every ctypes row of ``cuda_build.SIGNATURES`` against the
``extern "C"`` prototype in ``ops/csrc`` (a row that drifts from its
prototype misreads arguments on the card, where no CPU test reaches)."""

import ctypes
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

from mm_diffusion_tpu_torch.ops import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = pathlib.Path(cuda_build.__file__).resolve().parent

FAKE_NVCC = textwrap.dedent("""\
    #!/bin/sh
    # stands in for nvcc: counts its calls, sleeps, writes an empty output
    echo call >> "$NVCC_CALLS"
    out=""
    while [ $# -gt 0 ]; do
      if [ "$1" = "-o" ]; then out="$2"; fi
      shift
    done
    sleep 1
    : > "$out"
""")

BUILD = textwrap.dedent("""\
    import pathlib, sys
    from mm_diffusion_tpu_torch.ops import cuda_build
    cuda_build.BUILD_ROOT = pathlib.Path(sys.argv[1])
    path, seconds, _ = cuda_build.build()
    print(path.name, "compiled" if seconds > 0 else "found")
""")


def test_concurrent_builds_compile_once(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    calls = tmp_path / "calls"
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}", NVCC_CALLS=str(calls),
               PYTHONPATH=REPO)
    procs = [
        subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path / "kernels")], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(2)
    ]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert sorted(o.split()[-1] for o in outs) == ["compiled", "found"]
    sources = [s for s in cuda_build.SOURCES if s.endswith(".cu")]
    assert len(calls.read_text().split()) == len(sources) + 1  # each source once, one link
    (built,) = (tmp_path / "kernels").iterdir()
    assert (built / cuda_build.LIB_NAME).exists() and (built / "build.lock").exists()


def _c_entries() -> dict:
    """``{name: [ctypes type of each parameter]}`` of every ``extern "C"``
    function in ``ops/csrc``: a pointer is ``c_void_p``, ``long long``
    ``c_longlong``, ``float`` ``c_float``, ``int`` ``c_int``."""
    entries = {}
    for path in sorted(cuda_build.CSRC.glob("*.cu*")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            kinds = []
            for param in filter(None, (p.strip() for p in params.split(","))):
                if "*" in param:
                    kinds.append(ctypes.c_void_p)
                elif param.startswith("long long "):
                    kinds.append(ctypes.c_longlong)
                elif param.startswith("float "):
                    kinds.append(ctypes.c_float)
                elif param.startswith("int "):
                    kinds.append(ctypes.c_int)
                else:
                    raise AssertionError(f"{path.name}: {name}: parameter {param!r} of no known kind")
            assert name not in entries, f"{name} declared twice"
            entries[name] = kinds
    return entries


@pytest.mark.parametrize("name", sorted(cuda_build.SIGNATURES))
def test_signature_matches_its_c_prototype(name):
    entries = _c_entries()
    assert name in entries, f'no extern "C" int {name}(...) in {cuda_build.CSRC}'
    assert cuda_build.SIGNATURES[name] == entries[name]
    callers = [p.name for p in sorted(OPS.glob("*.py"))
               if p.name != "cuda_build.py" and re.search(rf"\b{name}\b", p.read_text())]
    assert callers, f"no module of ops/ names {name}"


def test_every_c_entry_has_a_signature():
    assert sorted(_c_entries()) == sorted(cuda_build.SIGNATURES)
