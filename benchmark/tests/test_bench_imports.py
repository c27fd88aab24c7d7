"""What the benchmark loads: nothing whose top-level module name is
``jax``, ``jaxlib``, ``flax`` or ``mm_diffusion_tpu`` (names compared
whole: the port's own name begins with the JAX package's), and a
reference that loads nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "mm_diffusion_tpu"}


def loaded_top_level(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter (from the repository's root)."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
    )
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_benchmark_and_the_port_it_drives_load_no_jax():
    drivers = sorted(p.stem for p in (BENCH / "drivers").glob("*.py"))
    metrics = sorted(p.name for p in (BENCH / "metrics").glob("*.*.py"))
    code = (
        "from benchmark import run, calibrate\n"
        f"for d in {drivers!r}: run.load_file(run.BENCH / 'drivers' / (d + '.py'))\n"
        f"for m in {metrics!r}: run.load_file(run.BENCH / 'metrics' / m)\n"
        # what the drivers' set-up imports of the port
        "import mm_diffusion_tpu_torch.configs, mm_diffusion_tpu_torch.sampling\n"
        "import mm_diffusion_tpu_torch.models.mm_unet, mm_diffusion_tpu_torch.models.image_unet\n"
        "import mm_diffusion_tpu_torch.train.state\n"
    )
    loaded = loaded_top_level(code)
    assert "mm_diffusion_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = loaded_top_level(
        "import benchmark.reference.mm_unet, benchmark.reference.image_unet, "
        "benchmark.reference.diffusion, benchmark.reference.train, benchmark.work, benchmark.weights")
    assert not loaded & (FORBIDDEN | {"mm_diffusion_tpu_torch"})


def test_the_reference_sources_import_no_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] in {"torch", "numpy", "math", "dataclasses", "typing",
                                              "__future__"}, (path.name, name)
