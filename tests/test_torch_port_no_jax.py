"""The PyTorch port never imports JAX: every module imports, and a tiny
forward of both models runs, in a fresh interpreter where jax / flax /
optax cannot be imported.  The only modules of the JAX package it may load
are its two JAX-free host modules (media IO and the logger)."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "mm_diffusion_tpu_torch"

PROBE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None  # any import of them raises ImportError

import torch
torch.set_num_threads(1)
import mm_diffusion_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    mm_diffusion_tpu_torch.__path__, "mm_diffusion_tpu_torch."))
for name in names:
    importlib.import_module(name)

from mm_diffusion_tpu_torch import configs
from mm_diffusion_tpu_torch.models.image_unet import ImageSuperResModel
from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
from mm_diffusion_tpu_torch.weights import randomize_
cfg = configs.create_model_config(video_size="4,3,16,16", audio_size="1,1024",
    num_channels=32, num_res_blocks=1, channel_mult="1,2", cross_attention_resolutions="2",
    cross_attention_windows="2", video_attention_resolutions="2", num_heads=2)
model = randomize_(MultimodalUNet(cfg), 0).eval()
sr = randomize_(ImageSuperResModel(configs.create_image_sr_config(
    large_size=64, sr_num_channels=32, sr_num_res_blocks=1, sr_attention_resolutions="8")), 1).eval()
with torch.no_grad():
    v, a = model(torch.randn(1, 4, 16, 16, 3), torch.randn(1, 1024, 1), torch.tensor([3]), shift=1)
    x = sr(torch.randn(2, 64, 64, 3), torch.tensor([3, 4]), torch.randn(2, 16, 16, 3))
assert v.shape == (1, 4, 16, 16, 3) and a.shape == (1, 1024, 1) and x.shape == (2, 64, 64, 6)
assert all(bool(torch.isfinite(y).all()) for y in (v, a, x))

loaded = [m for m, mod in sys.modules.items()
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax") and mod is not None]
assert not loaded, loaded
jax_pkg = sorted(m for m in sys.modules if m.split(".")[0] == "mm_diffusion_tpu")
print("MODULES", len(names))
print("JAXPKG", ",".join(jax_pkg))
"""

ALLOWED_FROM_JAX_PACKAGE = {
    "mm_diffusion_tpu",
    "mm_diffusion_tpu.data",
    "mm_diffusion_tpu.data.media",
    "mm_diffusion_tpu.data.synthetic",
    "mm_diffusion_tpu.utils",
    "mm_diffusion_tpu.utils.logger",
}


def test_port_imports_and_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines() if " " in line)
    assert int(lines["MODULES"]) >= 15
    assert set(lines["JAXPKG"].split(",")) <= ALLOWED_FROM_JAX_PACKAGE


@pytest.mark.parametrize(
    "needle",
    [
        "import jax", "from jax", "import flax", "from flax", "import optax",
        "scaled_dot_product_attention", "torch.compile",
    ],
)
def test_port_sources_use_no_jax_and_no_library_attention(needle):
    hits = [
        str(p.relative_to(REPO))
        for p in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
        if needle in p.read_text()
    ]
    assert hits == []
