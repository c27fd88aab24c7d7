"""The PyTorch port never imports JAX nor anything of the JAX package: every
module imports, a tiny forward of both models and of the single-modal video
and audio U-Nets, a tiny training loss and backward, one tiny SR train
step, one tiny step of the conditional sampler's gradient method, the
flash MHA and spike-kernel entry points, the A/B tools and the parallel
layer's one-process path run, in a fresh interpreter where jax / flax / optax
cannot be
imported, and no module of the JAX package gets loaded -- not even one that
does not import JAX.  No port module and not chip_smoke.py has an import of
the JAX package, and library attention is timed only as chip_smoke.py's
yardstick."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "mm_diffusion_tpu_torch"

PROBE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "cv2", "PIL", "tensorflow"):
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

from mm_diffusion_tpu_torch.train.state import mm_model_fn
model.train()
diffusion = configs.create_gaussian_diffusion(steps=100)
x0 = {"video": torch.rand(2, 4, 16, 16, 3) * 2 - 1, "audio": torch.rand(2, 1024, 1) * 2 - 1}
loss = diffusion.training_losses(mm_model_fn(model, 1), x0, torch.tensor([0, 7]))["loss"].mean()
loss.backward()
assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in model.parameters())

from mm_diffusion_tpu_torch.sampling import mm_raw_model
from mm_diffusion_tpu_torch.samplers import conditional_gradient_step
model.eval().requires_grad_(False)
raw = mm_raw_model(model)
x_T = {"video": torch.randn(1, 4, 16, 16, 3), "audio": torch.randn(1, 1024, 1)}
cond = torch.rand(1, 1024, 1) * 2 - 1
with torch.no_grad():
    step_loss, step_grad, prev = conditional_gradient_step(
        diffusion, lambda x, tt: raw(x, tt, strip_sigma=False),
        {**x_T, "audio": diffusion.q_sample(cond, torch.tensor([50]), x_T["audio"])},
        torch.tensor([50]), cond, "audio", x_T["audio"])
assert step_grad.shape == x_T["video"].shape and bool(step_grad.abs().max() > 0)
assert bool(torch.isfinite(step_loss)) and bool(torch.isfinite(step_grad).all())
assert all(bool(torch.isfinite(v).all()) for v in prev.values())

from mm_diffusion_tpu_torch.models.single_unet import SingleModalUNet, SingleUNetConfig
for kw in (dict(modality="video", video_size=(2, 3, 8, 8)), dict(modality="audio", audio_size=(1, 256))):
    single = randomize_(SingleModalUNet(SingleUNetConfig(model_channels=16, num_res_blocks=1,
        attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2, out_channels=3 if
        kw["modality"] == "video" else 1, dtype="float32", **kw)), 2).eval()
    with torch.no_grad():
        y = single(torch.randn((1,) + single.cfg.sample_shape), torch.tensor([5]))
    assert y.shape == (1,) + single.cfg.sample_shape and bool(torch.isfinite(y).all())

from mm_diffusion_tpu_torch.scripts.image_sr_train import synthetic_sr_data
from mm_diffusion_tpu_torch.train import ImageSRTask, create_train_state, make_optimizer, make_train_step
sr.train()
sr_state = create_train_state(sr, make_optimizer(sr, 1e-4), num_timesteps=100)
sr_batch = {k: torch.from_numpy(v) for k, v in next(synthetic_sr_data(2, 64, 16)).items()}
sr_diffusion = configs.create_gaussian_diffusion(steps=100, learn_sigma=True)
sr_metrics = make_train_step(sr_diffusion, adapter=ImageSRTask().adapter(None))(sr_state, sr_batch)
assert bool(torch.isfinite(sr_metrics["loss"])) and sr_state.step == 1

from mm_diffusion_tpu_torch.parallel import ParallelModel, make_mesh, param_spec, rank_rows, setup_dist
assert setup_dist("cpu") == torch.device("cpu") and make_mesh(device_type="cpu") is None
assert ParallelModel(sr).kind == "single" and param_spec((64, 32, 3, 3), 2, 16) == 0
assert rank_rows(torch.arange(4), 1, 2).tolist() == [2, 3]

from mm_diffusion_tpu_torch.ops import block_attention, fused_attention, gemm_conv
x = torch.randn(1, 8, 2, 64, requires_grad=True)
fused_attention.flash_mha(x, x, x).sum().backward()
fused_attention.flash_mha_bhtd(x, x, x)
for variant in block_attention.VARIANTS:
    block_attention.self_attention_variant(torch.randn(2, 16, 3 * 64), 1, variant)
y = torch.randn(1, 4, 4, 8)
gemm_conv.skip_gemm(y, y, torch.randn(16, 8))
gemm_conv.conv3x3_chw(y, torch.randn(8, 4, 3, 3))
gemm_conv.gemm_blocks(torch.randn(8, 4), y)
from mm_diffusion_tpu_torch.tools import bench_attn_variants, bench_skip_conv, conv_chw_spike
bench_attn_variants.main(["--device", "cpu", "--small", "--replays", "1"])
bench_skip_conv.main(["--device", "cpu", "--small", "--replays", "1"])
conv_chw_spike.main(["gemm", "--device", "cpu", "--small", "--replays", "1"])

import os, tempfile
import numpy as np
from mm_diffusion_tpu_torch.evaluation import eval_multimodal
from mm_diffusion_tpu_torch.evaluation.npz_batch import save_av_npz_batch
work = tempfile.mkdtemp()
rng = np.random.default_rng(0)
# 44.1 kHz, the protocol's rate: scipy's resampler probes sys.modules["jax"], which the block sets to None
sets = [save_av_npz_batch(os.path.join(work, name), rng.uniform(-1, 1, (2, 3, 16, 16, 3)),
                          rng.uniform(-1, 1, (2, 2205)), 10, 44100) for name in ("real", "fake")]
metrics = eval_multimodal(*sets, eval_num=2, batch_size=2, device="cpu")
assert metrics["protocol"] == "fallback" and all(np.isfinite(metrics[k]) for k in ("fvd", "kvd", "fad"))

loaded = [m for m, mod in sys.modules.items()
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cv2", "PIL", "tensorflow")
          and mod is not None]
assert not loaded, loaded
jax_pkg = sorted(m for m in sys.modules if m.split(".")[0] == "mm_diffusion_tpu")
print("MODULES", len(names))
print("NAMES", ",".join(names))
print("JAXPKG", ",".join(jax_pkg))
"""

ALLOWED_FROM_JAX_PACKAGE: set = set()
# The conditional CLIs, the flash MHA and spike-kernel modules, the A/B
# tools, the data loaders, the single-modal model, BertAdam, the SR and
# single-modal train CLIs and the parallel layer: imported (the tools also
# run, plain versions, small shapes; the parallel layer's one-process
# path) by the probe above, and scanned below.
NEW_MODULES = {
    "mm_diffusion_tpu_torch.scripts.audio2video_sample_sr",
    "mm_diffusion_tpu_torch.scripts.video2audio_sample",
    "mm_diffusion_tpu_torch.ops.fused_attention",
    "mm_diffusion_tpu_torch.ops.gemm_conv",
    "mm_diffusion_tpu_torch.utils.timing",
    "mm_diffusion_tpu_torch.tools.bench_attn_variants",
    "mm_diffusion_tpu_torch.tools.bench_skip_conv",
    "mm_diffusion_tpu_torch.tools.conv_chw_spike",
    "mm_diffusion_tpu_torch.data.video",
    "mm_diffusion_tpu_torch.data.image",
    "mm_diffusion_tpu_torch.models.single_unet",
    "mm_diffusion_tpu_torch.train.optimization",
    "mm_diffusion_tpu_torch.scripts.image_sr_train",
    "mm_diffusion_tpu_torch.scripts.single_modal_train",
    "mm_diffusion_tpu_torch.parallel.bootstrap",
    "mm_diffusion_tpu_torch.parallel.mesh",
    "mm_diffusion_tpu_torch.utils.seeds",
    # the evaluation layer and its CLIs; a tiny eval_multimodal runs on the
    # fallback route with cv2, PIL and tensorflow blocked too
    *(f"mm_diffusion_tpu_torch.evaluation.{m}" for m in (
        "audio_embed", "audioclip", "c3d", "clip_model", "common", "evaluator", "graphdef", "i3d",
        "image_eval", "inception_score", "metrics", "npz_batch", "resize", "tf_bundle")),
    "mm_diffusion_tpu_torch.scripts.eval",
    "mm_diffusion_tpu_torch.scripts.image_eval",
    "mm_diffusion_tpu_torch.scripts.video_is",
}
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
JAX_PACKAGE_IMPORT = re.compile(r"^\s*(from|import)\s+mm_diffusion_tpu(\.|\s|$)", re.M)


def test_port_imports_and_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.split(" ", 1)[0] in ("MODULES", "NAMES", "JAXPKG"))
    assert int(lines["MODULES"]) >= 25
    assert NEW_MODULES <= set(lines["NAMES"].split(","))
    assert set(filter(None, lines["JAXPKG"].split(","))) <= ALLOWED_FROM_JAX_PACKAGE


@pytest.mark.parametrize(
    "needle",
    [
        "import jax", "from jax", "import flax", "from flax", "import optax",
        "scaled_dot_product_attention", "torch.compile",
    ],
)
def test_port_sources_use_no_jax_and_no_library_attention(needle):
    """No needle in any port module or chip_smoke.py, except that chip_smoke.py
    calls scaled_dot_product_attention inside the one function that times
    the library yardstick."""
    hits = [str(p.relative_to(REPO)) for p in SOURCES if needle in p.read_text()]
    if needle == "scaled_dot_product_attention":
        assert hits == ["chip_smoke.py"]
        smoke = (REPO / "chip_smoke.py").read_text()
        (fn,) = [n for n in ast.walk(ast.parse(smoke))
                 if isinstance(n, ast.FunctionDef) and n.name == "library_attention_ms"]
        lines = [i for i, line in enumerate(smoke.splitlines(), 1) if needle in line]
        assert all(fn.lineno <= i <= fn.end_lineno for i in lines)
    else:
        assert hits == []


def test_port_sources_import_nothing_of_the_jax_package():
    scanned = {".".join(p.relative_to(REPO).with_suffix("").parts) for p in SOURCES}
    assert NEW_MODULES <= scanned
    hits = [str(p.relative_to(REPO)) for p in SOURCES if JAX_PACKAGE_IMPORT.search(p.read_text())]
    assert hits == []
    assert JAX_PACKAGE_IMPORT.search("from mm_diffusion_tpu.data import media")  # the needle works
    assert not JAX_PACKAGE_IMPORT.search("from mm_diffusion_tpu_torch.data import media")
