"""The port's C3D video IS (evaluation/c3d.py) against the JAX package's on
the CPU: the network on the chainer-npz arrays (the JAX suite's narrow
variant of the graph, and the published widths once), the preprocessing
(OpenCV's bicubic there, torch's here), the TGAN IS and the whole score.

Limits: the network rtol 2e-4 / atol 2e-5 (tests/test_c3d.py); the
preprocessing 1 step of uint8 (the resize's documented difference) on the
mean-subtracted values; the score 1e-3 relative (it follows the 1-step
resize difference through the network); the IS formula 1e-10."""

import numpy as np
import pytest
import torch

from mm_diffusion_tpu.evaluation import c3d as jax_c3d
from mm_diffusion_tpu_torch.evaluation import c3d
from test_c3d import _fake_weights, _save_npz
from torch_port_common import one_torch_thread  # noqa: F401

PUBLISHED = {"conv1a": (3, 64), "conv2a": (64, 128), "conv3a": (128, 256), "conv3b": (256, 256),
             "conv4a": (256, 512), "conv4b": (512, 512), "conv5a": (512, 512), "conv5b": (512, 512)}


def _published_weights(rng):
    raw = {}
    for name, (cin, cout) in PUBLISHED.items():
        raw[f"{name}/W"] = (rng.standard_normal((cout, cin, 3, 3, 3)) / np.sqrt(27 * cin)).astype(np.float32)
        raw[f"{name}/b"] = (rng.standard_normal(cout) * 0.05).astype(np.float32)
    for name, (cin, cout) in {"fc6": (8192, 4096), "fc7": (4096, 4096), "fc8": (4096, 101)}.items():
        raw[f"{name}/W"] = (rng.standard_normal((cout, cin)) / np.sqrt(cin)).astype(np.float32)
        raw[f"{name}/b"] = (rng.standard_normal(cout) * 0.05).astype(np.float32)
    return raw


@pytest.mark.parametrize("widths", ["narrow", "published"])
def test_c3d_forward_matches_jax(tmp_path, widths):
    rng = np.random.default_rng(0)
    raw = _fake_weights(rng) if widths == "narrow" else _published_weights(rng)
    _save_npz(tmp_path / "c3d.npz", raw, leading_slash=True)
    x = rng.standard_normal((2 if widths == "narrow" else 1, 16, 112, 112, 3)).astype(np.float32)
    got = c3d.c3d_apply(c3d.load_c3d_npz(str(tmp_path / "c3d.npz")), torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_c3d.c3d_apply(jax_c3d.load_c3d_npz(str(tmp_path / "c3d.npz")), x))
    assert got.shape == (x.shape[0], 101)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("size", [(64, 64), (256, 256), (48, 80)])
def test_preprocess_matches_jax(size):
    rng = np.random.RandomState(1)
    videos = rng.randint(0, 256, (2, 12, *size, 3)).astype(np.uint8)  # 12 frames: padded to 16
    mean = rng.uniform(0, 255, (3, 1, 16, 128, 128)).astype(np.float32)
    got = c3d.preprocess_videos_c3d(videos, mean).numpy()
    ref = jax_c3d.preprocess_videos_c3d(videos, mean)
    assert got.shape == ref.shape == (2, 16, 112, 112, 3)
    assert np.abs(got - ref).max() <= 1.0 + 1e-4


def test_tgan_is_and_score_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    _save_npz(tmp_path / "c3d.npz", _fake_weights(rng))
    np.savez(tmp_path / "mean2.npz", mean=rng.uniform(0, 255, (3, 16, 128, 171)).astype(np.float32))
    ys = rng.dirichlet(np.ones(101), size=7)
    assert c3d.calc_inception_tgan(ys) == pytest.approx(jax_c3d.calc_inception_tgan(ys), rel=1e-10)
    videos = rng.integers(0, 256, (5, 16, 64, 64, 3), dtype=np.uint8)
    args = (videos, str(tmp_path / "c3d.npz"), str(tmp_path / "mean2.npz"))
    got = c3d.video_inception_score_c3d(*args, batch_size=2, device="cpu")
    ref = jax_c3d.video_inception_score_c3d(*args, batch_size=2)
    assert got == pytest.approx(ref, rel=1e-3)
