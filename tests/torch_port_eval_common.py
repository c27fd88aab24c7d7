"""Shared helpers of the evaluation parity tests (tests/test_torch_port_eval_*.py):
seeded random weights for both weight directions, and flax trees as numpy.

Port -> JAX: every parameter and BatchNorm statistic of the port module is
randomised, its ``state_dict`` goes through the JAX package's own converter.
JAX -> port: a flax variable tree of the same shapes is filled from a numpy
seed and goes through ``mm_diffusion_tpu_torch/weights.py``.  Also the AV
sample-set fixture and the metric-dict comparison of the pipeline tests.
"""

import jax
import numpy as np
import pytest
import torch

from mm_diffusion_tpu.evaluation.npz_batch import save_av_npz_batch as jax_save_av_npz_batch


@torch.no_grad()
def randomize_eval_(model: torch.nn.Module, seed: int, keep=(), gain: float = 2.0) -> torch.nn.Module:
    """Weights ~ N(0, gain / fan_in) (He's 2 by default: the signal does not
    die through the deep towers, so the embeddings stay input-dependent),
    scales ~ 1 + N(0, 0.1^2), biases and embeddings' other 1-D parameters
    ~ N(0, 0.1^2), running means ~ N(0, 0.1^2), running variances ~
    U(0.5, 1): no identity BN or zero bias hides a mismatch.  Parameters
    named in ``keep`` stay as they are."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name in keep:
            continue
        noise = torch.randn(p.shape, generator=g)
        if p.dim() > 1:
            p.copy_(noise * np.sqrt(gain / p[0].numel()))
        elif name.endswith("weight"):
            p.copy_(1.0 + 0.1 * noise)
        else:
            p.copy_(0.1 * noise)
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.copy_(torch.randn(b.shape, generator=g) * 0.1)
        elif name.endswith("running_var"):
            b.copy_(torch.rand(b.shape, generator=g) * 0.5 + 0.5)
    return model.eval()


def state_dict_np(module, prefix=""):
    return {prefix + k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def random_flax_variables(model, seed, *inputs, special=None, gain=2.0):
    """The flax module's variable tree (shapes from ``jax.eval_shape``)
    filled from ``seed`` as :func:`randomize_eval_` fills a port module:
    kernels ~ N(0, gain / fan_in) (fan_in: all dims but the last, flax's
    output dim), BN / LayerNorm scales ~ 1 + N(0, 0.1^2), other 1-D
    parameters ~ N(0, 0.1^2), batch-stat means ~ N(0, 0.1^2), variances ~
    U(0.5, 1).  ``special`` maps a top-level param name to a function
    ``(rng, shape) -> array``."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        keys = [getattr(k, "key", str(k)) for k in path]
        if keys[0] == "batch_stats":
            if keys[-1] == "var":
                return (rng.rand(*leaf.shape) * 0.5 + 0.5).astype(np.float32)
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        if special and keys[1] in special:
            return special[keys[1]](rng, leaf.shape).astype(np.float32)
        noise = rng.randn(*leaf.shape)
        if len(leaf.shape) > 1:
            fan_in = int(np.prod(leaf.shape[:-1]))
            if keys[-1] in ("embedding", "positional_embedding", "text_projection"):
                fan_in = leaf.shape[-1] if keys[-1] != "text_projection" else leaf.shape[0]
            return (noise * np.sqrt(gain / fan_in)).astype(np.float32)
        if keys[-1] == "scale":
            return (1.0 + 0.1 * noise).astype(np.float32)
        return (0.1 * noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def assert_close_scaled(got, ref, rtol):
    """The JAX suite's network limit: rtol, atol = rtol * max|ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


# the metric dicts' numbers; every other key (tags) must be equal
NUMBERS = ("fvd", "kvd", "fad", "av_clip_score_fake", "av_clip_score_real", "video_is", "video_is_std",
           "fid", "sfid", "kid", "precision", "recall", "inception_score")


def assert_metrics_close(got, ref, rel, exact=()):
    """The same keys; tags equal; numbers finite and within ``rel`` (the
    keys in ``exact`` within 1e-9)."""
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k, v in ref.items():
        if k not in NUMBERS:
            assert got[k] == v, k
        else:
            assert np.isfinite(got[k]), k
            assert got[k] == pytest.approx(v, rel=1e-9 if k in exact else rel, abs=1e-9), (k, got[k], v)


@pytest.fixture(scope="module")
def av_sets(tmp_path_factory):
    """A "real" and a "fake" AV batch (JAX-written): 2 clips of 10 frames at
    48x64 with the protocol's 1.6 s of full-band 44.1 kHz audio each (audio
    band-limited by resampling leaves FBSP bins whose power is fp32
    rounding noise in either package, and their dB values differ freely;
    the 16 kHz -> 44.1 kHz loader is held in test_torch_port_eval_metrics.py
    and through the sampling CLI in test_torch_port_eval_pipeline.py)."""
    d = tmp_path_factory.mktemp("av_sets")
    rng = np.random.default_rng(0)
    paths = {}
    for name, shift in (("real", 0.0), ("fake", 0.3)):
        videos = np.clip(rng.uniform(-1, 1, (2, 10, 48, 64, 3)) * 0.7 + shift, -1, 1)
        audio = rng.uniform(-0.5, 0.5, (2, 70560)) * (1 + shift)
        paths[name] = jax_save_av_npz_batch(str(d / name), videos, audio, 10, 44100)
    return paths
