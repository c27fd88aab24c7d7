"""The port's layers (mm_diffusion_tpu_torch/models/layers.py) against the
JAX package's (mm_diffusion_tpu/models/layers.py), same weights and inputs,
fp32 on the CPU.  Weights go to flax through the JAX package's own torch
importer helpers.  Tolerance 1e-5 abs unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_common import one_torch_thread, randn, state_dict_numpy, t  # noqa: F401

from mm_diffusion_tpu.models import layers as jl
from mm_diffusion_tpu.train import torch_import as ti
from mm_diffusion_tpu_torch.models import layers as pl
from mm_diffusion_tpu_torch.weights import randomize_

TOL = dict(rtol=1e-5, atol=1e-5)


def _sd(module, prefix="m"):
    return ti._SD({f"{prefix}.{k}": v for k, v in state_dict_numpy(module).items()})


@pytest.mark.parametrize(
    "timesteps", [np.array([0, 7, 999]), np.array([0.5, 13.25, 998.999]), np.array([3.0])]
)
@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(timesteps, dim):
    ref = np.asarray(jl.timestep_embedding(jnp.asarray(timesteps, jnp.float32), dim))
    out = pl.timestep_embedding(torch.as_tensor(timesteps, dtype=torch.float32), dim).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("mc,embed", [(32, 32), (16, 64)])
def test_time_embedding(mc, embed):
    m = randomize_(pl.TimeEmbedding(mc, embed), seed=1)
    sd = state_dict_numpy(m)
    params = {
        f"Dense_{i}": {"kernel": sd[f"{j}.weight"].T, "bias": sd[f"{j}.bias"]}
        for i, j in ((0, 0), (1, 2))
    }
    ts = np.array([1, 250, 998])
    ref = jl.TimeEmbedding(mc, embed, dtype=jnp.float32).apply({"params": params}, jnp.asarray(ts))
    out = m(torch.as_tensor(ts)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("channels,groups", [(64, 32), (24, 8), (40, 8), (6, 2)])
@pytest.mark.parametrize("film", [False, True])
def test_group_norm_group_fallback_and_film(channels, groups, film):
    gn = randomize_(pl.GroupNorm32(channels), seed=2)
    assert gn.num_groups == groups
    x = randn(3, 2, 5, 7, channels)  # channels-last [B, ..., C]
    fs = randn(4, 2, channels, scale=0.3) if film else None
    fb = randn(5, 2, channels, scale=0.3) if film else None
    params = ti._groupnorm(_sd(gn), "m")
    ref = jl.GroupNormFP32().apply(
        {"params": params}, jnp.asarray(x), film=(jnp.asarray(fs), jnp.asarray(fb)) if film else None
    )
    with torch.no_grad():
        out = gn(t(x), film=(t(fs), t(fb)) if film else None, channels_last=True)
        first = gn(t(x).movedim(-1, 1), film=(t(fs), t(fb)) if film else None).movedim(1, -1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(first.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("conv_type,k", [("2d+1d", 3), ("3d", 3), ("3d", 1)])
def test_video_conv(conv_type, k):
    conv = randomize_(pl.VideoConv(8, 16, k, conv_type), seed=3)
    x = randn(6, 2, 4, 6, 5, 8)  # [B, F, H, W, C]
    params = ti._video_conv(_sd(conv), "m", conv_type)
    ref = jl.VideoConv(16, k, conv_type=conv_type, dtype=jnp.float32).apply(
        {"params": params}, jnp.asarray(x)
    )
    with torch.no_grad():
        out = conv(t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("k,dilation", [(3, 1), (3, 4), (3, 512), (1, 1)])
def test_dilated_audio_conv(k, dilation):
    conv = randomize_(pl.AudioConv(8, 12, k, dilation), seed=4)
    x = randn(7, 2, 1024, 8)  # [B, L, C]
    params = ti._audio_conv(_sd(conv), "m")
    ref = jl.AudioConv(12, k, dilation=dilation, dtype=jnp.float32).apply(
        {"params": params}, jnp.asarray(x)
    )
    with torch.no_grad():
        out = conv(t(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_resamplers():
    v = randn(8, 2, 3, 8, 6, 5)  # [B, F, H, W, C]
    a = randn(9, 2, 64, 5)  # [B, L, C]
    img = randn(10, 2, 8, 6, 5)  # [B, H, W, C]
    vt, at, it = t(v).permute(0, 4, 1, 2, 3), t(a).transpose(1, 2), t(img).permute(0, 3, 1, 2)
    cases = [
        (jl.video_downsample(jnp.asarray(v)), pl.video_downsample(vt).permute(0, 2, 3, 4, 1)),
        (jl.video_upsample(jnp.asarray(v)), pl.video_upsample(vt).permute(0, 2, 3, 4, 1)),
        (jl.audio_downsample(jnp.asarray(a)), pl.audio_downsample(at).transpose(1, 2)),
        (jl.audio_upsample(jnp.asarray(a)), pl.audio_upsample(at).transpose(1, 2)),
        (jl.image_downsample(jnp.asarray(img)), pl.image_downsample(it).permute(0, 2, 3, 1)),
        (jl.image_upsample(jnp.asarray(img)), pl.image_upsample(it).permute(0, 2, 3, 1)),
    ]
    for ref, out in cases:
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bilinear_64_to_256_matches_jax_image_resize():
    """The SR model's low-res upsample: F.interpolate(bilinear,
    align_corners=False) against jax.image.resize(..., "bilinear")."""
    low = randn(11, 2, 64, 64, 3)
    ref = jax.image.resize(jnp.asarray(low), (2, 256, 256, 3), "bilinear")
    out = F.interpolate(
        t(low).permute(0, 3, 1, 2), size=(256, 256), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
