"""The port's SR U-Net (mm_diffusion_tpu_torch/models/image_unet.py) against
the JAX package's ImageSuperResModel, in both weight directions, at a tiny
SR config with attention (legacy per-head qkv order, read in place by the
attention op) and with / without resblock_updown.  Every parameter is
random and non-zero.  fp32 on the CPU; tolerance rtol 2e-3, atol 2e-4.
The port runs under ``no_grad`` there, so with its ResBlocks' conv biases
taken by the norm and the residual pass; that route against the unfolded
one (autograd recording), SR- and SDXL-style, and ``BIAS_FOLDS``'s counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (  # noqa: F401
    one_torch_thread,
    randn,
    randomize_flax_params,
    state_dict_numpy,
    t,
)

from mm_diffusion_tpu.models.image_unet import ImageSuperResModel as JaxSR
from mm_diffusion_tpu.models.image_unet import ImageUNetConfig as JaxConfig
from mm_diffusion_tpu.train import torch_import as ti
from mm_diffusion_tpu_torch.models.image_unet import (
    ImageAttention,
    ImageResBlock,
    ImageSuperResModel,
    ImageUNet,
    ImageUNetConfig,
)
from mm_diffusion_tpu_torch.models.layers import Conv2d
from mm_diffusion_tpu_torch.ops import group_norm as gn
from mm_diffusion_tpu_torch.weights import image_state_dict_from_jax, randomize_

TOL = dict(rtol=2e-3, atol=2e-4)
BASE = dict(
    image_size=64,
    in_channels=6,
    model_channels=32,
    out_channels=6,
    num_res_blocks=1,
    attention_resolutions=(2, 4),
    channel_mult=(1, 2, 3, 4),
    num_head_channels=32,
    use_scale_shift_norm=True,
    dtype="float32",
)
UPDOWN = [True, False]


@pytest.fixture(scope="module")
def inputs():
    return randn(0, 2, 64, 64, 3), np.array([5, 930]), randn(1, 2, 16, 16, 3)


@pytest.fixture(scope="module", params=UPDOWN, ids=["updown", "conv_resample"])
def setup(request):
    cfg = dict(BASE, resblock_updown=request.param)
    model = JaxSR(JaxConfig(**cfg))
    fwd = jax.jit(lambda p, x, ts, low: model.apply({"params": {"unet": p}}, x, ts, low))
    return cfg, fwd


def _run(model, inputs):
    x, ts, low = inputs
    with torch.no_grad():
        return model(t(x), torch.as_tensor(ts), t(low)).numpy()


def _compare(ref, out):
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, 64, 64, 6)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, **TOL)


def test_attention_uses_legacy_per_head_layout():
    model = ImageSuperResModel(ImageUNetConfig(**BASE, resblock_updown=True))
    attn = [m for m in model.modules() if isinstance(m, ImageAttention)]
    assert attn and all(m.layout == "per_head" for m in attn)


def test_port_weights_to_jax(setup, inputs):
    cfg, fwd = setup
    model = randomize_(ImageSuperResModel(ImageUNetConfig(**cfg)), seed=2).eval()
    params, unused = ti.convert_image_unet_state_dict(state_dict_numpy(model), JaxConfig(**cfg))
    assert unused == []
    x, ts, low = inputs
    _compare(fwd(params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(low)), _run(model, inputs))


def test_jax_weights_to_port(setup, inputs):
    cfg, fwd = setup
    template = ImageSuperResModel(ImageUNetConfig(**cfg))
    params, _ = ti.convert_image_unet_state_dict(state_dict_numpy(template), JaxConfig(**cfg))
    params = randomize_flax_params(params, seed=3, scale=0.2)
    model = ImageSuperResModel(ImageUNetConfig(**cfg)).eval()
    model.load_state_dict(image_state_dict_from_jax(jax.tree.map(np.asarray, params), model.cfg))
    x, ts, low = inputs
    _compare(fwd(params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(low)), _run(model, inputs))


@pytest.mark.parametrize("updown", UPDOWN)
def test_state_dict_round_trip_is_bit_exact(updown):
    model = randomize_(ImageSuperResModel(ImageUNetConfig(**BASE, resblock_updown=updown)), 4)
    sd = state_dict_numpy(model)
    params, unused = ti.convert_image_unet_state_dict(sd, JaxConfig(**BASE, resblock_updown=updown))
    assert unused == []
    back = image_state_dict_from_jax({"unet": params}, model.cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert np.array_equal(back[k].numpy(), v), k


# SDXL-style: no scale-shift norm (the time embedding added to the first
# conv's output), spatial transformers attending to a context.
SDXL_STYLE = dict(image_size=16, in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
                  attention_resolutions=(2,), channel_mult=(1, 2), num_head_channels=8, context_dim=24,
                  transformer_depth=(1, 1), dtype="float32")
FOLD_CASES = ["sr_updown", "sr_conv_resample", "sdxl_style"]


def _fold_case(name):
    """(model, forward args, kwargs) of a tiny fp32 image U-Net, weights random."""
    g = torch.Generator().manual_seed(9)
    if name == "sdxl_style":
        model = randomize_(ImageUNet(ImageUNetConfig(**SDXL_STYLE)), seed=8).eval()
        return model, (torch.randn((2, 16, 16, 4), generator=g), torch.tensor([999, 431])), dict(
            context=torch.randn((2, 7, 24), generator=g))
    cfg = dict(BASE, image_size=32, resblock_updown=name == "sr_updown")
    model = randomize_(ImageSuperResModel(ImageUNetConfig(**cfg)), seed=8).eval()
    return model, (torch.randn((2, 32, 32, 3), generator=g), torch.tensor([5, 930]),
                   torch.randn((2, 8, 8, 3), generator=g)), {}


@pytest.mark.parametrize("name", FOLD_CASES)
def test_folded_biases_match_the_unfolded_blocks(name):
    """Under ``inference_mode`` the norm and the residual pass fold the
    ResBlocks' conv biases into their reads; with autograd recording they
    add them where the convs did.  fp32: the same sums in another order."""
    model, args, kwargs = _fold_case(name)
    with torch.inference_mode():
        folded = model(*args, **kwargs)
    unfolded = model(*args, **kwargs).detach()
    assert float(unfolded.abs().max()) > 1e-2
    assert float((folded - unfolded).norm() / unfolded.norm()) <= 1e-5


@pytest.mark.parametrize("name", FOLD_CASES)
def test_bias_folds_count_the_blocks(name):
    """One evaluation counts every ResBlock's first conv ("norm"), second conv
    ("residual") and skip conv ("skip") when nothing records, and every
    ResBlock as "eager" alone under autograd, backward included."""
    model, args, kwargs = _fold_case(name)
    blocks = [m for m in model.modules() if isinstance(m, ImageResBlock)]
    skips = sum(isinstance(b.skip_connection, Conv2d) for b in blocks)
    assert blocks and 0 < skips < len(blocks)
    gn.reset_launch_counts()
    with torch.no_grad():
        model(*args, **kwargs)
    assert dict(gn.BIAS_FOLDS) == {"norm": len(blocks), "residual": len(blocks), "skip": skips}
    gn.reset_launch_counts()
    model(*args, **kwargs).square().mean().backward()
    assert dict(gn.BIAS_FOLDS) == {"eager": len(blocks)}
