"""The port's MM-UNet (mm_diffusion_tpu_torch/models/mm_unet.py) against the
JAX package's, in both weight directions, at a tiny config that reaches
every attention site: spatial/temporal/audio self-attention, RS-MMA at
downsample rates 2/4/8 with windows 1/4/8 and the middle full-window block,
num_head_channels != -1, learned-sigma heads.  Every parameter is random
and non-zero.  fp32 on the CPU; tolerance rtol 2e-3, atol 2e-4."""

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

from mm_diffusion_tpu.models import attention as jattn
from mm_diffusion_tpu.models.mm_unet import MMUNetConfig as JaxConfig
from mm_diffusion_tpu.models.mm_unet import MultimodalUNet as JaxUNet
from mm_diffusion_tpu.train import torch_import as ti
from mm_diffusion_tpu_torch.models.attention import RSMMACrossAttention
from mm_diffusion_tpu_torch.models.mm_unet import CrossAttnSpec, MMUNetConfig, MultimodalUNet
from mm_diffusion_tpu_torch.weights import randomize_, state_dict_from_jax

TOL = dict(rtol=2e-3, atol=2e-4)
CFG = dict(
    video_size=(4, 3, 16, 16),
    audio_size=(1, 1024),
    model_channels=32,
    video_out_channels=6,
    audio_out_channels=2,
    num_res_blocks=1,
    cross_attention_resolutions=(2, 4, 8),
    cross_attention_windows=(1, 4, 8),
    cross_attention_shift=False,
    video_attention_resolutions=(2, 4, 8),
    audio_attention_resolutions=(-1,),
    channel_mult=(1, 2, 3, 4),
    num_heads=2,
    num_head_channels=16,
    resblock_updown=True,
    dtype="float32",
)


@pytest.fixture(scope="module")
def jax_forward():
    model = JaxUNet(JaxConfig(**CFG))
    return jax.jit(lambda p, v, a, ts: model.apply({"params": p}, v, a, ts))


@pytest.fixture(scope="module")
def inputs():
    f, c, h, w = CFG["video_size"]
    return randn(0, 2, f, h, w, c), randn(1, 2, CFG["audio_size"][1], 1), np.array([7, 420])


def _port_forward(model, inputs):
    v, a, ts = inputs
    with torch.no_grad():
        pv, pa = model(t(v), t(a), torch.as_tensor(ts))
    return pv.numpy(), pa.numpy()


def _compare(jax_out, port_out):
    for ref, out in zip(jax_out, port_out):
        assert out.shape == ref.shape
        assert np.abs(ref).max() > 1e-2  # non-trivial output
        np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_plan_reaches_every_attention_site():
    model = MultimodalUNet(MMUNetConfig(**CFG))
    cross = [s for specs in model.plan.encoder + model.plan.decoder for s in specs
             if isinstance(s, CrossAttnSpec)]
    assert sorted({s.local_window for s in cross}) == [1, 4, 8]
    assert isinstance(model.plan.middle[1], CrossAttnSpec)
    assert model.plan.middle[1].local_window == CFG["video_size"][0]
    assert {s.heads for s in cross} == {64 // 16, 96 // 16, 128 // 16}


def test_port_weights_to_jax(jax_forward, inputs):
    """Port (random) -> convert_mm_unet_state_dict -> flax: same outputs."""
    model = randomize_(MultimodalUNet(MMUNetConfig(**CFG)), seed=3).eval()
    params, unused = ti.convert_mm_unet_state_dict(state_dict_numpy(model), JaxConfig(**CFG))
    assert unused == []
    v, a, ts = inputs
    ref = jax_forward(params, jnp.asarray(v), jnp.asarray(a), jnp.asarray(ts))
    _compare(ref, _port_forward(model, inputs))


def test_jax_weights_to_port(jax_forward, inputs):
    """JAX params (random) -> state_dict_from_jax -> the port: same outputs."""
    template = MultimodalUNet(MMUNetConfig(**CFG))
    params, _ = ti.convert_mm_unet_state_dict(state_dict_numpy(template), JaxConfig(**CFG))
    params = randomize_flax_params(params, seed=4, scale=0.2)
    model = MultimodalUNet(MMUNetConfig(**CFG)).eval()
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params), model.cfg))
    v, a, ts = inputs
    ref = jax_forward(params, jnp.asarray(v), jnp.asarray(a), jnp.asarray(ts))
    _compare(ref, _port_forward(model, inputs))


def test_state_dict_round_trip_is_bit_exact():
    model = randomize_(MultimodalUNet(MMUNetConfig(**CFG)), seed=5)
    sd = state_dict_numpy(model)
    params, unused = ti.convert_mm_unet_state_dict(sd, JaxConfig(**CFG))
    assert unused == []
    back = state_dict_from_jax(params, model.cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert np.array_equal(back[k].numpy(), v), k


@pytest.mark.parametrize(
    "lw,shift", [(1, 0), (1, 1), (1, 3), (2, 0), (2, 2), (4, 0)]
)
def test_rsmma_site_with_explicit_shift(lw, shift, monkeypatch):
    """One RS-MMA site with an injected shift; the JAX module draws its shift
    from the 'shift' RNG, patched here to return the same value."""
    c, heads, f = 32, 2, 4
    port = randomize_(RSMMACrossAttention(c, heads, lw, window_shift=True), seed=6).eval()
    params = ti._cross_attention(
        ti._SD({f"x.{k}": v for k, v in state_dict_numpy(port).items()}), "x", heads
    )
    video, audio = randn(7, 2, f, 4, 4, c), randn(8, 2, 4 * f, c)
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.int32(shift))
    ref = jattn.RSMMACrossAttention(c, heads, lw, window_shift=True, dtype=jnp.float32).apply(
        {"params": params}, jnp.asarray(video), jnp.asarray(audio),
        rngs={"shift": jax.random.PRNGKey(0)},
    )
    with torch.no_grad():
        pv, pa = port(t(video).permute(0, 4, 1, 2, 3), t(audio).transpose(1, 2), shift)
    np.testing.assert_allclose(pv.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(pa.transpose(1, 2).numpy(), np.asarray(ref[1]), **TOL)


def test_shift_generator_draws_each_site_in_range():
    cfg = MMUNetConfig(**{**CFG, "cross_attention_shift": True})
    model = MultimodalUNet(cfg).eval()
    drawn = []
    sites = [m for m in model.modules() if isinstance(m, RSMMACrossAttention)]
    for blk in sites:
        orig = blk.forward
        blk.forward = lambda v, a, s, _o=orig, _b=blk: (drawn.append((_b, s)), _o(v, a, s))[1]
    v, a, ts = randn(9, 1, 4, 16, 16, 3), randn(10, 1, 1024, 1), np.array([3])
    with torch.no_grad():
        model(t(v), t(a), torch.as_tensor(ts), shift=torch.Generator().manual_seed(0))
    assert len(drawn) == len(sites) == 10  # 3 encoder + middle + 6 decoder sites
    for blk, s in drawn:
        span = 4 - blk.window(4) if blk.window_shift else 0
        assert 0 <= s <= span
    with pytest.raises(ValueError, match="shift"):
        model(t(v), t(a), torch.as_tensor(ts), shift=2)  # lw=4 sites allow only 0
