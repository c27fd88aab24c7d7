"""The port's single-modal U-Net (mm_diffusion_tpu_torch/models/single_unet.py)
and its sampler (sampling.py::build_single_sampler) against the JAX
package's, video and audio, at tiny configs that reach every block kind:
factorised spatial + temporal video attention, audio token attention, the
audio-dilation counter, resblock_updown and plain resampling, additive
and FiLM conditioning, learned-sigma heads.  Weights go both ways through
weights.single_state_dict_from_jax / single_jax_params_from_state_dict.

Tolerances: the model rtol 2e-3 / atol 2e-4, as the other model parity
tests; the samplers 2e-3 absolute on samples in [-1, 1] (fp32 differences
carried through the steps).  The port's random weights are scaled by 0.3
where they enter (as tests/test_torch_port_training.py does): at full
scale the tiny video model's two-frame temporal softmax is numerically
chaotic (a 5e-2 gap from rounding alone), at 0.3x its fp32 runs agree to
1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, randn, randomize_flax_params, t  # noqa: F401

from mm_diffusion_tpu import configs as jconfigs
from mm_diffusion_tpu import sampling as jsampling
from mm_diffusion_tpu.models.single_unet import SingleModalUNet as JaxUNet
from mm_diffusion_tpu.models.single_unet import SingleUNetConfig as JaxConfig
from mm_diffusion_tpu.models.single_unet import build_single_plan as jax_plan
from mm_diffusion_tpu_torch import configs
from mm_diffusion_tpu_torch.models import single_unet
from mm_diffusion_tpu_torch.models.single_unet import SingleModalUNet, SingleUNetConfig, build_single_plan
from mm_diffusion_tpu_torch.sampling import build_single_sampler
from mm_diffusion_tpu_torch.weights import (
    randomize_,
    single_jax_params_from_state_dict,
    single_state_dict_from_jax,
)

TOL = dict(rtol=2e-3, atol=2e-4)
VIDEO = dict(modality="video", video_size=(4, 3, 8, 8), model_channels=16, out_channels=6,
             num_res_blocks=1, attention_resolutions=(2, 4), channel_mult=(1, 2, 2), num_heads=2,
             dtype="float32")
AUDIO = dict(modality="audio", audio_size=(1, 256), model_channels=16, out_channels=1,
             num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2, 2), num_heads=2,
             resblock_updown=False, use_scale_shift_norm=False, dtype="float32")
CASES = {"video": VIDEO, "audio": AUDIO, "audio learn_sigma": {**AUDIO, "out_channels": 2},
         "video plain resampling": {**VIDEO, "resblock_updown": False, "out_channels": 3}}


def port_model(kw, seed=0, scale=0.3):
    model = randomize_(SingleModalUNet(SingleUNetConfig(**kw)), seed=seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.mul_(scale)
    return model.eval()


def _inputs(kw, seed=1):
    cfg = SingleUNetConfig(**kw)
    return randn(seed, 2, *cfg.sample_shape), np.array([3, 70])


def test_plan_matches_jax_and_reaches_every_block():
    for kw in CASES.values():
        encoder, middle, decoder = build_single_plan(SingleUNetConfig(**kw))
        jenc, jmid, jdec = jax_plan(JaxConfig(**kw))

        def fields(specs):
            return [s if isinstance(s, str) else dataclasses.astuple(s) for s in specs]

        assert [fields(s) for s in encoder] == [fields(s) for s in jenc]
        assert fields(middle) == fields(jmid)
        assert [fields(s) for s in decoder] == [fields(s) for s in jdec]
    encoder, _, decoder = build_single_plan(SingleUNetConfig(**VIDEO))
    specs = [s for blk in encoder + decoder for s in blk if not isinstance(s, str)]
    assert {s.dilation for s in specs} > {1, 2, 4}
    assert any(s.up for s in specs) and any(s.down for s in specs) and any(s.attention for s in specs)


@pytest.mark.parametrize("name", list(CASES))
def test_port_weights_to_jax(name):
    """Port (random) -> single_jax_params_from_state_dict -> flax: the
    param tree is the JAX model's, and the outputs agree."""
    kw = CASES[name]
    model = port_model(kw, seed=2)
    params = single_jax_params_from_state_dict(model.state_dict(), model.cfg)
    x, ts = _inputs(kw)
    jmodel = JaxUNet(JaxConfig(**kw))
    init = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(ts))["params"]
    assert jax.tree_util.tree_structure(init) == jax.tree_util.tree_structure(params)
    assert all(a.shape == np.shape(b) for a, b in zip(jax.tree_util.tree_leaves(init),
                                                       jax.tree_util.tree_leaves(params)))
    ref = np.asarray(jmodel.apply({"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x),
                                  jnp.asarray(ts)))
    with torch.no_grad():
        out = model(t(x), torch.as_tensor(ts)).numpy()
    assert out.shape == (2,) + model.cfg.sample_shape[:-1] + (kw["out_channels"],)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("name", ["video", "audio"])
def test_jax_weights_to_port(name):
    """JAX params (random) -> single_state_dict_from_jax -> the port: the
    same outputs; and the bridge round-trips bit for bit."""
    kw = CASES[name]
    template = SingleModalUNet(SingleUNetConfig(**kw))
    params = randomize_flax_params(single_jax_params_from_state_dict(template.state_dict(), template.cfg),
                                   seed=4, scale=0.2)
    params = jax.tree.map(np.asarray, params)
    sd = single_state_dict_from_jax(params, template.cfg)
    assert set(sd) == set(template.state_dict())
    template.load_state_dict(sd)
    back = single_jax_params_from_state_dict(sd, template.cfg)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(params),
                                                     jax.tree_util.tree_leaves(back)))
    x, ts = _inputs(kw, seed=5)
    ref = np.asarray(JaxUNet(JaxConfig(**kw)).apply({"params": jax.tree.map(jnp.asarray, params)},
                                                     jnp.asarray(x), jnp.asarray(ts)))
    with torch.no_grad():
        out = template.eval()(t(x), torch.as_tensor(ts)).numpy()
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, **TOL)


def test_remat_leaves_gradients_unchanged(monkeypatch):
    """use_checkpoint recomputes each ResBlock with at least
    remat_min_tokens() tokens (all of them at 0): same gradients."""
    monkeypatch.setenv("MMDIFF_REMAT_MIN_TOKENS", "0")
    grads, calls, real = [], [], single_unet.checkpoint
    monkeypatch.setattr(single_unet, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    for use_checkpoint in (False, True):
        for kw in (VIDEO, AUDIO):
            model = port_model({**kw, "use_checkpoint": use_checkpoint}, seed=6).train()
            calls.clear()
            x, ts = _inputs(kw, seed=7)
            model(t(x), torch.as_tensor(ts)).square().mean().backward()
            n_blocks = sum(isinstance(m, single_unet.SingleResBlock) for m in model.modules())
            assert len(calls) == (n_blocks if use_checkpoint else 0)
            grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(grads[:2], grads[2:]):
        for ga, gb in zip(a, b):
            torch.testing.assert_close(ga, gb, rtol=0, atol=1e-6)


def test_dropout_is_active_only_in_train_mode():
    model = port_model({**AUDIO, "dropout": 0.5}, seed=8)
    x, ts = _inputs(AUDIO, seed=9)
    with torch.no_grad():
        assert torch.equal(model(t(x), torch.as_tensor(ts)), model(t(x), torch.as_tensor(ts)))
        model.train()
        assert not torch.equal(model(t(x), torch.as_tensor(ts)), model(t(x), torch.as_tensor(ts)))


@pytest.mark.parametrize("sample_fn,steps", [("ddim", 10), ("dpm_solver", 6)])
@pytest.mark.parametrize("name", ["video", "audio learn_sigma"])
def test_single_sampler_matches_jax(name, sample_fn, steps):
    """The same x_T (JAX's own draw from its key) through both samplers."""
    kw = CASES[name]
    model = port_model(kw, seed=10)
    params = jax.tree.map(jnp.asarray, single_jax_params_from_state_dict(model.state_dict(), model.cfg))
    respacing = f"ddim{steps}" if sample_fn == "ddim" else ""
    diff_kw = dict(steps=100, learn_sigma=kw["out_channels"] == 2 * model.cfg.in_channels,
                   timestep_respacing=respacing)
    jd, pd = jconfigs.create_gaussian_diffusion(**diff_kw), configs.create_gaussian_diffusion(**diff_kw)
    jsample = jsampling.build_single_sampler(JaxUNet(JaxConfig(**kw)), jd, params, sample_fn, steps)
    rng = jax.random.PRNGKey(11)
    shape = (2,) + model.cfg.sample_shape
    key = jax.random.split(rng)[1] if sample_fn == "ddim" else rng
    x_T = np.asarray(jax.random.normal(key, shape))
    ref = np.asarray(jax.jit(jsample, static_argnums=(1,))(rng, 2))
    out = build_single_sampler(model, pd, sample_fn, steps)(2, x_T=t(x_T)).numpy()
    assert out.shape == shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-3)
