"""The port's zero-shot conditional sampling against the JAX package's, on
the CPU in float32: the conditional loop in both forms (replacement and
gradient) through ``build_conditional_sampler`` on a tiny MM-UNet with the
RS-MMA shift off, every step's noise replayed from JAX's own key sequence;
one gradient-method step and its gradient at batch 2; the model and
diffusion factory; and both conditional CLIs on the CPU."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_sampling import BASE_FLAGS, E2E_TOL, _Jitted
from torch_port_common import one_torch_thread, randn, state_dict_numpy, t  # noqa: F401

import mm_diffusion_tpu.sampling as jsampling
from mm_diffusion_tpu import configs as jconfigs
from mm_diffusion_tpu.diffusion.gaussian import mean_flat as jax_mean_flat
from mm_diffusion_tpu.diffusion.gaussian import tree_randn_like as jax_tree_randn_like
from mm_diffusion_tpu.models.mm_unet import MultimodalUNet as JaxUNet
from mm_diffusion_tpu.train import torch_import as ti
from mm_diffusion_tpu_torch import configs, sampling
from mm_diffusion_tpu_torch.diffusion import gaussian
from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
from mm_diffusion_tpu_torch.samplers import conditional_gradient_step
from mm_diffusion_tpu_torch.scripts import audio2video_sample_sr as a2v_cli
from mm_diffusion_tpu_torch.scripts import video2audio_sample as v2a_cli
from mm_diffusion_tpu_torch.weights import randomize_

STEPS = 3  # respaced steps of the conditional loops
GRAD_TOL = dict(rtol=2e-3, atol=1e-6)  # one step's loss and gradient through the MM-UNet, fp32


@pytest.fixture(scope="module")
def models():
    """The same random weights in the port's MM-UNet and the JAX one."""
    cfg = configs.create_model_config(**BASE_FLAGS)
    port = randomize_(MultimodalUNet(cfg), seed=7).eval()
    jcfg = jconfigs.create_model_config(**BASE_FLAGS, dtype="float32")
    params, unused = ti.convert_mm_unet_state_dict(state_dict_numpy(port), jcfg)
    assert unused == []
    return port, _Jitted(JaxUNet(jcfg)), params


def _numpy_state(x):
    return {k: np.asarray(v) for k, v in x.items()}


def _torch_state(x):
    return {k: t(v) for k, v in x.items()}


def _replay_noise(monkeypatch, noises):
    """The port's noise draws (``gaussian.tree_randn_like``) return the
    given numpy states in order."""
    queue = list(noises)

    def draw(x, generator=None):
        n = queue.pop(0)
        assert all(tuple(n[k].shape) == tuple(x[k].shape) for k in x)
        return _torch_state(n)

    monkeypatch.setattr(gaussian, "tree_randn_like", draw)
    return queue


def _loop_noises(rng, x_T, steps):
    """The per-step ancestral noise of JAX's conditional loop: each step
    splits ``rng`` into (rng, k_noise, k_model) and draws from k_noise."""
    noises = []
    for _ in range(steps):
        rng, k_noise, _ = jax.random.split(rng, 3)
        noises.append(_numpy_state(jax_tree_randn_like(k_noise, x_T)))
    return noises


def _inputs(batch):
    x_T = {"video": randn(31, batch, 4, 16, 16, 3), "audio": randn(32, batch, 1024, 1)}
    gt = {"video": np.tanh(randn(33, batch, 4, 16, 16, 3)), "audio": np.tanh(randn(34, batch, 1024, 1))}
    return x_T, gt


@pytest.mark.parametrize("condition_key,scale", [("audio", 3.0), ("audio", 0.0), ("video", 0.0)])
def test_conditional_sampler_matches_jax(models, monkeypatch, condition_key, scale):
    """build_conditional_sampler -> conditional_p_sample_loop on both sides:
    a2v with the gradient method, a2v and v2a with replacement."""
    port, jmodel, params = models
    flags = dict(learn_sigma=True, timestep_respacing=str(STEPS))
    x_T, gt = _inputs(1)
    jdiff = jconfigs.create_gaussian_diffusion(**flags)
    monkeypatch.setattr(jsampling, "tree_randn_like", lambda rng, x: jax.tree.map(jnp.asarray, x_T))
    jsample = jsampling.build_conditional_sampler(
        jmodel, jdiff, params, condition_key=condition_key, class_scale=scale
    )
    rng = jax.random.PRNGKey(3)
    ref = jsample(rng, jnp.asarray(gt[condition_key]))
    # the loop's rng is what build_conditional_sampler keeps after drawing x_T
    _replay_noise(monkeypatch, _loop_noises(jax.random.split(rng)[0], x_T, STEPS))

    psample = sampling.build_conditional_sampler(
        port, configs.create_gaussian_diffusion(**flags), condition_key, class_scale=scale
    )
    step_seconds = []
    out = psample(t(gt[condition_key]), x_T=_torch_state(x_T), step_seconds=step_seconds)
    assert len(step_seconds) == STEPS
    assert all(not p.requires_grad for p in port.parameters()) or scale == 0.0
    for k in ("video", "audio"):
        assert np.abs(np.asarray(ref[k])).max() > 1e-2
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **E2E_TOL)


def test_gradient_step_matches_jax(models):
    """One gradient-method step at batch 2 (so the batch mean's 1/B reaches
    each sample's gradient): the consistency loss and its gradient with
    respect to the video, against jax.grad of the JAX loop's step loss."""
    port, jmodel, params = models
    x_T, gt = _inputs(2)
    flags = dict(learn_sigma=True, timestep_respacing="10")
    jdiff = jconfigs.create_gaussian_diffusion(**flags)
    pdiff = configs.create_gaussian_diffusion(**flags)
    raw = jsampling.mm_raw_model(jmodel, params)
    i = 6
    tj = jnp.full((2,), i, jnp.int32)
    k_noise, k_model = jax.random.split(jax.random.PRNGKey(9))
    noise = _numpy_state(jax_tree_randn_like(k_noise, x_T))
    cond = jnp.asarray(gt["audio"])
    x = {**x_T, "audio": np.asarray(jdiff.q_sample({"audio": cond}, tj, {"audio": x_T["audio"]})["audio"])}
    prev_cond = jdiff.q_sample({"audio": cond}, tj - 1, {"audio": jnp.asarray(x_T["audio"])})["audio"]

    def step_loss(video):  # the JAX loop's step loss (samplers/ancestral.py)
        out = jdiff.p_sample(lambda xx, tt: raw(xx, tt, k_model, strip_sigma=False),
                             {"audio": jnp.asarray(x["audio"]), "video": video}, tj, k_noise)
        return jnp.mean(jax_mean_flat((out["sample"]["audio"] - prev_cond) ** 2)), out["sample"]

    (ref_loss, ref_prev), ref_grad = jax.value_and_grad(step_loss, has_aux=True)(jnp.asarray(x["video"]))

    port.requires_grad_(False)
    praw = sampling.mm_raw_model(port)
    with torch.no_grad():
        loss, grad, prev = conditional_gradient_step(
            pdiff, lambda xx, tt: praw(xx, tt, strip_sigma=False), _torch_state(x), torch.full((2,), i),
            t(gt["audio"]), "audio", t(x_T["audio"]), noise=_torch_state(noise),
        )
    assert np.abs(np.asarray(ref_grad)).max() > 0
    np.testing.assert_allclose(loss.item(), float(ref_loss), **GRAD_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), **GRAD_TOL)
    for k in ("video", "audio"):
        np.testing.assert_allclose(prev[k].numpy(), np.asarray(ref_prev[k]), **E2E_TOL)


def test_create_model_and_diffusion_matches_jax():
    flags = dict(BASE_FLAGS, learn_sigma=True, timestep_respacing="ddim5", diffusion_steps=100,
                 predict_xstart=True, use_fp16=True)
    model, diffusion = configs.create_model_and_diffusion(**flags)
    jmodel, jdiff = jconfigs.create_model_and_diffusion(**flags)
    jcfg = dataclasses.asdict(jmodel.cfg)
    assert isinstance(model, MultimodalUNet)
    for field, value in dataclasses.asdict(model.cfg).items():
        assert value == jcfg[field], field
    for a in ("mean_type", "var_type", "loss_type"):
        assert getattr(diffusion, a).name == getattr(jdiff, a).name
    assert diffusion.rescale_timesteps == jdiff.rescale_timesteps
    assert diffusion.num_timesteps == jdiff.num_timesteps == 5
    for name in ("betas", "alphas_cumprod", "timestep_map"):
        assert np.array_equal(getattr(diffusion.tables, name).numpy(),
                              np.asarray(getattr(jdiff.tables, name))), name


CLI_ARGS = [
    "--video_size", "4,3,16,16", "--audio_size", "1,1024", "--num_channels", "32",
    "--num_res_blocks", "1", "--channel_mult", "1,2,3,4", "--num_head_channels", "16",
    "--resblock_updown", "True", "--large_size", "64", "--small_size", "16",
    "--sr_num_channels", "32", "--sr_num_res_blocks", "1", "--sr_attention_resolutions", "4,8",
    "--sr_num_head_channels", "32", "--sr_resblock_updown", "True", "--timestep_respacing", "3",
    "--sr_sample_steps", "2", "--sample_num", "1", "--device", "cpu",
]


def test_audio2video_cli_gradient_method_with_sr_on_cpu(tmp_path):
    result = a2v_cli.main(CLI_ARGS + ["--output_dir", str(tmp_path), "--classifier_scale", "3.0",
                                      "--sr_model_path", "random"])
    samples = result["samples"]
    assert samples["video"].shape == (1, 4, 16, 16, 3)
    assert samples["audio"].shape == (1, 1024, 1)
    assert samples["sr_video"].shape == (1, 4, 64, 64, 3)
    assert all(np.isfinite(v).all() for v in samples.values())
    names = [os.path.basename(p) for p in result["paths"]]
    assert any(n.startswith("a2v_00000_gt") for n in names)
    assert any(n.startswith("a2v_00000_sr") for n in names)
    assert all(os.path.exists(p) for p in result["paths"])
    timing = result["timings"][0]
    assert len(timing["step_s"]) == 3 and {"base_s", "sr_s"} <= set(timing)


def test_video2audio_cli_on_cpu(tmp_path):
    result = v2a_cli.main(CLI_ARGS + ["--output_dir", str(tmp_path), "--sr_model_path", "random"])
    samples = result["samples"]
    assert set(samples) == {"video", "audio"}  # no SR stage for audio generation
    assert samples["audio"].shape == (1, 1024, 1)
    assert all(np.isfinite(v).all() for v in samples.values())
    assert result["paths"] and all(os.path.exists(p) for p in result["paths"])
    assert any(os.path.basename(p).startswith("v2a_00000_gt") for p in result["paths"])


@pytest.mark.parametrize("main", [a2v_cli.main, v2a_cli.main])
def test_conditional_clis_refuse_a_dataset_directory(tmp_path, main):
    """A dataset directory is read (tests/test_torch_port_data.py samples
    from one); one that holds no video is refused."""
    with pytest.raises(FileNotFoundError, match="no video files"):
        main(CLI_ARGS + ["--output_dir", str(tmp_path), "--data_dir", str(tmp_path)])


@pytest.mark.parametrize("main", [a2v_cli.main, v2a_cli.main])
def test_conditional_clis_refuse_missing_cuda_device(tmp_path, main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [a for a in CLI_ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args + ["--output_dir", str(tmp_path)])
