"""The port's diffusion tables, samplers and pipeline against the JAX
package's: schedules and respacing exactly; DPM-Solver and DDIM on an
analytic model (delta data at x0) to 1e-5; base + SR sampling end to end at
tiny configs with the RS-MMA shift off and the noise injected from numpy;
and the CLI on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, randn, state_dict_numpy, t  # noqa: F401

import mm_diffusion_tpu.sampling as jsampling
from mm_diffusion_tpu import configs as jconfigs
from mm_diffusion_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from mm_diffusion_tpu.diffusion import make_schedule as jax_make_schedule
from mm_diffusion_tpu.diffusion.schedules import space_timesteps as jax_space_timesteps
from mm_diffusion_tpu.samplers import DPMSolver as JaxSolver
from mm_diffusion_tpu.samplers import NoiseScheduleVP as JaxNS
from mm_diffusion_tpu.samplers import ddim_sample_loop as jax_ddim_loop
from mm_diffusion_tpu.samplers import model_input_time as jax_model_input_time
from mm_diffusion_tpu.train import torch_import as ti
from mm_diffusion_tpu_torch import configs, sampling
from mm_diffusion_tpu_torch.diffusion import GaussianDiffusion, make_schedule, space_timesteps
from mm_diffusion_tpu_torch.models.image_unet import ImageSuperResModel
from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
from mm_diffusion_tpu_torch.samplers import (
    DPMSolver,
    NoiseScheduleVP,
    ddim_sample_loop,
    model_input_time,
)
from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr as cli
from mm_diffusion_tpu_torch.weights import randomize_

TABLES = [
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
    "log_betas", "fixed_large_variance", "fixed_large_log_variance", "timestep_map",
]


@pytest.mark.parametrize(
    "schedule,steps,respacing",
    [("linear", 1000, None), ("linear", 1000, "ddim25"), ("cosine", 100, "10,5"),
     ("linear", 100, "ddim10"), ("cosine", 1000, "250")],
)
def test_schedule_tables_are_exact(schedule, steps, respacing):
    ref = jax_make_schedule(schedule, steps, respacing)
    out = make_schedule(schedule, steps, respacing)
    assert out.num_timesteps == ref.num_timesteps
    assert out.original_num_steps == ref.original_num_steps
    for name in TABLES:
        assert np.array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name))), name


@pytest.mark.parametrize("counts", ["ddim25", "ddim50", "10,15,20", [3, 4], "1000"])
def test_space_timesteps(counts):
    assert space_timesteps(1000, counts) == jax_space_timesteps(1000, counts)


T = 100


@pytest.fixture(scope="module")
def analytic():
    """Delta data at x0: the exact noise prediction, in both frameworks."""
    x0 = {"video": np.tanh(randn(0, 2, 2, 4, 4, 3)), "audio": np.tanh(randn(1, 2, 32, 1))}
    x_T = {"video": randn(2, 2, 2, 4, 4, 3), "audio": randn(3, 2, 32, 1)}
    jd = JaxDiffusion(tables=jax_make_schedule("linear", T))
    pd = GaussianDiffusion(tables=make_schedule("linear", T))
    return x0, x_T, jd, pd


@pytest.mark.parametrize("method,order,skip", [("singlestep", 3, "logSNR"),
                                               ("multistep", 2, "time_uniform")])
@pytest.mark.parametrize("predict_x0", [False, True])
def test_dpm_solver_matches_jax_on_analytic_model(analytic, method, order, skip, predict_x0):
    x0, x_T, jd, pd = analytic
    jns = JaxNS.from_alphas_cumprod(np.asarray(jd.tables.alphas_cumprod))
    pns = NoiseScheduleVP(np.asarray(jd.tables.alphas_cumprod))

    def jax_eps(x, tc):
        a, s = jns.marginal_alpha(tc), jns.marginal_std(tc)
        return jax.tree.map(lambda xt, x0l: (xt - a * x0l) / s, x, x0)

    def port_eps(x, tc):
        a, s = pns.marginal_alpha(tc), pns.marginal_std(tc)
        return {k: (x[k] - a * t(x0[k])) / s for k in x}

    steps = 15
    jsolver = JaxSolver(jax_eps, jns, predict_x0=predict_x0)
    ref = jax.jit(lambda x: jsolver.sample(x, steps=steps, order=order, skip_type=skip,
                                           method=method))(jax.tree.map(jnp.asarray, x_T))
    psolver = DPMSolver(port_eps, pns, predict_x0=predict_x0)
    out = psolver.sample({k: t(v) for k, v in x_T.items()}, steps=steps, order=order,
                         skip_type=skip, method=method)
    for k in x0:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-5)
    # the analytic probability-flow solution at t_0
    t_0 = 1.0 / T
    aT, sT = pns.marginal_alpha(1.0), pns.marginal_std(1.0)
    a0, s0 = pns.marginal_alpha(t_0), pns.marginal_std(t_0)
    for k in x0:
        expected = a0 * t(x0[k]) + s0 * (t(x_T[k]) - aT * t(x0[k])) / sT
        assert (out[k] - expected).abs().max() < 0.02


@pytest.mark.parametrize("skip,n", [("logSNR", 20), ("time_uniform", 50), ("logSNR", 7)])
def test_time_grid_and_model_timesteps_match_jax(skip, n):
    abar = np.asarray(jax_make_schedule("linear", 1000).alphas_cumprod, np.float64)
    jns, pns = JaxNS.from_alphas_cumprod(abar), NoiseScheduleVP(abar)
    ref = np.asarray(JaxSolver(None, jns).get_time_steps(skip, 1.0, 1e-3, n))
    out = DPMSolver(None, pns).get_time_steps(skip, 1.0, 1e-3, n)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)  # FMA contraction
    assert np.array_equal(
        model_input_time(pns, out).numpy(), np.asarray(jax_model_input_time(jns, jnp.asarray(ref)))
    )


def test_ddim_loop_matches_jax_with_injected_x_T(analytic):
    x0, x_T, _, _ = analytic
    jd = JaxDiffusion(tables=jax_make_schedule("linear", T, "ddim25"))
    pd = GaussianDiffusion(tables=make_schedule("linear", T, "ddim25"))
    abar_j, abar_p = jd.tables.alphas_cumprod, pd.tables.alphas_cumprod
    jmap, pmap = jd.tables.timestep_map, pd.tables.timestep_map

    def jax_model(x, tm, rng=None):  # model timesteps are original indices
        idx = jnp.searchsorted(jmap, tm)
        a = abar_j[idx].reshape(-1, *([1] * 4))
        return {k: (x[k] - jnp.sqrt(a.reshape((-1,) + (1,) * (x[k].ndim - 1))) * x0[k])
                / jnp.sqrt(1 - a.reshape((-1,) + (1,) * (x[k].ndim - 1))) for k in x}

    def port_model(x, tm):
        idx = torch.searchsorted(pmap, tm)
        out = {}
        for k in x:
            a = abar_p[idx].reshape((-1,) + (1,) * (x[k].dim() - 1))
            out[k] = (x[k] - torch.sqrt(a) * t(x0[k])) / torch.sqrt(1 - a)
        return out

    ref = jax.jit(lambda x: jax_ddim_loop(jd, jax_model, x, jax.random.PRNGKey(0)))(
        jax.tree.map(jnp.asarray, x_T)
    )
    out = ddim_sample_loop(pd, port_model, {k: t(v) for k, v in x_T.items()})
    for k in x0:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-5)
        assert (out[k] - t(x0[k])).abs().max() < 0.06


# -- end to end at tiny configs --------------------------------------------------

BASE_FLAGS = dict(
    video_size="4,3,16,16", audio_size="1,1024", num_channels=32, num_res_blocks=1,
    channel_mult="1,2,3,4", num_head_channels=16, resblock_updown=True, learn_sigma=True,
    cross_attention_shift=False,
)
SR_FLAGS = dict(
    large_size=64, small_size=16, sr_num_channels=32, sr_num_res_blocks=1,
    sr_attention_resolutions="4,8", sr_num_head_channels=32, sr_resblock_updown=True,
)
BASE_STEPS, SR_STEPS = 4, 3  # NFE: 4 (orders [3, 1]) and 3
E2E_TOL = dict(rtol=0, atol=2e-3)  # fp32 differences carried through 7 model evaluations


class _Jitted:
    """A flax module whose ``apply`` is compiled once: the JAX pipeline then
    runs its solver steps eagerly around one compiled model."""

    def __init__(self, module):
        self.cfg = module.cfg
        self.apply = jax.jit(module.apply)


def test_sample_base_and_sr_matches_jax(monkeypatch):
    base_cfg = configs.create_model_config(**BASE_FLAGS)
    sr_cfg = configs.create_image_sr_config(**SR_FLAGS)
    base = randomize_(MultimodalUNet(base_cfg), seed=1).eval()
    sr = randomize_(ImageSuperResModel(sr_cfg), seed=2).eval()
    diffusion = configs.create_gaussian_diffusion(learn_sigma=True)
    sr_diffusion = configs.create_gaussian_diffusion(
        learn_sigma=True, timestep_respacing=f"ddim{SR_STEPS}"
    )
    x_T = {"video": randn(3, 1, 4, 16, 16, 3), "audio": randn(4, 1, 1024, 1)}
    sr_x_T = np.repeat(randn(5, 1, 1, 64, 64, 3), 4, axis=1)  # one noise image per clip

    # JAX: the same weights and noise through its own pipeline functions
    jbase_cfg = jconfigs.create_model_config(**BASE_FLAGS, dtype="float32")
    jsr_cfg = jconfigs.create_image_sr_config(**SR_FLAGS, dtype="float32")
    jparams, unused = ti.convert_mm_unet_state_dict(state_dict_numpy(base), jbase_cfg)
    jsr_params, sr_unused = ti.convert_image_unet_state_dict(state_dict_numpy(sr), jsr_cfg)
    assert unused == sr_unused == []
    from mm_diffusion_tpu.models.image_unet import ImageSuperResModel as JaxSR
    from mm_diffusion_tpu.models.mm_unet import MultimodalUNet as JaxUNet

    jdiff = jconfigs.create_gaussian_diffusion(learn_sigma=True)
    jsr_diff = jconfigs.create_gaussian_diffusion(
        learn_sigma=True, timestep_respacing=f"ddim{SR_STEPS}"
    )
    monkeypatch.setattr(jsampling, "tree_randn_like",
                        lambda rng, x: jax.tree.map(jnp.asarray, x_T))
    monkeypatch.setattr(jsampling, "shared_clip_noise",
                        lambda rng, b, f, size: jnp.asarray(sr_x_T.reshape(-1, 64, 64, 3)))
    jbase = jsampling.build_base_sampler(_Jitted(JaxUNet(jbase_cfg)), jdiff, jparams,
                                         steps=BASE_STEPS)
    jsr = jsampling.build_sr_sampler(_Jitted(JaxSR(jsr_cfg)), jsr_diff, {"unet": jsr_params},
                                     sample_fn="ddim", steps=SR_STEPS)
    ref = jsampling.sample_base_and_sr(jbase, jsr, jax.random.PRNGKey(0), 1, 64, 4)

    pbase = sampling.build_base_sampler(base, diffusion, steps=BASE_STEPS)
    psr = sampling.build_sr_sampler(sr, sr_diffusion, sample_fn="ddim", steps=SR_STEPS)
    out = sampling.sample_base_and_sr(
        pbase, psr, 1, 64, 4, x_T={k: t(v) for k, v in x_T.items()}, sr_x_T=t(sr_x_T)
    )
    for k in ("video", "audio", "sr_video"):
        assert out[k].shape == ref[k].shape
        assert np.abs(np.asarray(ref[k])).max() > 1e-2
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **E2E_TOL)


CLI_ARGS = [
    "--video_size", "4,3,16,16", "--audio_size", "1,1024", "--num_channels", "32",
    "--num_res_blocks", "1", "--channel_mult", "1,2,3,4", "--num_head_channels", "16",
    "--resblock_updown", "True", "--large_size", "64", "--small_size", "16",
    "--sr_num_channels", "32", "--sr_num_res_blocks", "1", "--sr_attention_resolutions", "4,8",
    "--sr_num_head_channels", "32", "--sr_resblock_updown", "True",
    "--sample_steps", "3", "--sr_sample_steps", "2", "--sample_num", "1", "--device", "cpu",
]


def test_cli_writes_samples_on_cpu(tmp_path):
    result = cli.main(CLI_ARGS + ["--output_dir", str(tmp_path)])
    samples = result["samples"]
    assert samples["video"].shape == (1, 4, 16, 16, 3)
    assert samples["audio"].shape == (1, 1024, 1)
    assert samples["sr_video"].shape == (1, 4, 64, 64, 3)
    assert all(np.isfinite(v).all() for v in samples.values())
    assert result["paths"] and all(os.path.exists(p) for p in result["paths"])
    assert {"base_s", "sr_s"} <= set(result["timings"][0])


@pytest.mark.parametrize("flag,value,error,match", [
    # --save_type npz and --run_eval run (tests/test_torch_port_eval_pipeline.py);
    # --n_sample_data 2 samples on 2 processes (tests/test_torch_port_parallel_cli.py);
    # a run of one process refuses it with the launch line to use
    ("--n_sample_data", "2", ValueError, "torchrun --nproc_per_node 2"),
])
def test_cli_refuses_unported_options(tmp_path, flag, value, error, match):
    with pytest.raises(error, match=match):
        cli.main(CLI_ARGS + ["--output_dir", str(tmp_path), flag, value])


def test_cli_refuses_missing_cuda_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [a for a in CLI_ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args + ["--output_dir", str(tmp_path)])
