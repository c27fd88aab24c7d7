"""Single-modal (video or audio) training in the port (train/tasks.py::
SingleModalTask on the shared train step and loop,
scripts/single_modal_train.py) against the JAX package's, in fp32 on the
CPU: one train step's loss and every parameter gradient against
``jax.value_and_grad`` of JAX's SingleModalTask adapter step, with the same
weights, timesteps and noise.  Then the CLI's config against JAX's, each
task's preview, and the CLI's two steps and resume for both modalities.

Tolerances: the loss 1e-5 relative; the gradients rtol 2e-3 with an
absolute floor of 1e-4 x the largest (the 0.3x weight scale of
tests/test_torch_port_training.py, for the same reason)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, randn, t  # noqa: F401

from mm_diffusion_tpu import configs as jconfigs
from mm_diffusion_tpu.models.single_unet import SingleModalUNet as JaxUNet
from mm_diffusion_tpu.models.single_unet import SingleUNetConfig as JaxConfig
from mm_diffusion_tpu.scripts import single_modal_train as jcli
from mm_diffusion_tpu.train import tasks as jtasks
from mm_diffusion_tpu_torch import configs
from mm_diffusion_tpu_torch.data.synthetic import load_synthetic_data
from mm_diffusion_tpu_torch.models.single_unet import SingleModalUNet, SingleUNetConfig
from mm_diffusion_tpu_torch.scripts import single_modal_train as cli
from mm_diffusion_tpu_torch.train import (
    SingleModalTask,
    TrainLoop,
    create_train_state,
    latest_checkpoint_step,
    make_optimizer,
    make_train_step,
)
from mm_diffusion_tpu_torch.weights import (
    randomize_,
    single_jax_params_from_state_dict,
    single_state_dict_from_jax,
)

CFGS = {
    "video": dict(modality="video", video_size=(4, 3, 8, 8), model_channels=16, out_channels=6,
                  num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2,
                  dtype="float32"),
    "audio": dict(modality="audio", audio_size=(1, 256), model_channels=16, out_channels=1,
                  num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2, 2), num_heads=2,
                  dtype="float32"),
}
B, STEPS, T_STEPS = 2, 100, np.array([0, 61])
TINY_ARGV = ("--video_size 4,3,8,8 --audio_size 1,256 --num_channels 16 --num_res_blocks 1 "
             "--attention_resolutions 2 --channel_mult 1,2 --num_heads 2 --batch_size 2 "
             "--diffusion_steps 100 --device cpu --log_interval 1").split()


def _model(modality):
    model = randomize_(SingleModalUNet(SingleUNetConfig(**CFGS[modality])), seed=3)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.mul_(0.3)
    return model.train()


def _batch(modality):
    cfg = SingleUNetConfig(**CFGS[modality])
    av = next(load_synthetic_data(B, video_size=cfg.video_size, audio_size=cfg.audio_size, seed=2))
    return {"x": av[modality]}


def _diffusion_kw(modality):
    return dict(steps=STEPS, learn_sigma=CFGS[modality]["out_channels"] == 2 * SingleUNetConfig(
        **CFGS[modality]).in_channels)


@pytest.mark.parametrize("modality", ["video", "audio"])
def test_single_train_step_matches_jax(modality):
    model = _model(modality)
    params = jax.tree.map(jnp.asarray, single_jax_params_from_state_dict(model.state_dict(), model.cfg))
    batch, noise = _batch(modality), randn(4, B, *model.cfg.sample_shape)

    jmodel = JaxUNet(JaxConfig(**CFGS[modality]))
    jd = jconfigs.create_gaussian_diffusion(**_diffusion_kw(modality))
    adapt = jtasks.SingleModalTask().adapter(jmodel)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.asarray(noise, dtype))
    try:
        def loss_fn(p):
            x_start, model_fn = adapt(p, jax.tree.map(jnp.asarray, batch), {"dropout": jax.random.PRNGKey(1)})
            terms = jd.training_losses(model_fn, x_start, jnp.asarray(T_STEPS), jax.random.PRNGKey(2))
            return jnp.mean(terms["loss"])

        ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    finally:
        mp.undo()
    ref_grads = single_state_dict_from_jax(jax.tree.map(np.asarray, ref_grads), model.cfg)

    state = create_train_state(model, make_optimizer(model, 1e-3), (0.5,), num_timesteps=STEPS)
    step = make_train_step(configs.create_gaussian_diffusion(**_diffusion_kw(modality)),
                           adapter=SingleModalTask().adapter(None))
    metrics = step(state, {"x": t(batch["x"])}, t=torch.as_tensor(T_STEPS), noise=t(noise))
    np.testing.assert_allclose(float(metrics["loss"]), float(ref_loss), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(ref_grads)
    scale = max(float(v.abs().max()) for v in ref_grads.values())
    assert scale > 1e-3
    for name, g in ref_grads.items():
        torch.testing.assert_close(grads[name], g, rtol=2e-3, atol=1e-4 * scale, msg=name)


@pytest.mark.parametrize("modality", ["video", "audio"])
def test_cli_config_matches_jax(modality):
    args = cli.create_argparser().parse_args(TINY_ARGV + ["--modality", modality, "--learn_sigma", "True",
                                                          "--use_checkpoint", "True"])
    flags = {k: getattr(args, k) for k in cli.single_model_defaults()}
    assert cli.single_model_defaults() == jcli.single_model_defaults()
    ours, ref = cli.create_single_config(**flags), jcli.create_single_config(**flags)
    ref = dataclasses.asdict(ref)
    assert ref.pop("num_classes") is None  # the class label no CLI can set is not ported
    assert dataclasses.asdict(ours) == ref
    assert ours.dtype == "bfloat16"  # as in the JAX package, whatever --use_fp16 says
    assert set(vars(args)) - {"device"} == set(vars(jcli.create_argparser().parse_args([])))
    data = cli.single_stream(load_synthetic_data(2, video_size=ours.video_size, audio_size=ours.audio_size),
                             modality)
    assert next(data)["x"].shape == (2,) + ours.sample_shape


@pytest.mark.parametrize("modality,sample_fn", [("video", "dpm_solver"), ("audio", "ddim")])
def test_preview_writes_media(modality, sample_fn, tmp_path):
    model = _model(modality)
    cfg = model.cfg
    timestep_respacing = "ddim4" if sample_fn == "ddim" else ""
    loop = TrainLoop(
        model=model,
        diffusion=configs.create_gaussian_diffusion(**_diffusion_kw(modality),
                                                    timestep_respacing=timestep_respacing),
        data=cli.single_stream(load_synthetic_data(B, video_size=cfg.video_size, audio_size=cfg.audio_size),
                               modality),
        task=SingleModalTask(sample_fn=sample_fn, preview_steps=3), preview_samples=2,
        log_interval=1, save_interval=1, output_dir=str(tmp_path), device="cpu",
    )
    loop.run_loop(max_steps=1)
    loop.close()
    names = sorted(os.listdir(tmp_path / "previews"))
    if modality == "video":
        assert any(n.startswith("step_000001_grid") for n in names)
    else:
        assert names == ["step_000001_00.wav", "step_000001_01.wav"]


@pytest.mark.parametrize("modality", ["video", "audio"])
def test_single_cli_on_cpu_resumes(modality, tmp_path):
    out = str(tmp_path / modality)
    argv = TINY_ARGV + ["--modality", modality, "--output_dir", out, "--use_checkpoint", "True",
                        "--microbatch", "1"]
    loop = cli.main(argv + ["--max_steps", "2"])
    assert loop.state.step == 2 and loop.model.cfg.modality == modality and loop.model.cfg.use_checkpoint
    assert all(np.isfinite(r["loss"]) for r in loop.history)
    assert latest_checkpoint_step(f"{out}/checkpoints") == 2
    again = cli.main(argv + ["--max_steps", "3"])
    assert again.resumed_from == 2 and again.state.step == 3
    # --n_fsdp 2 shards over 2 processes; without a launcher the mesh cannot be built
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        cli.main(argv + ["--n_fsdp", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main([a for a in argv if a not in ("--device", "cpu")])
