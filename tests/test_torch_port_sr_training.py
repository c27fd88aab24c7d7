"""SR U-Net training in the port (train/tasks.py::ImageSRTask on the shared
train step and loop, scripts/image_sr_train.py) against the JAX package's,
in fp32 on the CPU: one train step's loss and every parameter gradient
against ``jax.value_and_grad`` of JAX's ImageSRTask adapter step, with the
same weights, timesteps and noise.  Then the port's own invariants:
use_checkpoint (now passed on by create_image_sr_config) leaves the
gradients unchanged, dropout follows train(), the preview writes its
triptych, the CLI trains, saves and resumes, and ``--resume_checkpoint
<file>.pt`` loads the same parameters as JAX's load_torch_image_checkpoint.

Tolerances: the loss 1e-5 relative; the gradients rtol 2e-3 with an
absolute floor of 1e-4 x the largest (as tests/test_torch_port_training.py,
whose 0.3x weight scale this file shares for the same reason); remat
1e-6 absolute; the loaded parameters bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, randn, state_dict_numpy, t  # noqa: F401

from mm_diffusion_tpu import configs as jconfigs
from mm_diffusion_tpu.train import tasks as jtasks
from mm_diffusion_tpu.train import torch_import as ti
from mm_diffusion_tpu_torch import configs
from mm_diffusion_tpu_torch.models import image_unet
from mm_diffusion_tpu_torch.scripts import image_sr_train
from mm_diffusion_tpu_torch.train import (
    ImageSRTask,
    TrainLoop,
    create_train_state,
    latest_checkpoint_step,
    make_optimizer,
    make_train_step,
)
from mm_diffusion_tpu_torch.weights import image_state_dict_from_jax, randomize_

SR = dict(large_size=64, small_size=16, sr_num_channels=32, sr_num_res_blocks=1,
          sr_attention_resolutions="4,8", sr_num_head_channels=16, sr_resblock_updown=True,
          sr_learn_sigma=True, sr_diffusion_steps=100)
SR_ARGV = [f"--{k}={v}" for k, v in SR.items()]
B, LR = 2, 1e-3
T_STEPS = np.array([0, 57])  # t = 0 takes the decoder-NLL branch of the VLB


def _batch(seed=0):
    return next(image_sr_train.synthetic_sr_data(B, 64, 16, seed))


def _noise(seed=1):
    return randn(seed, B, 64, 64, 3)


def _grads_close(got, ref):
    scale = max(float(v.abs().max()) for v in ref.values())
    assert scale > 1e-3
    for name, g in ref.items():
        torch.testing.assert_close(got[name], g, rtol=2e-3, atol=1e-4 * scale, msg=name)


@pytest.fixture(scope="module")
def weights():
    model, _ = configs.image_sr_create_model_and_diffusion(**SR)
    randomize_(model, seed=3)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.mul_(0.3)
    return model.state_dict()


def _port_model(sd, **kw):
    model, diffusion = configs.image_sr_create_model_and_diffusion(**SR, **kw)
    model.load_state_dict(sd)
    return model.train(), diffusion


def _port_step(sd, **kw):
    model, diffusion = _port_model(sd, **kw)
    state = create_train_state(model, make_optimizer(model, LR), (0.5,), num_timesteps=100)
    step = make_train_step(diffusion, adapter=ImageSRTask().adapter(None))
    metrics = step(state, {k: t(v) for k, v in _batch().items()}, t=torch.as_tensor(T_STEPS),
                   noise=t(_noise()))
    return metrics, {n: p.grad.detach().clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def jax_step(weights):
    """JAX's ImageSRTask adapter step: jax.random.normal (the noise)
    patched to return the port's."""
    model, diffusion = jconfigs.image_sr_create_model_and_diffusion(**SR)
    params, unused = ti.convert_image_unet_state_dict(
        {k: v.numpy() for k, v in weights.items()}, model.cfg)
    assert unused == []
    params = {"unet": jax.tree.map(jnp.asarray, params)}
    adapt = jtasks.ImageSRTask(64, 16).adapter(model)
    batch = jax.tree.map(jnp.asarray, _batch())
    noise = jnp.asarray(_noise())
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: noise.astype(dtype))
    try:
        def loss_fn(p):
            x_start, model_fn = adapt(p, batch, {"dropout": jax.random.PRNGKey(1)})
            terms = diffusion.training_losses(model_fn, x_start, jnp.asarray(T_STEPS), jax.random.PRNGKey(2))
            return jnp.mean(terms["loss"])

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    finally:
        mp.undo()
    cfg = configs.create_image_sr_config(**SR)
    return float(loss), image_state_dict_from_jax(jax.tree.map(np.asarray, grads), cfg)


def test_sr_train_step_matches_jax(weights, jax_step):
    metrics, grads = _port_step(weights)
    ref_loss, ref_grads = jax_step
    np.testing.assert_allclose(float(metrics["loss"]), ref_loss, rtol=1e-5)
    assert set(grads) == set(ref_grads)
    _grads_close(grads, ref_grads)


def test_use_checkpoint_is_passed_on_and_leaves_gradients_unchanged(weights, monkeypatch):
    assert configs.create_image_sr_config(**SR, use_checkpoint=True).use_checkpoint
    assert not configs.create_image_sr_config(**SR).use_checkpoint
    _, ref = _port_step(weights)
    monkeypatch.setenv("MMDIFF_REMAT_MIN_TOKENS", "64")  # every block at 8x8 pixels or more
    calls, real = [], image_unet.checkpoint
    monkeypatch.setattr(image_unet, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, got = _port_step(weights, use_checkpoint=True)
    model, _ = _port_model(weights)
    assert len(calls) == sum(isinstance(m, image_unet.ImageResBlock) for m in model.modules())
    for name, g in ref.items():
        torch.testing.assert_close(got[name], g, rtol=0, atol=1e-6, msg=name)
    with torch.no_grad():  # no recompute without gradients (sampling)
        calls.clear()
        model.eval()(t(_noise()), torch.tensor([3, 4]), t(_batch()["low_res"]))
        assert calls == []


def test_dropout_follows_train_mode(weights):
    model, _ = _port_model(weights, sr_dropout=0.5)
    x, ts, low = t(_noise()), torch.tensor([3, 4]), t(_batch()["low_res"])
    with torch.no_grad():
        model.eval()
        assert torch.equal(model(x, ts, low), model(x, ts, low))
        model.train()
        assert not torch.equal(model(x, ts, low), model(x, ts, low))


def test_preview_writes_the_triptych(weights, tmp_path):
    model, diffusion = _port_model(weights)
    loop = TrainLoop(model=model, diffusion=diffusion, data=image_sr_train.synthetic_sr_data(3, 64, 16),
                     task=ImageSRTask(preview_steps=3), log_interval=1, save_interval=1,
                     output_dir=str(tmp_path), device="cpu")
    loop.run_loop(max_steps=1)
    loop.close()
    assert set(loop.last_batch) == {"high_res", "low_res"}
    import cv2

    img = cv2.imread(str(tmp_path / "previews" / "step_000001.png"))
    assert img.shape == (3 * 64, 3 * 64, 3)  # bicubic | sample | ground truth, one row per image
    assert latest_checkpoint_step(str(tmp_path / "checkpoints")) == 1


def test_sr_train_cli_on_cpu_resumes(tmp_path):
    out = str(tmp_path / "run")
    argv = SR_ARGV + ["--device", "cpu", "--batch_size", "2", "--log_interval", "1", "--output_dir", out,
                      "--use_checkpoint", "True"]
    loop = image_sr_train.main(argv + ["--max_steps", "2"])
    assert loop.state.step == 2 and loop.model.cfg.use_checkpoint
    assert all(np.isfinite(r["loss"]) for r in loop.history)
    assert latest_checkpoint_step(f"{out}/checkpoints") == 2
    again = image_sr_train.main(argv + ["--max_steps", "3"])
    assert again.resumed_from == 2 and again.state.step == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            image_sr_train.main(SR_ARGV + ["--output_dir", out])


def test_resume_from_a_reference_pt_matches_jax_import(weights, tmp_path):
    """A guided-diffusion-layout .pt initialises the CLI's model (lr 0
    keeps it for one step) to JAX's load_torch_image_checkpoint of it."""
    pt = str(tmp_path / "upsampler.pt")
    torch.save(weights, pt)
    loop = image_sr_train.main(SR_ARGV + ["--device", "cpu", "--batch_size", "2", "--max_steps", "1",
                                          "--lr", "0", "--resume_checkpoint", pt,
                                          "--output_dir", str(tmp_path / "run")])
    assert loop.resumed_from is None and loop.state.step == 1
    jcfg = jconfigs.create_image_sr_config(**{**jconfigs.image_sr_model_and_diffusion_defaults(), **SR})
    ref = image_state_dict_from_jax(ti.load_torch_image_checkpoint(pt, jcfg, super_res=True),
                                    loop.model.cfg)
    got = state_dict_numpy(loop.model)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
