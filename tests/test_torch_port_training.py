"""The port's training path against the JAX package's, in fp32 on the CPU:
the diffusion losses, the loss-aware schedule sampler, AdamW (anneal,
clip) against optax, and one train step of a tiny MM-UNet (the
tests/test_training.py config) -- loss, every gradient, the parameters and
EMA after the update -- with the same weights through the weight bridge and
the same timesteps, noise and RS-MMA shift.  Then the port's own
invariants: accumulation and remat leave the gradients unchanged, the
checkpoint round trip, the loop's resume, and the train CLI on the CPU.

Tolerances: fp32 summation order only -- 1e-5 relative for losses and
the optimizer's arithmetic (a few ulps per AdamW step), 1e-6 absolute for
the parameters and EMA after one step, 2e-3 relative with an absolute floor of
1e-4 x the largest gradient for the model's gradients (the MM-UNet forward
parity's tolerance, tests/test_torch_port_mm_unet.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_common import one_torch_thread, randn, t  # noqa: F401

from mm_diffusion_tpu import configs as jconfigs
from mm_diffusion_tpu.models.mm_unet import MultimodalUNet as JaxUNet
from mm_diffusion_tpu.train import resample as jresample
from mm_diffusion_tpu.train import state as jstate
from mm_diffusion_tpu.train import torch_import as ti
from mm_diffusion_tpu_torch import configs
from mm_diffusion_tpu_torch.data.synthetic import load_synthetic_data
from mm_diffusion_tpu_torch.diffusion import gaussian as pgauss
from mm_diffusion_tpu_torch.models import mm_unet
from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
from mm_diffusion_tpu_torch.scripts import multimodal_train
from mm_diffusion_tpu_torch.train import (
    LossSecondMomentResampler,
    TrainLoop,
    create_train_state,
    latest_checkpoint_step,
    make_optimizer,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from mm_diffusion_tpu_torch.train.state import AdamW
from mm_diffusion_tpu_torch.weights import jax_params_from_state_dict, randomize_, state_dict_from_jax

TINY = dict(
    video_size="2,3,8,8", audio_size="1,128", num_channels=16, num_res_blocks=1,
    cross_attention_resolutions="2", cross_attention_windows="1", cross_attention_shift=True,
    video_attention_resolutions="2", audio_attention_resolutions="-1", channel_mult="1,2",
    num_heads=2, dropout=0.0, dtype="float32",
)
TINY_ARGV = (
    "--video_size 2,3,8,8 --audio_size 1,128 --num_channels 16 --num_res_blocks 1 "
    "--cross_attention_resolutions 2 --cross_attention_windows 1 --video_attention_resolutions 2 "
    "--audio_attention_resolutions -1 --channel_mult 1,2 --num_heads 2 --batch_size 4"
).split()
B, STEPS, SHIFT, LR = 4, 100, 1, 1e-3
T_STEPS = np.array([0, 17, 55, 99])  # t = 0 takes the decoder-NLL branch of the VLB


def _batch(seed=0):
    return next(load_synthetic_data(B, video_size=(2, 3, 8, 8), audio_size=(1, 128), seed=seed))


def _noise(seed=1):
    return {"video": randn(seed, B, 2, 8, 8, 3), "audio": randn(seed + 1, B, 128, 1)}


def _tt(x):
    return {k: t(v) for k, v in x.items()} if isinstance(x, dict) else t(x)


def _jj(x):
    return {k: jnp.asarray(v) for k, v in x.items()} if isinstance(x, dict) else jnp.asarray(x)


# -- losses ------------------------------------------------------------------


def _jax_model(learn_sigma):
    """A smooth stand-in model: mean 0.5 x + 1e-3 t, variance values
    0.3 tanh(x) when learned (the same function as _port_model)."""

    def model_fn(x, t_model):
        def leaf(v):
            mean = 0.5 * v + 1e-3 * t_model.reshape((-1,) + (1,) * (v.ndim - 1)).astype(v.dtype)
            return jnp.concatenate([mean, 0.3 * jnp.tanh(v)], -1) if learn_sigma else mean

        return {k: leaf(v) for k, v in x.items()}

    return model_fn


def _port_model(learn_sigma):
    def model_fn(x, t_model):
        def leaf(v):
            mean = 0.5 * v + 1e-3 * t_model.reshape((-1,) + (1,) * (v.dim() - 1)).to(v.dtype)
            return torch.cat([mean, 0.3 * torch.tanh(v)], -1) if learn_sigma else mean

        return {k: leaf(v) for k, v in x.items()}

    return model_fn


@pytest.mark.parametrize(
    "learn_sigma,use_kl,rescale",
    [(False, False, False), (True, False, False), (True, False, True), (True, True, False)],
    ids=["mse", "mse+vb", "rescaled mse+vb", "rescaled kl"],
)
def test_training_losses_match_jax(learn_sigma, use_kl, rescale):
    kw = dict(steps=STEPS, learn_sigma=learn_sigma, use_kl=use_kl, rescale_learned_sigmas=rescale)
    jd, pd = jconfigs.create_gaussian_diffusion(**kw), configs.create_gaussian_diffusion(**kw)
    assert jd.loss_type.name == pd.loss_type.name
    x, noise = _batch(), _noise()
    ref = jd.training_losses(_jax_model(learn_sigma), _jj(x), jnp.asarray(T_STEPS),
                             jax.random.PRNGKey(0), noise=_jj(noise))
    out = pd.training_losses(_port_model(learn_sigma), _tt(x), torch.as_tensor(T_STEPS),
                             noise=_tt(noise))
    assert set(out) == set(ref)
    np.testing.assert_allclose(out["loss"].numpy(), np.asarray(ref["loss"]), rtol=1e-5)
    for key in set(ref) - {"loss"}:
        for m in ("video", "audio"):
            np.testing.assert_allclose(
                out[key][m].numpy(), np.asarray(ref[key][m]), rtol=1e-5, atol=1e-7, err_msg=key
            )


def test_q_sample_and_q_mean_variance_match_jax():
    jd, pd = jconfigs.create_gaussian_diffusion(steps=STEPS), configs.create_gaussian_diffusion(steps=STEPS)
    x, noise, tt = _batch(), _noise(), T_STEPS
    np.testing.assert_allclose(
        pd.q_sample(_tt(x), torch.as_tensor(tt), _tt(noise))["video"].numpy(),
        np.asarray(jd.q_sample(_jj(x), jnp.asarray(tt), _jj(noise))["video"]), rtol=1e-6, atol=1e-6,
    )
    for a, b in zip(pd.q_mean_variance(_tt(x), torch.as_tensor(tt)),
                    jd.q_mean_variance(_jj(x), jnp.asarray(tt))):
        np.testing.assert_allclose(a["audio"].numpy(), np.asarray(b["audio"]), rtol=1e-6, atol=1e-7)


# -- schedule sampler, optimizer ------------------------------------------------


def test_loss_second_moment_resampler_matches_jax():
    js = jresample.LossSecondMomentResampler.create(num_timesteps=10, history=3)
    ps = LossSecondMomentResampler(10, history=3)
    rng = np.random.RandomState(0)
    for i in range(14):  # warm-up, ring-buffer overflow, repeated timesteps in one batch
        tt = np.array([0, 0, 0, 5]) if i == 0 else rng.randint(0, 10, size=6)
        losses = rng.rand(len(tt)).astype(np.float32) + i
        js = js.update(jnp.asarray(tt), jnp.asarray(losses))
        ps.update(torch.as_tensor(tt), torch.as_tensor(losses))
        np.testing.assert_array_equal(ps.loss_counts.numpy(), np.asarray(js.loss_counts))
        np.testing.assert_allclose(ps.loss_history.numpy(), np.asarray(js.loss_history))
        np.testing.assert_allclose(ps.weights().numpy(), np.asarray(js.weights()), rtol=1e-6)
    assert bool((ps.loss_counts == 3).all())  # warmed up: weights no longer uniform
    t_s, w = ps.sample(64, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(w.numpy(), 1.0 / (10 * ps.weights()[t_s].numpy()), rtol=1e-6)


@pytest.mark.parametrize("anneal,clip", [(0, 0.0), (4, 0.0), (4, 0.5)])
def test_adamw_matches_optax(anneal, clip):
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [randn(i, *s) for i, s in enumerate(shapes)]
    tx = jstate.make_optimizer(lr=1e-2, weight_decay=0.1, lr_anneal_steps=anneal, grad_clip=clip)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    pp = [torch.nn.Parameter(t(p)) for p in params]
    opt = AdamW(pp, lr=1e-2, weight_decay=0.1, lr_anneal_steps=anneal, grad_clip=clip)
    for step in range(5):
        grads = [randn(10 + step * 3 + i, *s) for i, s in enumerate(shapes)]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(pp, grads):
            p.grad = t(g)
        opt.step(step)
        for a, b in zip(pp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


# -- one train step of the tiny MM-UNet against JAX -----------------------------


@pytest.fixture(scope="module")
def tiny():
    """Random non-zero weights (port -> JAX through the weight bridge), the
    matrices at 0.3x randomize_'s scale: at full scale this tiny model is
    numerically chaotic (its fp32 and fp64 gradients differ by 6% relative
    L2, the fp64 gradient disagrees with finite differences), at 0.3x they
    agree to 1e-5, so an fp32 comparison with the JAX package means
    something."""
    cfg = configs.create_model_config(**TINY)
    model = randomize_(MultimodalUNet(cfg), seed=3)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.mul_(0.3)
    params = jax_params_from_state_dict(model.state_dict(), cfg)
    return cfg, model.state_dict(), params


def _port_state(cfg, sd, ema_rates=(0.5,), **cfg_kw):
    model = MultimodalUNet(configs.create_model_config(**{**TINY, **cfg_kw}))
    model.load_state_dict(sd)
    model.train()
    return create_train_state(model, make_optimizer(model, LR), ema_rates, num_timesteps=STEPS)


def _grads_by_name(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _assert_grads_close(got, ref):
    scale = max(float(v.abs().max()) for v in ref.values())
    assert scale > 1e-3
    for name, g in ref.items():
        torch.testing.assert_close(got[name], g, rtol=2e-3, atol=1e-4 * scale, msg=name)


@pytest.fixture(scope="module")
def jax_step(tiny):
    """The JAX package's loss gradient and train step on the same draws:
    jax.random.randint (timesteps and the RS-MMA shift) and
    jax.random.normal (the noise) patched to return them."""
    cfg, sd, params = tiny
    model = JaxUNet(jconfigs.create_model_config(**TINY))
    diffusion = jconfigs.create_gaussian_diffusion(steps=STEPS)
    tx = jstate.make_optimizer(lr=LR)
    batch, noise = _jj(_batch()), _noise()
    by_shape = {v.shape: jnp.asarray(v) for v in noise.values()}

    def randint(key, shape, lo, hi, *a, **k):
        return jnp.asarray(T_STEPS, jnp.int32) if tuple(shape) == (B,) else jnp.int32(SHIFT)

    def normal(key, shape=(), dtype=jnp.float32):
        return by_shape[tuple(shape)].astype(dtype)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "randint", randint)
    mp.setattr(jax.random, "normal", normal)
    try:
        def loss_fn(p):
            def model_fn(x, t_model):
                v, a = model.apply({"params": p}, x["video"], x["audio"], t_model, train=True,
                                   rngs={"shift": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)})
                return {"video": v, "audio": a}

            terms = diffusion.training_losses(model_fn, batch, jnp.asarray(T_STEPS), jax.random.PRNGKey(2))
            return jnp.mean(terms["loss"])

        jparams = jax.tree.map(jnp.asarray, params)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
        state = jstate.create_train_state(jparams, tx, ema_rates=(0.5,), num_timesteps=STEPS)
        new_state, metrics = jax.jit(jstate.make_train_step(model, diffusion, tx))(
            state, batch, jax.random.PRNGKey(3)
        )
    finally:
        mp.undo()
    to_sd = lambda tree: state_dict_from_jax(jax.tree.map(np.asarray, tree), cfg)  # noqa: E731
    return {
        "loss": float(loss), "grads": to_sd(grads), "params": to_sd(new_state.params),
        "ema": to_sd(new_state.ema["0.5"]), "metrics": jax.tree.map(float, metrics),
    }


def _port_step(state, accum_steps=1):
    step = make_train_step(configs.create_gaussian_diffusion(steps=STEPS), accum_steps, shift=SHIFT)
    return step(state, _tt(_batch()), t=torch.as_tensor(T_STEPS), noise=_tt(_noise()))


def test_bridge_matches_jax_importer_and_round_trips(tiny):
    """jax_params_from_state_dict equals the JAX package's importer bit for
    bit, and state_dict_from_jax inverts it."""
    cfg, sd, params = tiny
    sd_np = {k: v.numpy() for k, v in sd.items()}
    ref, unused = ti.convert_mm_unet_state_dict(sd_np, jconfigs.create_model_config(**TINY))
    assert unused == []
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(flat) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat[path], np.asarray(leaf), err_msg=str(path))
    back = state_dict_from_jax(params, cfg)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_train_step_matches_jax(tiny, jax_step):
    cfg, sd, _ = tiny
    state = _port_state(cfg, sd)
    metrics = _port_step(state)
    np.testing.assert_allclose(float(metrics["loss"]), jax_step["loss"], rtol=1e-5)
    for k in ("loss", "grad_norm", "param_norm", "loss_q0", "loss_q1", "loss_q2", "loss_q3"):
        np.testing.assert_allclose(float(metrics[k]), jax_step["metrics"][k], rtol=2e-5, err_msg=k)
    _assert_grads_close(_grads_by_name(state.model), jax_step["grads"])
    # AdamW's first step moves each parameter by lr * g / (|g| + eps): where
    # the gradient is below the fp32 noise floor (a conv bias ahead of a
    # GroupNorm has a true gradient of 0) its sign is noise, so the updated
    # values are compared where the gradient is resolved, and elsewhere
    # only held to a step of at most lr.
    floor = 1e-4 * max(float(v.abs().max()) for v in jax_step["grads"].values())
    params = dict(state.model.named_parameters())
    resolved = 0
    for name, p in jax_step["params"].items():
        mask = jax_step["grads"][name].abs() > floor
        resolved += int(mask.sum())
        for got, ref in ((params[name].detach(), p), (state.ema["0.5"][name], jax_step["ema"][name])):
            torch.testing.assert_close(got[mask], ref[mask], rtol=0, atol=1e-6, msg=name)
        assert float((params[name].detach() - sd[name]).abs().max()) <= LR * 1.001, name
    assert resolved > 0.75 * sum(p.numel() for p in params.values())  # 81% here
    assert state.step == 1


def test_accumulation_and_remat_leave_gradients_unchanged(tiny, monkeypatch):
    cfg, sd, _ = tiny
    base = _port_state(cfg, sd)
    _port_step(base)
    ref = _grads_by_name(base.model)
    accum = _port_state(cfg, sd)
    _port_step(accum, accum_steps=2)
    _assert_grads_close(_grads_by_name(accum.model), ref)

    monkeypatch.setenv("MMDIFF_REMAT_MIN_TOKENS", "0")  # every ResBlock of the tiny model
    remat = _port_state(cfg, sd, use_checkpoint=True)
    calls = []
    real = mm_unet.checkpoint
    monkeypatch.setattr(mm_unet, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    _port_step(remat)
    assert len(calls) == sum(isinstance(m, mm_unet.MMResBlock) for m in remat.model.modules())
    for name, g in _grads_by_name(remat.model).items():
        torch.testing.assert_close(g, ref[name], rtol=0, atol=1e-6, msg=name)


def test_dropout_is_active_only_in_train_mode():
    model = MultimodalUNet(configs.create_model_config(**{**TINY, "dropout": 0.5}))
    randomize_(model, seed=4)
    v, a, tt = t(randn(5, 1, 2, 8, 8, 3)), t(randn(6, 1, 128, 1)), torch.tensor([5])
    with torch.no_grad():
        model.eval()
        assert torch.equal(model(v, a, tt)[0], model(v, a, tt)[0])
        model.train()
        assert not torch.equal(model(v, a, tt)[0], model(v, a, tt)[0])


# -- checkpoint, loop, CLI ---------------------------------------------------------


def test_checkpoint_round_trip_and_latest_step(tiny, tmp_path):
    cfg, sd, _ = tiny
    state = _port_state(cfg, sd)
    _port_step(state)
    ckpt = str(tmp_path / "ckpt")
    assert latest_checkpoint_step(ckpt) is None
    assert save_checkpoint(ckpt, state) == 1
    _port_step(state)
    save_checkpoint(ckpt, state)
    assert latest_checkpoint_step(ckpt) == 2
    fresh = _port_state(cfg, sd)
    restore_checkpoint(ckpt, fresh)
    assert fresh.step == 2
    for (n, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    for n, x in state.ema["0.5"].items():
        assert torch.equal(x, fresh.ema["0.5"][n]), n
    m1, m2 = _port_step(state), _port_step(fresh)  # the optimizer state came back too
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)
    restore_checkpoint(ckpt, fresh, step=1)
    assert fresh.step == 1


def _loop(tmp_path, model=None, **kw):
    cfg = configs.create_model_config(**TINY)
    return TrainLoop(
        model=model or randomize_(MultimodalUNet(cfg), seed=7),
        diffusion=configs.create_gaussian_diffusion(steps=STEPS),
        data=load_synthetic_data(B, video_size=(2, 3, 8, 8), audio_size=(1, 128)),
        log_interval=1, save_interval=1000, output_dir=str(tmp_path),
        save_preview=False, device="cpu", **kw,
    )


def test_train_loop_runs_saves_and_resumes(tmp_path):
    loop = _loop(tmp_path)
    loop.run_loop(max_steps=2)
    loop.close()
    assert not loop._prefetch
    assert loop.state.step == 2 and len(loop.history) == 2
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in loop.history)
    assert latest_checkpoint_step(str(tmp_path / "checkpoints")) == 2
    resumed = _loop(tmp_path)
    assert resumed.resumed_from == 2 and resumed.state.step == 2
    for a, b in zip(loop.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    resumed.run_loop(max_steps=3)
    resumed.close()
    assert resumed.state.step == 3 and [r["step"] for r in resumed.history] == [3]


def test_preview_samples_with_the_ema_weights(tmp_path):
    """At a save interval the loop writes a checkpoint and an EMA-weight
    preview (a grid video and one audio-video pair per sample)."""
    loop = _loop(tmp_path)
    loop.save_preview, loop.save_interval = True, 1
    loop.run_loop(max_steps=1)
    loop.close()
    previews = sorted(p.name for p in (tmp_path / "previews").iterdir())
    assert any(n.startswith("step_000001_grid") for n in previews)
    assert sum(n.endswith(".wav") for n in previews) == loop.preview_samples
    assert latest_checkpoint_step(str(tmp_path / "checkpoints")) == 1


def test_train_loop_surfaces_loader_errors(tmp_path):
    def dying():
        yield next(load_synthetic_data(B, video_size=(2, 3, 8, 8), audio_size=(1, 128)))
        raise IOError("no audio source for clip_7.mp4")

    loop = _loop(tmp_path)
    loop.data = dying()
    with pytest.raises(IOError, match="no audio source"):
        loop.run_loop(max_steps=5)
    loop.close()
    assert loop.state.step == 1


def test_train_cli_on_cpu(tmp_path):
    out = str(tmp_path / "run")
    argv = TINY_ARGV + ["--device", "cpu", "--output_dir", out, "--log_interval", "1",
                        "--learn_sigma", "True", "--use_checkpoint", "True", "--microbatch", "2"]
    loop = multimodal_train.main(argv + ["--max_steps", "2"])
    assert loop.state.step == 2 and loop.model.cfg.use_checkpoint
    assert loop.diffusion.loss_type == pgauss.LossType.MSE
    assert latest_checkpoint_step(f"{out}/checkpoints") == 2
    again = multimodal_train.main(argv + ["--max_steps", "3"])
    assert again.resumed_from == 2 and again.state.step == 3
    # --n_fsdp 2 shards over 2 processes (tests/test_torch_port_parallel_cli.py);
    # without a launcher the mesh cannot be built
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        multimodal_train.main(argv + ["--n_fsdp", "2"])
    # a dataset directory is read (tests/test_torch_port_data.py trains on
    # one); a directory without videos is refused when the first batch is drawn
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no video files"):
        multimodal_train.main(argv + ["--data_dir", str(tmp_path / "empty"),
                                      "--output_dir", str(tmp_path / "run_empty")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            multimodal_train.main(TINY_ARGV + ["--output_dir", out])
