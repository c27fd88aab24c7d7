"""The port's training loop, train CLIs and sampling CLI on several
processes (CPU, gloo), each launch with the environment torchrun gives.

* Checkpoints across world sizes: a 2-rank FSDP run saves at step 2; a
  one-process run resumed from that file equals the uninterrupted
  one-process run at step 3, and a 2-rank FSDP run resumed from the
  one-process step-2 file equals it too (each step's draws depend on the
  seed and the step alone).  The 2-rank run's first two steps equal the
  one-process run's.
* The three train CLIs run 2 steps on 2 ranks and resume to step 3 (MM
  with FSDP over both ranks, single-modal and SR with DDP); rank 0 alone
  writes the logs.
* ``multimodal_sample_sr`` on 2 ranks with ``--n_sample_data 2`` writes the
  files of the one-process run at the same seed, and the same samples
  (1e-5), with the deterministic samplers (dpm_solver, then ddim for SR)
  and with ddpm at both stages, whose per-step noise the ranks draw for
  the global batch; the one-process run is held to JAX by
  tests/test_torch_port_sampling.py::test_sample_base_and_sr_matches_jax.

Tolerances: losses 2e-5 relative; parameters after three AdamW steps
within a tenth of one step (lr / 10) where the run's last gradient is
resolved (the step of a parameter whose gradient is below fp32's noise
floor has a random sign: the conv biases ahead of a GroupNorm, which do
not change the loss)."""

import itertools
import os
import shutil

import numpy as np
import pytest
import torch
from test_torch_port_training import LR, STEPS, TINY, TINY_ARGV, tiny  # noqa: F401  (tiny: a fixture)
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_parallel_worker import Launch

from mm_diffusion_tpu_torch import configs
from mm_diffusion_tpu_torch.data.synthetic import load_synthetic_data
from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr
from mm_diffusion_tpu_torch.train import TrainLoop

SINGLE_ARGV = ("--modality audio --audio_size 1,256 --num_channels 16 --num_res_blocks 1 "
               "--attention_resolutions 2 --channel_mult 1,2 --num_heads 2 --batch_size 2 "
               "--diffusion_steps 100").split()
SR_ARGV = ("--large_size 64 --small_size 16 --sr_num_channels 32 --sr_num_res_blocks 1 "
           "--sr_attention_resolutions 4,8 --sr_num_head_channels 16 --sr_resblock_updown True "
           "--sr_learn_sigma True --sr_diffusion_steps 100 --batch_size 2").split()
SAMPLE_ARGV = ("--video_size 4,3,16,16 --audio_size 1,1024 --num_channels 32 --num_res_blocks 1 "
               "--channel_mult 1,2,3,4 --num_head_channels 16 --resblock_updown True --large_size 64 "
               "--small_size 16 --sr_num_channels 32 --sr_num_res_blocks 1 --sr_attention_resolutions 4,8 "
               "--sr_num_head_channels 32 --sr_resblock_updown True --sample_steps 3 --sr_sample_steps 2 "
               "--batch_size 2 --sample_num 2 --device cpu").split()
SAMPLE_ARGVS = {"solver": SAMPLE_ARGV,
                "ddpm": SAMPLE_ARGV + ("--sample_fn ddpm --timestep_respacing 3 --sr_sample_fn ddpm "
                                       "--sr_timestep_respacing 2").split()}
FSDP_MIN = 512


def _one_process_loop(sd, out_dir, skip=0, **kw):
    """A one-process TrainLoop on the global batches of 4, from the
    ``skip``-th on (a resumed run's data continues where the saved run's
    stopped)."""
    model = MultimodalUNet(configs.create_model_config(**TINY))
    model.load_state_dict(sd)
    return TrainLoop(
        model=model, diffusion=configs.create_gaussian_diffusion(steps=STEPS),
        data=itertools.islice(load_synthetic_data(4, video_size=(2, 3, 8, 8), audio_size=(1, 128)), skip, None),
        lr=LR, ema_rate="0.5", log_interval=1, save_interval=2, output_dir=str(out_dir),
        save_preview=False, device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def runs(tiny, tmp_path_factory):
    """The one-process references, and the three 2-rank launches (started
    once the one-process step-2 checkpoint exists, run side by side)."""
    _, sd, _ = tiny
    work = tmp_path_factory.mktemp("parallel_cli")
    torch.save({"sd": sd, "cfg": TINY, "steps": STEPS, "lr": LR, "t": np.zeros(4),
                "mm_argv": TINY_ARGV + ["--batch_size", "2"], "single_argv": SINGLE_ARGV,
                "sr_argv": SR_ARGV, "sample_argvs": SAMPLE_ARGVS}, work / "init.pt")
    one = _one_process_loop(sd, work / "one")
    one.run_loop(max_steps=3)
    one.close()
    (work / "one_at2").mkdir()
    shutil.copy(work / "one" / "checkpoints" / "step_00000002.pt", work / "one_at2")
    launches = {
        "checkpoint": Launch("checkpoint", work, 2, 2, FSDP_MIN, work / "one_at2"),
        "cli": Launch("cli", work, 2, work / "cli"),
        "sample": Launch("sample", work, 2, work / "sample_ranks"),
    }
    single = {name: multimodal_sample_sr.main(argv + ["--output_dir", str(work / "sample_one" / name)])
              for name, argv in SAMPLE_ARGVS.items()}
    out = {name: launch.results() for name, launch in launches.items()}
    resumed = _one_process_loop(sd, work / "one_resumed", skip=2,
                                resume_checkpoint=str(work / "ranks" / "checkpoints"))
    resumed.run_loop(max_steps=3)
    resumed.close()
    return {"work": work, "one": one, "resumed": resumed, "sample_one": single, **out}


def _assert_params_close(got, ref_loop):
    grads = {n: p.grad for n, p in ref_loop.model.named_parameters()}
    floor = 1e-4 * max(float(g.abs().max()) for g in grads.values())
    resolved = 0
    for name, p in ref_loop.model.named_parameters():
        mask = grads[name].abs() > floor
        resolved += int(mask.sum())
        torch.testing.assert_close(got[name].detach()[mask], p.detach()[mask], rtol=0, atol=LR / 10,
                                   msg=lambda m: f"{name}: {m}")
    assert resolved > 0.7 * sum(p.numel() for p in ref_loop.model.parameters())  # 74% here


def test_two_rank_fsdp_steps_equal_one_process_steps(runs):
    one_losses = [r["loss"] for r in runs["one"].history]
    for out in runs["checkpoint"]:
        assert out["is_sharded"]
        np.testing.assert_allclose([r["loss"] for r in out["history"]], one_losses[:2], rtol=2e-5)
    assert sorted(os.listdir(runs["work"] / "ranks" / "checkpoints")) == ["step_00000002.pt"]
    previews = os.listdir(runs["work"] / "ranks" / "previews")  # rank 0's, from the gathered EMA
    assert sum(n.endswith(".wav") for n in previews) == 1


@pytest.mark.parametrize("direction", ["ranks_to_one", "one_to_ranks"])
def test_checkpoint_resumes_across_world_sizes(runs, direction):
    """Step 3 resumed from the other world size's step-2 file equals the
    uninterrupted one-process step 3."""
    one = runs["one"]
    if direction == "ranks_to_one":
        resumed = runs["resumed"]
        assert resumed.resumed_from == 2 and resumed.state.step == 3
        got, losses = dict(resumed.model.named_parameters()), [r["loss"] for r in resumed.history]
        _assert_params_close(got, one)
        np.testing.assert_allclose(losses, [one.history[2]["loss"]], rtol=2e-5)
    else:
        for out in runs["checkpoint"]:
            assert out["resumed_from"] == 2
            np.testing.assert_allclose([r["loss"] for r in out["resumed_history"]], [one.history[2]["loss"]],
                                       rtol=2e-5)
            _assert_params_close(out["resumed_params"], one)


@pytest.mark.parametrize("name", ["mm", "single", "sr"])
def test_train_clis_run_and_resume_on_two_ranks(runs, name):
    a, b = runs["cli"]
    assert a[name] == b[name]  # the global step's metrics on both ranks
    out = a[name]
    assert out["kind"] == ("fsdp" if name == "mm" else "ddp") and out["is_sharded"] == (name == "mm")
    assert out["step"] == 2 and out["resumed_from"] == 2 and out["resumed_step"] == 3
    assert all(np.isfinite(out["losses"] + out["resumed_losses"]))
    run_dir = runs["work"] / "cli" / name
    rows = (run_dir / "progress.jsonl").read_text().splitlines()
    assert len(rows) == 3  # 2 steps and the resumed one, written by rank 0 alone
    assert sorted(os.listdir(run_dir / "checkpoints")) == ["step_00000002.pt", "step_00000003.pt"]


def _assert_sampling_equal(runs, name):
    one = runs["sample_one"][name]
    base = lambda paths: sorted(os.path.basename(p) for p in paths)  # noqa: E731
    ranks = [r[name] for r in runs["sample"]]
    assert ranks[1]["paths"] == [] and base(ranks[0]["paths"]) == base(one["paths"])
    assert len(one["paths"]) >= 4  # two clips, each an SR video, its audio and the base video
    for out in ranks:
        for k, v in one["samples"].items():
            assert out["samples"][k].shape == v.shape == (2,) + v.shape[1:]
            np.testing.assert_allclose(out["samples"][k], v, rtol=0, atol=1e-5, err_msg=k)


def test_sampling_on_two_ranks_equals_one_process(runs):
    _assert_sampling_equal(runs, "solver")


def test_ddpm_sampling_on_two_ranks_equals_one_process(runs):
    """ddpm draws noise at every step of both stages: the ranks' rows of
    it are the one-process draws."""
    _assert_sampling_equal(runs, "ddpm")
