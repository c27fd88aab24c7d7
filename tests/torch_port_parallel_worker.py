"""One rank of the multi-process tests of the PyTorch port's parallel layer
(tests/test_torch_port_parallel*.py), on the CPU over gloo.

    RANK=r WORLD_SIZE=w LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_port_parallel_worker.py <scenario> <dir> [args...]

The environment is the one ``torchrun`` gives each process.  The worker
reads ``<dir>/init.pt`` (the tiny model's weights, config, global batch,
noise and timesteps, written by the test) and writes what the test checks
to ``<dir>/<scenario>_rank<r>.pt``.  It imports torch and the port only.
"""

import itertools
import os
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mm_diffusion_tpu_torch import configs  # noqa: E402
from mm_diffusion_tpu_torch.data.synthetic import load_synthetic_data  # noqa: E402
from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet  # noqa: E402
from mm_diffusion_tpu_torch.parallel import (  # noqa: E402
    ParallelModel,
    is_fsdp_sharded,
    make_mesh,
    process_data_shard,
    rank_rows,
    setup_dist,
)
from mm_diffusion_tpu_torch.parallel.mesh import full_tensor, is_dtensor  # noqa: E402
from mm_diffusion_tpu_torch.train import (  # noqa: E402
    LossSecondMomentResampler,
    TrainLoop,
    create_train_state,
    make_optimizer,
    make_train_step,
)


def _model(p):
    model = MultimodalUNet(configs.create_model_config(**p["cfg"]))
    model.load_state_dict(p["sd"])
    return model.train()


def _whole(named):
    return {n: full_tensor(x).detach().clone() for n, x in named}


def _state(p, mesh, min_size, sampler=None):
    model = _model(p)
    par = ParallelModel(model, mesh, min_size)
    state = create_train_state(model, make_optimizer(model, p["lr"]), (0.5,), sampler=sampler,
                               num_timesteps=p["steps"], parallel=par)
    return model, state


def _sharded(model):
    """``{parameter name: sharded dim}`` of the parameters FSDP shards."""
    return {n: [pl.dim for pl in q.placements if pl.is_shard()][0] for n, q in model.named_parameters()
            if is_dtensor(q) and any(pl.is_shard() for pl in q.placements)}


def _local_batch(p, rank, world):
    return {k: rank_rows(torch.from_numpy(v), rank, world) for k, v in p["batch"].items()}


def step(p, rank, world, n_fsdp, min_size):
    """One train step of the tiny MM-UNet on this rank's rows of the global
    batch, with the global timesteps and noise injected; with n_fsdp == 1
    also the same step at accum_steps 2 and three steps of the loss-aware
    sampler; with n_fsdp > 1 also the default threshold's placement."""
    n_fsdp, min_size = int(n_fsdp), int(min_size)
    mesh = make_mesh(n_fsdp=n_fsdp, device_type="cpu")
    diffusion = configs.create_gaussian_diffusion(steps=p["steps"])
    batch = _local_batch(p, rank, world)
    injected = dict(t=torch.as_tensor(p["t"]), noise={k: torch.from_numpy(v) for k, v in p["noise"].items()})
    model, state = _state(p, mesh, min_size)
    metrics = make_train_step(diffusion, shift=p["shift"])(state, batch, **injected)
    out = {
        "kind": state.parallel.kind,
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": _whole((n, q.grad) for n, q in model.named_parameters()),
        "params": _whole(model.named_parameters()),
        "ema": _whole(state.ema["0.5"].items()),
        "sharded": _sharded(model),
        "is_sharded": is_fsdp_sharded(model),
    }
    if n_fsdp == 1:
        model, state = _state(p, mesh, min_size)
        make_train_step(diffusion, accum_steps=2, shift=p["shift"])(state, batch, **injected)
        out["grads_accum2"] = _whole((n, q.grad) for n, q in model.named_parameters())

        sampler = LossSecondMomentResampler(p["steps"], history=p["history"])
        sampler.load_state_dict(p["warm_sampler"])
        seen = []
        update = sampler.update
        sampler.update = lambda t, losses: seen.append((t.clone(), losses.clone())) or update(t, losses)
        model, state = _state(p, mesh, min_size, sampler=sampler)
        train_step = make_train_step(diffusion, shift=p["shift"])
        t_gen, noise_gen = torch.Generator().manual_seed(11), torch.Generator().manual_seed(12)
        for _ in range(p["sampler_steps"]):
            train_step(state, batch, t_generator=t_gen, noise_generator=noise_gen)
        out["sampler_seen"] = seen
        out["sampler_state"] = sampler.state_dict()
    else:
        model, _ = _state(p, mesh, 2**18)
        out["default_threshold_sharded"] = is_fsdp_sharded(model)
    return out


def _rows(stream, rank, world):
    for b in stream:
        yield {k: v[rank * (len(v) // world):(rank + 1) * (len(v) // world)] for k, v in b.items()}


def checkpoint(p, rank, world, n_fsdp, min_size, resume_dir):
    """A TrainLoop on a (world / n_fsdp, n_fsdp) mesh over the rank's rows of
    the global batches: 2 steps from the initial weights saving at step 2
    (with a preview); then a run resumed from ``resume_dir`` to step 3 on
    the third global batch."""
    mesh = make_mesh(n_fsdp=int(n_fsdp), device_type="cpu")
    root = os.path.dirname(resume_dir)

    def loop(out_dir, skip=0, **kw):
        stream = load_synthetic_data(len(p["t"]), video_size=(2, 3, 8, 8), audio_size=(1, 128))
        return TrainLoop(
            model=_model(p), diffusion=configs.create_gaussian_diffusion(steps=p["steps"]),
            data=_rows(itertools.islice(stream, skip, None), rank, world),
            lr=p["lr"], ema_rate="0.5", log_interval=1, save_interval=2, output_dir=out_dir,
            preview_samples=1, device="cpu", mesh=mesh, fsdp_min_size=int(min_size), **kw,
        )

    first = loop(os.path.join(root, "ranks"))
    first.run_loop(max_steps=2)
    first.close()
    resumed = loop(os.path.join(root, "ranks_resumed"), skip=2, resume_checkpoint=resume_dir, save_preview=False)
    resumed.run_loop(max_steps=3)
    resumed.close()
    return {
        "history": first.history, "is_sharded": is_fsdp_sharded(first.model),
        "resumed_from": resumed.resumed_from, "resumed_history": resumed.history,
        "resumed_params": _whole(resumed.model.named_parameters()),
    }


def cli(p, rank, world, out_root):
    """The three train CLIs for 2 steps and a resume to step 3 each; the
    MM one with FSDP over both ranks (threshold lowered so that it
    shards), the others with DDP."""
    from mm_diffusion_tpu_torch.scripts import image_sr_train, multimodal_train, single_modal_train

    runs = {
        "mm": (multimodal_train, p["mm_argv"] + ["--n_fsdp", str(world), "--fsdp_min_size", "512"]),
        "single": (single_modal_train, p["single_argv"]),
        "sr": (image_sr_train, p["sr_argv"]),
    }
    out = {}
    for name, (mod, argv) in runs.items():
        argv = argv + ["--device", "cpu", "--output_dir", os.path.join(out_root, name), "--log_interval", "1"]
        first = mod.main(argv + ["--max_steps", "2"])
        first.close()
        again = mod.main(argv + ["--max_steps", "3"])
        again.close()
        out[name] = {
            "kind": first.parallel.kind, "is_sharded": is_fsdp_sharded(first.model),
            "step": first.state.step, "losses": [r["loss"] for r in first.history],
            "resumed_from": again.resumed_from, "resumed_step": again.state.step,
            "resumed_losses": [r["loss"] for r in again.history],
        }
    return out


def sample(p, rank, world, out_dir):
    """The sampling CLI once per argv of ``p["sample_argvs"]`` (by name)."""
    from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr

    out = {}
    for name, argv in p["sample_argvs"].items():
        result = multimodal_sample_sr.main(
            argv + ["--n_sample_data", str(world), "--output_dir", os.path.join(out_dir, name)])
        out[name] = {"paths": result["paths"], "samples": result["samples"]}
    return out


SCENARIOS = {"step": step, "checkpoint": checkpoint, "cli": cli, "sample": sample}


def main():
    scenario, work = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    setup_dist("cpu")
    rank, world = process_data_shard()
    payload = torch.load(os.path.join(work, "init.pt"), weights_only=False)
    out = SCENARIOS[scenario](payload, rank, world, *sys.argv[3:])
    torch.save(out, os.path.join(work, f"{scenario}_rank{rank}.pt"))


class Launch:
    """``world`` workers of ``scenario`` started side by side, each with the
    environment ``torchrun`` would give it and a free rendezvous port."""

    def __init__(self, scenario, work, world, *args, env=None):
        self.scenario, self.work, self.world = scenario, str(work), world
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        base = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                    OMP_NUM_THREADS="1", PYTHONPATH=REPO, **(env or {}))
        self.procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), scenario, self.work, *map(str, args)],
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            )
            for r in range(world)
        ]

    def results(self, timeout=150):
        """Each rank's output, once every worker exited 0; a worker still
        running at ``timeout`` is killed (none outlives the call)."""
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0, f"{self.scenario} rank {r} exited {p.returncode}:\n{out[-4000:]}"
        return [torch.load(os.path.join(self.work, f"{self.scenario}_rank{r}.pt"), weights_only=False)
                for r in range(self.world)]


if __name__ == "__main__":
    main()
