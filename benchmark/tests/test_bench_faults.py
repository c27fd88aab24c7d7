"""A run of each cell at tiny sizes on the CPU (the look for a card
skipped), once sound and once with the timed path broken underneath:
``correct`` has to come out true, then false for every fault the cell can
have -- an answer altered where it is produced (sampling), a train step
that leaves the state unchanged, and half of each batch left out with the
mean taken over the rest (training).  One chip: no exchange between chips
to leave out."""

from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_tiny(workload: str) -> dict:
    config, traffic = tiny.cell(workload)
    return run.run_cell(tiny.spec(), workload, 2**31 + 77, 0.2, False, torch.device("cpu"), 0.0,
                        config=config, traffic=traffic)


def _alter_sr(monkeypatch):
    from mm_diffusion_tpu_torch import sampling

    real = sampling.ddim_sample_loop

    def altered(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[0] += 0.5
        return out

    monkeypatch.setattr(sampling, "ddim_sample_loop", altered)


def _alter_base(monkeypatch):
    from mm_diffusion_tpu_torch.samplers.dpm import DPMSolver

    real = DPMSolver.sample

    def altered(self, *args, **kwargs):
        out = dict(real(self, *args, **kwargs))
        out["video"] = out["video"].clone()
        out["video"][:, 0] *= 1.25  # the solver's output is unbounded: alter it in proportion
        return out

    monkeypatch.setattr(DPMSolver, "sample", altered)


def _state_unchanged(monkeypatch):
    from mm_diffusion_tpu_torch.train.state import AdamW

    monkeypatch.setattr(AdamW, "step", lambda self, step, grad_norm=None: None)
    monkeypatch.setattr(torch, "_foreach_add_", lambda *a, **k: None)  # the EMA keeps its copy
    monkeypatch.setattr(torch, "_foreach_mul_", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from mm_diffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion, tree_map

    real = GaussianDiffusion.training_losses

    def half(self, model_fn, x_start, t, noise=None, generator=None):
        keep = t.shape[0] // 2
        terms = real(self, model_fn, tree_map(lambda x: x[:keep], x_start), t[:keep],
                     noise=tree_map(lambda x: x[:keep], noise))
        terms["loss"] = terms["loss"].repeat(2)  # the mean over the kept rows
        return terms

    monkeypatch.setattr(GaussianDiffusion, "training_losses", half)


@pytest.mark.parametrize("workload", ["sr-ddim25-clip", "base-dpm20-b8", "mm-train-b4"])
def test_a_sound_run_is_correct(workload):
    result = run_tiny(workload)
    assert result["correct"], result["compared"]


@pytest.mark.parametrize("workload,fault", [
    ("sr-ddim25-clip", _alter_sr),
    ("base-dpm20-b8", _alter_base),
    ("mm-train-b4", _state_unchanged),
    ("mm-train-b4", _half_batch),
])
def test_a_broken_run_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = run_tiny(workload)
    assert not result["correct"], result["compared"]
