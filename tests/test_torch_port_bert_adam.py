"""The port's BertAdam (mm_diffusion_tpu_torch/train/optimization.py, a
torch.optim.Optimizer) against the JAX package's optax ``bert_adam``, for
each warmup schedule, over several steps whose gradients cross the
per-tensor clip, with and without weight decay; the schedules against
JAX's at sample points; the constant rate of ``t_total = -1``; the
argument checks.  Tolerance: 1e-5 relative, 1e-6 absolute (fp32, a few
ulps per step)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_common import one_torch_thread, randn, t  # noqa: F401

from mm_diffusion_tpu.train import optimization as jopt
from mm_diffusion_tpu_torch.train import SCHEDULES, BertAdam
from mm_diffusion_tpu_torch.train import optimization as popt

SHAPES = [(4, 3), (3,), (2, 2, 5)]


def _run_both(steps=5, grad_scale=(0.5, 3.0, 1.0, 8.0, 0.2), **kw):
    params = [randn(i, *s) for i, s in enumerate(SHAPES)]
    tx = jopt.bert_adam(**kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    pp = [torch.nn.Parameter(t(p)) for p in params]
    opt = BertAdam(pp, **kw)
    for step in range(steps):
        grads = [randn(10 + 3 * step + i, *s, scale=grad_scale[step % len(grad_scale)])
                 for i, s in enumerate(SHAPES)]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(pp, grads):
            p.grad = t(g)
        opt.step()
        for a, b in zip(pp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    return pp, params


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("weight_decay,max_grad_norm", [(0.01, 1.0), (0.0, 0.0), (0.1, 2.5)])
def test_bert_adam_matches_jax(schedule, weight_decay, max_grad_norm):
    pp, params = _run_both(lr=1e-2, warmup=0.3, t_total=6, schedule=schedule,
                           weight_decay=weight_decay, max_grad_norm=max_grad_norm)
    assert all(not np.array_equal(p.detach().numpy(), q) for p, q in zip(pp, params))


def test_constant_rate_without_t_total_matches_jax():
    _run_both(lr=3e-3, t_total=-1, steps=4)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    for x in (0.0, 0.05, 0.1, 0.2, 0.5, 0.99, 1.0, 1.3):
        for warmup in (0.002, 0.1, 0.4, -1):
            np.testing.assert_allclose(SCHEDULES[name](x, warmup),
                                       float(jopt.SCHEDULES[name](jnp.float32(x), warmup)),
                                       rtol=1e-6, atol=1e-7)
    assert popt.SCHEDULES is SCHEDULES


def test_argument_checks_match_jax():
    p = [torch.nn.Parameter(torch.zeros(2))]
    for kw in (dict(schedule="warmup_exp"), dict(warmup=1.5), dict(b1=1.0), dict(b2=-0.1), dict(eps=-1.0)):
        with pytest.raises(ValueError):
            jopt.bert_adam(lr=1e-3, **kw)
        with pytest.raises(ValueError):
            BertAdam(p, lr=1e-3, **kw)


def test_bert_adam_trains_and_saves_its_state():
    """Step 0 under warmup has lr 0 (as in the reference); the loss falls
    once the ramp is underway, and the state_dict round-trips."""
    w = torch.nn.Parameter(torch.ones(3))
    opt = BertAdam([w], lr=1e-2, warmup=0.1, t_total=100)
    losses = []
    for _ in range(4):
        opt.zero_grad()
        loss = (w - 2.0).square().sum()
        loss.backward()
        losses.append(float(loss.detach()))
        opt.step()
    assert losses[1] == losses[0] and losses[-1] < losses[0]
    again = BertAdam([torch.nn.Parameter(w.detach().clone())], lr=1e-2, warmup=0.1, t_total=100)
    again.load_state_dict(opt.state_dict())
    assert again.state_dict()["state"][0]["step"] == 4
