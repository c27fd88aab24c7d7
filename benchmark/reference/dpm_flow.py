"""A flow-matching sampler of Wan 2.1's kind, plain: DPM-Solver++ (2M) on the
flow-matching schedule, the update of Wan's
``FlowDPMSolverMultistepScheduler`` (``wan/utils/fm_solvers.py``) with
``dpmsolver++``, ``solver_order=2``, ``lower_order_final`` and a final sigma
of zero, written from its equations (Lu et al., arXiv:2211.01095, the
multistep second-order update in its midpoint form), on the step grid the
benchmark's text-to-video cell specifies (below).  Wan's ``generate.py``
samples with UniPC by default, and its dpm++ branch may hand the scheduler
a grid that starts at sigma 1 (``shift(linspace(1, 0, N + 1)[:N])``); the
work a step is the same.

The schedule: ``x_sigma = (1 - sigma) x_0 + sigma eps``, so ``alpha = 1 -
sigma`` and ``lambda = log((1 - sigma) / sigma)``; the model predicts the
velocity ``v = eps - x_0``, so ``x_0 = x - sigma v``.  The steps: ``sigma_i
= linspace(0.999, 0.001, N + 1)[:-1]``, each shifted to ``s sigma / (1 +
(s - 1) sigma)``, then 0.  The first update is first-order, the others
second-order, and the last, to sigma = 0, first-order, which returns the
last data prediction.  Coefficients are float64 host numbers; the state
is float32, or what ``act`` makes of it.  Guidance evaluates the doubled
batch ``[uncond; cond]`` once a step: ``v = v_u + scale (v_c - v_u)``, at
the model time ``1000 sigma``.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

SIGMA_MAX, SIGMA_MIN = 0.999, 0.001  # Wan's for 1000 training steps
TRAIN_STEPS = 1000


def shifted_sigmas(steps: int, shift: float, sigma_max: float = SIGMA_MAX,
                   sigma_min: float = SIGMA_MIN) -> List[float]:
    """The ``steps + 1`` noise levels, the last 0."""
    sigma = np.linspace(sigma_max, sigma_min, steps + 1)[:-1]
    return [float(s) for s in shift * sigma / (1 + (shift - 1) * sigma)] + [0.0]


def _lam(sigma: float) -> float:
    return math.inf if sigma == 0 else math.log((1 - sigma) / sigma)


def sample(x: torch.Tensor, sigmas: List[float], velocity: Callable, act: Callable = lambda v: v) -> torch.Tensor:
    """Solve from ``x`` at ``sigmas[0]`` to 0; ``velocity(x, i, sigma)`` is
    the guided velocity of evaluation ``i``."""
    x = act(x.float())
    x0_prev = None
    for i in range(len(sigmas) - 1):
        s, t = sigmas[i], sigmas[i + 1]
        x0 = x - s * velocity(x, i, s).float()
        h = _lam(t) - _lam(s)
        phi = (1 - t) * math.expm1(-h)  # -1 at t = 0
        if i == 0 or t == 0:
            x = (t / s) * x - phi * x0
        else:
            r = (_lam(s) - _lam(sigmas[i - 1])) / h
            x = (t / s) * x - phi * x0 - 0.5 * phi * (x0 - x0_prev) / r
        x = act(x)
        x0_prev = x0
    return x


def guided(raw: torch.Tensor, scale: float) -> torch.Tensor:
    """``[uncond; cond]`` velocities -> the guided one."""
    u, c = raw.float().chunk(2)
    return u + scale * (c - u)


def guided_sample(model: Callable, x: torch.Tensor, context: torch.Tensor, uncond: torch.Tensor, steps: int,
                  shift: float, scale: float) -> torch.Tensor:
    """``steps`` evaluations of ``model(x, t, context)`` on the doubled
    batch from ``x`` at the first noise level."""
    both = torch.cat([uncond, context])

    def velocity(xx, i, sigma):
        t = torch.full((2 * xx.shape[0],), TRAIN_STEPS * sigma, dtype=torch.float64, device=xx.device)
        return guided(model(torch.cat([xx, xx]), t, both), scale)

    return sample(x, shifted_sigmas(steps, shift), velocity)
