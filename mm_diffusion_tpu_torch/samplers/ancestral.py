"""Ancestral (DDPM) and DDIM sampling loops (counterpart of
``mm_diffusion_tpu/samplers/ancestral.py``) as Python loops over the
timesteps.  ``model_fn(x, t_model) -> model output``; ancestral noise comes
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..diffusion.gaussian import GaussianDiffusion

State = Any


def _leaf(x: State) -> torch.Tensor:
    return next(iter(x.values())) if isinstance(x, dict) else x


def _loop(step, diffusion: GaussianDiffusion, x_T: State) -> State:
    leaf = _leaf(x_T)
    diffusion = diffusion.to(leaf.device)
    x = x_T
    for i in reversed(range(diffusion.num_timesteps)):
        t = torch.full((leaf.shape[0],), i, dtype=torch.long, device=leaf.device)
        x = step(diffusion, x, t)["sample"]
    return x


def p_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: Callable,
    x_T: State,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
) -> State:
    """Ancestral sampling from ``x_T`` down to ``t = 0``."""
    return _loop(
        lambda d, x, t: d.p_sample(model_fn, x, t, clip_denoised, generator=generator),
        diffusion, x_T,
    )


def ddim_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: Callable,
    x_T: State,
    clip_denoised: bool = True,
) -> State:
    """Deterministic DDIM sampling (eta 0) from ``x_T``."""
    return _loop(lambda d, x, t: d.ddim_sample(model_fn, x, t, clip_denoised), diffusion, x_T)
