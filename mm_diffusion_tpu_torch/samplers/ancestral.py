"""Ancestral (DDPM) and DDIM sampling loops, the DDIM encoding loop, the
diversified ancestral loop and the zero-shot conditional loops (counterpart
of ``mm_diffusion_tpu/samplers/ancestral.py``) as Python loops over the
timesteps.  ``model_fn(x, t_model) -> model output``; the model draws its
own RS-MMA shift at each call, and every noise draw comes from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

import torch

from ..diffusion import gaussian
from ..diffusion.gaussian import GaussianDiffusion, mean_flat, tree_leaves, tree_map
from ..utils.timing import sync

State = Any


def _leaf(x: State) -> torch.Tensor:
    return tree_leaves(x)[0]


def _steps(diffusion: GaussianDiffusion, x: State, order):
    """(diffusion with its tables on the state's device, [(i, t [B])] in
    ``order``)."""
    leaf = _leaf(x)
    diffusion = diffusion.to(leaf.device)
    return diffusion, [
        (i, torch.full((leaf.shape[0],), i, dtype=torch.long, device=leaf.device)) for i in order
    ]


def _loop(step, diffusion: GaussianDiffusion, x_T: State, return_trajectory: bool = False):
    diffusion, steps = _steps(diffusion, x_T, reversed(range(diffusion.num_timesteps)))
    x, trajectory = x_T, []
    for _, t in steps:
        x = step(diffusion, x, t)["sample"]
        if return_trajectory:
            trajectory.append(x)
    if return_trajectory:
        return x, tree_map(lambda *xs: torch.stack(xs), *trajectory)
    return x


def p_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: Callable,
    x_T: State,
    generator: Optional[torch.Generator] = None,
    clip_denoised: bool = True,
    denoised_fn=None,
    cond_fn=None,
    return_trajectory: bool = False,
    noise_fn: Optional[Callable[[State], State]] = None,
) -> State:
    """Ancestral sampling from ``x_T`` down to ``t = 0``.  With
    ``return_trajectory`` also each step's sample, stacked on a leading axis
    in the order t = T-1 .. 0: ``(x_0, trajectory)``.  ``noise_fn(x)``,
    when given, draws each step's noise (else ``generator`` does)."""
    return _loop(
        lambda d, x, t: d.p_sample(
            model_fn, x, t, clip_denoised, generator=generator, denoised_fn=denoised_fn,
            cond_fn=cond_fn, noise=None if noise_fn is None else noise_fn(x),
        ),
        diffusion, x_T, return_trajectory,
    )


def ddim_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: Callable,
    x_T: State,
    clip_denoised: bool = True,
    generator: Optional[torch.Generator] = None,
    denoised_fn=None,
    cond_fn=None,
    eta: float = 0.0,
    return_trajectory: bool = False,
) -> State:
    """DDIM sampling from ``x_T`` (deterministic at ``eta`` 0);
    ``return_trajectory`` as in :func:`p_sample_loop`."""
    return _loop(
        lambda d, x, t: d.ddim_sample(
            model_fn, x, t, clip_denoised, generator=generator, denoised_fn=denoised_fn,
            cond_fn=cond_fn, eta=eta,
        ),
        diffusion, x_T, return_trajectory,
    )


def ddim_reverse_loop(
    diffusion: GaussianDiffusion, model_fn: Callable, x_0: State, clip_denoised: bool = True
) -> State:
    """Deterministic DDIM encoding from ``x_0`` up to ``x_T``."""
    diffusion, steps = _steps(diffusion, x_0, range(diffusion.num_timesteps))
    x = x_0
    for _, t in steps:
        x = diffusion.ddim_reverse_sample(model_fn, x, t, clip_denoised)["sample"]
    return x


def p_sample_loop_diverse(
    diffusion: GaussianDiffusion,
    model_fn: Callable,
    x_T: State,
    generator: Optional[torch.Generator] = None,
    random_num: int = 10,
    random_step=(899, 999),
    clip_denoised: bool = True,
) -> State:
    """``random_num`` trajectories from one shared ``x_T``: the ancestral
    noise is shared by the copies at every step except those with
    ``random_step[0] < i <= random_step[1]``, where each copy draws its own,
    so the samples differ only through that window.  The copies run as one
    batch of ``random_num * B`` per step (one model call, one RS-MMA shift).

    Returns a state whose leaves have a leading ``random_num`` axis."""
    rs0, rs1 = random_step
    b = _leaf(x_T).shape[0]
    flat = lambda l: l.reshape((random_num * b,) + l.shape[2:])  # noqa: E731
    x = tree_map(lambda l: flat(l.unsqueeze(0).expand((random_num,) + l.shape)), x_T)
    diffusion, steps = _steps(diffusion, x, reversed(range(diffusion.num_timesteps)))
    for i, t in steps:
        if rs0 < i <= rs1:
            noise = gaussian.tree_randn_like(x, generator)
        else:
            shared = gaussian.tree_randn_like(x_T, generator)
            noise = tree_map(lambda n: flat(n.unsqueeze(0).expand((random_num,) + n.shape)), shared)
        x = diffusion.p_sample(model_fn, x, t, clip_denoised, noise=noise)["sample"]
    return tree_map(lambda l: l.reshape((random_num, b) + l.shape[1:]), x)


def conditional_gradient_step(
    diffusion: GaussianDiffusion,
    model_fn: Callable,
    x: State,
    t: torch.Tensor,
    condition: torch.Tensor,
    condition_key: str,
    fixed_noise: torch.Tensor,
    clip_denoised: bool = True,
    generator: Optional[torch.Generator] = None,
    noise: Optional[State] = None,
):
    """One ``p_sample`` step of the gradient method, differentiated with
    respect to the free modality: ``(loss, gradient, sample)``.

    ``x`` holds the re-noised condition; the loss is the batch mean of the
    per-sample MSE between the step's condition leaf and the condition
    re-noised to ``t - 1`` with ``fixed_noise``, so each sample's gradient
    carries a 1/B factor.  Autograd records this step alone (the caller may
    run under ``torch.no_grad()``); every tensor it saves is built here,
    outside inference mode."""
    (target_key,) = [k for k in x if k != condition_key]
    prev_cond = diffusion.q_sample(condition, (t - 1).clamp(min=0), fixed_noise)
    with torch.enable_grad():
        target = x[target_key].detach().requires_grad_(True)
        out = diffusion.p_sample(
            model_fn, {**x, target_key: target}, t, clip_denoised, generator=generator, noise=noise
        )
        loss = mean_flat((out["sample"][condition_key] - prev_cond) ** 2).mean()
        (grad,) = torch.autograd.grad(loss, target)
    return loss.detach(), grad, tree_map(torch.Tensor.detach, out["sample"])


def conditional_p_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: Callable,
    x_T: State,
    condition: torch.Tensor,
    condition_key: str,
    class_scale: float = 0.0,
    clip_denoised: bool = True,
    generator: Optional[torch.Generator] = None,
    step_seconds: Optional[List[float]] = None,
) -> State:
    """Zero-shot audio->video (``condition_key="audio"``) or video->audio.

    ``condition`` is the ground-truth leaf.  Before every step it is
    re-noised to ``t`` with the initial ``x_T`` draw of its own leaf and
    overwrites that leaf (the replacement method, ``class_scale == 0``).
    With ``class_scale > 0`` (the gradient method) the free modality also
    descends the gradient of :func:`conditional_gradient_step`'s loss,
    scaled by ``class_scale * sqrt(alpha_bar_t)``; at t = 0 the update is
    masked, so that step is a plain ``p_sample``.

    ``step_seconds``, when given, receives each step's wall seconds
    (measured to a device synchronisation)."""
    (target_key,) = [k for k in sorted(x_T) if k != condition_key]
    fixed_noise = x_T[condition_key]
    diffusion, steps = _steps(diffusion, x_T, reversed(range(diffusion.num_timesteps)))
    x = x_T
    for i, t in steps:
        t0 = time.perf_counter()
        x = {**x, condition_key: diffusion.q_sample(condition, t, fixed_noise)}
        if class_scale == 0.0 or i == 0:
            x = diffusion.p_sample(model_fn, x, t, clip_denoised, generator=generator)["sample"]
        else:
            _, grad, prev = conditional_gradient_step(
                diffusion, model_fn, x, t, condition, condition_key, fixed_noise,
                clip_denoised, generator,
            )
            scale = class_scale * diffusion.tables.sqrt_alphas_cumprod[i]
            x = {**prev, target_key: prev[target_key] - scale * grad}
        if step_seconds is not None:
            sync(t.device)
            step_seconds.append(time.perf_counter() - t0)
    return x
