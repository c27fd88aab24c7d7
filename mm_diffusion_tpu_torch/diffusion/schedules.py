"""Noise schedules, coefficient tables and timestep respacing (counterpart
of ``mm_diffusion_tpu/diffusion/schedules.py``).

Tables are computed once on the host in float64 numpy and stored as
float32 tensors; respacing is a precomputed ``timestep_map`` gather.

Also the step grid of the flow-matching (rectified-flow) sampler of Wan 2.1,
which the JAX package does not have: :func:`flow_sigmas`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Set, Union

import numpy as np
import torch

__all__ = [
    "get_named_beta_schedule",
    "betas_for_alpha_bar",
    "space_timesteps",
    "respace_betas",
    "ScheduleTables",
    "make_schedule",
    "tables_from_betas",
    "flow_sigmas",
]


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    if schedule_name == "linear":
        # Ho et al.'s linear schedule, rescaled so it is invariant to T.
        scale = 1000.0 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64)
    if schedule_name == "scaled_linear":
        # Stable Diffusion's: linear in sqrt(beta) from 0.00085 to 0.012
        # (SGM's LegacyDDPMDiscretization, diffusers' "scaled_linear").
        return np.linspace(0.00085**0.5, 0.012**0.5, num_diffusion_timesteps, dtype=np.float64) ** 2
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar, max_beta=0.999) -> np.ndarray:
    ts = np.arange(num_diffusion_timesteps, dtype=np.float64)
    a1 = np.array([alpha_bar(float(t)) for t in ts / num_diffusion_timesteps])
    a2 = np.array([alpha_bar(float(t)) for t in (ts + 1.0) / num_diffusion_timesteps])
    return np.minimum(1.0 - a2 / a1, max_beta)


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> Set[int]:
    """The original timesteps kept when respacing: ``"ddimN"`` (a fixed
    integer stride) or comma-separated per-section counts."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired_count:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot create exactly {desired_count} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]

    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


def respace_betas(betas: np.ndarray, use_timesteps: Set[int]):
    """Betas over the kept timesteps; returns ``(new_betas, timestep_map)``
    with ``timestep_map[i]`` the original index of respaced step ``i``."""
    alphas_cumprod = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64))
    last = 1.0
    new_betas, timestep_map = [], []
    for i, ac in enumerate(alphas_cumprod):
        if i in use_timesteps:
            new_betas.append(1.0 - ac / last)
            last = ac
            timestep_map.append(i)
    return np.array(new_betas, dtype=np.float64), np.array(timestep_map, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class ScheduleTables:
    """Per-timestep coefficient tables, float32 ``[num_timesteps]``."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    log_betas: torch.Tensor
    fixed_large_variance: torch.Tensor  # append(posterior_variance[1], betas[1:])
    fixed_large_log_variance: torch.Tensor
    timestep_map: torch.Tensor  # int64: model timestep of each sampler step
    num_timesteps: int
    original_num_steps: int

    def to(self, device) -> "ScheduleTables":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )


def make_schedule(
    noise_schedule: str = "linear",
    diffusion_steps: int = 1000,
    timestep_respacing: Union[str, Sequence[int], None] = None,
) -> ScheduleTables:
    base_betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if timestep_respacing:
        betas, timestep_map = respace_betas(
            base_betas, space_timesteps(diffusion_steps, timestep_respacing)
        )
    else:
        betas, timestep_map = base_betas, np.arange(diffusion_steps, dtype=np.int64)
    return tables_from_betas(betas, timestep_map=timestep_map, original_num_steps=diffusion_steps)


def tables_from_betas(betas, timestep_map=None, original_num_steps=None) -> ScheduleTables:
    """All coefficient tables from a 1-D beta array (float64 host math)."""
    betas = np.asarray(betas, dtype=np.float64)
    if not (betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must be a 1-D array in (0, 1]")
    n = betas.shape[0]
    if timestep_map is None:
        timestep_map = np.arange(n, dtype=np.int64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    fixed_large_variance = np.append(posterior_variance[1], betas[1:])

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32))

    return ScheduleTables(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        alphas_cumprod_next=f32(alphas_cumprod_next),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.append(posterior_variance[1], posterior_variance[1:]))
        ),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        log_betas=f32(np.log(betas)),
        fixed_large_variance=f32(fixed_large_variance),
        fixed_large_log_variance=f32(np.log(fixed_large_variance)),
        timestep_map=torch.from_numpy(np.asarray(timestep_map, dtype=np.int64)),
        num_timesteps=int(n),
        original_num_steps=int(original_num_steps if original_num_steps is not None else n),
    )


# -- flow matching (Wan 2.1) ---------------------------------------------------


FLOW_TRAIN_STEPS = 1000
FLOW_SIGMA_MAX, FLOW_SIGMA_MIN = 0.999, 0.001  # Wan's noise levels for 1000 training steps


def flow_sigmas(steps: int, shift: float) -> np.ndarray:
    """The ``steps + 1`` noise levels of a flow-matching sampler, float64:
    ``linspace(FLOW_SIGMA_MAX, FLOW_SIGMA_MIN, steps + 1)[:-1]``, each
    shifted by Wan's ``s sigma / (1 + (s - 1) sigma)`` (more of the steps
    at high noise for ``s > 1``), then 0 (the step that returns the data
    prediction)."""
    sigmas = np.linspace(FLOW_SIGMA_MAX, FLOW_SIGMA_MIN, steps + 1, dtype=np.float64)[:-1]
    return np.append(shift * sigmas / (1.0 + (shift - 1.0) * sigmas), 0.0)
