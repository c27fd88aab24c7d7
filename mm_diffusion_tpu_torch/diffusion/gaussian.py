"""Gaussian diffusion, the sampling subset (counterpart of
``mm_diffusion_tpu/diffusion/gaussian.py``): the reverse-process mean and
variance (learned-range sigma included), ``p_sample`` and eta-0 DDIM steps.

A state is one tensor or a dict of tensors (``{"video", "audio"}``); each
formula is written once and mapped over the leaves, with one shared
timestep vector ``t`` [B] (sampler-step indices; the model sees them
through ``timestep_map``).  Training losses are not ported yet.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional

import torch

from .schedules import ScheduleTables

State = Any  # a tensor or a dict of tensors
ModelFn = Callable[[State, torch.Tensor], State]


class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


def tree_map(fn, *states):
    """Apply ``fn`` leaf-wise over tensors or dicts of tensors."""
    if isinstance(states[0], dict):
        return {k: fn(*(s[k] for s in states)) for k in states[0]}
    return fn(*states)


def tree_randn_like(x: State, generator: Optional[torch.Generator] = None) -> State:
    return tree_map(
        lambda l: torch.randn(l.shape, dtype=l.dtype, device=l.device, generator=generator), x
    )


def _bcast(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep coefficients shaped to broadcast over a rank-``ndim`` leaf."""
    return table[t].reshape(t.shape + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    tables: ScheduleTables
    mean_type: ModelMeanType = ModelMeanType.EPSILON
    var_type: ModelVarType = ModelVarType.FIXED_LARGE
    rescale_timesteps: bool = False

    @property
    def num_timesteps(self) -> int:
        return self.tables.num_timesteps

    def to(self, device) -> "GaussianDiffusion":
        """The same process with its tables on ``device`` (where the state lives)."""
        return dataclasses.replace(self, tables=self.tables.to(device))

    def model_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        mt = self.tables.timestep_map[t]
        if self.rescale_timesteps:
            return mt.float() * (1000.0 / self.tables.original_num_steps)
        return mt

    def q_posterior_mean_variance(self, x_start: State, x_t: State, t: torch.Tensor):
        tb = self.tables
        mean = tree_map(
            lambda s, xt: _bcast(tb.posterior_mean_coef1, t, xt.dim()) * s
            + _bcast(tb.posterior_mean_coef2, t, xt.dim()) * xt,
            x_start, x_t,
        )
        variance = tree_map(
            lambda xt: _bcast(tb.posterior_variance, t, xt.dim()).expand(xt.shape), x_t
        )
        log_variance = tree_map(
            lambda xt: _bcast(tb.posterior_log_variance_clipped, t, xt.dim()).expand(xt.shape), x_t
        )
        return mean, variance, log_variance

    def predict_xstart_from_eps(self, x_t: State, t: torch.Tensor, eps: State) -> State:
        tb = self.tables
        return tree_map(
            lambda xt, e: _bcast(tb.sqrt_recip_alphas_cumprod, t, xt.dim()) * xt
            - _bcast(tb.sqrt_recipm1_alphas_cumprod, t, xt.dim()) * e,
            x_t, eps,
        )

    def predict_eps_from_xstart(self, x_t: State, t: torch.Tensor, xstart: State) -> State:
        tb = self.tables
        return tree_map(
            lambda xt, x0: (_bcast(tb.sqrt_recip_alphas_cumprod, t, xt.dim()) * xt - x0)
            / _bcast(tb.sqrt_recipm1_alphas_cumprod, t, xt.dim()),
            x_t, xstart,
        )

    def split_model_output(self, model_output: State):
        """(mean part, variance values or None): learned variance rides the
        second half of the channel (last) axis."""
        if self.var_type != ModelVarType.LEARNED_RANGE:
            return model_output, None
        halves = tree_map(lambda mo: mo.chunk(2, dim=-1), model_output)
        return tree_map(lambda h: h[0], halves), tree_map(lambda h: h[1], halves)

    def model_variance(self, var_values: Optional[State], x: State, t: torch.Tensor):
        """Per-leaf (variance, log_variance): learned-range interpolation
        between the clipped posterior and beta log-variances, or a fixed table."""
        tb = self.tables
        if self.var_type == ModelVarType.LEARNED_RANGE:

            def interp(v, xt):
                min_log = _bcast(tb.posterior_log_variance_clipped, t, xt.dim())
                max_log = _bcast(tb.log_betas, t, xt.dim())
                frac = (v + 1.0) / 2.0
                return frac * max_log + (1.0 - frac) * min_log

            log_variance = tree_map(interp, var_values, x)
            return tree_map(torch.exp, log_variance), log_variance
        fixed = {
            ModelVarType.FIXED_LARGE: (tb.fixed_large_variance, tb.fixed_large_log_variance),
            ModelVarType.FIXED_SMALL: (tb.posterior_variance, tb.posterior_log_variance_clipped),
        }
        if self.var_type not in fixed:
            raise NotImplementedError(f"{self.var_type} is not ported")
        var, log_var = fixed[self.var_type]
        variance = tree_map(lambda xt: _bcast(var, t, xt.dim()).expand(xt.shape), x)
        log_variance = tree_map(lambda xt: _bcast(log_var, t, xt.dim()).expand(xt.shape), x)
        return variance, log_variance

    def p_mean_variance(self, model_fn: ModelFn, x: State, t: torch.Tensor, clip_denoised: bool = True):
        """Reverse-process mean / variance and the x0 prediction."""
        model_output = model_fn(x, self.model_timesteps(t))
        mean_part, var_values = self.split_model_output(model_output)
        variance, log_variance = self.model_variance(var_values, x, t)

        def process_xstart(x0):
            return tree_map(lambda l: l.clamp(-1.0, 1.0), x0) if clip_denoised else x0

        if self.mean_type == ModelMeanType.START_X:
            pred_xstart = process_xstart(mean_part)
        elif self.mean_type == ModelMeanType.EPSILON:
            pred_xstart = process_xstart(self.predict_xstart_from_eps(x, t, mean_part))
        else:
            raise NotImplementedError(f"{self.mean_type} is not ported")
        mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {
            "mean": mean,
            "variance": variance,
            "log_variance": log_variance,
            "pred_xstart": pred_xstart,
            "model_output": mean_part,
        }

    def p_sample(
        self,
        model_fn: ModelFn,
        x: State,
        t: torch.Tensor,
        clip_denoised: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        """One ancestral step, its noise drawn from ``generator``."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised)
        noise = tree_randn_like(x, generator)
        nonzero = (t != 0).float()
        sample = tree_map(
            lambda m, lv, n: m
            + nonzero.reshape(t.shape + (1,) * (m.dim() - 1)) * torch.exp(0.5 * lv) * n,
            out["mean"], out["log_variance"], noise,
        )
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_sample(self, model_fn: ModelFn, x: State, t: torch.Tensor, clip_denoised: bool = True):
        """One deterministic DDIM step (eta 0)."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised)
        eps = self.predict_eps_from_xstart(x, t, out["pred_xstart"])
        abar_prev = self.tables.alphas_cumprod_prev

        def step(x0, e, xt):
            a = _bcast(abar_prev, t, xt.dim())
            return x0 * torch.sqrt(a) + torch.sqrt(1.0 - a) * e

        sample = tree_map(step, out["pred_xstart"], eps, x)
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}
