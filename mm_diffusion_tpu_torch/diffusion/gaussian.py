"""Gaussian diffusion (counterpart of ``mm_diffusion_tpu/diffusion/gaussian.py``):
the forward process ``q(x_t | x_0)``, the reverse-process mean and variance
(learned-range sigma included), ``p_sample`` and eta-0 DDIM steps, and the
training losses (MSE / rescaled MSE with the learned-sigma VLB term, KL /
rescaled KL).

A state is one tensor or a dict of tensors (``{"video", "audio"}``); each
formula is written once and mapped over the leaves, with one shared
timestep vector ``t`` [B] (sampler-step indices; the model sees them
through ``timestep_map``).
"""

from __future__ import annotations

import dataclasses
import enum
import math
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


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()

    def is_vb(self):
        return self in (LossType.KL, LossType.RESCALED_KL)


def tree_map(fn, *states):
    """Apply ``fn`` leaf-wise over tensors or dicts of tensors."""
    if isinstance(states[0], dict):
        return {k: fn(*(s[k] for s in states)) for k in states[0]}
    return fn(*states)


def tree_randn_like(x: State, generator: Optional[torch.Generator] = None) -> State:
    return tree_map(
        lambda l: torch.randn(l.shape, dtype=l.dtype, device=l.device, generator=generator), x
    )


def tree_leaves(x: State):
    """The leaves in the JAX package's order (dict keys sorted)."""
    return [x[k] for k in sorted(x)] if isinstance(x, dict) else [x]


def _bcast(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep coefficients shaped to broadcast over a rank-``ndim`` leaf."""
    return table[t].reshape(t.shape + (1,) * (ndim - 1))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes."""
    return x.mean(dim=tuple(range(1, x.dim())))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL divergence between two diagonal Gaussians."""
    return 0.5 * (
        -1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretized to [-1, 1] 8-bit bins."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(
        x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta)
    )


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    tables: ScheduleTables
    mean_type: ModelMeanType = ModelMeanType.EPSILON
    var_type: ModelVarType = ModelVarType.FIXED_LARGE
    loss_type: LossType = LossType.MSE
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

    def q_mean_variance(self, x_start: State, t: torch.Tensor):
        """Mean, variance and log-variance of ``q(x_t | x_0)``."""
        tb = self.tables
        mean = tree_map(lambda l: _bcast(tb.sqrt_alphas_cumprod, t, l.dim()) * l, x_start)
        variance = tree_map(
            lambda l: (1.0 - _bcast(tb.alphas_cumprod, t, l.dim())).expand(l.shape), x_start
        )
        log_variance = tree_map(
            lambda l: _bcast(tb.log_one_minus_alphas_cumprod, t, l.dim()).expand(l.shape), x_start
        )
        return mean, variance, log_variance

    def q_sample(self, x_start: State, t: torch.Tensor, noise: State) -> State:
        """A draw of ``q(x_t | x_0)`` with the given noise."""
        tb = self.tables
        return tree_map(
            lambda l, n: _bcast(tb.sqrt_alphas_cumprod, t, l.dim()) * l
            + _bcast(tb.sqrt_one_minus_alphas_cumprod, t, l.dim()) * n,
            x_start, noise,
        )

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

    # -- the variational bound and the training losses ---------------------------

    def vb_terms_bpd(
        self, model_fn: ModelFn, x_start: State, x_t: State, t: torch.Tensor,
        clip_denoised: bool = True,
    ):
        """Per-leaf variational-bound term in bits/dim: KL(q || p) for t > 0,
        the discretized decoder NLL at t = 0."""
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_fn, x_t, t, clip_denoised=clip_denoised)

        def term(xs, tm, tlv, m, lv):
            kl = mean_flat(normal_kl(tm, tlv, m, lv)) / math.log(2.0)
            nll = -discretized_gaussian_log_likelihood(xs, means=m, log_scales=0.5 * lv)
            return torch.where(t == 0, mean_flat(nll) / math.log(2.0), kl)

        output = tree_map(term, x_start, true_mean, true_log_var, out["mean"], out["log_variance"])
        return {"output": output, "pred_xstart": out["pred_xstart"]}

    def training_losses(
        self,
        model_fn: ModelFn,
        x_start: State,
        t: torch.Tensor,
        noise: Optional[State] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Training losses of one shared timestep batch.  ``noise`` defaults
        to a draw from ``generator``.

        Returns ``{"loss": [B] total, "mse": state of [B], "vb": state of [B]
        (learned variance or a KL loss)}``.  With learned variance the VLB
        term sees the mean prediction detached, so that it trains only the
        variance and does not bias the MSE term."""
        if noise is None:
            noise = tree_randn_like(x_start, generator)
        x_t = self.q_sample(x_start, t, noise)
        terms = {}
        if self.loss_type in (LossType.MSE, LossType.RESCALED_MSE):
            mean_part, var_values = self.split_model_output(model_fn(x_t, self.model_timesteps(t)))
            if var_values is not None:
                frozen = tree_map(
                    lambda mp, vv: torch.cat([mp.detach(), vv], dim=-1), mean_part, var_values
                )
                vb = self.vb_terms_bpd(lambda *_: frozen, x_start, x_t, t, clip_denoised=False)
                vb = vb["output"]
                if self.loss_type == LossType.RESCALED_MSE:
                    vb = tree_map(lambda v: v * (self.num_timesteps / 1000.0), vb)
                terms["vb"] = vb
            if self.mean_type == ModelMeanType.START_X:
                target = x_start
            elif self.mean_type == ModelMeanType.EPSILON:
                target = noise
            else:
                raise NotImplementedError(f"{self.mean_type} is not ported")
            terms["mse"] = tree_map(
                lambda tgt, mo: mean_flat((tgt - mo.to(tgt.dtype)) ** 2), target, mean_part
            )
        elif self.loss_type.is_vb():
            vb = self.vb_terms_bpd(model_fn, x_start, x_t, t, clip_denoised=False)["output"]
            if self.loss_type == LossType.RESCALED_KL:
                vb = tree_map(lambda v: v * self.num_timesteps, vb)
            terms["vb"] = vb
        else:
            raise NotImplementedError(self.loss_type)
        leaves = [leaf for key in ("mse", "vb") if key in terms for leaf in tree_leaves(terms[key])]
        terms["loss"] = sum(leaves[1:], leaves[0])
        return terms
