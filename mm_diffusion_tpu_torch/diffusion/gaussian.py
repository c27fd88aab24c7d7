"""Gaussian diffusion (counterpart of ``mm_diffusion_tpu/diffusion/gaussian.py``):
the forward process ``q(x_t | x_0)``, the reverse-process mean and variance
(every mean and variance type), ``p_sample`` with ``denoised_fn`` and
``cond_fn`` guidance, DDIM steps (``eta``, guidance) and the DDIM encoding
step, the training losses (MSE / rescaled MSE with the learned-sigma VLB
term, KL / rescaled KL) and the full-chain bound in bits/dim.

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


def _nonzero(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """1 where ``t != 0``, shaped to broadcast over a rank-``ndim`` leaf."""
    return (t != 0).float().reshape(t.shape + (1,) * (ndim - 1))


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

    def predict_xstart_from_xprev(self, x_t: State, t: torch.Tensor, xprev: State) -> State:
        tb = self.tables
        return tree_map(
            lambda xt, xp: _bcast(1.0 / tb.posterior_mean_coef1, t, xt.dim()) * xp
            - _bcast(tb.posterior_mean_coef2 / tb.posterior_mean_coef1, t, xt.dim()) * xt,
            x_t, xprev,
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
        if self.var_type not in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
            return model_output, None
        halves = tree_map(lambda mo: mo.chunk(2, dim=-1), model_output)
        return tree_map(lambda h: h[0], halves), tree_map(lambda h: h[1], halves)

    def model_variance(self, var_values: Optional[State], x: State, t: torch.Tensor):
        """Per-leaf (variance, log_variance): the learned log-variance, the
        learned-range interpolation between the clipped posterior and beta
        log-variances, or a fixed table."""
        tb = self.tables
        if self.var_type == ModelVarType.LEARNED:
            return tree_map(torch.exp, var_values), var_values
        if self.var_type == ModelVarType.LEARNED_RANGE:

            def interp(v, xt):
                min_log = _bcast(tb.posterior_log_variance_clipped, t, xt.dim())
                max_log = _bcast(tb.log_betas, t, xt.dim())
                frac = (v + 1.0) / 2.0
                return frac * max_log + (1.0 - frac) * min_log

            log_variance = tree_map(interp, var_values, x)
            return tree_map(torch.exp, log_variance), log_variance
        var, log_var = {
            ModelVarType.FIXED_LARGE: (tb.fixed_large_variance, tb.fixed_large_log_variance),
            ModelVarType.FIXED_SMALL: (tb.posterior_variance, tb.posterior_log_variance_clipped),
        }[self.var_type]
        variance = tree_map(lambda xt: _bcast(var, t, xt.dim()).expand(xt.shape), x)
        log_variance = tree_map(lambda xt: _bcast(log_var, t, xt.dim()).expand(xt.shape), x)
        return variance, log_variance

    def p_mean_variance(
        self, model_fn: ModelFn, x: State, t: torch.Tensor, clip_denoised: bool = True,
        denoised_fn: Optional[Callable[[State], State]] = None,
    ):
        """Reverse-process mean / variance and the x0 prediction;
        ``denoised_fn`` maps each x0 prediction before the clip."""
        model_output = model_fn(x, self.model_timesteps(t))
        mean_part, var_values = self.split_model_output(model_output)
        variance, log_variance = self.model_variance(var_values, x, t)

        def process_xstart(x0):
            if denoised_fn is not None:
                x0 = denoised_fn(x0)
            return tree_map(lambda l: l.clamp(-1.0, 1.0), x0) if clip_denoised else x0

        if self.mean_type == ModelMeanType.PREVIOUS_X:
            pred_xstart = process_xstart(self.predict_xstart_from_xprev(x, t, mean_part))
            mean = mean_part
        else:
            if self.mean_type == ModelMeanType.START_X:
                pred_xstart = process_xstart(mean_part)
            else:
                pred_xstart = process_xstart(self.predict_xstart_from_eps(x, t, mean_part))
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
        denoised_fn=None,
        cond_fn=None,
        noise: Optional[State] = None,
    ):
        """One ancestral step; ``noise`` defaults to a draw from ``generator``.
        ``cond_fn(x, t_model) -> gradient`` shifts the mean by variance x
        gradient."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        if cond_fn is not None:
            out["mean"] = self.condition_mean(cond_fn, out, x, t)
        if noise is None:
            noise = tree_randn_like(x, generator)
        sample = tree_map(
            lambda m, lv, n: m + _nonzero(t, m.dim()) * torch.exp(0.5 * lv) * n,
            out["mean"], out["log_variance"], noise,
        )
        return {"sample": sample, "pred_xstart": out["pred_xstart"], "pred_noise": out["model_output"]}

    def condition_mean(self, cond_fn, p_mean_var, x: State, t: torch.Tensor) -> State:
        """The mean shifted by variance x ``cond_fn``'s gradient."""
        gradient = cond_fn(x, self.model_timesteps(t))
        return tree_map(lambda m, v, g: m + v * g, p_mean_var["mean"], p_mean_var["variance"], gradient)

    def condition_score(self, cond_fn, p_mean_var, x: State, t: torch.Tensor):
        """Score conditioning: eps moved by -sqrt(1 - alpha_bar) x gradient,
        then x0 and the mean recomputed from it."""
        tb = self.tables
        gradient = cond_fn(x, self.model_timesteps(t))
        eps = self.predict_eps_from_xstart(x, t, p_mean_var["pred_xstart"])
        eps = tree_map(
            lambda e, g, xt: e - torch.sqrt(1.0 - _bcast(tb.alphas_cumprod, t, xt.dim())) * g,
            eps, gradient, x,
        )
        out = dict(p_mean_var)
        out["pred_xstart"] = self.predict_xstart_from_eps(x, t, eps)
        out["mean"], _, _ = self.q_posterior_mean_variance(out["pred_xstart"], x, t)
        return out

    def ddim_sample(
        self,
        model_fn: ModelFn,
        x: State,
        t: torch.Tensor,
        clip_denoised: bool = True,
        generator: Optional[torch.Generator] = None,
        denoised_fn=None,
        cond_fn=None,
        eta: float = 0.0,
        noise: Optional[State] = None,
    ):
        """One DDIM step; at ``eta`` > 0 its noise defaults to a draw from
        ``generator`` (at eta 0 none is drawn)."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        if cond_fn is not None:
            out = self.condition_score(cond_fn, out, x, t)
        tb = self.tables
        eps = self.predict_eps_from_xstart(x, t, out["pred_xstart"])
        if noise is None and eta > 0:
            noise = tree_randn_like(x, generator)

        def step(x0, e, xt, n=None):
            abar = _bcast(tb.alphas_cumprod, t, xt.dim())
            abar_prev = _bcast(tb.alphas_cumprod_prev, t, xt.dim())
            sigma = eta * torch.sqrt((1.0 - abar_prev) / (1.0 - abar)) * torch.sqrt(1.0 - abar / abar_prev)
            mean_pred = x0 * torch.sqrt(abar_prev) + torch.sqrt(1.0 - abar_prev - sigma**2) * e
            return mean_pred if n is None else mean_pred + _nonzero(t, xt.dim()) * sigma * n

        if noise is None:
            sample = tree_map(step, out["pred_xstart"], eps, x)
        else:
            sample = tree_map(step, out["pred_xstart"], eps, x, noise)
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def ddim_reverse_sample(
        self, model_fn: ModelFn, x: State, t: torch.Tensor, clip_denoised: bool = True,
        denoised_fn=None,
    ):
        """One deterministic DDIM encoding step x_t -> x_{t+1}."""
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        tb = self.tables

        def step(x0, xt):
            eps = (_bcast(tb.sqrt_recip_alphas_cumprod, t, xt.dim()) * xt - x0) / _bcast(
                tb.sqrt_recipm1_alphas_cumprod, t, xt.dim()
            )
            abar_next = _bcast(tb.alphas_cumprod_next, t, xt.dim())
            return x0 * torch.sqrt(abar_next) + torch.sqrt(1.0 - abar_next) * eps

        return {"sample": tree_map(step, out["pred_xstart"], x), "pred_xstart": out["pred_xstart"]}

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
            if self.mean_type == ModelMeanType.PREVIOUS_X:
                target = self.q_posterior_mean_variance(x_start, x_t, t)[0]
            elif self.mean_type == ModelMeanType.START_X:
                target = x_start
            else:
                target = noise
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

    def prior_bpd(self, x_start: State) -> State:
        """KL(q(x_T | x_0) || N(0, I)) per leaf, in bits/dim, shape [B]."""
        b = tree_leaves(x_start)[0].shape[0]
        t = torch.full((b,), self.num_timesteps - 1, dtype=torch.long, device=self.tables.betas.device)
        mean, _, log_var = self.q_mean_variance(x_start, t)
        return tree_map(
            lambda m, lv: mean_flat(normal_kl(m, lv, torch.zeros_like(m), torch.zeros_like(lv))) / math.log(2.0),
            mean, log_var,
        )

    def calc_bpd_loop(
        self, model_fn: ModelFn, x_start: State, clip_denoised: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        """The full-chain variational bound in bits/dim, per batch element.

        Returns per-leaf states: ``total_bpd`` / ``prior_bpd`` of shape [B]
        and ``vb`` / ``xstart_mse`` / ``mse`` of shape [B, T], column 0 being
        t = T - 1.  Each step's noise is a draw from ``generator``."""
        b = tree_leaves(x_start)[0].shape[0]
        device = self.tables.betas.device
        cols = {"vb": [], "xstart_mse": [], "mse": []}
        for i in reversed(range(self.num_timesteps)):
            t = torch.full((b,), i, dtype=torch.long, device=device)
            noise = tree_randn_like(x_start, generator)
            x_t = self.q_sample(x_start, t, noise)
            out = self.vb_terms_bpd(model_fn, x_start, x_t, t, clip_denoised)
            eps = self.predict_eps_from_xstart(x_t, t, out["pred_xstart"])
            cols["vb"].append(out["output"])
            cols["xstart_mse"].append(
                tree_map(lambda xs, px: mean_flat((px - xs) ** 2), x_start, out["pred_xstart"])
            )
            cols["mse"].append(tree_map(lambda e, n: mean_flat((e - n) ** 2), eps, noise))
        seq = {k: tree_map(lambda *c: torch.stack(c, dim=1), *v) for k, v in cols.items()}
        prior = self.prior_bpd(x_start)
        return {
            "total_bpd": tree_map(lambda v, p: v.sum(dim=1) + p, seq["vb"], prior),
            "prior_bpd": prior,
            **seq,
        }
