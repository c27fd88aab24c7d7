"""DPM-Solver / DPM-Solver++ over tensor or dict states (counterpart of
``mm_diffusion_tpu/samplers/dpm.py``): the discrete and the continuous
(linear, cosine) VP schedules, the model wrapper with classifier and
classifier-free guidance, singlestep and multistep solvers of order 1-3 in
the ``dpm_solver`` and ``taylor`` forms, the adaptive solver, and dynamic
thresholding.  Beside the VP schedules, the flow-matching schedule of Wan
2.1 (:class:`NoiseScheduleFlow`, which the JAX package does not have):
its model predicts a velocity, which :func:`wrap_model` turns into noise.

Step times and solver coefficients are float32 scalars on the host (0-dim
CPU tensors, computed with the JAX package's float32 formulas so that the
integer model timesteps agree); only the state lives on the device.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..diffusion.gaussian import tree_leaves, tree_map
from ..diffusion.schedules import FLOW_SIGMA_MAX, FLOW_TRAIN_STEPS, flow_sigmas

State = Any


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation with ``jnp.interp``'s float32 formula
    (constant extrapolation)."""
    shape = x.shape
    x = x.reshape(-1)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    f = torch.where(x > xp[-1], fp[-1], f)
    return f.reshape(shape)


def linspace(start, stop, num: int) -> torch.Tensor:
    """``jnp.linspace``'s float32 formula: start*(1-s) + stop*s, s = i/(num-1),
    with the end point exact."""
    start, stop = _f32(start), _f32(stop)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / _f32(div)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


_COSINE_S = 0.008
_COSINE_LOG_ALPHA_0 = math.log(math.cos(_COSINE_S / (1.0 + _COSINE_S) * math.pi / 2.0))


class NoiseScheduleVP:
    """VP schedule in continuous time.  ``schedule``:

    - ``"discrete"``: ``t_i = (i + 1) / N`` and ``log_alpha(t)``
      piecewise-linear over ``(t_i, 0.5 * log alphas_cumprod_i)``;
    - ``"linear"``: the continuous DDPM VPSDE, ``log_alpha(t) = -t^2 (b1 -
      b0) / 4 - t b0 / 2``, closed-form inverse;
    - ``"cosine"``: the improved-DDPM cosine schedule up to ``T = 0.9946``,
      arccos inverse.
    """

    def __init__(self, alphas_cumprod=None, schedule: str = "discrete",
                 beta_0: float = 0.1, beta_1: float = 20.0):
        if schedule == "discrete":
            abar = np.clip(np.asarray(alphas_cumprod, dtype=np.float64), 1e-12, 1.0)
            self.total_N = abar.shape[0]
            self.t_array = _f32(np.linspace(0.0, 1.0, self.total_N + 1)[1:])
            self.log_alpha_array = _f32(0.5 * np.log(abar))
        elif schedule in ("linear", "cosine"):
            self.total_N = 1000
        else:
            raise ValueError(f"schedule {schedule!r} not in ('discrete', 'linear', 'cosine')")
        self.schedule, self.beta_0, self.beta_1 = schedule, beta_0, beta_1
        self.T = 0.9946 if schedule == "cosine" else 1.0

    @classmethod
    def from_alphas_cumprod(cls, alphas_cumprod) -> "NoiseScheduleVP":
        return cls(alphas_cumprod)

    @classmethod
    def from_betas(cls, betas) -> "NoiseScheduleVP":
        return cls(np.cumprod(1.0 - np.asarray(betas, np.float64)))

    @classmethod
    def continuous(cls, schedule: str = "linear", beta_0: float = 0.1, beta_1: float = 20.0):
        if schedule not in ("linear", "cosine"):
            raise ValueError(f"continuous schedule {schedule!r} not in ('linear', 'cosine')")
        return cls(schedule=schedule, beta_0=beta_0, beta_1=beta_1)

    def marginal_log_mean_coeff(self, t):
        t = _f32(t)
        if self.schedule == "linear":
            return -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0
        if self.schedule == "cosine":
            return (
                torch.log(torch.cos((t + _COSINE_S) / (1.0 + _COSINE_S) * math.pi / 2.0))
                - _COSINE_LOG_ALPHA_0
            )
        return interp(t, self.t_array, self.log_alpha_array)

    def marginal_alpha(self, t):
        return torch.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_mean = self.marginal_log_mean_coeff(t)
        log_std = 0.5 * torch.log(1.0 - torch.exp(2.0 * log_mean))
        return log_mean - log_std

    def inverse_lambda(self, lamb):
        lamb = _f32(lamb)
        if self.schedule == "linear":
            tmp = 2.0 * (self.beta_1 - self.beta_0) * torch.logaddexp(-2.0 * lamb, torch.zeros_like(lamb))
            delta = self.beta_0**2 + tmp
            return tmp / (torch.sqrt(delta) + self.beta_0) / (self.beta_1 - self.beta_0)
        log_alpha = -0.5 * torch.logaddexp(torch.zeros_like(lamb), -2.0 * lamb)
        if self.schedule == "cosine":
            return (
                torch.arccos(torch.exp(log_alpha + _COSINE_LOG_ALPHA_0))
                * 2.0 * (1.0 + _COSINE_S) / math.pi
                - _COSINE_S
            )
        return interp(log_alpha, self.log_alpha_array.flip(0), self.t_array.flip(0))


class NoiseScheduleFlow:
    """The flow-matching (rectified-flow) schedule ``x_t = (1 - sigma) x_0 +
    sigma eps`` in the time ``t = sigma``: ``alpha_t = 1 - t``, ``sigma_t =
    t``, ``lambda_t = log((1 - t) / t)``.  Its step grid
    (:meth:`time_steps`, the solver's only grid on this schedule) shifts as Wan does:
    ``steps`` noise levels from 0.999 down, each shifted by ``shift``, then
    0, where the update returns the data prediction.  Its model predicts
    the velocity (:func:`wrap_model`), at the input time ``total_N * t``."""

    schedule = "flow"
    total_N = FLOW_TRAIN_STEPS
    T = FLOW_SIGMA_MAX

    def __init__(self, shift: float = 1.0):
        self.shift = shift

    def marginal_log_mean_coeff(self, t):
        return torch.log1p(-_f32(t))

    def marginal_alpha(self, t):
        return 1.0 - _f32(t)

    def marginal_std(self, t):
        return _f32(t)

    def marginal_lambda(self, t):
        t = _f32(t)
        return torch.log1p(-t) - torch.log(t)

    def inverse_lambda(self, lamb):
        return torch.sigmoid(-_f32(lamb))

    def time_steps(self, steps: int) -> torch.Tensor:
        """The ``steps + 1`` step times, float32 (``diffusion/schedules.py::flow_sigmas``)."""
        return _f32(flow_sigmas(steps, self.shift))


def model_input_time(ns: NoiseScheduleVP, t_continuous: torch.Tensor, rescale: bool = False):
    """Continuous t in [1/N, 1] -> the model's input time: the integer
    timestep (truncated; scaled to 1000 steps with ``rescale``) on a
    discrete schedule, ``total_N * t`` on the flow schedule, t itself on a
    continuous one."""
    if ns.schedule == "flow":
        return t_continuous * float(ns.total_N)
    if ns.schedule != "discrete":
        return t_continuous
    max_step = 1000.0 if rescale else float(ns.total_N)
    return ((t_continuous - 1.0 / ns.total_N) * max_step).to(torch.int32)


def _state_from_leaves(like: State, leaves) -> State:
    """A state of ``like``'s structure from its leaves in :func:`tree_leaves` order."""
    if isinstance(like, dict):
        return dict(zip(sorted(like), leaves))
    return leaves[0]


def wrap_model(
    raw_model_fn: Callable,
    ns: NoiseScheduleVP,
    guidance_type: str = "uncond",
    guidance_scale: float = 1.0,
    condition=None,
    unconditional_condition=None,
    classifier_fn=None,
    rescale: bool = False,
) -> Callable[[State, torch.Tensor], State]:
    """A discrete-time noise model as a continuous-time one.

    ``raw_model_fn(x, t_input [B], cond=None) -> eps`` (learned-variance
    channels already stripped); ``t_input`` lies on the state's device.
    ``guidance_type``: ``"uncond"``; ``"classifier"``, eps - scale *
    sigma_t * grad_x sum(classifier_fn(x, t_input, condition)) (the
    gradient by ``torch.autograd.grad``); or ``"classifier-free"``, uncond
    + scale * (cond - uncond) from one call on the doubled batch.
    On the flow schedule (:class:`NoiseScheduleFlow`) the model predicts
    the velocity ``v = eps - x_0``: guidance applies to ``v``, then ``eps =
    x_t + (1 - sigma_t) v`` (so that ``x_0 = x_t - sigma_t v``); the map is
    linear, so guiding ``v`` is guiding ``x_0``."""

    def batch_t(x, t_continuous):
        b = tree_leaves(x)[0].shape[0]
        return _f32(t_continuous).reshape(-1).expand(b)

    def noise_pred(x, tb, cond=None):
        # non_blocking: a copy from pageable memory that does not wait for the device
        t_input = model_input_time(ns, tb, rescale).to(tree_leaves(x)[0].device, non_blocking=True)
        return raw_model_fn(x, t_input) if cond is None else raw_model_fn(x, t_input, cond)

    if guidance_type == "uncond":

        def model_fn(x, t_continuous):
            return noise_pred(x, batch_t(x, t_continuous))

    elif guidance_type == "classifier":
        if classifier_fn is None:
            raise ValueError("classifier guidance needs classifier_fn")

        def model_fn(x, t_continuous):
            tb = batch_t(x, t_continuous)
            t_input = model_input_time(ns, tb, rescale).to(tree_leaves(x)[0].device)
            with torch.enable_grad():
                xg = tree_map(lambda l: l.detach().requires_grad_(True), x)
                log_prob = classifier_fn(xg, t_input, condition).sum()
                leaves = tree_leaves(xg)
                grads = torch.autograd.grad(log_prob, leaves, allow_unused=True)
            cond_grad = _state_from_leaves(
                x, [torch.zeros_like(l) if g is None else g for l, g in zip(leaves, grads)]
            )
            sigma_t = ns.marginal_std(tb)
            return tree_map(
                lambda n, g: n
                - guidance_scale * sigma_t.to(n.device).reshape((-1,) + (1,) * (n.dim() - 1)) * g,
                noise_pred(x, tb), cond_grad,
            )

    elif guidance_type == "classifier-free":

        def model_fn(x, t_continuous):
            tb = batch_t(x, t_continuous)
            if guidance_scale == 1.0 or unconditional_condition is None:
                return noise_pred(x, tb, cond=condition)
            x2 = tree_map(lambda l: torch.cat([l, l]), x)
            c2 = tree_map(lambda u, c: torch.cat([u, c]), unconditional_condition, condition)
            out = noise_pred(x2, torch.cat([tb, tb]), cond=c2)
            return tree_map(
                lambda l: l[: l.shape[0] // 2] + guidance_scale * (l[l.shape[0] // 2:] - l[: l.shape[0] // 2]),
                out,
            )

    else:
        raise ValueError(f"guidance_type {guidance_type!r} not in ('uncond', 'classifier', 'classifier-free')")
    if ns.schedule == "flow":
        velocity_fn = model_fn

        def model_fn(x, t_continuous):
            alpha_t = float(ns.marginal_alpha(t_continuous))  # a host scalar: no wait on the device
            return tree_map(lambda xs, v: torch.add(xs, v, alpha=alpha_t), x, velocity_fn(x, t_continuous))

    return model_fn


def _quantile_threshold(x0: torch.Tensor, p: float = 0.995, max_val: float = 1.0):
    """Dynamic thresholding per sample (Imagen), to [-max_val, max_val]."""
    b = x0.shape[0]
    s = torch.quantile(x0.reshape(b, -1).abs().float(), p, dim=1)
    s = torch.clamp(s, min=1.0).reshape((b,) + (1,) * (x0.dim() - 1)).to(x0.dtype)
    return torch.minimum(torch.maximum(x0, -s), s) / (s / max_val)


SOLVER_TYPES = ("dpm_solver", "taylor")


class DPMSolver:
    """DPM-Solver (noise prediction) or DPM-Solver++ (``predict_x0=True``).
    ``model_fn(x, t_continuous) -> eps`` with ``t_continuous`` a 0-dim
    float32 tensor (see :func:`wrap_model`).  ``solver_type`` picks the
    second- and third-order corrections: ``"dpm_solver"`` or ``"taylor"``."""

    def __init__(
        self,
        model_fn: Callable[[State, torch.Tensor], State],
        ns: NoiseScheduleVP,
        predict_x0: bool = False,
        thresholding: bool = False,
        max_val: float = 1.0,
    ):
        self.model = model_fn
        self.ns = ns
        self.predict_x0 = predict_x0
        self.thresholding = thresholding
        self.max_val = max_val

    def noise_prediction_fn(self, x, t):
        return self.model(x, t)

    def data_prediction_fn(self, x, t):
        noise = self.noise_prediction_fn(x, t)
        alpha_t, sigma_t = self.ns.marginal_alpha(t), self.ns.marginal_std(t)
        x0 = tree_map(lambda xt, n: (xt - sigma_t * n) / alpha_t, x, noise)
        if self.thresholding:
            x0 = tree_map(lambda l: _quantile_threshold(l, max_val=self.max_val), x0)
        return x0

    def model_fn(self, x, t):
        return self.data_prediction_fn(x, t) if self.predict_x0 else self.noise_prediction_fn(x, t)

    def get_time_steps(self, skip_type: str, t_T: float, t_0: float, n: int) -> torch.Tensor:
        if self.ns.schedule == "flow":  # the schedule's own grid, whatever the skip type and ends
            return self.ns.time_steps(n)
        if skip_type == "logSNR":
            lam = linspace(self.ns.marginal_lambda(t_T), self.ns.marginal_lambda(t_0), n + 1)
            return self.ns.inverse_lambda(lam)
        if skip_type == "time_uniform":
            return linspace(t_T, t_0, n + 1)
        if skip_type == "time_quadratic":
            return linspace(t_T**0.5, t_0**0.5, n + 1) ** 2
        raise ValueError(f"unsupported skip_type {skip_type}")

    @staticmethod
    def get_orders_for_singlestep_solver(steps: int, order: int):
        if order == 3:
            k = steps // 3 + 1
            if steps % 3 == 0:
                return [3] * (k - 2) + [2, 1]
            if steps % 3 == 1:
                return [3] * (k - 1) + [1]
            return [3] * (k - 1) + [2]
        if order == 2:
            k = steps // 2
            return [2] * k if steps % 2 == 0 else [2] * k + [1]
        if order == 1:
            return [1] * steps
        raise ValueError("order must be 1, 2 or 3")

    def _coeffs(self, t):
        ns = self.ns
        return ns.marginal_lambda(t), ns.marginal_log_mean_coeff(t), ns.marginal_std(t)

    def first_update(self, x, s, t, model_s=None):
        lam_s, log_a_s, sig_s = self._coeffs(s)
        lam_t, log_a_t, sig_t = self._coeffs(t)
        h = lam_t - lam_s
        if model_s is None:
            model_s = self.model_fn(x, s)
        if self.predict_x0:
            c_x, c_m = sig_t / sig_s, torch.exp(log_a_t) * torch.expm1(-h)
        else:
            c_x, c_m = torch.exp(log_a_t - log_a_s), sig_t * torch.expm1(h)
        return tree_map(lambda xs, ms: c_x * xs - c_m * ms, x, model_s)

    def singlestep_second_update(self, x, s, t, r1=None, model_s=None, return_intermediate=False,
                                 solver_type="dpm_solver"):
        r1 = 0.5 if r1 is None else r1
        ns = self.ns
        lam_s, log_a_s, sig_s = self._coeffs(s)
        lam_t, log_a_t, sig_t = self._coeffs(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        log_a_s1, sig_s1 = ns.marginal_log_mean_coeff(s1), ns.marginal_std(s1)
        alpha_s1, alpha_t = torch.exp(log_a_s1), torch.exp(log_a_t)
        if model_s is None:
            model_s = self.model_fn(x, s)
        if self.predict_x0:
            phi_11, phi_1 = torch.expm1(-r1 * h), torch.expm1(-h)
            x_s1 = tree_map(lambda xs, ms: (sig_s1 / sig_s) * xs - (alpha_s1 * phi_11) * ms, x, model_s)
            model_s1 = self.model_fn(x_s1, s1)
            if solver_type == "dpm_solver":
                x_t = tree_map(
                    lambda xs, ms, ms1: (sig_t / sig_s) * xs
                    - (alpha_t * phi_1) * ms
                    - (0.5 / r1) * (alpha_t * phi_1) * (ms1 - ms),
                    x, model_s, model_s1,
                )
            else:
                phi_2 = phi_1 / h + 1.0
                x_t = tree_map(
                    lambda xs, ms, ms1: (sig_t / sig_s) * xs
                    - (alpha_t * phi_1) * ms
                    + (1.0 / r1) * (alpha_t * phi_2) * (ms1 - ms),
                    x, model_s, model_s1,
                )
        else:
            phi_11, phi_1 = torch.expm1(r1 * h), torch.expm1(h)
            x_s1 = tree_map(
                lambda xs, ms: torch.exp(log_a_s1 - log_a_s) * xs - (sig_s1 * phi_11) * ms, x, model_s
            )
            model_s1 = self.model_fn(x_s1, s1)
            if solver_type == "dpm_solver":
                x_t = tree_map(
                    lambda xs, ms, ms1: torch.exp(log_a_t - log_a_s) * xs
                    - (sig_t * phi_1) * ms
                    - (0.5 / r1) * (sig_t * phi_1) * (ms1 - ms),
                    x, model_s, model_s1,
                )
            else:
                phi_2 = phi_1 / h - 1.0
                x_t = tree_map(
                    lambda xs, ms, ms1: torch.exp(log_a_t - log_a_s) * xs
                    - (sig_t * phi_1) * ms
                    - (1.0 / r1) * (sig_t * phi_2) * (ms1 - ms),
                    x, model_s, model_s1,
                )
        if return_intermediate:
            return x_t, {"model_s": model_s, "model_s1": model_s1}
        return x_t

    def singlestep_third_update(self, x, s, t, r1=None, r2=None, model_s=None, model_s1=None,
                                return_intermediate=False, solver_type="dpm_solver"):
        r1 = 1.0 / 3.0 if r1 is None else r1
        r2 = 2.0 / 3.0 if r2 is None else r2
        ns = self.ns
        lam_s, log_a_s, sig_s = self._coeffs(s)
        lam_t, log_a_t, sig_t = self._coeffs(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        s2 = ns.inverse_lambda(lam_s + r2 * h)
        log_a_s1, sig_s1 = ns.marginal_log_mean_coeff(s1), ns.marginal_std(s1)
        log_a_s2, sig_s2 = ns.marginal_log_mean_coeff(s2), ns.marginal_std(s2)
        alpha_s1, alpha_s2, alpha_t = torch.exp(log_a_s1), torch.exp(log_a_s2), torch.exp(log_a_t)
        if model_s is None:
            model_s = self.model_fn(x, s)
        if self.predict_x0:
            phi_11, phi_12, phi_1 = torch.expm1(-r1 * h), torch.expm1(-r2 * h), torch.expm1(-h)
            phi_22 = torch.expm1(-r2 * h) / (r2 * h) + 1.0
            phi_2 = phi_1 / h + 1.0
            if model_s1 is None:
                x_s1 = tree_map(
                    lambda xs, ms: (sig_s1 / sig_s) * xs - (alpha_s1 * phi_11) * ms, x, model_s
                )
                model_s1 = self.model_fn(x_s1, s1)
            x_s2 = tree_map(
                lambda xs, ms, ms1: (sig_s2 / sig_s) * xs
                - (alpha_s2 * phi_12) * ms
                + (r2 / r1) * (alpha_s2 * phi_22) * (ms1 - ms),
                x, model_s, model_s1,
            )
            model_s2 = self.model_fn(x_s2, s2)
            x_t = tree_map(
                lambda xs, ms, ms2: (sig_t / sig_s) * xs
                - (alpha_t * phi_1) * ms
                + (1.0 / r2) * (alpha_t * phi_2) * (ms2 - ms),
                x, model_s, model_s2,
            )
        else:
            phi_11, phi_12, phi_1 = torch.expm1(r1 * h), torch.expm1(r2 * h), torch.expm1(h)
            phi_22 = torch.expm1(r2 * h) / (r2 * h) - 1.0
            phi_2 = phi_1 / h - 1.0
            if model_s1 is None:
                x_s1 = tree_map(
                    lambda xs, ms: torch.exp(log_a_s1 - log_a_s) * xs - (sig_s1 * phi_11) * ms,
                    x, model_s,
                )
                model_s1 = self.model_fn(x_s1, s1)
            x_s2 = tree_map(
                lambda xs, ms, ms1: torch.exp(log_a_s2 - log_a_s) * xs
                - (sig_s2 * phi_12) * ms
                - (r2 / r1) * (sig_s2 * phi_22) * (ms1 - ms),
                x, model_s, model_s1,
            )
            model_s2 = self.model_fn(x_s2, s2)
            x_t = tree_map(
                lambda xs, ms, ms2: torch.exp(log_a_t - log_a_s) * xs
                - (sig_t * phi_1) * ms
                - (1.0 / r2) * (sig_t * phi_2) * (ms2 - ms),
                x, model_s, model_s2,
            )
        if return_intermediate:
            return x_t, {"model_s": model_s, "model_s1": model_s1, "model_s2": model_s2}
        return x_t

    def singlestep_update(self, x, s, t, order, r1=None, r2=None, solver_type="dpm_solver",
                          return_intermediate=False):
        if order == 1:
            if return_intermediate:
                model_s = self.model_fn(x, s)
                return self.first_update(x, s, t, model_s=model_s), {"model_s": model_s}
            return self.first_update(x, s, t)
        if order == 2:
            return self.singlestep_second_update(
                x, s, t, r1=r1, solver_type=solver_type, return_intermediate=return_intermediate
            )
        if order == 3:
            return self.singlestep_third_update(
                x, s, t, r1=r1, r2=r2, solver_type=solver_type,
                return_intermediate=return_intermediate,
            )
        raise ValueError(order)

    def multistep_second_update(self, x, model_hist, t_hist, t, solver_type="dpm_solver"):
        """``model_hist`` / ``t_hist``: the last evaluations, newest last."""
        ns = self.ns
        m0, m1 = model_hist[-1], model_hist[-2]
        t0, t1 = t_hist[-1], t_hist[-2]
        lam_1, lam_0, lam_t = ns.marginal_lambda(t1), ns.marginal_lambda(t0), ns.marginal_lambda(t)
        log_a_0, log_a_t = ns.marginal_log_mean_coeff(t0), ns.marginal_log_mean_coeff(t)
        sig_0, sig_t = ns.marginal_std(t0), ns.marginal_std(t)
        alpha_t = torch.exp(log_a_t)
        h0, h = lam_0 - lam_1, lam_t - lam_0
        r0 = h0 / h
        d1 = tree_map(lambda a, b: (1.0 / r0) * (a - b), m0, m1)
        if self.predict_x0:
            if solver_type == "dpm_solver":
                return tree_map(
                    lambda xs, m, d: (sig_t / sig_0) * xs
                    - alpha_t * torch.expm1(-h) * m
                    - 0.5 * alpha_t * torch.expm1(-h) * d,
                    x, m0, d1,
                )
            return tree_map(
                lambda xs, m, d: (sig_t / sig_0) * xs
                - alpha_t * torch.expm1(-h) * m
                + alpha_t * (torch.expm1(-h) / h + 1.0) * d,
                x, m0, d1,
            )
        if solver_type == "dpm_solver":
            return tree_map(
                lambda xs, m, d: torch.exp(log_a_t - log_a_0) * xs
                - sig_t * torch.expm1(h) * m
                - 0.5 * sig_t * torch.expm1(h) * d,
                x, m0, d1,
            )
        return tree_map(
            lambda xs, m, d: torch.exp(log_a_t - log_a_0) * xs
            - sig_t * torch.expm1(h) * m
            - sig_t * (torch.expm1(h) / h - 1.0) * d,
            x, m0, d1,
        )

    def multistep_third_update(self, x, model_hist, t_hist, t, solver_type="dpm_solver"):
        """The third-order multistep update (one form for both solver types)."""
        ns = self.ns
        m0, m1, m2 = model_hist[-1], model_hist[-2], model_hist[-3]
        t0, t1, t2 = t_hist[-1], t_hist[-2], t_hist[-3]
        lam_2, lam_1, lam_0 = ns.marginal_lambda(t2), ns.marginal_lambda(t1), ns.marginal_lambda(t0)
        lam_t = ns.marginal_lambda(t)
        log_a_0, log_a_t = ns.marginal_log_mean_coeff(t0), ns.marginal_log_mean_coeff(t)
        sig_0, sig_t = ns.marginal_std(t0), ns.marginal_std(t)
        alpha_t = torch.exp(log_a_t)
        h1, h0, h = lam_1 - lam_2, lam_0 - lam_1, lam_t - lam_0
        r0, r1 = h0 / h, h1 / h
        d1_0 = tree_map(lambda a, b: (1.0 / r0) * (a - b), m0, m1)
        d1_1 = tree_map(lambda a, b: (1.0 / r1) * (a - b), m1, m2)
        d1 = tree_map(lambda a, b: a + (r0 / (r0 + r1)) * (a - b), d1_0, d1_1)
        d2 = tree_map(lambda a, b: (1.0 / (r0 + r1)) * (a - b), d1_0, d1_1)
        if self.predict_x0:
            return tree_map(
                lambda xs, m, da, db: (sig_t / sig_0) * xs
                - alpha_t * torch.expm1(-h) * m
                + alpha_t * (torch.expm1(-h) / h + 1.0) * da
                - alpha_t * ((torch.expm1(-h) + h) / h**2 - 0.5) * db,
                x, m0, d1, d2,
            )
        return tree_map(
            lambda xs, m, da, db: torch.exp(log_a_t - log_a_0) * xs
            - sig_t * torch.expm1(h) * m
            - sig_t * (torch.expm1(h) / h - 1.0) * da
            - sig_t * ((torch.expm1(h) - h) / h**2 - 0.5) * db,
            x, m0, d1, d2,
        )

    def multistep_update(self, x, model_hist, t_hist, t, order, solver_type="dpm_solver"):
        if order == 1:
            return self.first_update(x, t_hist[-1], t, model_s=model_hist[-1])
        if order == 2:
            return self.multistep_second_update(x, model_hist, t_hist, t, solver_type)
        if order == 3:
            return self.multistep_third_update(x, model_hist, t_hist, t, solver_type)
        raise ValueError(f"multistep order {order} not in (1, 2, 3)")

    def adaptive(self, x, order, t_T, t_0, h_init=0.05, atol=0.0078, rtol=0.05, theta=0.9,
                 t_err=1e-5, solver_type="dpm_solver", max_iters=200):
        """Adaptive step size: each step takes the order-(k-1) and order-k
        updates (sharing their model evaluations), accepts the higher one
        when their scaled RMS gap is <= 1, and sets the next logSNR step
        from that gap; at most ``max_iters`` tries."""
        ns = self.ns
        if order == 2:
            r1 = 0.5

            def lower(xx, s, t):
                return self.singlestep_update(xx, s, t, 1, return_intermediate=True)

            def higher(xx, s, t, kw):
                return self.singlestep_second_update(
                    xx, s, t, r1=r1, solver_type=solver_type, model_s=kw["model_s"]
                )

        elif order == 3:
            r1, r2 = 1.0 / 3.0, 2.0 / 3.0

            def lower(xx, s, t):
                return self.singlestep_second_update(
                    xx, s, t, r1=r1, return_intermediate=True, solver_type=solver_type
                )

            def higher(xx, s, t, kw):
                return self.singlestep_third_update(
                    xx, s, t, r1=r1, r2=r2, solver_type=solver_type,
                    model_s=kw["model_s"], model_s1=kw["model_s1"],
                )

        else:
            raise ValueError("adaptive solver order must be 2 or 3")

        lambda_0 = ns.marginal_lambda(t_0)

        def norm(v):
            return torch.sqrt(torch.mean(torch.square(v.reshape(v.shape[0], -1)), dim=-1))

        x_prev, s, h = x, _f32(t_T), _f32(h_init)
        for _ in range(max_iters):
            if not torch.abs(s - t_0) > t_err:
                break
            t = ns.inverse_lambda(ns.marginal_lambda(s) + h)
            x_lower, kw = lower(x, s, t)
            x_higher = higher(x, s, t, kw)
            errs = tree_map(
                lambda lo, hi, pr: norm(
                    (hi - lo) / torch.clamp(rtol * torch.maximum(lo.abs(), pr.abs()), min=atol)
                ).max(),
                x_lower, x_higher, x_prev,
            )
            e = torch.stack([v.float().cpu() for v in tree_leaves(errs)]).max()
            if e <= 1.0:
                x, x_prev, s = x_higher, x_lower, t
            h = torch.minimum(theta * h * e ** (-1.0 / order), lambda_0 - ns.marginal_lambda(s))
        return x

    def sample(
        self,
        x: State,
        steps: int = 20,
        t_start: Optional[float] = None,
        t_end: Optional[float] = None,
        order: int = 3,
        skip_type: str = "time_uniform",
        method: str = "singlestep",
        denoise: bool = False,
        solver_type: str = "dpm_solver",
        atol: float = 0.0078,
        rtol: float = 0.05,
    ) -> State:
        """Solve from ``t_start`` (default T) to ``t_end`` (default 1/N):
        ``method`` "singlestep", "singlestep_fixed" (``steps // order``
        steps of ``order``), "multistep" or "adaptive"; ``denoise`` ends
        with one x0 prediction at ``t_end``.  On the flow schedule the grid
        is its own (:meth:`NoiseScheduleFlow.time_steps`) and the last
        multistep update, to time 0, is first-order: it returns the last
        data prediction."""
        if solver_type not in SOLVER_TYPES:
            raise ValueError(f"solver_type {solver_type!r} not in {SOLVER_TYPES}")
        t_0 = 1.0 / self.ns.total_N if t_end is None else t_end
        t_T = self.ns.T if t_start is None else t_start
        if method == "adaptive":
            x = self.adaptive(x, order=order, t_T=t_T, t_0=t_0, atol=atol, rtol=rtol,
                              solver_type=solver_type)
        elif method == "multistep":
            if steps < order:
                raise ValueError(f"multistep needs steps >= order ({steps} < {order})")
            ts = self.get_time_steps(skip_type, t_T, t_0, steps)
            model_hist, t_hist = [self.model_fn(x, ts[0])], [ts[0]]
            for init_order in range(1, order):  # lower-order warm-up
                x = self.multistep_update(x, model_hist, t_hist, ts[init_order], init_order, solver_type)
                model_hist.append(self.model_fn(x, ts[init_order]))
                t_hist.append(ts[init_order])
            for step in range(order, steps + 1):
                step_order = 1 if self.ns.schedule == "flow" and step == steps else order
                x = self.multistep_update(x, model_hist, t_hist, ts[step], step_order, solver_type)
                t_hist = t_hist[1:] + [ts[step]]
                if step < steps:
                    model_hist = model_hist[1:] + [self.model_fn(x, ts[step])]
        elif method in ("singlestep", "singlestep_fixed"):
            if method == "singlestep":
                orders = self.get_orders_for_singlestep_solver(steps, order)
                ts = self.get_time_steps(skip_type, t_T, t_0, steps)
            else:
                orders = [order] * (steps // order)
                ts = self.get_time_steps(skip_type, t_T, t_0, steps // order * order)
            lambdas = self.ns.marginal_lambda(ts)
            i = 0
            for o in orders:
                h = lambdas[i + o] - lambdas[i]
                r1 = None if o <= 1 else (lambdas[i + 1] - lambdas[i]) / h
                r2 = None if o <= 2 else (lambdas[i + 2] - lambdas[i]) / h
                x = self.singlestep_update(x, ts[i], ts[i + o], o, r1=r1, r2=r2, solver_type=solver_type)
                i += o
        else:
            raise ValueError(
                f"method {method!r} not in ('singlestep', 'singlestep_fixed', 'multistep', 'adaptive')"
            )
        if denoise:
            x = self.data_prediction_fn(x, _f32(t_0))
        return x


def noise_schedule_from_diffusion(diffusion) -> NoiseScheduleVP:
    return NoiseScheduleVP(diffusion.tables.alphas_cumprod.cpu().double().numpy())


__all__ = [
    "DPMSolver",
    "NoiseScheduleFlow",
    "NoiseScheduleVP",
    "interp",
    "linspace",
    "model_input_time",
    "noise_schedule_from_diffusion",
    "wrap_model",
]
