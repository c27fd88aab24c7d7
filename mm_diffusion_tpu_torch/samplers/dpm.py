"""DPM-Solver / DPM-Solver++ over tensor or dict states (counterpart of
``mm_diffusion_tpu/samplers/dpm.py``), the parts the sampling pipeline
reaches: the discrete VP schedule, singlestep solvers of order 1-3 and the
multistep solver of order 1-2, with optional dynamic thresholding.

Step times and solver coefficients are float32 scalars on the host (0-dim
CPU tensors, computed with the JAX package's float32 formulas so that the
integer model timesteps agree); only the state lives on the device.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..diffusion.gaussian import tree_map

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


class NoiseScheduleVP:
    """Discrete-time VP schedule: ``t_i = (i + 1) / N`` and ``log_alpha(t)``
    piecewise-linear over ``(t_i, 0.5 * log alphas_cumprod_i)``."""

    schedule = "discrete"
    T = 1.0

    def __init__(self, alphas_cumprod):
        abar = np.clip(np.asarray(alphas_cumprod, dtype=np.float64), 1e-12, 1.0)
        self.total_N = abar.shape[0]
        self.t_array = _f32(np.linspace(0.0, 1.0, self.total_N + 1)[1:])
        self.log_alpha_array = _f32(0.5 * np.log(abar))

    def marginal_log_mean_coeff(self, t):
        return interp(_f32(t), self.t_array, self.log_alpha_array)

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
        log_alpha = -0.5 * torch.logaddexp(torch.zeros_like(lamb), -2.0 * lamb)
        return interp(log_alpha, self.log_alpha_array.flip(0), self.t_array.flip(0))


def model_input_time(ns: NoiseScheduleVP, t_continuous: torch.Tensor) -> torch.Tensor:
    """Continuous t in [1/N, 1] -> the integer model timestep (truncated)."""
    return ((t_continuous - 1.0 / ns.total_N) * float(ns.total_N)).to(torch.int32)


def _quantile_threshold(x0: torch.Tensor, p: float = 0.995):
    """Dynamic thresholding per sample (Imagen), to [-1, 1]."""
    b = x0.shape[0]
    s = torch.quantile(x0.reshape(b, -1).abs().float(), p, dim=1)
    s = torch.clamp(s, min=1.0).reshape((b,) + (1,) * (x0.dim() - 1)).to(x0.dtype)
    return torch.minimum(torch.maximum(x0, -s), s) / s


class DPMSolver:
    """DPM-Solver (noise prediction) or DPM-Solver++ (``predict_x0=True``).
    ``model_fn(x, t_continuous) -> eps`` with ``t_continuous`` a 0-dim
    float32 tensor."""

    def __init__(
        self,
        model_fn: Callable[[State, torch.Tensor], State],
        ns: NoiseScheduleVP,
        predict_x0: bool = False,
        thresholding: bool = False,
    ):
        self.model = model_fn
        self.ns = ns
        self.predict_x0 = predict_x0
        self.thresholding = thresholding

    def data_prediction_fn(self, x, t):
        noise = self.model(x, t)
        alpha_t, sigma_t = self.ns.marginal_alpha(t), self.ns.marginal_std(t)
        x0 = tree_map(lambda xt, n: (xt - sigma_t * n) / alpha_t, x, noise)
        if self.thresholding:
            x0 = tree_map(_quantile_threshold, x0)
        return x0

    def model_fn(self, x, t):
        return self.data_prediction_fn(x, t) if self.predict_x0 else self.model(x, t)

    def get_time_steps(self, skip_type: str, t_T: float, t_0: float, n: int) -> torch.Tensor:
        if skip_type == "logSNR":
            lam = linspace(self.ns.marginal_lambda(t_T), self.ns.marginal_lambda(t_0), n + 1)
            return self.ns.inverse_lambda(lam)
        if skip_type == "time_uniform":
            return linspace(t_T, t_0, n + 1)
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

    def singlestep_second_update(self, x, s, t, r1=None):
        r1 = 0.5 if r1 is None else r1
        ns = self.ns
        lam_s, log_a_s, sig_s = self._coeffs(s)
        lam_t, log_a_t, sig_t = self._coeffs(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        log_a_s1, sig_s1 = ns.marginal_log_mean_coeff(s1), ns.marginal_std(s1)
        alpha_s1, alpha_t = torch.exp(log_a_s1), torch.exp(log_a_t)
        model_s = self.model_fn(x, s)
        if self.predict_x0:
            phi_11, phi_1 = torch.expm1(-r1 * h), torch.expm1(-h)
            x_s1 = tree_map(lambda xs, ms: (sig_s1 / sig_s) * xs - (alpha_s1 * phi_11) * ms, x, model_s)
            model_s1 = self.model_fn(x_s1, s1)
            return tree_map(
                lambda xs, ms, ms1: (sig_t / sig_s) * xs
                - (alpha_t * phi_1) * ms
                - (0.5 / r1) * (alpha_t * phi_1) * (ms1 - ms),
                x, model_s, model_s1,
            )
        phi_11, phi_1 = torch.expm1(r1 * h), torch.expm1(h)
        x_s1 = tree_map(
            lambda xs, ms: torch.exp(log_a_s1 - log_a_s) * xs - (sig_s1 * phi_11) * ms, x, model_s
        )
        model_s1 = self.model_fn(x_s1, s1)
        return tree_map(
            lambda xs, ms, ms1: torch.exp(log_a_t - log_a_s) * xs
            - (sig_t * phi_1) * ms
            - (0.5 / r1) * (sig_t * phi_1) * (ms1 - ms),
            x, model_s, model_s1,
        )

    def singlestep_third_update(self, x, s, t, r1=None, r2=None):
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
        model_s = self.model_fn(x, s)
        if self.predict_x0:
            phi_11, phi_12, phi_1 = torch.expm1(-r1 * h), torch.expm1(-r2 * h), torch.expm1(-h)
            phi_22 = torch.expm1(-r2 * h) / (r2 * h) + 1.0
            phi_2 = phi_1 / h + 1.0
            x_s1 = tree_map(lambda xs, ms: (sig_s1 / sig_s) * xs - (alpha_s1 * phi_11) * ms, x, model_s)
            model_s1 = self.model_fn(x_s1, s1)
            x_s2 = tree_map(
                lambda xs, ms, ms1: (sig_s2 / sig_s) * xs
                - (alpha_s2 * phi_12) * ms
                + (r2 / r1) * (alpha_s2 * phi_22) * (ms1 - ms),
                x, model_s, model_s1,
            )
            model_s2 = self.model_fn(x_s2, s2)
            return tree_map(
                lambda xs, ms, ms2: (sig_t / sig_s) * xs
                - (alpha_t * phi_1) * ms
                + (1.0 / r2) * (alpha_t * phi_2) * (ms2 - ms),
                x, model_s, model_s2,
            )
        phi_11, phi_12, phi_1 = torch.expm1(r1 * h), torch.expm1(r2 * h), torch.expm1(h)
        phi_22 = torch.expm1(r2 * h) / (r2 * h) - 1.0
        phi_2 = phi_1 / h - 1.0
        x_s1 = tree_map(
            lambda xs, ms: torch.exp(log_a_s1 - log_a_s) * xs - (sig_s1 * phi_11) * ms, x, model_s
        )
        model_s1 = self.model_fn(x_s1, s1)
        x_s2 = tree_map(
            lambda xs, ms, ms1: torch.exp(log_a_s2 - log_a_s) * xs
            - (sig_s2 * phi_12) * ms
            - (r2 / r1) * (sig_s2 * phi_22) * (ms1 - ms),
            x, model_s, model_s1,
        )
        model_s2 = self.model_fn(x_s2, s2)
        return tree_map(
            lambda xs, ms, ms2: torch.exp(log_a_t - log_a_s) * xs
            - (sig_t * phi_1) * ms
            - (1.0 / r2) * (sig_t * phi_2) * (ms2 - ms),
            x, model_s, model_s2,
        )

    def singlestep_update(self, x, s, t, order, r1=None, r2=None):
        if order == 1:
            return self.first_update(x, s, t)
        if order == 2:
            return self.singlestep_second_update(x, s, t, r1=r1)
        if order == 3:
            return self.singlestep_third_update(x, s, t, r1=r1, r2=r2)
        raise ValueError(order)

    def multistep_second_update(self, x, model_hist, t_hist, t):
        """``model_hist`` / ``t_hist``: the last two evaluations, newest last."""
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
            return tree_map(
                lambda xs, m, d: (sig_t / sig_0) * xs
                - alpha_t * torch.expm1(-h) * m
                - 0.5 * alpha_t * torch.expm1(-h) * d,
                x, m0, d1,
            )
        return tree_map(
            lambda xs, m, d: torch.exp(log_a_t - log_a_0) * xs
            - sig_t * torch.expm1(h) * m
            - 0.5 * sig_t * torch.expm1(h) * d,
            x, m0, d1,
        )

    def multistep_update(self, x, model_hist, t_hist, t, order):
        if order == 1:
            return self.first_update(x, t_hist[-1], t, model_s=model_hist[-1])
        if order == 2:
            return self.multistep_second_update(x, model_hist, t_hist, t)
        raise ValueError(f"multistep order {order} is not ported (1 or 2)")

    def sample(
        self,
        x: State,
        steps: int = 20,
        order: int = 3,
        skip_type: str = "time_uniform",
        method: str = "singlestep",
    ) -> State:
        """Solve from t = T to t = 1/N."""
        t_0, t_T = 1.0 / self.ns.total_N, self.ns.T
        if method == "multistep":
            if steps < order:
                raise ValueError(f"multistep needs steps >= order ({steps} < {order})")
            ts = self.get_time_steps(skip_type, t_T, t_0, steps)
            model_hist, t_hist = [self.model_fn(x, ts[0])], [ts[0]]
            for init_order in range(1, order):  # lower-order warm-up
                x = self.multistep_update(x, model_hist, t_hist, ts[init_order], init_order)
                model_hist.append(self.model_fn(x, ts[init_order]))
                t_hist.append(ts[init_order])
            for step in range(order, steps + 1):
                x = self.multistep_update(x, model_hist, t_hist, ts[step], order)
                t_hist = t_hist[1:] + [ts[step]]
                if step < steps:
                    model_hist = model_hist[1:] + [self.model_fn(x, ts[step])]
        elif method == "singlestep":
            orders = self.get_orders_for_singlestep_solver(steps, order)
            ts = self.get_time_steps(skip_type, t_T, t_0, steps)
            lambdas = self.ns.marginal_lambda(ts)
            i = 0
            for o in orders:
                h = lambdas[i + o] - lambdas[i]
                r1 = None if o <= 1 else (lambdas[i + 1] - lambdas[i]) / h
                r2 = None if o <= 2 else (lambdas[i + 2] - lambdas[i]) / h
                x = self.singlestep_update(x, ts[i], ts[i + o], o, r1=r1, r2=r2)
                i += o
        else:
            raise ValueError(f"method {method!r} is not ported (singlestep or multistep)")
        return x


def noise_schedule_from_diffusion(diffusion) -> NoiseScheduleVP:
    return NoiseScheduleVP(diffusion.tables.alphas_cumprod.cpu().double().numpy())


__all__ = [
    "DPMSolver",
    "NoiseScheduleVP",
    "interp",
    "linspace",
    "model_input_time",
    "noise_schedule_from_diffusion",
]
