"""The diffusion arithmetic of the reference: the linear schedule and its
DDIM respacing, the DDIM loop (eta 0, learned sigma, x0 clipped to [-1,
1]), the epsilon-MSE training loss, and singlestep DPM-Solver (order 3,
logSNR steps, noise prediction) on the discrete VP schedule.

A frozen copy of the port's ``diffusion/schedules.py``, ``diffusion/
gaussian.py`` and ``samplers/dpm.py`` on the paths the benchmark drives.
The tables are worked out in float64 and kept in float32, and the solver's
step times are float32 host scalars, as the configuration's sampler keeps
them: the integer timestep the model sees is the truncation of a float32
time, and an ulp moves it by one.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

State = Dict[str, torch.Tensor]


def linear_betas(steps: int) -> np.ndarray:
    scale = 1000.0 / steps
    return np.linspace(scale * 0.0001, scale * 0.02, steps, dtype=np.float64)


def ddim_timesteps(steps: int, count: int):
    """The kept timesteps of ``"ddim<count>"``: the integer stride that
    gives exactly ``count`` of them."""
    for stride in range(1, steps):
        if len(range(0, steps, stride)) == count:
            return list(range(0, steps, stride))
    raise ValueError(f"no integer stride gives {count} of {steps} steps")


class Tables:
    """float32 coefficient tables of a (respaced) schedule, on ``device``."""

    def __init__(self, steps: int, respace: int = 0, device="cpu"):
        betas = linear_betas(steps)
        keep = ddim_timesteps(steps, respace) if respace else list(range(steps))
        abar_all = np.cumprod(1.0 - betas)
        new_betas, last = [], 1.0
        for i in keep:
            new_betas.append(1.0 - abar_all[i] / last)
            last = abar_all[i]
        abar = np.cumprod(1.0 - np.array(new_betas))
        abar_prev = np.append(1.0, abar[:-1])

        def f32(a):
            return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

        self.num_timesteps = len(keep)
        self.timestep_map = torch.tensor(keep, dtype=torch.long, device=device)
        self.abar_prev = f32(abar_prev)
        self.sqrt_abar = f32(np.sqrt(abar))
        self.sqrt_1m_abar = f32(np.sqrt(1.0 - abar))
        self.sqrt_recip = f32(np.sqrt(1.0 / abar))
        self.sqrt_recipm1 = f32(np.sqrt(1.0 / abar - 1.0))


def _b(table: torch.Tensor, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return table[t].reshape(t.shape + (1,) * (x.dim() - 1))


def ddim_sample(tables: Tables, model: Callable, x_T: torch.Tensor, learn_sigma: bool) -> torch.Tensor:
    """DDIM at eta 0 over every step of ``tables``; ``model(x, t_model)``
    returns the noise prediction (and the variance channels when
    ``learn_sigma``)."""
    x = x_T.float()
    for i in reversed(range(tables.num_timesteps)):
        t = torch.full((x.shape[0],), i, dtype=torch.long, device=x.device)
        out = model(x, tables.timestep_map[t]).float()
        eps = out[..., : out.shape[-1] // 2] if learn_sigma else out
        x0 = (_b(tables.sqrt_recip, t, x) * x - _b(tables.sqrt_recipm1, t, x) * eps).clamp(-1.0, 1.0)
        eps = (_b(tables.sqrt_recip, t, x) * x - x0) / _b(tables.sqrt_recipm1, t, x)
        abar_prev = _b(tables.abar_prev, t, x)
        x = x0 * torch.sqrt(abar_prev) + torch.sqrt(1.0 - abar_prev) * eps
    return x


def mse_loss(tables: Tables, model: Callable, x_start: State, t: torch.Tensor, noise: State):
    """Per-example epsilon MSE, summed over the state's leaves (keys in
    sorted order): ``[B]``."""
    x_t = {k: _b(tables.sqrt_abar, t, v) * v + _b(tables.sqrt_1m_abar, t, v) * noise[k]
           for k, v in x_start.items()}
    out = model(x_t, tables.timestep_map[t])
    losses = [((out[k] - noise[k]) ** 2).mean(dim=tuple(range(1, noise[k].dim()))) for k in sorted(x_start)]
    return sum(losses[1:], losses[0])


# -- DPM-Solver -------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _interp(x, xp, fp):
    """Piecewise-linear interpolation (float32, constant extrapolation)."""
    shape = x.shape
    x = x.reshape(-1)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df, dx, delta = fp[i] - fp[i - 1], xp[i] - xp[i - 1], x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    f = torch.where(x > xp[-1], fp[-1], f)
    return f.reshape(shape)


def _linspace(start, stop, num: int):
    start, stop = _f32(start), _f32(stop)
    step = torch.arange(num - 1, dtype=torch.float32) / _f32(num - 1)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


class DiscreteVP:
    """The discrete VP schedule: ``t_i = (i + 1) / N``, ``log alpha(t)``
    piecewise linear over ``(t_i, 0.5 log abar_i)``."""

    def __init__(self, abar_f32: np.ndarray):
        abar = np.clip(np.asarray(abar_f32, dtype=np.float64), 1e-12, 1.0)
        self.N = abar.shape[0]
        self.t_array = _f32(np.linspace(0.0, 1.0, self.N + 1)[1:])
        self.log_alpha_array = _f32(0.5 * np.log(abar))

    def log_alpha(self, t):
        return _interp(_f32(t), self.t_array, self.log_alpha_array)

    def std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.log_alpha(t)))

    def lam(self, t):
        la = self.log_alpha(t)
        return la - 0.5 * torch.log(1.0 - torch.exp(2.0 * la))

    def inverse_lambda(self, lamb):
        lamb = _f32(lamb)
        log_alpha = -0.5 * torch.logaddexp(torch.zeros_like(lamb), -2.0 * lamb)
        return _interp(log_alpha, self.log_alpha_array.flip(0), self.t_array.flip(0))

    def model_time(self, t) -> int:
        return int(((t - 1.0 / self.N) * float(self.N)).to(torch.int32))


def singlestep_orders(steps: int):
    """Order-3 singlestep: ``[3] * (k - 2) + [2, 1]`` and its variants."""
    k = steps // 3 + 1
    if steps % 3 == 0:
        return [3] * (k - 2) + [2, 1]
    if steps % 3 == 1:
        return [3] * (k - 1) + [1]
    return [3] * (k - 1) + [2]


def dpm_solver_sample(vp: DiscreteVP, eps_model: Callable, x: State, steps: int) -> State:
    """Singlestep DPM-Solver of order 3 (noise prediction, the
    ``dpm_solver`` corrections), logSNR-uniform steps from t = 1 to 1/N;
    ``eps_model(x, t_int)`` with the integer model timestep."""
    lam_T, lam_0 = vp.lam(_f32(1.0)), vp.lam(_f32(1.0 / vp.N))
    ts = vp.inverse_lambda(_linspace(lam_T, lam_0, steps + 1))
    lams = vp.lam(ts)

    def model(x, t):
        return eps_model(x, vp.model_time(t))

    def comb(*terms):
        keys = terms[0][1].keys()
        return {k: sum(c * v[k] for c, v in terms[1:]) + terms[0][0] * terms[0][1][k] for k in keys}

    i = 0
    for o in singlestep_orders(steps):
        s, t = ts[i], ts[i + o]
        lam_s, la_s = vp.lam(s), vp.log_alpha(s)
        lam_t, la_t, sig_t = vp.lam(t), vp.log_alpha(t), vp.std(t)
        h = lam_t - lam_s
        h_r = lams[i + o] - lams[i]
        m_s = model(x, s)
        if o == 1:
            x = comb((torch.exp(la_t - la_s), x), (-(sig_t * torch.expm1(h)), m_s))
        elif o == 2:
            r1 = (lams[i + 1] - lams[i]) / h_r
            s1 = vp.inverse_lambda(lam_s + r1 * h)
            la_s1, sig_s1 = vp.log_alpha(s1), vp.std(s1)
            phi_11, phi_1 = torch.expm1(r1 * h), torch.expm1(h)
            x_s1 = comb((torch.exp(la_s1 - la_s), x), (-(sig_s1 * phi_11), m_s))
            m_s1 = model(x_s1, s1)
            x = {k: torch.exp(la_t - la_s) * x[k] - (sig_t * phi_1) * m_s[k]
                 - (0.5 / r1) * (sig_t * phi_1) * (m_s1[k] - m_s[k]) for k in x}
        else:
            r1 = (lams[i + 1] - lams[i]) / h_r
            r2 = (lams[i + 2] - lams[i]) / h_r
            s1, s2 = vp.inverse_lambda(lam_s + r1 * h), vp.inverse_lambda(lam_s + r2 * h)
            la_s1, sig_s1 = vp.log_alpha(s1), vp.std(s1)
            la_s2, sig_s2 = vp.log_alpha(s2), vp.std(s2)
            phi_11, phi_12, phi_1 = torch.expm1(r1 * h), torch.expm1(r2 * h), torch.expm1(h)
            phi_22 = torch.expm1(r2 * h) / (r2 * h) - 1.0
            phi_2 = phi_1 / h - 1.0
            x_s1 = comb((torch.exp(la_s1 - la_s), x), (-(sig_s1 * phi_11), m_s))
            m_s1 = model(x_s1, s1)
            x_s2 = {k: torch.exp(la_s2 - la_s) * x[k] - (sig_s2 * phi_12) * m_s[k]
                    - (r2 / r1) * (sig_s2 * phi_22) * (m_s1[k] - m_s[k]) for k in x}
            m_s2 = model(x_s2, s2)
            x = {k: torch.exp(la_t - la_s) * x[k] - (sig_t * phi_1) * m_s[k]
                 - (1.0 / r2) * (sig_t * phi_2) * (m_s2[k] - m_s[k]) for k in x}
        i += o
    return x

