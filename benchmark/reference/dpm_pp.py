"""Stable Diffusion XL's sampler, plain: the scaled-linear schedule, and
DPM-Solver++ (data prediction, no thresholding), multistep of order 2 over
time-uniform steps from t = 1 to 1/N, with classifier-free guidance,
written from DPM-Solver's equations (Lu et al., arXiv:2211.01095, the
multistep second-order update of its ``dpm_solver`` form).

Step times and coefficients are float32 host scalars on ``DiscreteVP``, as
the configuration's sampler keeps them; the model sees the truncated
integer timestep of each step time, where DPM-Solver's own wrapper passes
the fractional one.  Guidance evaluates the doubled batch ``[uncond;
cond]`` once a step: ``eps = eps_u + scale * (eps_c - eps_u)``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .diffusion import DiscreteVP, _linspace


def scaled_linear_betas(steps: int = 1000) -> np.ndarray:
    """Linear in sqrt(beta) from 0.00085 to 0.012."""
    return np.linspace(0.00085**0.5, 0.012**0.5, steps, dtype=np.float64) ** 2


def scaled_linear_vp(steps: int = 1000) -> DiscreteVP:
    abar = np.cumprod(1.0 - scaled_linear_betas(steps))
    return DiscreteVP(np.float32(abar))


def guided_sample(vp: DiscreteVP, eps_model: Callable, x: torch.Tensor, cond: Dict[str, torch.Tensor],
                  uncond: Dict[str, torch.Tensor], steps: int, scale: float) -> torch.Tensor:
    """``steps`` evaluations of ``eps_model(x, t_int, condition)`` on the
    doubled batch; returns the latent at t = 1/N."""
    ts = _linspace(1.0, 1.0 / vp.N, steps + 1)
    both = {k: torch.cat([uncond[k], cond[k]]) for k in cond}

    def alpha(t):
        return torch.exp(vp.log_alpha(t))

    def data_prediction(x, t):
        t_int = torch.full((2 * x.shape[0],), vp.model_time(t), dtype=torch.long, device=x.device)
        eps_u, eps_c = eps_model(torch.cat([x, x]), t_int, both).float().chunk(2)
        eps = eps_u + scale * (eps_c - eps_u)
        return (x - vp.std(t) * eps) / alpha(t)

    m_prev = data_prediction(x, ts[0])
    h = vp.lam(ts[1]) - vp.lam(ts[0])
    x = (vp.std(ts[1]) / vp.std(ts[0])) * x - alpha(ts[1]) * torch.expm1(-h) * m_prev
    for i in range(2, steps + 1):
        t_prev, t_now, t = ts[i - 2], ts[i - 1], ts[i]
        m = data_prediction(x, t_now)
        h_prev, h = vp.lam(t_now) - vp.lam(t_prev), vp.lam(t) - vp.lam(t_now)
        d1 = (m - m_prev) * (h / h_prev)
        phi = alpha(t) * torch.expm1(-h)
        x = (vp.std(t) / vp.std(t_now)) * x - phi * m - 0.5 * phi * d1
        m_prev = m
    return x
