"""BertAdam and its warmup schedules (counterpart of
``mm_diffusion_tpu/train/optimization.py``), as a ``torch.optim.Optimizer``.

The BERT variant of Adam that the reference vendors
(``mm_diffusion/optimization.py``): no bias correction, each gradient
tensor clipped to ``max_grad_norm`` on its own (not the global norm),
decoupled weight decay added to the normalised update, and the warmup
schedule applied inside the step at ``progress = step / t_total``
(``t_total == -1``: a constant learning rate).  The reference's training
scripts construct AdamW; this is for configurations that used BertAdam.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else 0.5 * (1.0 + math.cos(math.pi * x))


def warmup_constant(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else 1.0


def warmup_linear(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0), 0.0)


SCHEDULES = {
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
}


class BertAdam(torch.optim.Optimizer):
    """BERT-Adam: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
    ``p -= lr_t (m / (sqrt(v) + eps) + weight_decay p)``, each ``g`` first
    scaled to a norm of at most ``max_grad_norm`` (0: no clipping).
    Moments are kept in the parameters' dtype."""

    def __init__(
        self,
        params,
        lr: float,
        warmup: float = -1,
        t_total: int = -1,
        schedule: str = "warmup_linear",
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-6,
        weight_decay: float = 0.01,
        max_grad_norm: float = 1.0,
    ):
        if schedule not in SCHEDULES:
            raise ValueError(f"Invalid schedule parameter: {schedule}")
        if not (warmup == -1 or 0.0 <= warmup < 1.0):
            raise ValueError(f"Invalid warmup: {warmup}")
        for name, val in (("b1", b1), ("b2", b2)):
            if not 0.0 <= val < 1.0:
                raise ValueError(f"Invalid {name} parameter: {val}")
        if eps < 0.0 or lr < 0.0:
            raise ValueError(f"Invalid lr/epsilon: {lr}, {eps}")
        defaults = dict(lr=lr, warmup=warmup, t_total=t_total, schedule=schedule, b1=b1, b2=b2,
                        eps=eps, weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        super().__init__(params, defaults)

    def lr_at(self, group, step: int) -> float:
        """The scheduled learning rate of optimizer step ``step`` (0 first)."""
        if group["t_total"] == -1:
            return group["lr"]
        return group["lr"] * SCHEDULES[group["schedule"]](step / group["t_total"], group["warmup"])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            wd, max_norm = group["weight_decay"], group["max_grad_norm"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if max_norm > 0:
                    norm = torch.linalg.vector_norm(g.float())
                    g = g * (max_norm / norm.clamp(min=1e-6)).clamp(max=1.0).to(g.dtype)
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["m"] = torch.zeros_like(p)
                    state["v"] = torch.zeros_like(p)
                m, v = state["m"], state["v"]
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).add_((1.0 - b2) * g * g)
                update = m / (v.sqrt() + eps)
                if wd > 0.0:
                    update = update + wd * p
                p.sub_(self.lr_at(group, state["step"]) * update)
                state["step"] += 1
        return loss
