"""Timestep schedule samplers for training (counterpart of
``mm_diffusion_tpu/train/resample.py``).

The sampler lives on the host: timesteps are drawn there from an explicit
``torch.Generator`` and copied to the device with the batch, so drawing
them never waits on the card.  The loss-aware sampler's history is
updated from the step's per-example losses, which costs one small
device-to-host copy per step; the uniform sampler needs none.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


class UniformSampler:
    """Uniform timesteps with unit importance weights."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def weights(self) -> torch.Tensor:
        return torch.full((self.num_timesteps,), 1.0 / self.num_timesteps)

    def sample(
        self, batch: int, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(t [batch] int64, importance weights [batch] fp32)`` on the CPU."""
        t = torch.randint(0, self.num_timesteps, (batch,), generator=generator)
        return t, torch.ones(batch)

    def update(self, t: torch.Tensor, losses: torch.Tensor) -> None:
        pass

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        pass


class LossSecondMomentResampler(UniformSampler):
    """Importance-sample timesteps by the RMS of recent losses.

    Keeps the last ``history`` losses of each timestep in a ring buffer;
    until every buffer is full, sampling stays uniform.  Weights are
    sqrt(E[loss^2]) per timestep, mixed with ``uniform_prob`` of uniform.
    """

    def __init__(self, num_timesteps: int, history: int = 10, uniform_prob: float = 0.001):
        super().__init__(num_timesteps)
        self.history = history
        self.uniform_prob = uniform_prob
        self.loss_history = torch.zeros((num_timesteps, history))
        self.loss_counts = torch.zeros((num_timesteps,), dtype=torch.int64)

    def weights(self) -> torch.Tensor:
        if not bool((self.loss_counts == self.history).all()):
            return super().weights()
        w = torch.sqrt((self.loss_history**2).mean(dim=-1))
        w = w / w.sum()
        return w * (1 - self.uniform_prob) + self.uniform_prob / self.num_timesteps

    def sample(self, batch: int, generator: Optional[torch.Generator] = None):
        w = self.weights()
        t = torch.multinomial(w, batch, replacement=True, generator=generator)
        return t, 1.0 / (self.num_timesteps * w[t])

    def update(self, t: torch.Tensor, losses: torch.Tensor) -> None:
        """Insert the batch's (t, loss) pairs in order; a full buffer drops
        its oldest loss."""
        for ti, li in zip(t.tolist(), losses.detach().float().cpu().tolist()):
            cnt = int(self.loss_counts[ti])
            if cnt == self.history:
                self.loss_history[ti, :-1] = self.loss_history[ti, 1:].clone()
                self.loss_history[ti, -1] = li
            else:
                self.loss_history[ti, cnt] = li
                self.loss_counts[ti] = cnt + 1

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {"loss_history": self.loss_history.clone(), "loss_counts": self.loss_counts.clone()}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        self.loss_history.copy_(state["loss_history"])
        self.loss_counts.copy_(state["loss_counts"])


def create_named_schedule_sampler(name: str, num_timesteps: int) -> UniformSampler:
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
