"""Pieces the drivers share: the compared numbers and their limits, the
spans around the model's calls, and the comparison helpers."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional

import torch

from .weights import derive_seed


@dataclasses.dataclass
class Check:
    """One compared number beside its limit (a number at or under its
    limit passes)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


def ints(text) -> tuple:
    """A configuration's comma-separated sizes (``"16,3,64,64"``)."""
    return tuple(int(v) for v in str(text).split(","))


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.double(), ref.double()
    return float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))


def sample_indices(seed: int, tag: str, population: int, k: int) -> List[int]:
    """``k`` distinct indices of ``range(population)`` drawn from the seed."""
    g = torch.Generator().manual_seed(derive_seed(seed, tag))
    return sorted(torch.randperm(population, generator=g)[:k].tolist())


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    """Each kept leaf's gap of norms: ``|prog - ref|`` over the larger of
    the leaf's reference norm and the median leaf's."""
    median = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in keep}


def kept_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others (a key's bias under the softmax) move by
    round-off alone."""
    median = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= 1e-3 * median]


class Spanned:
    """A model as a sampler sees it (``cfg``, ``parameters()``, calls),
    which, when ``on`` and on a card, records a CUDA event before and after
    each call."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.cfg = model.cfg
        self.on = False
        self.events: List[tuple] = []

    def parameters(self):
        return self.model.parameters()

    def __call__(self, *args, **kwargs):
        if not (self.on and torch.cuda.is_available()):
            return self.model(*args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.model(*args, **kwargs)
        end.record()
        self.events.append((start, end))
        return out

    def span_s(self) -> Optional[float]:
        """Seconds inside the recorded calls (device clock), None if none."""
        if not self.events:
            return None
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3


def device_generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, *tags))


def free_cuda() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
