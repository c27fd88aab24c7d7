"""Seeded weights, made on the device in one draw and handed by
``state_dict`` key to the port and to the reference alike.

Matrices (every parameter of two or more dims) ~ N(0, 1 / fan_in), norm
scales (one-dim ``*.weight``) ~ 1 + N(0, 0.1^2), biases ~ N(0, 0.1^2).
Zero-initialised output heads are drawn too, so that every layer shapes
the output.  The keys are taken in sorted order, so the values depend on
the names and shapes alone, never on module order.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed from ``seed`` and any tags (stable across processes)."""
    text = "/".join(str(x) for x in (seed,) + tags).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def seeded_state(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 values for every key of ``shapes`` from ``seed``, on ``device``."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for name, x in zip(names, flat.split(sizes)):
        shape = tuple(shapes[name])
        x = x.view(shape)
        if len(shape) > 1:
            x.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif name.endswith("weight"):
            x.mul_(0.1).add_(1.0)
        else:
            x.mul_(0.1)
        out[name] = x
    return out


def load_seeded_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every parameter of ``model`` (on its device) from ``seed``."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    state = seeded_state({n: tuple(p.shape) for n, p in params.items()}, seed, device)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(state[name])
    return model
