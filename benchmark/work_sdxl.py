"""The yardstick of the text-to-image U-Net (Stable Diffusion XL base),
beside ``work.py``'s and on its peaks: the model FLOPs of one evaluation
by ``FlopCounterMode`` over the reference on the meta device (convolutions
and linears), with every attention product counted from its shape, and
the work of each attention site.

A ``"cross"`` site, ``("cross", N, Tq, Tk, C, H)``: the two products
``4 N H Tq Tk d``; bf16 bytes with q read once, k and v read once and the
output written once.  Self sites are ``work.site_work``'s.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import work
from .reference.layers import Precision
from .reference.sdxl_unet import SDXLConfig, SDXLUNet


def site_work(site: tuple) -> Tuple[float, float]:
    """(FLOPs, bytes) of one forward attention call."""
    if site[0] != "cross":
        return work.site_work(site)
    _, n, tq, tk, c, h = site
    flops = 4 * n * h * tq * tk * (c // h)
    return flops, (2 * n * tq * c + 2 * n * tk * c) * work.BYTES_PER_ELEMENT


def self_attention_bound_s(sites: List[tuple]) -> float:
    """Summed bound of the self-attention sites (the kernels of the
    "attention (hand CUDA)" kind)."""
    return sum(work.bound_s(*site_work(s)) for s in sites if s[0] == "self")


def eval_work(flags: dict, rows: int, tokens: int, size: int):
    """(model FLOPs of one evaluation of ``rows`` latents of ``size``^2
    against ``tokens`` context tokens, its attention sites)."""
    cfg = SDXLConfig.from_flags(flags)
    sites: List[tuple] = []
    with torch.device("meta"):
        model = SDXLUNet(cfg, Precision(sites=sites))
        inputs = (torch.zeros(rows, size, size, cfg.in_channels), torch.zeros(rows, dtype=torch.long),
                  torch.zeros(rows, tokens, cfg.context_dim), torch.zeros(rows, cfg.adm_in_channels))
        with FlopCounterMode(display=False) as counter:
            model(*inputs)
    return counter.get_total_flops() + sum(site_work(s)[0] for s in sites), sites
