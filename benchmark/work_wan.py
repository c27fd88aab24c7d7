"""The yardstick of the text-to-video transformer (Wan 2.1), beside
``work.py``'s and on its peaks: the model FLOPs of one evaluation by
``FlopCounterMode`` over the reference on the meta device (the patch
embedding's conv and the linears), with every attention product counted
from its shape (``work_sdxl.site_work``: ``("self", N, T, C, H)`` and
``("cross", N, Tq, Tk, C, H)``), and the work of each attention site.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import work_sdxl
from .reference.layers import Precision
from .reference.wan import WanRef, WanRefConfig


def latent_shape(video: dict) -> Tuple[int, int, int, int]:
    """``(z_dim, F, H, W)`` of the VAE latent of ``video``'s frames and size."""
    tf, th, tw = (int(v) for v in str(video["vae_stride"]).split(","))
    return (int(video["z_dim"]), (int(video["frames"]) - 1) // tf + 1, int(video["height"]) // th,
            int(video["width"]) // tw)


def eval_work(flags: dict, rows: int, latent: Tuple[int, int, int, int]):
    """(model FLOPs of one evaluation of ``rows`` latents of shape
    ``latent`` against the configuration's text context, its attention
    sites)."""
    cfg = WanRefConfig.from_flags(flags)
    sites: List[tuple] = []
    with torch.device("meta"):
        model = WanRef(cfg, Precision(sites=sites))
        inputs = (torch.zeros(rows, *latent), torch.zeros(rows), torch.zeros(rows, cfg.text_len, cfg.text_dim))
        with FlopCounterMode(display=False) as counter:
            model(*inputs)
    return counter.get_total_flops() + sum(work_sdxl.site_work(s)[0] for s in sites), sites
