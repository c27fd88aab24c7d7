"""The yardstick's arithmetic: the card's peaks, the model FLOPs of one
evaluation, and the operations and bytes of every attention site, all
worked out from a configuration and never read from the port.

* Model FLOPs: ``FlopCounterMode`` over the reference on the meta device at
  the cell's shapes (convolutions and linears; norms and elementwise work
  are not counted), with every attention product counted from its shapes
  instead of from the reference's plain attention.
* Attention: the forward's two products (``4 N H Tq Tk d``) and the
  backward's four (twice that; the recompute of the logits is not needed
  work), over bf16 operands: each input byte read once and each needed
  output byte written once -- the forward reads q, k, v and writes the
  output; the backward reads q, k, v and the output's gradient and writes
  the gradients of q, k and v, only the lanes each site has.
* The bound of a piece of work: the larger of its FLOPs over the bf16 peak
  and its bytes over the memory bandwidth.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.image_unet import SRConfig, SRUNet
from .reference.layers import Precision
from .reference.mm_unet import MMConfig, MMUNet

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (data sheet, 700 W)
PEAK_HBM_BYTES_PER_S = 3.35e12
BYTES_PER_ELEMENT = 2  # bf16 operands, as the configurations compute


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take for this work."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def site_work(site: tuple, backward: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention call recorded by the reference:
    ``("self", N, T, C, H)`` or ``("banded", N, F, Tq, Tk, C, H, lw)``."""
    e = BYTES_PER_ELEMENT
    if site[0] == "self":
        _, n, t, c, h = site
        d = c // h
        flops = 4 * n * h * t * t * d
        if not backward:
            return flops, n * t * (3 * c + c) * e
        return 2 * flops, n * t * (3 * c + c + 3 * c) * e
    _, n, f, tq, tk, c, h, lw = site
    d = c // h
    flops = 4 * n * f * h * tq * (lw * tk) * d
    reads = n * f * (tq * c + tk * 2 * c) * e
    if not backward:
        return flops, reads + n * f * tq * c * e
    return 2 * flops, reads + n * f * tq * c * e + n * f * (tq * c + tk * 2 * c) * e


def attention_bound_s(sites: List[tuple], backward: bool = False) -> float:
    """Summed bound of the sites' forward (and backward) work."""
    total = 0.0
    for site in sites:
        total += bound_s(*site_work(site))
        if backward:
            total += bound_s(*site_work(site, backward=True))
    return total


def _count(model, *inputs):
    with FlopCounterMode(display=False) as counter:
        model(*inputs)
    return counter.get_total_flops()


def mm_eval_work(flags: dict, batch: int):
    """(model FLOPs of one MM-UNet evaluation at ``batch``, its attention
    sites)."""
    cfg = MMConfig.from_flags(flags)
    sites: List[tuple] = []
    f, c, h, w = cfg.video_size
    ca, length = cfg.audio_size
    with torch.device("meta"):
        model = MMUNet(cfg, Precision(sites=sites))
        dense = _count(model, torch.zeros(batch, f, h, w, c), torch.zeros(batch, length, ca),
                       torch.zeros(batch, dtype=torch.long))
    return dense + sum(site_work(s)[0] for s in sites), sites


def sr_eval_work(flags: dict, frames: int):
    """(model FLOPs of one SR U-Net evaluation of ``frames`` frames, its
    attention sites)."""
    cfg = SRConfig.from_flags(flags)
    sites: List[tuple] = []
    s, low = cfg.image_size, cfg.small_size
    with torch.device("meta"):
        model = SRUNet(cfg, Precision(sites=sites))
        dense = _count(model, torch.zeros(frames, s, s, 3), torch.zeros(frames, dtype=torch.long),
                       torch.zeros(frames, low, low, 3))
    return dense + sum(site_work(s)[0] for s in sites), sites
