"""Layers of the reference U-Nets, with the precision of their products
held by one :class:`Precision` object.

Layouts are the port's: channels-first inside the models (video ``[B, C,
F, H, W]``, audio ``[B, C, L]``, images ``[N, C, H, W]``), channels-last
at their edges.  Every product (conv, linear, attention) takes its two
operands through ``precision``, and every activation the program stores
through ``precision.act``; the arithmetic (GroupNorm, SiLU, the residual
sums, the softmax) is float32.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # largest finite float8 e4m3 value


class Precision:
    """How the reference computes the operands of its products.

    ``"float32"``: as they are (the caller turns TF32 off).  ``"fp8"``: the
    control, the configurations' bf16 network with fp8 products -- each
    operand of a product rounded to float8 e4m3 under one scale per tensor
    (its absolute maximum over 448) and multiplied in float32 (an fp8
    product with a float32 accumulator), and every activation the bf16
    program stores in bf16 (the inputs, each product's output, each norm's
    input and output, each residual sum) rounded to bf16 (:meth:`act`);
    gradients pass the rounding unchanged.  ``sites``, when a list, turns
    every attention call into a stub that appends its shape to it and
    returns zeros: the model FLOPs are then counted without the attention
    products, which ``work.py`` counts from the shapes."""

    KINDS = ("float32", "fp8")

    def __init__(self, kind: str = "float32", sites: Optional[List[tuple]] = None):
        if kind not in self.KINDS:
            raise ValueError(f"precision {kind!r} not in {self.KINDS}")
        self.kind = kind
        self.sites = sites

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.kind == "float32" or x.device.type == "meta":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach() if x.requires_grad else q

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as the configuration stores it: bf16 in the
        control, as it is in float32."""
        if self.kind == "float32" or x.device.type == "meta":
            return x
        r = x.detach().to(torch.bfloat16).float()
        return x + (r - x).detach() if x.requires_grad else r


def set_precision(model: nn.Module, precision: Precision) -> nn.Module:
    """Give every submodule of ``model`` the one ``precision`` object."""
    for m in model.modules():
        m.precision = precision
    return model


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embeddings in ``[cos | sin]`` order, float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Linear(nn.Linear):
    def forward(self, x):
        p = self.precision
        return p.act(F.linear(p(x), p(self.weight), self.bias.float()))


class Conv1d(nn.Conv1d):
    def forward(self, x):
        p = self.precision
        return p.act(self._conv_forward(p(x), p(self.weight), self.bias.float()))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        p = self.precision
        return p.act(self._conv_forward(p(x), p(self.weight), self.bias.float()))


class Conv3d(nn.Conv3d):
    def forward(self, x):
        p = self.precision
        return p.act(self._conv_forward(p(x), p(self.weight), self.bias.float()))


def pointwise(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """A 1x1 convolution applied to channels-last tokens ``[..., C_in]``."""
    p = conv.precision
    w = conv.weight.reshape(conv.weight.shape[0], conv.weight.shape[1])
    return p.act(F.linear(p(x), p(w), conv.bias.float()))


class GroupNorm32(nn.GroupNorm):
    """GroupNorm, eps 1e-5, 32 groups (halved until they divide the
    channels); ``film=(scale, shift)`` applies ``y * (1 + scale) + shift``;
    ``channels_last`` takes ``[N, ..., C]``."""

    def __init__(self, channels: int, num_groups: int = 32):
        while channels % num_groups:
            num_groups //= 2
        super().__init__(num_groups, channels, eps=1e-5)

    def forward(self, x, film=None, channels_last: bool = False):
        y = self.precision.act(x.float())
        if channels_last:
            y = y.movedim(-1, 1)
        y = F.group_norm(y, self.num_groups, self.weight, self.bias, self.eps)
        if film is not None:
            shape = (y.shape[0], y.shape[1]) + (1,) * (y.dim() - 2)
            scale, shift = film
            y = y * (1.0 + scale.reshape(shape)) + shift.reshape(shape)
        if channels_last:
            y = y.movedim(1, -1)
        return self.precision.act(y)


class MMNorm(nn.Module):
    """The MM-UNet's norm, held as ``.GroupNorm`` (the original's keys)."""

    def __init__(self, channels: int):
        super().__init__()
        self.GroupNorm = GroupNorm32(channels)

    def forward(self, x, film=None, channels_last: bool = False):
        return self.GroupNorm(x, film=film, channels_last=channels_last)


class VideoConv(nn.Module):
    """SAME-padded video conv over ``[B, C, F, H, W]``: ``"2d+1d"`` is a
    (1, k, k) spatial conv then a (k, 1, 1) temporal one; ``"3d"`` one
    (k, k, k) conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, conv_type: str = "2d+1d"):
        super().__init__()
        self.conv_type = conv_type
        p = kernel_size // 2
        if conv_type == "2d+1d":
            self.video_conv_spatial = Conv2d(in_ch, out_ch, kernel_size, padding=p)
            self.video_conv_temporal = Conv1d(out_ch, out_ch, kernel_size, padding=p)
        elif conv_type == "3d":
            self.video_conv = Conv3d(in_ch, out_ch, kernel_size, padding=p)
        else:
            raise NotImplementedError(conv_type)

    def forward(self, x):
        if self.conv_type == "3d":
            return self.video_conv(x)
        pr = self.precision
        s, t = self.video_conv_spatial, self.video_conv_temporal
        p = s.kernel_size[0] // 2
        x = pr.act(F.conv3d(pr(x), pr(s.weight.unsqueeze(2)), s.bias.float(), padding=(0, p, p)))
        return pr.act(F.conv3d(pr(x), pr(t.weight[..., None, None]), t.bias.float(), padding=(p, 0, 0)))


class AudioConv(nn.Module):
    """Dilated SAME-padded 1-d conv over ``[B, C, L]``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.audio_conv = Conv1d(in_ch, out_ch, kernel_size, padding=dilation * (kernel_size // 2),
                                 dilation=dilation)

    def forward(self, x):
        return self.audio_conv(x)


def video_downsample(x):
    return F.avg_pool2d(x.flatten(1, 2), 2).unflatten(1, x.shape[1:3])


def video_upsample(x):
    return x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)


def audio_downsample(x):
    return F.avg_pool1d(x, 4)


def audio_upsample(x):
    return x.repeat_interleave(4, dim=2)


def image_downsample(x):
    return F.avg_pool2d(x, 2)


def image_upsample(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class TimeEmbedding(nn.Sequential):
    """Sinusoid -> Linear -> SiLU -> Linear (keys ``time_embed.0`` / ``.2``)."""

    def __init__(self, model_channels: int, embed_dim: int):
        super().__init__(Linear(model_channels, embed_dim), nn.SiLU(), Linear(embed_dim, embed_dim))
        self.model_channels = model_channels

    def forward(self, timesteps):
        return super().forward(self.precision.act(timestep_embedding(timesteps, self.model_channels)))


# -- attention -------------------------------------------------------------------


def _attend(p: Precision, q, k, v, scale: float, eq_logits: str, eq_out: str):
    logits = torch.einsum(eq_logits, p(q), p(k)) * scale
    w = torch.softmax(logits, dim=-1)
    return p.act(torch.einsum(eq_out, p(w), p(v)))


def self_attention(p: Precision, qkv: torch.Tensor, num_heads: int, layout: str) -> torch.Tensor:
    """Multi-head attention over packed ``[N, T, 3C]`` qkv -> ``[N, T, C]``;
    ``layout`` "thirds" reads ``[q | k | v]``, "per_head" the legacy
    ``[h0: q k v | h1: ...]`` order of the SR U-Net."""
    n, t, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    if p.sites is not None:
        p.sites.append(("self", n, t, c, num_heads))
        return qkv.new_zeros(n, t, c)
    if layout == "thirds":
        q, k, v = (x.reshape(n, t, num_heads, d) for x in qkv.split(c, dim=-1))
    else:
        x = qkv.reshape(n, t, num_heads, 3, d)
        q, k, v = x[..., 0, :], x[..., 1, :], x[..., 2, :]
    out = _attend(p, q, k, v, 1.0 / math.sqrt(d), "nqhd,nkhd->nhqk", "nhqk,nkhd->nqhd")
    return out.reshape(n, t, c)


def banded_cross_attention(p: Precision, q_src, kv_src, shift: int, local_window: int,
                           num_heads: int, channels: int) -> torch.Tensor:
    """RS-MMA: query frame ``f`` of ``q_src[..., :C]`` ([N, F, Tq, 3C])
    attends to the kv frames ``(f + shift + j) % F``, ``j < local_window``,
    of ``kv_src[..., C:3C]`` ([N, F, Tk, 3C]) under one softmax."""
    n, f, tq, _ = q_src.shape
    tk = kv_src.shape[2]
    c = channels
    d = c // num_heads
    if p.sites is not None:
        p.sites.append(("banded", n, f, tq, tk, c, num_heads, local_window))
        return q_src.new_zeros(n, f, tq, c)
    q = q_src[..., :c]
    kv = kv_src[..., c: 3 * c]
    idx = (torch.arange(f, device=q.device)[:, None] + shift
           + torch.arange(local_window, device=q.device)[None, :]) % f
    kvw = kv[:, idx].reshape(n, f, local_window * tk, 2 * c)
    k, v = kvw.split(c, dim=-1)
    out = _attend(p, q.reshape(n, f, tq, num_heads, d), k.reshape(n, f, -1, num_heads, d),
                  v.reshape(n, f, -1, num_heads, d), 1.0 / math.sqrt(d),
                  "nfqhd,nfkhd->nfhqk", "nfhqk,nfkhd->nfqhd")
    return out.reshape(n, f, tq, c)


class TokenSelfAttention(nn.Module):
    """Residual multi-head self-attention over ``[N, T, C]`` tokens;
    ``image=True`` is the SR U-Net's AttentionBlock (bare GroupNorm,
    per-head qkv order)."""

    def __init__(self, channels: int, num_heads: int, image: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.layout = "per_head" if image else "thirds"
        self.norm = GroupNorm32(channels) if image else MMNorm(channels)
        self.qkv = Conv1d(channels, 3 * channels, 1)
        self.proj_out = Conv1d(channels, channels, 1)

    def forward(self, x):
        qkv = pointwise(self.norm(x, channels_last=True), self.qkv)
        out = self_attention(self.precision, qkv, self.num_heads, self.layout)
        return self.precision.act(x + pointwise(out, self.proj_out))
