"""Shared layers of the MM-UNet and the SR U-Net
(counterpart of ``mm_diffusion_tpu/models/layers.py``).

Layout: inside the models activations are channels-first -- video
``[B, C, F, H, W]``, audio ``[B, C, L]``, images ``[N, C, H, W]`` -- the
layout PyTorch's convolutions take.  The models' public functions keep the
JAX package's channels-last layouts and convert at the edges.

Precision: parameters stay fp32; every conv / linear runs in the dtype of
its input (bf16 when the model computes in bf16), GroupNorm computes its
statistics and affine in fp32 and returns the input's dtype.

Parameter names follow the original PyTorch MM-Diffusion module tree, so
its ``state_dict`` keys load unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.group_norm import group_norm_silu

Film = Optional[Tuple[torch.Tensor, torch.Tensor]]


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embeddings in ``[cos | sin]`` order, fp32; accepts
    fractional timesteps."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Linear(nn.Linear):
    """fp32 parameters, computed in the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv1d(nn.Conv1d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv3d(nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def zero_module(module: nn.Module) -> nn.Module:
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


def pointwise(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """A 1x1 convolution applied to channels-last tokens ``[..., C_in]``."""
    w = conv.weight.reshape(conv.weight.shape[0], conv.weight.shape[1])
    return F.linear(x, w.to(x.dtype), conv.bias.to(x.dtype))


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with fp32 statistics, eps 1e-5.  The group count halves
    from 32 until it divides the channels (narrow test widths).

    ``film=(scale, shift)`` ([B, C] each) applies ``y * (1 + scale) + shift``
    in fp32 before the cast back.  ``channels_last=True`` takes ``[N, ..., C]``.
    """

    def __init__(self, channels: int, num_groups: int = 32):
        while channels % num_groups:
            num_groups //= 2
        super().__init__(num_groups, channels, eps=1e-5)

    def forward(self, x, film: Film = None, channels_last: bool = False):
        y = x.float()
        if channels_last:
            y = y.movedim(-1, 1)
        y = F.group_norm(y, self.num_groups, self.weight, self.bias, self.eps)
        if film is not None:
            shape = (y.shape[0], y.shape[1]) + (1,) * (y.dim() - 2)
            scale, shift = film
            y = y * (1.0 + scale.float().reshape(shape)) + shift.float().reshape(shape)
        if channels_last:
            y = y.movedim(1, -1)
        return y.to(x.dtype)


class MMNorm(nn.Module):
    """The MM-UNet's normalization: a GroupNorm32 held as ``.GroupNorm``
    (the original's parameter names ``<prefix>.GroupNorm.weight``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.GroupNorm = GroupNorm32(channels)

    def forward(self, x, film: Film = None, channels_last: bool = False):
        return self.GroupNorm(x, film=film, channels_last=channels_last)


def norm_silu_then(layers: nn.Sequential, x: torch.Tensor, film: Film = None) -> torch.Tensor:
    """``layers`` = (norm, SiLU, *rest): ``rest(silu(norm(x, film=film)))``
    with the norm and the SiLU as one pass (``ops/group_norm.py``)."""
    h = group_norm_silu(layers[0], x, film)
    for m in layers[2:]:
        h = m(h)
    return h


class VideoConv(nn.Module):
    """SAME-padded, stride-1 video convolution over ``[B, C, F, H, W]``.

    ``"2d+1d"``: a (1, k, k) spatial conv then a (k, 1, 1) temporal conv,
    held as the original's Conv2d / Conv1d parameters and run as 3-d
    convolutions with singleton kernel axes.  ``"3d"``: one (k, k, k) conv.
    """

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
        s, t = self.video_conv_spatial, self.video_conv_temporal
        k = s.kernel_size[0]
        p = k // 2
        x = F.conv3d(x, s.weight.unsqueeze(2).to(x.dtype), s.bias.to(x.dtype), padding=(0, p, p))
        return F.conv3d(
            x, t.weight[..., None, None].to(x.dtype), t.bias.to(x.dtype), padding=(p, 0, 0)
        )


class AudioConv(nn.Module):
    """Dilated SAME-padded 1-d audio convolution over ``[B, C, L]``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.audio_conv = Conv1d(
            in_ch, out_ch, kernel_size, padding=dilation * (kernel_size // 2), dilation=dilation
        )

    def forward(self, x):
        return self.audio_conv(x)


def video_downsample(x):
    """Space-only 2x average pool of ``[B, C, F, H, W]`` (frames folded
    into channels: a 2-d pool runs in every dtype on every device)."""
    return F.avg_pool2d(x.flatten(1, 2), 2).unflatten(1, x.shape[1:3])


def video_upsample(x):
    """Space-only 2x nearest upsample of ``[B, C, F, H, W]``."""
    return x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)


def audio_downsample(x):
    """4x average pool over the length of ``[B, C, L]``."""
    return F.avg_pool1d(x, 4)


def audio_upsample(x):
    """4x nearest upsample over the length of ``[B, C, L]``."""
    return x.repeat_interleave(4, dim=2)


def image_downsample(x):
    return F.avg_pool2d(x, 2)


def image_upsample(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class TimeEmbedding(nn.Sequential):
    """Sinusoid -> Linear -> SiLU -> Linear (the original's ``time_embed``
    Sequential).  ``embed_dim`` is ``model_channels`` in the MM-UNet and
    four times that in the image U-Net."""

    def __init__(self, model_channels: int, embed_dim: int):
        super().__init__(Linear(model_channels, embed_dim), nn.SiLU(), Linear(embed_dim, embed_dim))
        self.model_channels = model_channels

    def forward(self, timesteps, dtype=torch.float32):
        return super().forward(timestep_embedding(timesteps, self.model_channels).to(dtype))
