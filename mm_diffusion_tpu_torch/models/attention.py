"""Attention blocks: token self-attention, factorized video attention and
RS-MMA cross-modal attention (counterpart of
``mm_diffusion_tpu/models/attention.py``).

The qkv projections produce the packed channels-last ``[..., T, 3C]`` that
the attention ops read in place; the ops themselves (plain version on the
CPU, hand-written kernel on a GPU) live in ``ops/block_attention.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.block_attention import banded_cross_attention_packed, self_attention
from .layers import AudioConv, Conv1d, GroupNorm32, MMNorm, VideoConv, pointwise, zero_module


class TokenSelfAttention(nn.Module):
    """Residual multi-head self-attention over ``[N, T, C]`` tokens.

    ``image=True`` is the SR U-Net's AttentionBlock: a bare GroupNorm and
    the legacy per-head qkv order, which the kernel reads with
    ``layout="per_head"``; otherwise the MM-UNet's SingleModalAtten with
    thirds-major qkv.
    """

    def __init__(self, channels: int, num_heads: int, image: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.layout = "per_head" if image else "thirds"
        self.norm = GroupNorm32(channels) if image else MMNorm(channels)
        self.qkv = Conv1d(channels, 3 * channels, 1)
        self.proj_out = zero_module(Conv1d(channels, channels, 1))

    def forward(self, x):
        qkv = pointwise(self.norm(x, channels_last=True), self.qkv)
        out = self_attention(qkv, self.num_heads, self.layout)
        return x + pointwise(out, self.proj_out)


def factorized_video_attention(
    x: torch.Tensor, spatial: TokenSelfAttention, temporal: TokenSelfAttention
) -> torch.Tensor:
    """Spatial attention (H*W tokens per frame) then temporal attention
    (F tokens per pixel) on ``[B, C, F, H, W]``."""
    b, c, f, h, w = x.shape
    xs = spatial(x.permute(0, 2, 3, 4, 1).reshape(b * f, h * w, c))
    xt = xs.reshape(b, f, h * w, c).transpose(1, 2).reshape(b * h * w, f, c)
    xt = temporal(xt)
    return xt.reshape(b, h, w, f, c).permute(0, 4, 3, 1, 2).contiguous()


class RSMMACrossAttention(nn.Module):
    """Random-shift multi-modal attention (the original's
    CrossAttentionBlock).  Per frame f, the H*W video queries attend to the
    audio tokens of frames ``(f + shift + j) % F``, ``j < lw``, and each
    frame's L/F audio queries attend to the video tokens of the same frame
    window.  ``shift`` is an explicit argument: the caller draws it (from a
    host generator) in ``[0, F - lw]``, ``lw = min(local_window, F)``.
    """

    def __init__(self, channels: int, num_heads: int, local_window: int, window_shift: bool):
        super().__init__()
        self.channels = channels
        self.num_heads = num_heads
        self.local_window = local_window
        self.window_shift = window_shift
        self.v_norm = MMNorm(channels)
        self.a_norm = MMNorm(channels)
        self.v_qkv = Conv1d(channels, 3 * channels, 1)
        self.a_qkv = Conv1d(channels, 3 * channels, 1)
        self.video_proj_out = zero_module(VideoConv(channels, channels, 1, "3d"))
        self.audio_proj_out = zero_module(AudioConv(channels, channels, 1))

    def window(self, frames: int) -> int:
        return min(self.local_window, frames)

    def forward(self, video, audio, shift: int = 0):
        b, c, f, h, w = video.shape
        length = audio.shape[-1]
        if length % f:
            raise ValueError(f"audio length {length} does not divide into {f} frames")
        lw = self.window(f)
        if not 0 <= shift <= f - lw:
            raise ValueError(f"shift {shift} outside [0, {f - lw}]")
        vn = self.v_norm(video).permute(0, 2, 3, 4, 1).reshape(b, f, h * w, c)
        an = self.a_norm(audio).transpose(1, 2).reshape(b, f, length // f, c)
        v_qkv = pointwise(vn, self.v_qkv)
        a_qkv = pointwise(an, self.a_qkv)
        nh = self.num_heads
        v_out = banded_cross_attention_packed(v_qkv, a_qkv, shift, lw, nh, c)
        a_out = banded_cross_attention_packed(a_qkv, v_qkv, shift, lw, nh, c)
        v_out = pointwise(v_out, self.video_proj_out.video_conv)
        a_out = pointwise(a_out, self.audio_proj_out.audio_conv)
        v_out = v_out.reshape(b, f, h, w, c).permute(0, 4, 1, 2, 3)
        a_out = a_out.reshape(b, length, c).transpose(1, 2)
        return video + v_out, audio + a_out
