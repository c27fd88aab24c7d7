"""Spatial transformers of the text-to-image U-Net: Stable Diffusion XL's
``SpatialTransformer``, ``BasicTransformerBlock``, ``CrossAttention`` and
GEGLU ``FeedForward`` (``sgm/modules/attention.py``), on the port's kernels.

The module tree and parameter names are SGM's (``norm``, ``proj_in``,
``transformer_blocks.<i>.{norm1, attn1, norm2, attn2, norm3, ff}``,
``proj_out``), so SGM's ``model.diffusion_model.*`` keys, prefix stripped,
load unchanged.  A block on ``[N, T, C]`` tokens::

    x = x + attn1(norm1(x))            self-attention
    x = x + attn2(norm2(x), context)   cross-attention to the text context
    x = x + ff(norm3(x))               GEGLU: a * gelu(b) from one C -> 8C linear, then 4C -> C

Kernels on a card: self-attention runs K1 (``ops/block_attention.py``) on a
thirds-major packed qkv made by one GEMM over ``to_q | to_k | to_v``;
cross-attention runs K8 (``ops/fused_attention.flash_mha``) with the H*W
queries against the context's tokens; the SpatialTransformer's GroupNorm
(eps 1e-6) runs the GroupNorm kernel with the SiLU off.  The LayerNorms
(eps 1e-5), the exact (erf) GELU and the residual adds are PyTorch's.  On
the CPU every op takes its plain version.

Spans (``utils/tracing.py``, off by default): ``unet.transformer`` around
each SpatialTransformer call, ``unet.cross_attn`` around each
cross-attention inside it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.block_attention import self_attention
from ..ops.fused_attention import flash_mha
from ..ops.group_norm import group_norm_silu
from ..utils import tracing
from .layers import GroupNorm32, Linear, zero_module


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) with fp32 parameters, computed in the input's
    dtype (PyTorch's kernel keeps its statistics in fp32)."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class CrossAttention(nn.Module):
    """SGM's attention module: ``forward(x)`` is self-attention,
    ``forward(x, context)`` cross-attention to ``context [N, L, context_dim]``;
    the projections have no bias, ``to_out.0`` has one."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim or dim, inner, bias=False)
        self.to_v = Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), nn.Identity())  # SGM's dropout 0

    def forward(self, x, context=None):
        if context is None:
            w = torch.cat([m.weight.to(x.dtype) for m in (self.to_q, self.to_k, self.to_v)])
            out = self_attention(F.linear(x, w), self.heads, "thirds")
            return self.to_out(out)
        with tracing.span("unet.cross_attn"):
            n, t, _ = x.shape
            q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
            d = q.shape[-1] // self.heads
            out = flash_mha(q.view(n, t, self.heads, d), *(y.view(n, -1, self.heads, d) for y in (k, v)))
            return self.to_out(out.reshape(n, t, -1))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, 2 * dim_out)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU to ``mult * dim``, then a linear back to ``dim``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, mult * dim), nn.Identity(), Linear(mult * dim, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm (eps 1e-6), the linear ``proj_in`` (SGM's
    ``use_linear_in_transformer``), ``depth`` blocks over the H*W tokens,
    the linear ``proj_out``, plus the input: ``[N, C, H, W]`` -> ``[N, C,
    H, W]``.  On a channels-last ``x`` (the image U-Net's layout) the
    tokens ``proj_in`` reads and the image added back are views of
    ``[N, H*W, C]`` memory, and the sum is channels-last."""

    def __init__(self, channels: int, heads: int, depth: int, context_dim: int):
        super().__init__()
        dim_head = channels // heads
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, heads, dim_head, context_dim) for _ in range(depth)
        )
        self.proj_out = zero_module(Linear(channels, channels))

    def forward(self, x, context):
        with tracing.span("unet.transformer"):
            h, w = x.shape[2:]
            tokens = self.proj_in(group_norm_silu(self.norm, x, silu=False).flatten(2).transpose(1, 2))
            for block in self.transformer_blocks:
                tokens = block(tokens, context)
            return x + self.proj_out(tokens).transpose(1, 2).unflatten(2, (h, w))
