"""Wan 2.1's text-to-video diffusion transformer (``WanModel`` of
``wan/modules/model.py``, arXiv:2503.20314) on the port's kernels, which
the JAX package does not have.

The module tree and parameter names are Wan's (``patch_embedding``,
``text_embedding.{0,2}``, ``time_embedding.{0,2}``, ``time_projection.1``,
``blocks.<i>.{self_attn, norm3, cross_attn, ffn, modulation}``, ``head.{head,
modulation}``), so Wan's ``state_dict`` loads unchanged.  With ``m = (modulation
+ e0).chunk(6)`` a block on the ``[B, T, C]`` tokens is::

    x = x + self_attn(LN(x) (1 + m1) + m0) m2       q, k RMS-normed over C, 3-D RoPE
    x = x + cross_attn(LN_affine(x), context)        to the text context
    x = x + ffn(LN(x) (1 + m4) + m3) m5              GELU (tanh) between two linears

The residual stream, the LayerNorms, the q / k RMSNorms, the rotations, the
time embedding and all modulation arithmetic are fp32; the linears and the
attention run in ``cfg.dtype`` (bf16 on the card).  Parameters stay fp32.

Kernels on a card: self-attention runs K1 (``ops/block_attention.py``) on
one thirds-major ``[B, T, 3C]`` projection, whose q and k thirds are
normed and rotated in place; cross-attention runs K8
(``ops/fused_attention.flash_mha``) with the T queries against the
context's tokens.  The rest is PyTorch's.  On the CPU every op takes its
plain version.

RoPE: a head's lanes are pairs ``(x[2i], x[2i+1])``; the first ``D - 4 (D //
6)`` lanes rotate by the token's frame, the next ``2 (D // 6)`` by its row
and the last ``2 (D // 6)`` by its column on the patch grid, each axis with
its own frequencies ``10000^(-2j / d_axis)``.  The tables are made once per
grid and device, in float64, and kept as fp32 ``cos`` / ``sin`` per lane.

Spans (``utils/tracing.py``, off by default): ``wan.block`` around each
block, inside it ``wan.qk_prep`` (the q / k RMSNorms and rotations),
``wan.self_attn``, ``wan.cross_attn`` and ``wan.ffn``.  :data:`SITES` counts
the attention calls by ``(kind, Tq, Tk)``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.block_attention import self_attention
from ..ops.fused_attention import flash_mha
from ..utils import tracing
from .layers import DTYPES, Linear

SITES: collections.Counter = collections.Counter()  # attention calls by (kind, Tq, Tk)


@dataclasses.dataclass(frozen=True)
class WanConfig:
    """The transformer's widths under Wan's names (built by
    ``configs.create_text2video_config``; T2V-1.3B's are
    ``configs.wan_t2v_1_3b_flags``), with the compute dtype's name."""

    dim: int
    ffn_dim: int
    freq_dim: int
    num_heads: int
    num_layers: int
    in_dim: int
    out_dim: int
    text_len: int
    text_dim: int
    patch_size: Tuple[int, int, int]
    eps: float
    dtype: str

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``[cos(t w) | sin(t w)]``, ``w_j = 10000^(-j / (dim / 2))``, computed in
    float64, returned fp32; ``t`` may be fractional."""
    half = dim // 2
    t = t.to(torch.float64)
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float64, device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=1).float()


def rope_lanes(head_dim: int) -> Tuple[int, int, int]:
    """Lanes of a head rotated by the frame, the row and the column."""
    third = head_dim // 6
    return head_dim - 4 * third, 2 * third, 2 * third


def rope_tables(grid: Tuple[int, int, int], head_dim: int, device=None):
    """``(cos, sin)`` fp32 ``[T, 1, head_dim]`` over the tokens of ``grid``
    (frames, rows, columns; (f, h, w) order): each pair's angle on both of
    its lanes, ``sin`` signed ``(-, +)`` so that :func:`apply_rope` is one
    product and one multiply-add."""
    angles = []
    for axis, (n, lanes) in enumerate(zip(grid, rope_lanes(head_dim))):
        inv = torch.pow(10000.0, -torch.arange(0, lanes, 2, dtype=torch.float64) / lanes)
        shape = [1, 1, 1, lanes // 2]
        shape[axis] = n
        a = torch.outer(torch.arange(n, dtype=torch.float64), inv).view(shape)
        angles.append(a.expand(*grid, lanes // 2))
    theta = torch.cat(angles, dim=-1).reshape(-1, head_dim // 2)
    cos = theta.cos().repeat_interleave(2, dim=-1)
    sin = torch.stack([-theta.sin(), theta.sin()], dim=-1).flatten(-2)
    return cos.float()[:, None].to(device), sin.float()[:, None].to(device)


def apply_rope(y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, out: torch.Tensor) -> None:
    """Rotate fp32 ``y [B, T, H, D]`` by the tables, into ``out`` (same
    shape, any float dtype, may be a strided view): per pair ``(a, b) -> (a
    cos - b sin, a sin + b cos)``."""
    swapped = y.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    torch.addcmul(y * cos, swapped, sin, out=out)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, eps: float, dtype) -> torch.Tensor:
    """``LN(x) (1 + scale) + shift``, LayerNorm without affine, all fp32,
    written in ``dtype``."""
    h = F.layer_norm(x, x.shape[-1:], eps=eps)
    return torch.addcmul(shift, h, 1.0 + scale, out=torch.empty(h.shape, dtype=dtype, device=h.device))


class RMSNorm(nn.Module):
    """``x / rms(x) * weight`` over the last dim, fp32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return F.rms_norm(x.float(), x.shape[-1:], self.weight, self.eps)


class WanSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, eps: float):
        super().__init__()
        self.heads = heads
        self.q, self.k, self.v, self.o = (Linear(dim, dim) for _ in range(4))
        self.norm_q, self.norm_k = RMSNorm(dim, eps), RMSNorm(dim, eps)

    def forward(self, x, rope):
        """``x [B, T, C]`` in the compute dtype; ``rope`` :func:`rope_tables`' pair."""
        b, t, c = x.shape
        dt = x.dtype
        w = torch.cat([m.weight.to(dt) for m in (self.q, self.k, self.v)])
        bias = torch.cat([m.bias.to(dt) for m in (self.q, self.k, self.v)])
        qkv = F.linear(x, w, bias)
        with tracing.span("wan.qk_prep"):
            for i, norm in enumerate((self.norm_q, self.norm_k)):
                part = qkv[..., i * c: (i + 1) * c]
                apply_rope(norm(part).view(b, t, self.heads, -1), *rope, out=part.view(b, t, self.heads, -1))
        with tracing.span("wan.self_attn"):
            SITES[("self", t, t)] += 1
            out = self_attention(qkv, self.heads, "thirds")
        return self.o(out)


class WanCrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, eps: float):
        super().__init__()
        self.heads = heads
        self.q, self.k, self.v, self.o = (Linear(dim, dim) for _ in range(4))
        self.norm_q, self.norm_k = RMSNorm(dim, eps), RMSNorm(dim, eps)

    def forward(self, x, context):
        """``x [B, T, C]``, ``context [B, L, C]``, both in the compute dtype."""
        with tracing.span("wan.cross_attn"):
            (b, t, c), length = x.shape, context.shape[1]
            d = c // self.heads
            q = self.norm_q(self.q(x)).to(x.dtype)
            k = self.norm_k(self.k(context)).to(x.dtype)
            v = self.v(context)
            SITES[("cross", t, length)] += 1
            out = flash_mha(q.view(b, t, self.heads, d), k.view(b, length, self.heads, d),
                            v.view(b, length, self.heads, d))
            return self.o(out.reshape(b, t, c))


class WanAttentionBlock(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.eps = cfg.eps
        self.self_attn = WanSelfAttention(cfg.dim, cfg.num_heads, cfg.eps)
        self.norm3 = nn.LayerNorm(cfg.dim, eps=cfg.eps)  # Wan's cross_attn_norm
        self.cross_attn = WanCrossAttention(cfg.dim, cfg.num_heads, cfg.eps)
        self.ffn = nn.Sequential(Linear(cfg.dim, cfg.ffn_dim), nn.GELU(approximate="tanh"),
                                 Linear(cfg.ffn_dim, cfg.dim))
        self.modulation = nn.Parameter(torch.randn(1, 6, cfg.dim) / cfg.dim**0.5)

    def forward(self, x, e0, context, rope):
        """``x [B, T, C]`` fp32, ``e0 [B, 6, C]`` fp32, ``context [B, L, C]``
        in the compute dtype; returns the new fp32 ``x``."""
        with tracing.span("wan.block"):
            dt = context.dtype
            shift1, scale1, gate1, shift2, scale2, gate2 = (self.modulation + e0).unsqueeze(2).unbind(1)
            x = torch.addcmul(x, self.self_attn(modulate(x, shift1, scale1, self.eps, dt), rope), gate1)
            normed = F.layer_norm(x, x.shape[-1:], self.norm3.weight, self.norm3.bias, self.eps)
            x = x + self.cross_attn(normed.to(dt), context)
            with tracing.span("wan.ffn"):
                y = self.ffn(modulate(x, shift2, scale2, self.eps, dt))
            return torch.addcmul(x, y, gate2)


class WanHead(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.eps = cfg.eps
        self.head = Linear(cfg.dim, math.prod(cfg.patch_size) * cfg.out_dim)
        self.modulation = nn.Parameter(torch.randn(1, 2, cfg.dim) / cfg.dim**0.5)

    def forward(self, x, e):
        """fp32 ``x [B, T, C]`` and the time embedding ``e [B, C]`` -> fp32."""
        shift, scale = (self.modulation + e[:, None]).unsqueeze(2).unbind(1)
        return self.head(torch.addcmul(shift, F.layer_norm(x, x.shape[-1:], eps=self.eps), 1.0 + scale))


class WanModel(nn.Module):
    """``(x [B, in_dim, F, H, W], t [B] (fractional), context [B, L,
    text_dim])`` -> the velocity, fp32 ``[B, out_dim, F, H, W]``."""

    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.dim
        self.patch_embedding = nn.Conv3d(cfg.in_dim, dim, kernel_size=cfg.patch_size, stride=cfg.patch_size)
        self.text_embedding = nn.Sequential(Linear(cfg.text_dim, dim), nn.GELU(approximate="tanh"),
                                            Linear(dim, dim))
        self.time_embedding = nn.Sequential(Linear(cfg.freq_dim, dim), nn.SiLU(), Linear(dim, dim))
        self.time_projection = nn.Sequential(nn.SiLU(), Linear(dim, 6 * dim))
        self.blocks = nn.ModuleList(WanAttentionBlock(cfg) for _ in range(cfg.num_layers))
        self.head = WanHead(cfg)
        self._rope: Dict[tuple, tuple] = {}

    def rope(self, grid, device):
        key = (tuple(grid), str(device))
        if key not in self._rope:
            self._rope[key] = rope_tables(grid, self.cfg.head_dim, device)
        return self._rope[key]

    def forward(self, x, t, context):
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, c, f, h, w = x.shape
        pf, ph, pw = cfg.patch_size
        grid = (f // pf, h // ph, w // pw)
        # The patch embedding (a conv of stride = kernel) as one linear over
        # each patch's (channel, frame, row, column) lanes.
        patches = x.to(dt).reshape(b, c, grid[0], pf, grid[1], ph, grid[2], pw)
        patches = patches.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, math.prod(grid), c * pf * ph * pw)
        weight = self.patch_embedding.weight
        tokens = F.linear(patches, weight.reshape(weight.shape[0], -1).to(dt),
                          self.patch_embedding.bias.to(dt)).float()
        e = self.time_embedding(sinusoidal_embedding(t, cfg.freq_dim))
        e0 = self.time_projection(e).unflatten(1, (6, cfg.dim))
        context = self.text_embedding(context.to(dt))
        rope = self.rope(grid, x.device)
        for block in self.blocks:
            tokens = block(tokens, e0, context, rope)
        out = self.head(tokens, e)
        out = out.view(b, *grid, pf, ph, pw, cfg.out_dim).permute(0, 7, 1, 4, 2, 5, 3, 6)
        return out.reshape(b, cfg.out_dim, f, h, w)
