"""Wan 2.1's text-to-video diffusion transformer, plain and float32:
``WanModel`` of ``wan/modules/model.py`` (Wan2.1-T2V-1.3B: arXiv:2503.20314),
written from its equations.

Parameter names are Wan's ``state_dict`` keys, so one set of seeded weights
loads into the port and the reference alike.  Layout: ``x [B, C, F, H, W]``
in and out, ``[B, T, C]`` tokens in (f, h, w) order inside.  The patch
embedding is Wan's strided ``Conv3d``; RoPE is Wan's complex form in
float64 (``rope_params``, ``rope_apply``); attention is a plain softmax,
one batch row and :data:`QUERY_BLOCK` query rows at a time, so that the
32,760 x 32,760 logits of a 480p clip never exist at once.  With
``Precision.sites`` each attention call records its shape instead:
``("self", N, T, C, H)`` and ``("cross", N, Tq, Tk, C, H)``.

The residual stream, the norms and the modulation are float32, as Wan
computes them under ``autocast(float32)``; in the fp8 control
(``layers.Precision``) every product takes fp8 operands and every
activation Wan's bf16 model stores (each linear's output, the modulated
norms, the rotated q and k, each attention output) is rounded to bf16.

Where it departs from Wan: the text encoder (umT5-XXL) and the VAE are not
run, and the model time is the unrounded ``1000 sigma``
(``dpm_flow.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv3d, Linear, Precision, set_precision

QUERY_BLOCK = 2048  # query rows of one attention product: 12 x 2048 x 32,760 fp32 logits are 3.2 GB
ROPE_POSITIONS = 1024  # Wan's table length on each axis


def _ints(text) -> Tuple[int, ...]:
    return tuple(int(v) for v in str(text).split(","))


@dataclasses.dataclass(frozen=True)
class WanRefConfig:
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

    @classmethod
    def from_flags(cls, flags: dict) -> "WanRefConfig":
        """From Wan's ``WanModel`` arguments (a configuration file's
        ``model``); full attention, q / k norms and the cross-attention norm
        are the only kind written here."""
        if _ints(flags["window_size"]) != (-1, -1) or not flags["qk_norm"] or not flags["cross_attn_norm"]:
            raise NotImplementedError("windowed attention, or Wan without its q / k or cross-attention norms")
        return cls(dim=int(flags["dim"]), ffn_dim=int(flags["ffn_dim"]), freq_dim=int(flags["freq_dim"]),
                   num_heads=int(flags["num_heads"]), num_layers=int(flags["num_layers"]),
                   in_dim=int(flags["in_dim"]), out_dim=int(flags["out_dim"]), text_len=int(flags["text_len"]),
                   text_dim=int(flags["text_dim"]), patch_size=_ints(flags["patch_size"]), eps=float(flags["eps"]))


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """Wan's time embedding: ``[cos | sin]`` of ``position * 10000^(-j / half)``, float64."""
    half = dim // 2
    position = position.to(torch.float64)
    sinusoid = torch.outer(position, torch.pow(10000, -torch.arange(half, device=position.device)
                                               .to(position).div(half)))
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


def rope_params(max_seq_len: int, dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """``exp(i p theta^(-2j / dim))`` for positions ``p < max_seq_len``, complex128 ``[max_seq_len, dim / 2]``."""
    freqs = torch.outer(torch.arange(max_seq_len, device=device),
                        1.0 / torch.pow(theta, torch.arange(0, dim, 2, device=device).to(torch.float64).div(dim)))
    return torch.polar(torch.ones_like(freqs), freqs)


def rope_freqs(head_dim: int, device=None) -> torch.Tensor:
    """Wan's three tables side by side: frames ``d - 4 (d // 6)`` lanes, rows
    and columns ``2 (d // 6)`` each."""
    d = head_dim
    return torch.cat([rope_params(ROPE_POSITIONS, d - 4 * (d // 6), device=device),
                      rope_params(ROPE_POSITIONS, 2 * (d // 6), device=device),
                      rope_params(ROPE_POSITIONS, 2 * (d // 6), device=device)], dim=1)


def rope_apply(x: torch.Tensor, grid: Tuple[int, int, int], freqs: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [B, T, H, D]`` (T = f h w) as complex pairs, in float64;
    returns float32."""
    b, s, n, d = x.shape
    c = d // 2
    parts = freqs.split([c - 2 * (c // 3), c // 3, c // 3], dim=1)
    f, h, w = grid
    table = torch.cat([
        parts[0][:f].view(f, 1, 1, -1).expand(f, h, w, -1),
        parts[1][:h].view(1, h, 1, -1).expand(f, h, w, -1),
        parts[2][:w].view(1, 1, w, -1).expand(f, h, w, -1),
    ], dim=-1).reshape(s, 1, -1)
    xc = torch.view_as_complex(x.to(torch.float64).reshape(b, s, n, -1, 2))
    return torch.view_as_real(xc * table).flatten(3).float()


def attend(p: Precision, q, k, v, kind: str) -> torch.Tensor:
    """Softmax attention of ``q [N, Tq, H, D]`` over ``k, v [N, Tk, H, D]``,
    scale ``1/sqrt(D)``; ``[N, Tq, H D]``."""
    n, tq, heads, d = q.shape
    tk = k.shape[1]
    if p.sites is not None:
        c = heads * d
        p.sites.append(("self", n, tq, c, heads) if kind == "self" else ("cross", n, tq, tk, c, heads))
        return q.new_zeros(n, tq, c)
    out = q.new_empty(n, tq, heads * d)
    for i in range(n):
        ki, vi = p(k[i]), p(v[i])
        for s in range(0, tq, QUERY_BLOCK):
            logits = torch.einsum("qhd,khd->hqk", p(q[i, s: s + QUERY_BLOCK]), ki) / math.sqrt(d)
            w = torch.softmax(logits, dim=-1)
            del logits
            out[i, s: s + QUERY_BLOCK] = p.act(torch.einsum("hqk,khd->qhd", p(w), vi)).flatten(1)
    return out


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + self.eps) * self.weight


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, eps: float):
        super().__init__()
        self.heads = heads
        self.q, self.k, self.v, self.o = (Linear(dim, dim) for _ in range(4))
        self.norm_q, self.norm_k = RMSNorm(dim, eps), RMSNorm(dim, eps)

    def forward(self, x, grid, freqs):
        b, s, _ = x.shape
        act = self.precision.act
        q = self.norm_q(self.q(x)).view(b, s, self.heads, -1)
        k = self.norm_k(self.k(x)).view(b, s, self.heads, -1)
        v = self.v(x).view(b, s, self.heads, -1)
        if self.precision.sites is None:
            q, k = act(rope_apply(q, grid, freqs)), act(rope_apply(k, grid, freqs))
        return self.o(attend(self.precision, q, k, v, "self"))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, eps: float):
        super().__init__()
        self.heads = heads
        self.q, self.k, self.v, self.o = (Linear(dim, dim) for _ in range(4))
        self.norm_q, self.norm_k = RMSNorm(dim, eps), RMSNorm(dim, eps)

    def forward(self, x, context):
        b = x.shape[0]
        act = self.precision.act
        q = act(self.norm_q(self.q(x))).view(b, -1, self.heads, x.shape[-1] // self.heads)
        k = act(self.norm_k(self.k(context))).view(b, -1, self.heads, x.shape[-1] // self.heads)
        v = self.v(context).view(b, -1, self.heads, x.shape[-1] // self.heads)
        return self.o(attend(self.precision, q, k, v, "cross"))


class AttentionBlock(nn.Module):
    def __init__(self, cfg: WanRefConfig):
        super().__init__()
        self.eps = cfg.eps
        self.self_attn = SelfAttention(cfg.dim, cfg.num_heads, cfg.eps)
        self.norm3 = nn.LayerNorm(cfg.dim, eps=cfg.eps)
        self.cross_attn = CrossAttention(cfg.dim, cfg.num_heads, cfg.eps)
        self.ffn = nn.Sequential(Linear(cfg.dim, cfg.ffn_dim), nn.GELU(approximate="tanh"),
                                 Linear(cfg.ffn_dim, cfg.dim))
        self.modulation = nn.Parameter(torch.randn(1, 6, cfg.dim) / cfg.dim**0.5)

    def norm(self, x):
        return F.layer_norm(x, x.shape[-1:], eps=self.eps)

    def forward(self, x, e, context, grid, freqs):
        act = self.precision.act
        e = (self.modulation + e).chunk(6, dim=1)
        y = self.self_attn(act(self.norm(x) * (1 + e[1]) + e[0]), grid, freqs)
        x = x + y * e[2]
        x = x + self.cross_attn(act(self.norm3(x)), context)
        y = self.ffn[2](act(self.ffn[1](self.ffn[0](act(self.norm(x) * (1 + e[4]) + e[3])))))
        return x + y * e[5]


class Head(nn.Module):
    def __init__(self, cfg: WanRefConfig):
        super().__init__()
        self.eps = cfg.eps
        self.head = Linear(cfg.dim, math.prod(cfg.patch_size) * cfg.out_dim)
        self.modulation = nn.Parameter(torch.randn(1, 2, cfg.dim) / cfg.dim**0.5)

    def forward(self, x, e):
        e = (self.modulation + e.unsqueeze(1)).chunk(2, dim=1)
        return self.head(self.precision.act(F.layer_norm(x, x.shape[-1:], eps=self.eps) * (1 + e[1]) + e[0]))


class WanRef(nn.Module):
    """``(x [B, in_dim, F, H, W], t [B], context [B, L, text_dim])`` ->
    ``[B, out_dim, F, H, W]``, float32."""

    def __init__(self, cfg: WanRefConfig, precision: Precision = None):
        super().__init__()
        self.cfg = cfg
        dim = cfg.dim
        self.patch_embedding = Conv3d(cfg.in_dim, dim, kernel_size=cfg.patch_size, stride=cfg.patch_size)
        self.text_embedding = nn.Sequential(Linear(cfg.text_dim, dim), nn.GELU(approximate="tanh"),
                                            Linear(dim, dim))
        self.time_embedding = nn.Sequential(Linear(cfg.freq_dim, dim), nn.SiLU(), Linear(dim, dim))
        self.time_projection = nn.Sequential(nn.SiLU(), Linear(dim, 6 * dim))
        self.blocks = nn.ModuleList(AttentionBlock(cfg) for _ in range(cfg.num_layers))
        self.head = Head(cfg)
        set_precision(self, precision or Precision())

    def unpatchify(self, x, grid):
        """``[B, T, prod(patch) out_dim]`` -> ``[B, out_dim, F, H, W]`` by Wan's ``fhwpqrc -> cfphqwr``."""
        b = x.shape[0]
        x = x.view(b, *grid, *self.cfg.patch_size, self.cfg.out_dim)
        x = torch.einsum("bfhwpqrc->bcfphqwr", x)
        return x.reshape(b, self.cfg.out_dim, *(g * p for g, p in zip(grid, self.cfg.patch_size)))

    def forward(self, x, t, context):
        act = self.precision.act
        x = self.patch_embedding(act(x.float()))
        grid = tuple(x.shape[2:])
        x = x.flatten(2).transpose(1, 2)
        e = self.time_embedding(sinusoidal_embedding_1d(self.cfg.freq_dim, t).float())
        e0 = self.time_projection(e).unflatten(1, (6, self.cfg.dim))
        context = self.text_embedding(act(context.float()))
        freqs = rope_freqs(self.cfg.dim // self.cfg.num_heads, device=x.device)
        for block in self.blocks:
            x = block(x, e0, context, grid, freqs)
        return self.unpatchify(self.head(x, e), grid)
