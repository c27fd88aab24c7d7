"""The Stable Diffusion XL base U-Net, plain and float32: SGM's
``openaimodel.UNetModel`` (guided-diffusion's U-Net with spatial
transformers) and ``attention.py``'s ``SpatialTransformer``,
``BasicTransformerBlock``, ``CrossAttention`` and GEGLU ``FeedForward``,
written from SGM's equations.

Parameter names are SGM's ``model.diffusion_model.*`` keys with the prefix
stripped, so one set of seeded weights loads into the port and the
reference alike.  Layouts as in ``layers.py``: channels-last at the edges
(``x [N, H, W, C]``), channels-first inside.  Attention is a plain softmax,
one batch row at a time so that T = 4,096 fits; with ``Precision.sites``
each call records its shape instead: ``("self", N, T, C, H)`` and
``("cross", N, Tq, Tk, C, H)``.

Where it departs from SGM: the model time is the integer timestep the
sampler gives it (``dpm_pp.py``); the unconditional branch's context and
pooled embedding are zeros, which is diffusers' ``force_zeros_for_empty_prompt``
for SDXL base, not a text encoder's output for an empty prompt; the text
encoders and the VAE are not run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    Conv2d,
    GroupNorm32,
    Linear,
    Precision,
    TimeEmbedding,
    image_upsample,
    set_precision,
    timestep_embedding,
)


def _ints(text) -> Tuple[int, ...]:
    return tuple(int(v) for v in str(text).split(","))


@dataclasses.dataclass(frozen=True)
class SDXLConfig:
    in_channels: int
    out_channels: int
    model_channels: int
    num_res_blocks: int
    channel_mult: Tuple[int, ...]
    attention_resolutions: Tuple[int, ...]  # downsample rates
    num_head_channels: int
    transformer_depth: Tuple[int, ...]  # per level; the middle block takes the last
    context_dim: int
    adm_in_channels: int

    @classmethod
    def from_flags(cls, flags: dict) -> "SDXLConfig":
        """From SGM's ``UNetModel`` flags (a configuration file's ``model``;
        ``use_linear_in_transformer`` true, the only kind written here)."""
        if not flags["use_linear_in_transformer"]:
            raise NotImplementedError("the 1x1-conv projections of a spatial transformer")
        mult = _ints(flags["channel_mult"])
        depth = _ints(flags["transformer_depth"])
        depth = depth * len(mult) if len(depth) == 1 else depth
        return cls(
            in_channels=int(flags["in_channels"]),
            out_channels=int(flags["out_channels"]),
            model_channels=int(flags["model_channels"]),
            num_res_blocks=int(flags["num_res_blocks"]),
            channel_mult=mult,
            attention_resolutions=_ints(flags["attention_resolutions"]),
            num_head_channels=int(flags["num_head_channels"]),
            transformer_depth=depth,
            context_dim=int(flags["context_dim"]),
            adm_in_channels=int(flags["adm_in_channels"]),
        )


def vector_condition(pooled: torch.Tensor, sizes, size_dim: int) -> torch.Tensor:
    """SGM's ``y``: the pooled embedding, then each number of ``sizes``
    (original size, crop top-left, target size) as ``size_dim`` sinusoids
    (``ConcatTimestepEmbedderND``)."""
    s = torch.tensor([float(v) for v in sizes], dtype=torch.float32, device=pooled.device)
    emb = timestep_embedding(s, size_dim).reshape(1, -1).expand(pooled.shape[0], -1)
    return torch.cat([pooled.float(), emb], dim=-1)


# -- attention ---------------------------------------------------------------------


def attend(p: Precision, q, k, v, heads: int, kind: str) -> torch.Tensor:
    """Softmax attention of ``q [N, Tq, C]`` over ``k, v [N, Tk, C]`` with
    ``heads`` heads, scale ``1/sqrt(C / heads)``, one batch row at a time."""
    n, tq, c = q.shape
    tk = k.shape[1]
    if p.sites is not None:
        p.sites.append(("self", n, tq, c, heads) if kind == "self" else ("cross", n, tq, tk, c, heads))
        return q.new_zeros(n, tq, c)
    d = c // heads
    rows = []
    for i in range(n):
        qi, ki, vi = (x[i].reshape(-1, heads, d) for x in (q, k, v))
        logits = torch.einsum("qhd,khd->hqk", p(qi), p(ki)) / math.sqrt(d)
        w = torch.softmax(logits, dim=-1)
        rows.append(p.act(torch.einsum("hqk,khd->qhd", p(w), p(vi))).reshape(tq, c))
    return torch.stack(rows)


class LinearNoBias(nn.Linear):
    def __init__(self, i: int, o: int):
        super().__init__(i, o, bias=False)

    def forward(self, x):
        p = self.precision
        return p.act(F.linear(p(x), p(self.weight)))


class LayerNorm(nn.LayerNorm):
    """LayerNorm, eps 1e-5."""

    def forward(self, x):
        p = self.precision
        return p.act(F.layer_norm(p.act(x.float()), self.normalized_shape, self.weight, self.bias, self.eps))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int = 0):
        super().__init__()
        self.heads = heads
        self.to_q = LinearNoBias(dim, dim)
        self.to_k = LinearNoBias(context_dim or dim, dim)
        self.to_v = LinearNoBias(context_dim or dim, dim)
        self.to_out = nn.Sequential(Linear(dim, dim), nn.Identity())

    def forward(self, x, context=None):
        kind = "self" if context is None else "cross"
        src = x if context is None else context
        out = attend(self.precision, self.to_q(x), self.to_k(src), self.to_v(src), self.heads, kind)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, 2 * dim_out)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return self.precision.act(a * F.gelu(gate))  # exact (erf) GELU


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, mult * dim), nn.Identity(), Linear(mult * dim, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, context_dim)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context):
        act = self.precision.act
        x = act(self.attn1(self.norm1(x)) + x)
        x = act(self.attn2(self.norm2(x), context) + x)
        return act(self.ff(self.norm3(x)) + x)


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, heads: int, depth: int, context_dim: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.norm.eps = 1e-6  # SGM's Normalize
        self.proj_in = Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, heads, context_dim) for _ in range(depth))
        self.proj_out = Linear(channels, channels)

    def forward(self, x, context):
        n, c, h, w = x.shape
        tokens = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        for block in self.transformer_blocks:
            tokens = block(tokens, context)
        return self.precision.act(self.proj_out(tokens).transpose(1, 2).reshape(n, c, h, w) + x)


# -- the U-Net ---------------------------------------------------------------------


class ResBlock(nn.Module):
    """SGM's ResBlock without scale-shift norm or resampling."""

    def __init__(self, i: int, o: int, emb_ch: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(i), nn.SiLU(), Conv2d(i, o, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_ch, o))
        self.out_layers = nn.Sequential(GroupNorm32(o), nn.SiLU(), nn.Identity(), Conv2d(o, o, 3, padding=1))
        self.skip_connection = nn.Identity() if o == i else Conv2d(i, o, 1)

    def forward(self, x, emb):
        h = self.in_layers(x)
        h = self.out_layers(self.precision.act(h + self.emb_layers(emb)[:, :, None, None]))
        return self.precision.act(self.skip_connection(x) + h)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(image_upsample(x))


class SDXLUNet(nn.Module):
    """``(x [N, H, W, C], t [N], context [N, L, context_dim], y [N,
    adm_in_channels])`` -> ``[N, H, W, out_channels]``, float32."""

    def __init__(self, cfg: SDXLConfig, precision: Precision = None):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        emb_ch = 4 * mc
        self.time_embed = TimeEmbedding(mc, emb_ch)
        self.label_emb = nn.Sequential(nn.Sequential(Linear(cfg.adm_in_channels, emb_ch), nn.SiLU(),
                                                     Linear(emb_ch, emb_ch)))

        def transformer(ch, depth):
            return SpatialTransformer(ch, ch // cfg.num_head_channels, depth, cfg.context_dim)

        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(cfg.in_channels, mc, 3, padding=1)])])
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [ResBlock(ch, mult * mc, emb_ch)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(transformer(ch, cfg.transformer_depth[level]))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb_ch), transformer(ch, cfg.transformer_depth[-1]),
                                           ResBlock(ch, ch, emb_ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), mult * mc, emb_ch)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers.append(transformer(ch, cfg.transformer_depth[level]))
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), Conv2d(ch, cfg.out_channels, 3, padding=1))
        set_precision(self, precision or Precision())

    @staticmethod
    def _run(blocks, h, emb, context):
        for m in blocks:
            if isinstance(m, ResBlock):
                h = m(h, emb)
            elif isinstance(m, SpatialTransformer):
                h = m(h, context)
            else:
                h = m(h)
        return h

    def forward(self, x, timesteps, context, y):
        act = self.precision.act
        h = act(x.float().permute(0, 3, 1, 2))
        emb = act(self.time_embed(timesteps) + self.label_emb(act(y.float())))
        context = act(context.float())
        hs = []
        for blocks in self.input_blocks:
            h = self._run(blocks, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context)
        for blocks in self.output_blocks:
            h = self._run(blocks, torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h).permute(0, 2, 3, 1)

