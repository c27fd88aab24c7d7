"""The 64->256 super-resolution U-Net (guided-diffusion's upsampler layout),
plain and float32: a frozen copy of the port's ``models/image_unet.py``
(block plan, module tree, ``state_dict`` keys)."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    Conv2d,
    GroupNorm32,
    Linear,
    Precision,
    TimeEmbedding,
    TokenSelfAttention,
    image_downsample,
    image_upsample,
    set_precision,
)


@dataclasses.dataclass(frozen=True)
class SRConfig:
    image_size: int
    small_size: int
    model_channels: int
    num_res_blocks: int
    channel_mult: Tuple[int, ...]
    attention_resolutions: Tuple[int, ...]  # downsample rates
    num_heads: int
    num_head_channels: int
    use_scale_shift_norm: bool
    resblock_updown: bool
    learn_sigma: bool

    @classmethod
    def from_flags(cls, flags: dict) -> "SRConfig":
        """From the SR CLI's flags (a configuration file's ``model``)."""
        large = int(flags["large_size"])
        return cls(
            image_size=large,
            small_size=int(flags["small_size"]),
            model_channels=int(flags["sr_num_channels"]),
            num_res_blocks=int(flags["sr_num_res_blocks"]),
            channel_mult=(1, 1, 2, 2, 4, 4) if large in (256, 512) else (1, 2, 3, 4),
            attention_resolutions=tuple(int(r) for r in str(flags["sr_attention_resolutions"]).split(",")),
            num_heads=int(flags["sr_num_heads"]),
            num_head_channels=int(flags["sr_num_head_channels"]),
            use_scale_shift_norm=bool(flags["sr_use_scale_shift_norm"]),
            resblock_updown=bool(flags["sr_resblock_updown"]),
            learn_sigma=bool(flags["sr_learn_sigma"]),
        )

    def heads(self, ch: int) -> int:
        return self.num_heads if self.num_head_channels == -1 else ch // self.num_head_channels


@dataclasses.dataclass(frozen=True)
class RB:
    in_ch: int
    out_ch: int
    attn_heads: int = 0
    up: bool = False
    down: bool = False


def build_plan(cfg: SRConfig):
    mc = cfg.model_channels
    ch = int(cfg.channel_mult[0] * mc)
    chans = [ch]
    encoder: List[Tuple[Any, ...]] = [("initial",)]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            heads = cfg.heads(int(mult * mc)) if ds in cfg.attention_resolutions else 0
            encoder.append((RB(ch, int(mult * mc), heads),))
            ch = int(mult * mc)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            encoder.append((RB(ch, ch, down=True),) if cfg.resblock_updown else ("downsample",))
            chans.append(ch)
            ds *= 2
    middle = (RB(ch, ch, cfg.heads(ch)), RB(ch, ch))
    decoder: List[Tuple[Any, ...]] = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            heads = cfg.heads(int(mult * mc)) if ds in cfg.attention_resolutions else 0
            specs: List[Any] = [RB(ch + ich, int(mult * mc), heads)]
            ch = int(mult * mc)
            if level and i == cfg.num_res_blocks:
                specs.append(RB(ch, ch, up=True) if cfg.resblock_updown else "upsample")
                ds //= 2
            decoder.append(tuple(specs))
    return tuple(encoder), middle, tuple(decoder), ch


class ResBlock(nn.Module):
    def __init__(self, spec: RB, cfg: SRConfig, emb_ch: int):
        super().__init__()
        self.up, self.down = spec.up, spec.down
        self.scale_shift = cfg.use_scale_shift_norm
        i, o = spec.in_ch, spec.out_ch
        self.in_layers = nn.Sequential(GroupNorm32(i), nn.SiLU(), Conv2d(i, o, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_ch, 2 * o if self.scale_shift else o))
        self.out_layers = nn.Sequential(GroupNorm32(o), nn.SiLU(), nn.Identity(), Conv2d(o, o, 3, padding=1))
        self.skip_connection = nn.Identity() if o == i else Conv2d(i, o, 1)

    def forward(self, x, emb):
        if self.up or self.down:
            resample = image_upsample if self.up else image_downsample
            h = self.in_layers[2](resample(self.in_layers[1](self.in_layers[0](x))))
            x = resample(x)
        else:
            h = self.in_layers(x)
        emb_out = self.emb_layers(emb)
        if self.scale_shift:
            h = self.out_layers[0](h, film=tuple(emb_out.chunk(2, dim=-1)))
        else:
            h = self.out_layers[0](h + emb_out[:, :, None, None])
        return self.precision.act(self.skip_connection(x) + self.out_layers[3](self.out_layers[1](h)))


class Attention(TokenSelfAttention):
    """Spatial self-attention on ``[N, C, H, W]`` (bare GroupNorm, per-head qkv)."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__(channels, num_heads, image=True)

    def forward(self, x):
        n, c, h, w = x.shape
        return super().forward(x.flatten(2).transpose(1, 2)).transpose(1, 2).reshape(n, c, h, w)


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


class SRUNet(nn.Module):
    """``(x [N,H,W,3], t [N], low_res [N,h,w,3])`` -> ``[N,H,W,6]`` (learn
    sigma), float32: ``low_res`` bilinearly upsampled and concatenated."""

    def __init__(self, cfg: SRConfig, precision: Precision = None):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        emb_ch = 4 * mc
        encoder, middle, decoder, out_ch = build_plan(cfg)
        self.time_embed = TimeEmbedding(mc, emb_ch)
        ch = int(cfg.channel_mult[0] * mc)

        def blocks(specs):
            nonlocal ch
            mods = []
            for spec in specs:
                if spec == "initial":
                    mods.append(Conv2d(6, ch, 3, padding=1))
                elif spec == "downsample":
                    mods.append(Downsample(ch))
                elif spec == "upsample":
                    mods.append(Upsample(ch))
                else:
                    mods.append(ResBlock(spec, cfg, emb_ch))
                    ch = spec.out_ch
                    if spec.attn_heads:
                        mods.append(Attention(spec.out_ch, spec.attn_heads))
            return nn.ModuleList(mods)

        self.input_blocks = nn.ModuleList(blocks(s) for s in encoder)
        self.middle_block = blocks(middle)
        self.output_blocks = nn.ModuleList(blocks(s) for s in decoder)
        self.out = nn.Sequential(GroupNorm32(out_ch), nn.SiLU(),
                                 Conv2d(out_ch, 6 if cfg.learn_sigma else 3, 3, padding=1))
        set_precision(self, precision or Precision())

    @staticmethod
    def _run(blocks, h, emb):
        for m in blocks:
            h = m(h, emb) if isinstance(m, ResBlock) else m(h)
        return h

    def forward(self, x, timesteps, low_res):
        x = x.float().permute(0, 3, 1, 2)
        up = F.interpolate(low_res.float().permute(0, 3, 1, 2), size=x.shape[-2:], mode="bilinear",
                           align_corners=False)
        h = self.precision.act(torch.cat([x, up], dim=1))
        emb = self.time_embed(timesteps)
        hs = []
        for blocks in self.input_blocks:
            h = self._run(blocks, h, emb)
            hs.append(h)
        h = self._run(self.middle_block, h, emb)
        for blocks in self.output_blocks:
            h = self._run(blocks, torch.cat([h, hs.pop()], dim=1), emb)
        return self.out(h).permute(0, 2, 3, 1)
