"""The coupled audio-video MM-UNet of MM-Diffusion, plain and float32: a
frozen copy of the port's ``models/mm_unet.py`` (block plan, module tree
and ``state_dict`` keys), with the attention written out in
``layers.py``.  The RS-MMA shift of each shifting site is drawn, in the
order the sites run, from a host ``torch.Generator``:
``randint(0, F - lw + 1)``."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch
from torch import nn

from .layers import (
    AudioConv,
    Conv1d,
    Linear,
    MMNorm,
    Precision,
    TimeEmbedding,
    TokenSelfAttention,
    VideoConv,
    audio_downsample,
    audio_upsample,
    banded_cross_attention,
    pointwise,
    set_precision,
    video_downsample,
    video_upsample,
)


def _ints(s) -> Tuple[int, ...]:
    if isinstance(s, (list, tuple)):
        return tuple(int(v) for v in s)
    return tuple(int(v) for v in str(s).split(","))


@dataclasses.dataclass(frozen=True)
class MMConfig:
    video_size: Tuple[int, ...]  # (F, C, H, W)
    audio_size: Tuple[int, ...]  # (C, L)
    model_channels: int
    num_res_blocks: int
    channel_mult: Tuple[int, ...]
    cross_attention_resolutions: Tuple[int, ...]
    cross_attention_windows: Tuple[int, ...]
    cross_attention_shift: bool
    video_attention_resolutions: Tuple[int, ...]
    audio_attention_resolutions: Tuple[int, ...]
    num_heads: int
    num_head_channels: int
    use_scale_shift_norm: bool
    resblock_updown: bool
    learn_sigma: bool

    @classmethod
    def from_flags(cls, flags: dict) -> "MMConfig":
        """From the reference CLI's flags (a configuration file's ``model``)."""
        return cls(
            video_size=_ints(flags["video_size"]),
            audio_size=_ints(flags["audio_size"]),
            model_channels=int(flags["num_channels"]),
            num_res_blocks=int(flags["num_res_blocks"]),
            channel_mult=_ints(flags["channel_mult"]),
            cross_attention_resolutions=_ints(flags["cross_attention_resolutions"]),
            cross_attention_windows=_ints(flags["cross_attention_windows"]),
            cross_attention_shift=bool(flags["cross_attention_shift"]),
            video_attention_resolutions=_ints(flags["video_attention_resolutions"]),
            audio_attention_resolutions=_ints(flags["audio_attention_resolutions"]),
            num_heads=int(flags["num_heads"]),
            num_head_channels=int(flags["num_head_channels"]),
            use_scale_shift_norm=bool(flags["use_scale_shift_norm"]),
            resblock_updown=bool(flags["resblock_updown"]),
            learn_sigma=bool(flags["learn_sigma"]),
        )

    def cross_heads(self, ch: int) -> int:
        return self.num_heads if self.num_head_channels == -1 else ch // self.num_head_channels


@dataclasses.dataclass(frozen=True)
class ResSpec:
    in_ch: int
    out_ch: int
    audio_dilation: int
    video_attention: bool = False
    audio_attention: bool = False
    up: bool = False
    down: bool = False


@dataclasses.dataclass(frozen=True)
class CrossSpec:
    ch: int
    heads: int
    local_window: int
    window_shift: bool


def build_plan(cfg: MMConfig):
    """(encoder, middle, decoder, out channels): the original's block
    placement, the audio dilation ``2 ** (i % 10)`` counted up through the
    encoder and down through the decoder."""
    mc = cfg.model_channels
    ch = int(cfg.channel_mult[0] * mc)
    chans = [ch]
    encoder: List[Tuple[Any, ...]] = [("initial",)]
    ds, dil = 1, 1

    def d2(d):
        return 2 ** (d % 10)

    def cross(ch):
        i = cfg.cross_attention_resolutions.index(ds)
        return CrossSpec(ch, cfg.cross_heads(ch), cfg.cross_attention_windows[i], cfg.cross_attention_shift)

    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            specs: List[Any] = [ResSpec(ch, int(mult * mc), d2(dil),
                                        ds in cfg.video_attention_resolutions,
                                        ds in cfg.audio_attention_resolutions)]
            dil += 1
            ch = int(mult * mc)
            if ds in cfg.cross_attention_resolutions:
                specs.append(cross(ch))
            encoder.append(tuple(specs))
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            encoder.append((ResSpec(ch, ch, d2(dil), down=True),))
            dil += 1
            chans.append(ch)
            ds *= 2

    mid = ResSpec(ch, ch, d2(dil), True, True)
    middle: List[Any] = [mid]
    if tuple(cfg.cross_attention_windows) == (1, 4, 8):
        middle.append(CrossSpec(ch, cfg.cross_heads(ch), cfg.video_size[0], False))
    middle.append(mid)

    decoder: List[Tuple[Any, ...]] = []
    dil -= 1
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for block_id in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            specs = [ResSpec(ch + ich, int(mult * mc), d2(dil),
                             ds in cfg.video_attention_resolutions,
                             ds in cfg.audio_attention_resolutions)]
            dil -= 1
            ch = int(mult * mc)
            if ds in cfg.cross_attention_resolutions:
                specs.append(cross(ch))
            if level and block_id == cfg.num_res_blocks:
                specs.append(ResSpec(ch, ch, d2(dil), up=True) if cfg.resblock_updown else "upsample")
                ds //= 2
            decoder.append(tuple(specs))
    return tuple(encoder), tuple(middle), tuple(decoder), ch


def factorized_video_attention(x, spatial: TokenSelfAttention, temporal: TokenSelfAttention):
    """Spatial attention (H*W tokens a frame), then temporal (F tokens a pixel)."""
    b, c, f, h, w = x.shape
    xs = spatial(x.permute(0, 2, 3, 4, 1).reshape(b * f, h * w, c))
    xt = temporal(xs.reshape(b, f, h * w, c).transpose(1, 2).reshape(b * h * w, f, c))
    return xt.reshape(b, h, w, f, c).permute(0, 4, 3, 1, 2)


class RSMMA(nn.Module):
    """Random-shift multi-modal attention (the original's CrossAttentionBlock)."""

    def __init__(self, spec: CrossSpec):
        super().__init__()
        c = spec.ch
        self.spec = spec
        self.v_norm = MMNorm(c)
        self.a_norm = MMNorm(c)
        self.v_qkv = Conv1d(c, 3 * c, 1)
        self.a_qkv = Conv1d(c, 3 * c, 1)
        self.video_proj_out = VideoConv(c, c, 1, "3d")
        self.audio_proj_out = AudioConv(c, c, 1)

    def forward(self, video, audio, shift: int):
        b, c, f, h, w = video.shape
        length = audio.shape[-1]
        lw = min(self.spec.local_window, f)
        vn = self.v_norm(video).permute(0, 2, 3, 4, 1).reshape(b, f, h * w, c)
        an = self.a_norm(audio).transpose(1, 2).reshape(b, f, length // f, c)
        v_qkv, a_qkv = pointwise(vn, self.v_qkv), pointwise(an, self.a_qkv)
        p, nh = self.precision, self.spec.heads
        v_out = banded_cross_attention(p, v_qkv, a_qkv, shift, lw, nh, c)
        a_out = banded_cross_attention(p, a_qkv, v_qkv, shift, lw, nh, c)
        v_out = pointwise(v_out, self.video_proj_out.video_conv).reshape(b, f, h, w, c)
        a_out = pointwise(a_out, self.audio_proj_out.audio_conv).reshape(b, length, c)
        return p.act(video + v_out.permute(0, 4, 1, 2, 3)), p.act(audio + a_out.transpose(1, 2))


class ResBlock(nn.Module):
    """Dual-stream residual block (the original's keys), optional up/down
    resampling after ``in_layers`` and per-modality self-attention."""

    def __init__(self, spec: ResSpec, cfg: MMConfig):
        super().__init__()
        self.spec = spec
        self.scale_shift = cfg.use_scale_shift_norm
        i, o = spec.in_ch, spec.out_ch
        self.video_in_layers = nn.Sequential(MMNorm(i), nn.SiLU(), VideoConv(i, o, 3, "2d+1d"))
        self.audio_in_layers = nn.Sequential(MMNorm(i), nn.SiLU(), AudioConv(i, o, 3, spec.audio_dilation))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(cfg.model_channels, 2 * o if self.scale_shift else o))
        self.video_out_layers = nn.Sequential(MMNorm(o), nn.SiLU(), nn.Identity(), VideoConv(o, o, 1, "3d"))
        self.audio_out_layers = nn.Sequential(MMNorm(o), nn.SiLU(), nn.Identity(), AudioConv(o, o, 1))
        if o != i:
            self.video_skip_connection = VideoConv(i, o, 1, "3d")
            self.audio_skip_connection = AudioConv(i, o, 1)
        if spec.video_attention:
            self.spatial_attention_block = TokenSelfAttention(o, cfg.num_heads)
            self.temporal_attention_block = TokenSelfAttention(o, cfg.num_heads)
        if spec.audio_attention:
            self.audio_attention_block = TokenSelfAttention(o, cfg.num_heads)

    def _out(self, layers, h, emb_out, extra_dims):
        if self.scale_shift:
            h = layers[0](h, film=tuple(emb_out.chunk(2, dim=-1)))
        else:
            h = layers[0](h + emb_out.reshape(emb_out.shape + (1,) * extra_dims))
        return layers[3](layers[1](h))

    def forward(self, video, audio, emb):
        s = self.spec
        vh, ah = self.video_in_layers(video), self.audio_in_layers(audio)
        if s.down:
            vh, video, ah, audio = (video_downsample(vh), video_downsample(video),
                                    audio_downsample(ah), audio_downsample(audio))
        elif s.up:
            vh, video, ah, audio = (video_upsample(vh), video_upsample(video),
                                    audio_upsample(ah), audio_upsample(audio))
        emb_out = self.emb_layers(emb)
        vh = self._out(self.video_out_layers, vh, emb_out, 3)
        ah = self._out(self.audio_out_layers, ah, emb_out, 1)
        if s.out_ch != s.in_ch:
            video, audio = self.video_skip_connection(video), self.audio_skip_connection(audio)
        video, audio = self.precision.act(video + vh), self.precision.act(audio + ah)
        if s.video_attention:
            video = factorized_video_attention(video, self.spatial_attention_block,
                                               self.temporal_attention_block)
        if s.audio_attention:
            audio = self.audio_attention_block(audio.transpose(1, 2)).transpose(1, 2)
        return video, audio


class Initial(nn.Module):
    def __init__(self, video_ch: int, audio_ch: int, out_ch: int):
        super().__init__()
        self.video_conv = VideoConv(video_ch, out_ch, 3, "2d+1d")
        self.audio_conv = AudioConv(audio_ch, out_ch, 3)

    def forward(self, video, audio):
        return self.video_conv(video), self.audio_conv(audio)


class Upsample(nn.Module):
    def forward(self, video, audio):
        return video_upsample(video), audio_upsample(audio)


class MMUNet(nn.Module):
    """``(video [B,F,H,W,C], audio [B,L,C], t [B], shift_gen)`` ->
    ``(video_out, audio_out)``, channels-last, float32."""

    def __init__(self, cfg: MMConfig, precision: Precision = None):
        super().__init__()
        self.cfg = cfg
        encoder, middle, decoder, out_ch = build_plan(cfg)
        mc = cfg.model_channels
        self.time_embed = TimeEmbedding(mc, mc)

        def block(spec):
            if spec == "initial":
                return Initial(cfg.video_size[1], cfg.audio_size[0], int(cfg.channel_mult[0] * mc))
            if spec == "upsample":
                return Upsample()
            return ResBlock(spec, cfg) if isinstance(spec, ResSpec) else RSMMA(spec)

        self.input_blocks = nn.ModuleList(nn.ModuleList(block(s) for s in specs) for specs in encoder)
        self.middle_blocks = nn.ModuleList(block(s) for s in middle)
        self.output_blocks = nn.ModuleList(nn.ModuleList(block(s) for s in specs) for specs in decoder)
        vo, ao = (6, 2) if cfg.learn_sigma else (3, 1)
        self.video_out = nn.Sequential(MMNorm(out_ch), nn.SiLU(), VideoConv(out_ch, vo, 3, "3d"))
        self.audio_out = nn.Sequential(MMNorm(out_ch), nn.SiLU(), AudioConv(out_ch, ao, 3))
        set_precision(self, precision or Precision())

    def _run(self, blocks, video, audio, emb, shift_gen):
        for blk in blocks:
            if isinstance(blk, ResBlock):
                video, audio = blk(video, audio, emb)
            elif isinstance(blk, RSMMA):
                f = video.shape[2]
                span = f - min(blk.spec.local_window, f)
                shift = 0
                if blk.spec.window_shift and shift_gen is not None:
                    shift = int(torch.randint(0, span + 1, (1,), generator=shift_gen))
                video, audio = blk(video, audio, shift)
            else:
                video, audio = blk(video, audio)
        return video, audio

    def forward(self, video, audio, timesteps, shift_gen=None):
        emb = self.time_embed(timesteps)
        video = self.precision.act(video.float()).permute(0, 4, 1, 2, 3)
        audio = self.precision.act(audio.float()).transpose(1, 2)
        skips = []
        for blocks in self.input_blocks:
            video, audio = self._run(blocks, video, audio, emb, shift_gen)
            skips.append((video, audio))
        video, audio = self._run(self.middle_blocks, video, audio, emb, shift_gen)
        for blocks in self.output_blocks:
            sv, sa = skips.pop()
            video, audio = self._run(blocks, torch.cat([video, sv], 1), torch.cat([audio, sa], 1),
                                     emb, shift_gen)
        return self.video_out(video).permute(0, 2, 3, 4, 1), self.audio_out(audio).transpose(1, 2)
