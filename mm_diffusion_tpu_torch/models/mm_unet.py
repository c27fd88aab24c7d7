"""The coupled audio-video MM-UNet (counterpart of
``mm_diffusion_tpu/models/mm_unet.py``).

The structural plan (:func:`build_plan`) is the JAX package's, line for
line; the module tree is the original PyTorch model's, so its
``state_dict`` keys (``input_blocks.<i>.<j>...``, ``middle_blocks.<j>...``,
``output_blocks.<i>.<j>...``) load unchanged.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import RSMMACrossAttention, TokenSelfAttention, factorized_video_attention
from .layers import (
    DTYPES,
    AudioConv,
    Linear,
    MMNorm,
    TimeEmbedding,
    VideoConv,
    audio_downsample,
    audio_upsample,
    norm_silu_then,
    video_downsample,
    video_upsample,
    zero_module,
)

Shift = Union[None, int, torch.Generator]


@dataclasses.dataclass(frozen=True)
class MMUNetConfig:
    """Mirrors the reference model config surface."""

    video_size: Tuple[int, int, int, int] = (16, 3, 64, 64)  # (F, C, H, W)
    audio_size: Tuple[int, int] = (1, 25600)  # (C, L)
    model_channels: int = 128
    video_out_channels: int = 3  # 6 when learn_sigma
    audio_out_channels: int = 1  # 2 when learn_sigma
    num_res_blocks: int = 2
    cross_attention_resolutions: Tuple[int, ...] = (2, 4, 8)
    cross_attention_windows: Tuple[int, ...] = (1, 4, 8)
    cross_attention_shift: bool = True
    video_attention_resolutions: Tuple[int, ...] = (2, 4, 8)
    audio_attention_resolutions: Tuple[int, ...] = (-1,)
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    dropout: float = 0.0
    num_heads: int = 4
    num_head_channels: int = -1
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    video_type: str = "2d+1d"
    dtype: str = "bfloat16"  # compute dtype
    use_checkpoint: bool = False  # recompute the ResBlocks' conv path in the backward

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def cross_heads(self, ch: int) -> int:
        """Cross-attention obeys num_head_channels; self-attention always
        uses num_heads."""
        if self.num_head_channels == -1:
            return self.num_heads
        if ch % self.num_head_channels:
            raise ValueError(f"{ch} channels do not split into heads of {self.num_head_channels}")
        return ch // self.num_head_channels


@dataclasses.dataclass(frozen=True)
class ResBlockSpec:
    in_ch: int
    out_ch: int
    audio_dilation: int
    video_attention: bool = False
    audio_attention: bool = False
    up: bool = False
    down: bool = False


@dataclasses.dataclass(frozen=True)
class CrossAttnSpec:
    ch: int
    heads: int
    local_window: int
    window_shift: bool


@dataclasses.dataclass(frozen=True)
class UNetPlan:
    encoder: Tuple[Tuple[Any, ...], ...]
    middle: Tuple[Any, ...]
    decoder: Tuple[Tuple[Any, ...], ...]
    out_ch: int


MAX_DILATION_EXP = 10  # audio conv dilation cycles 2^(i % 10)


def build_plan(cfg: MMUNetConfig) -> UNetPlan:
    """Channel mults, the audio-dilation counter (up through the encoder,
    down through the decoder), cross-attention placement by downsample rate
    and skip wiring -- the same bookkeeping as the JAX package."""
    mc = cfg.model_channels
    ch = int(cfg.channel_mult[0] * mc)
    input_block_chans = [ch]
    encoder: List[Tuple[Any, ...]] = [("initial",)]
    ds = 1
    dilation = 1

    def d2(d):
        return 2 ** (d % MAX_DILATION_EXP)

    def cross(ch):
        i = cfg.cross_attention_resolutions.index(ds)
        return CrossAttnSpec(
            ch=ch,
            heads=cfg.cross_heads(ch),
            local_window=cfg.cross_attention_windows[i],
            window_shift=cfg.cross_attention_shift,
        )

    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            specs: List[Any] = [
                ResBlockSpec(
                    in_ch=ch,
                    out_ch=int(mult * mc),
                    audio_dilation=d2(dilation),
                    video_attention=ds in cfg.video_attention_resolutions,
                    audio_attention=ds in cfg.audio_attention_resolutions,
                )
            ]
            dilation += 1
            ch = int(mult * mc)
            if ds in cfg.cross_attention_resolutions:
                specs.append(cross(ch))
            encoder.append(tuple(specs))
            input_block_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            encoder.append(
                (ResBlockSpec(in_ch=ch, out_ch=ch, audio_dilation=d2(dilation), down=True),)
            )
            dilation += 1
            input_block_chans.append(ch)
            ds *= 2

    middle_res = ResBlockSpec(
        in_ch=ch, out_ch=ch, audio_dilation=d2(dilation),
        video_attention=True, audio_attention=True,
    )
    middle: List[Any] = [middle_res]
    # the middle full-window cross-attention exists only for windows (1,4,8)
    if tuple(cfg.cross_attention_windows) == (1, 4, 8):
        middle.append(
            CrossAttnSpec(
                ch=ch, heads=cfg.cross_heads(ch),
                local_window=cfg.video_size[0], window_shift=False,
            )
        )
    middle.append(middle_res)

    decoder: List[Tuple[Any, ...]] = []
    chans = list(input_block_chans)
    dilation -= 1
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for block_id in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            specs = [
                ResBlockSpec(
                    in_ch=ch + ich,
                    out_ch=int(mult * mc),
                    audio_dilation=d2(dilation),
                    video_attention=ds in cfg.video_attention_resolutions,
                    audio_attention=ds in cfg.audio_attention_resolutions,
                )
            ]
            dilation -= 1
            ch = int(mult * mc)
            if ds in cfg.cross_attention_resolutions:
                specs.append(cross(ch))
            if level and block_id == cfg.num_res_blocks:
                # resblock_updown=False: a parameter-free upsample marker
                # keeps the skip shapes valid (the JAX package's choice).
                if cfg.resblock_updown:
                    specs.append(
                        ResBlockSpec(in_ch=ch, out_ch=ch, audio_dilation=d2(dilation), up=True)
                    )
                else:
                    specs.append("upsample")
                ds //= 2
            decoder.append(tuple(specs))

    return UNetPlan(
        encoder=tuple(encoder),
        middle=tuple(middle),
        decoder=tuple(decoder),
        out_ch=ch,
    )


def remat_min_tokens() -> int:
    """Video tokens (F*H*W) a ResBlock's input needs before ``use_checkpoint``
    recomputes it (``MMDIFF_REMAT_MIN_TOKENS``, default 4096, as in the JAX
    package): below it the saved activations are small and the recompute
    would cost a full low-resolution forward."""
    return int(os.environ.get("MMDIFF_REMAT_MIN_TOKENS", "4096"))


class MMResBlock(nn.Module):
    """Dual-stream residual block with a shared timestep embedding: per
    modality GN -> SiLU -> conv, FiLM (or additive) conditioning, GN -> SiLU
    -> dropout -> zero-init 1x1 conv, plus a skip; optional up/down
    resampling after ``in_layers`` and per-modality self-attention.

    ``remat=True`` recomputes the residual (conv) path in the backward
    (``torch.utils.checkpoint``, the RNG state of its dropout preserved);
    the self-attention that follows keeps its activations, as the JAX
    package's remat policy saves the attention kernels' inputs and outputs.
    """

    def __init__(self, spec: ResBlockSpec, cfg: MMUNetConfig):
        super().__init__()
        self.spec = spec
        self.use_scale_shift_norm = cfg.use_scale_shift_norm
        i, o = spec.in_ch, spec.out_ch
        self.video_in_layers = nn.Sequential(
            MMNorm(i), nn.SiLU(), VideoConv(i, o, 3, cfg.video_type)
        )
        self.audio_in_layers = nn.Sequential(
            MMNorm(i), nn.SiLU(), AudioConv(i, o, 3, spec.audio_dilation)
        )
        emb_out = 2 * o if cfg.use_scale_shift_norm else o
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(cfg.model_channels, emb_out))
        self.video_out_layers = nn.Sequential(
            MMNorm(o), nn.SiLU(), nn.Dropout(cfg.dropout),
            zero_module(VideoConv(o, o, 1, "3d")),
        )
        self.audio_out_layers = nn.Sequential(
            MMNorm(o), nn.SiLU(), nn.Dropout(cfg.dropout), zero_module(AudioConv(o, o, 1)),
        )
        if o != i:
            self.video_skip_connection = VideoConv(i, o, 1, "3d")
            self.audio_skip_connection = AudioConv(i, o, 1)
        if spec.video_attention:
            self.spatial_attention_block = TokenSelfAttention(o, cfg.num_heads)
            self.temporal_attention_block = TokenSelfAttention(o, cfg.num_heads)
        if spec.audio_attention:
            self.audio_attention_block = TokenSelfAttention(o, cfg.num_heads)

    @staticmethod
    def _out(layers, h, film, add):
        if add is not None:
            h = h + add
        return norm_silu_then(layers, h, film)

    def forward(self, video, audio, emb, remat: bool = False):
        if remat:
            video, audio = checkpoint(self.residual, video, audio, emb, use_reentrant=False)
        else:
            video, audio = self.residual(video, audio, emb)
        if self.spec.video_attention:
            video = factorized_video_attention(
                video, self.spatial_attention_block, self.temporal_attention_block
            )
        if self.spec.audio_attention:
            audio = self.audio_attention_block(audio.transpose(1, 2)).transpose(1, 2)
        return video, audio

    def residual(self, video, audio, emb):
        spec = self.spec
        vh = norm_silu_then(self.video_in_layers, video)
        ah = norm_silu_then(self.audio_in_layers, audio)
        if spec.down:
            vh, video = video_downsample(vh), video_downsample(video)
            ah, audio = audio_downsample(ah), audio_downsample(audio)
        elif spec.up:
            vh, video = video_upsample(vh), video_upsample(video)
            ah, audio = audio_upsample(ah), audio_upsample(audio)

        emb_out = self.emb_layers(emb)
        if self.use_scale_shift_norm:
            film = tuple(emb_out.chunk(2, dim=-1))
            vh = self._out(self.video_out_layers, vh, film, None)
            ah = self._out(self.audio_out_layers, ah, film, None)
        else:
            vh = self._out(self.video_out_layers, vh, None, emb_out[:, :, None, None, None])
            ah = self._out(self.audio_out_layers, ah, None, emb_out[:, :, None])

        if spec.out_ch != spec.in_ch:
            video = self.video_skip_connection(video)
            audio = self.audio_skip_connection(audio)
        return video + vh, audio + ah


class InitialBlock(nn.Module):
    """First conv of each stream."""

    def __init__(self, video_ch: int, audio_ch: int, out_ch: int):
        super().__init__()
        self.video_conv = VideoConv(video_ch, out_ch, 3, "2d+1d")
        self.audio_conv = AudioConv(audio_ch, out_ch, 3)

    def forward(self, video, audio):
        return self.video_conv(video), self.audio_conv(audio)


class Upsample(nn.Module):
    """The parameter-free upsample marker of ``resblock_updown=False``."""

    def forward(self, video, audio):
        return video_upsample(video), audio_upsample(audio)


class MultimodalUNet(nn.Module):
    """``(video [B,F,H,W,C], audio [B,L,C], timesteps [B])`` ->
    ``(video_out [B,F,H,W,Cout], audio_out [B,L,Cout])``, fp32.

    ``shift`` sets the RS-MMA window shift of the shifting cross-attention
    sites: ``None`` (shift 0), an int used at every site, or a CPU
    ``torch.Generator`` from which each site draws its own shift in
    ``[0, F - lw]`` (the sampler's per-evaluation draw, and training's).

    Training mode: dropout is active under ``model.train()``; with
    ``cfg.use_checkpoint`` each ResBlock whose input holds at least
    :func:`remat_min_tokens` video tokens recomputes its conv path in the
    backward whenever gradients are taken.
    """

    def __init__(self, cfg: MMUNetConfig):
        super().__init__()
        self.cfg = cfg
        self.plan = build_plan(cfg)
        mc = cfg.model_channels
        self.time_embed = TimeEmbedding(mc, mc)

        def block(spec):
            if spec == "initial":
                return InitialBlock(
                    cfg.video_size[1], cfg.audio_size[0], int(cfg.channel_mult[0] * mc)
                )
            if spec == "upsample":
                return Upsample()
            if isinstance(spec, ResBlockSpec):
                return MMResBlock(spec, cfg)
            if isinstance(spec, CrossAttnSpec):
                return RSMMACrossAttention(spec.ch, spec.heads, spec.local_window, spec.window_shift)
            raise ValueError(spec)

        self.input_blocks = nn.ModuleList(
            nn.ModuleList(block(s) for s in specs) for specs in self.plan.encoder
        )
        self.middle_blocks = nn.ModuleList(block(s) for s in self.plan.middle)
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(block(s) for s in specs) for specs in self.plan.decoder
        )
        ch = self.plan.out_ch
        self.video_out = nn.Sequential(
            MMNorm(ch), nn.SiLU(), zero_module(VideoConv(ch, cfg.video_out_channels, 3, "3d"))
        )
        self.audio_out = nn.Sequential(
            MMNorm(ch), nn.SiLU(), zero_module(AudioConv(ch, cfg.audio_out_channels, 3))
        )

    @staticmethod
    def _site_shift(block: RSMMACrossAttention, frames: int, shift: Shift) -> int:
        if not block.window_shift or shift is None:
            return 0
        span = frames - block.window(frames)
        if isinstance(shift, torch.Generator):
            return int(torch.randint(0, span + 1, (1,), generator=shift))
        if not 0 <= int(shift) <= span:
            raise ValueError(f"shift {shift} outside [0, {span}] at a window-{block.local_window} site")
        return int(shift)

    def _remat(self, video) -> bool:
        if not (self.cfg.use_checkpoint and torch.is_grad_enabled()):
            return False
        f, h, w = video.shape[2:]
        return f * h * w >= remat_min_tokens()

    def _run(self, blocks, video, audio, emb, shift):
        for blk in blocks:
            if isinstance(blk, MMResBlock):
                video, audio = blk(video, audio, emb, remat=self._remat(video))
            elif isinstance(blk, RSMMACrossAttention):
                video, audio = blk(video, audio, self._site_shift(blk, video.shape[2], shift))
            else:
                video, audio = blk(video, audio)
        return video, audio

    def forward(self, video, audio, timesteps, shift: Shift = None):
        dt = self.cfg.compute_dtype
        emb = self.time_embed(timesteps, dt)

        video = video.to(dt).permute(0, 4, 1, 2, 3).contiguous()
        audio = audio.to(dt).transpose(1, 2).contiguous()
        skips = []
        for blocks in self.input_blocks:
            video, audio = self._run(blocks, video, audio, emb, shift)
            skips.append((video, audio))
        video, audio = self._run(self.middle_blocks, video, audio, emb, shift)
        for blocks in self.output_blocks:
            sv, sa = skips.pop()
            video, audio = self._run(
                blocks, torch.cat([video, sv], dim=1), torch.cat([audio, sa], dim=1), emb, shift
            )
        video = norm_silu_then(self.video_out, video).float().permute(0, 2, 3, 4, 1)
        audio = norm_silu_then(self.audio_out, audio).float().transpose(1, 2)
        return video, audio
