"""Single-modality diffusion U-Nets: plain video (3-D stream) and plain audio
(dilated 1-D stream) (counterpart of ``mm_diffusion_tpu/models/single_unet.py``).

Each is one stream of the MM-UNet with the cross-modal attention removed:
the same per-level plan (channel mults, the audio-dilation counter,
space-only / 4x-length resampling), the same blocks (``models/layers.py``,
``models/attention.py``).  Video attention is the factorised spatial +
temporal block, audio attention one token self-attention; both reach the
self-attention kernel (K1) and its backward (K4/K5) through
``ops/block_attention.self_attention``.

The reference ships no concrete single-modal architecture, so there is no
published ``state_dict`` to match; the module names follow the MM-UNet's
(``input_blocks.<i>.<j>``, ``middle_blocks.<j>``, ``output_blocks.<i>.<j>``,
``time_embed``, ``out``) with one stream, and ``weights.py`` maps the JAX
package's parameters onto them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import TokenSelfAttention, factorized_video_attention
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
from .mm_unet import MAX_DILATION_EXP, remat_min_tokens


@dataclasses.dataclass(frozen=True)
class SingleUNetConfig:
    """The MM-UNet's config fields that apply to one stream; ``modality``
    selects it.  The JAX package computes this model in bf16 whatever
    ``use_fp16`` says, hence the default."""

    modality: str = "video"  # "video" | "audio"
    video_size: Tuple[int, int, int, int] = (16, 3, 64, 64)  # (F, C, H, W)
    audio_size: Tuple[int, int] = (1, 25600)  # (C, L)
    model_channels: int = 128
    out_channels: int = 3  # 2x when learn_sigma
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (2, 4, 8)
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    dropout: float = 0.0
    num_heads: int = 4
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    video_type: str = "2d+1d"
    use_checkpoint: bool = False  # recompute the ResBlocks' conv path in the backward
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.modality not in ("video", "audio"):
            raise ValueError(f"modality {self.modality!r} not in ('video', 'audio')")

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def in_channels(self) -> int:
        return self.video_size[1] if self.modality == "video" else self.audio_size[0]

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        """Channels-last sample shape (without batch)."""
        if self.modality == "video":
            f, c, h, w = self.video_size
            return (f, h, w, c)
        ca, length = self.audio_size
        return (length, ca)


@dataclasses.dataclass(frozen=True)
class SingleBlockSpec:
    in_ch: int
    out_ch: int
    dilation: int = 1
    attention: bool = False
    up: bool = False
    down: bool = False


def build_single_plan(cfg: SingleUNetConfig):
    """(encoder, middle, decoder) block specs, as in the JAX package: the
    audio-dilation counter increments per encoder ResBlock and walks back
    down through the decoder; attention where the downsample rate is in
    ``attention_resolutions`` and in both middle blocks."""
    mc = cfg.model_channels
    ch = int(cfg.channel_mult[0] * mc)
    input_chans = [ch]
    encoder: List[Tuple[Any, ...]] = [("initial",)]
    ds, dilation = 1, 1

    def d2(d):
        return 2 ** (d % MAX_DILATION_EXP)

    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            encoder.append((SingleBlockSpec(ch, int(mult * mc), dilation=d2(dilation),
                                            attention=ds in cfg.attention_resolutions),))
            dilation += 1
            ch = int(mult * mc)
            input_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            encoder.append((SingleBlockSpec(ch, ch, dilation=d2(dilation), down=True),))
            dilation += 1
            input_chans.append(ch)
            ds *= 2

    middle = (
        SingleBlockSpec(ch, ch, dilation=d2(dilation), attention=True),
        SingleBlockSpec(ch, ch, dilation=d2(dilation), attention=True),
    )

    decoder: List[Tuple[Any, ...]] = []
    chans = list(input_chans)
    dilation -= 1
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for block_id in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            specs: List[Any] = [SingleBlockSpec(ch + ich, int(mult * mc), dilation=d2(dilation),
                                                attention=ds in cfg.attention_resolutions)]
            dilation -= 1
            ch = int(mult * mc)
            if level and block_id == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    specs.append(SingleBlockSpec(ch, ch, dilation=d2(dilation), up=True))
                else:
                    specs.append("upsample")
                ds //= 2
            decoder.append(tuple(specs))
    return tuple(encoder), middle, tuple(decoder)


def _stream_conv(cfg: SingleUNetConfig, i: int, o: int, k: int, dilation: int = 1,
                 conv_type: Optional[str] = None) -> nn.Module:
    if cfg.modality == "video":
        return VideoConv(i, o, k, conv_type or (cfg.video_type if k == 3 else "3d"))
    return AudioConv(i, o, k, dilation)


class SingleResBlock(nn.Module):
    """One stream of the MM-UNet's ResBlock: GN -> SiLU -> conv, FiLM (or
    additive) conditioning, GN -> SiLU -> dropout -> zero-init 1x1 conv,
    plus a skip; optional up/down resampling after ``in_layers`` and the
    stream's self-attention.  ``remat=True`` recomputes the residual (conv)
    path in the backward; the attention keeps its activations."""

    def __init__(self, spec: SingleBlockSpec, cfg: SingleUNetConfig):
        super().__init__()
        self.spec = spec
        self.video = cfg.modality == "video"
        self.use_scale_shift_norm = cfg.use_scale_shift_norm
        i, o = spec.in_ch, spec.out_ch
        self.in_layers = nn.Sequential(MMNorm(i), nn.SiLU(), _stream_conv(cfg, i, o, 3, spec.dilation))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(cfg.model_channels, 2 * o if cfg.use_scale_shift_norm else o)
        )
        self.out_layers = nn.Sequential(
            MMNorm(o), nn.SiLU(), nn.Dropout(cfg.dropout), zero_module(_stream_conv(cfg, o, o, 1)),
        )
        if o != i:
            self.skip_connection = _stream_conv(cfg, i, o, 1)
        if spec.attention and self.video:
            self.spatial_attention_block = TokenSelfAttention(o, cfg.num_heads)
            self.temporal_attention_block = TokenSelfAttention(o, cfg.num_heads)
        elif spec.attention:
            self.attention_block = TokenSelfAttention(o, cfg.num_heads)

    def forward(self, x, emb, remat: bool = False):
        x = checkpoint(self.residual, x, emb, use_reentrant=False) if remat else self.residual(x, emb)
        if not self.spec.attention:
            return x
        if self.video:
            return factorized_video_attention(
                x, self.spatial_attention_block, self.temporal_attention_block
            )
        return self.attention_block(x.transpose(1, 2)).transpose(1, 2)

    def residual(self, x, emb):
        spec = self.spec
        h = norm_silu_then(self.in_layers, x)
        if spec.down:
            down = video_downsample if self.video else audio_downsample
            h, x = down(h), down(x)
        elif spec.up:
            up = video_upsample if self.video else audio_upsample
            h, x = up(h), up(x)
        emb_out = self.emb_layers(emb)
        if self.use_scale_shift_norm:
            h = norm_silu_then(self.out_layers, h, film=tuple(emb_out.chunk(2, dim=-1)))
        else:
            h = norm_silu_then(self.out_layers, h + emb_out.reshape(emb_out.shape + (1,) * (h.dim() - 2)))
        if spec.out_ch != spec.in_ch:
            x = self.skip_connection(x)
        return x + h


class Upsample(nn.Module):
    """The parameter-free upsample marker of ``resblock_updown=False``."""

    def __init__(self, video: bool):
        super().__init__()
        self.up = video_upsample if video else audio_upsample

    def forward(self, x):
        return self.up(x)


class SingleModalUNet(nn.Module):
    """Uncoupled video or audio diffusion U-Net: ``(x, timesteps [B]) ->
    [B, ..., out_channels]`` fp32, ``x`` channels-last (video
    ``[B,F,H,W,C]``, audio ``[B,L,C]``).  The JAX model's class label is
    not ported: no CLI can set it (both refuse ``--class_cond``).

    Training mode: dropout is active under ``model.train()``; with
    ``cfg.use_checkpoint`` each ResBlock whose input holds at least
    :func:`remat_min_tokens` tokens (F*H*W, or L) recomputes its conv path
    in the backward whenever gradients are taken."""

    def __init__(self, cfg: SingleUNetConfig):
        super().__init__()
        self.cfg = cfg
        self.plan = build_single_plan(cfg)
        encoder, middle, decoder = self.plan
        mc = cfg.model_channels
        video = cfg.modality == "video"
        self.time_embed = TimeEmbedding(mc, mc)

        def block(spec):
            if spec == "initial":
                return _stream_conv(cfg, cfg.in_channels, int(cfg.channel_mult[0] * mc), 3,
                                    conv_type="2d+1d")
            if spec == "upsample":
                return Upsample(video)
            return SingleResBlock(spec, cfg)

        self.input_blocks = nn.ModuleList(nn.ModuleList(block(s) for s in specs) for specs in encoder)
        self.middle_blocks = nn.ModuleList(block(s) for s in middle)
        self.output_blocks = nn.ModuleList(nn.ModuleList(block(s) for s in specs) for specs in decoder)
        ch = decoder[-1][0].out_ch
        self.out = nn.Sequential(
            MMNorm(ch), nn.SiLU(),
            zero_module(_stream_conv(cfg, ch, cfg.out_channels, 3, conv_type="3d")),
        )

    def _remat(self, x) -> bool:
        if not (self.cfg.use_checkpoint and torch.is_grad_enabled()):
            return False
        return x.shape[2:].numel() >= remat_min_tokens()

    def _run(self, blocks, h, emb):
        for blk in blocks:
            h = blk(h, emb, remat=self._remat(h)) if isinstance(blk, SingleResBlock) else blk(h)
        return h

    def forward(self, x, timesteps):
        dt = self.cfg.compute_dtype
        emb = self.time_embed(timesteps, dt)
        h = x.to(dt).movedim(-1, 1).contiguous()
        skips = []
        for blocks in self.input_blocks:
            h = self._run(blocks, h, emb)
            skips.append(h)
        h = self._run(self.middle_blocks, h, emb)
        for blocks in self.output_blocks:
            h = self._run(blocks, torch.cat([h, skips.pop()], dim=1), emb)
        return norm_silu_then(self.out, h).float().movedim(1, -1)
