"""Guided-diffusion image U-Net and its 64->256 super-resolution variant
(counterpart of ``mm_diffusion_tpu/models/image_unet.py``).

The module tree is the original's (``input_blocks.<i>.<j>``,
``middle_block.<j>``, ``output_blocks.<i>.<j>``, ``out``), so published
upsampler checkpoints load unchanged.  Differences from the MM-UNet, as in
the original: the time embedding is ``4 * model_channels`` wide, and an
up/down ResBlock resamples between its norm-SiLU and its first conv.

Text-to-image (Stable Diffusion XL's U-Net, SGM's ``openaimodel.UNetModel``):
with ``context_dim`` set, every attention site is a ``SpatialTransformer``
of ``transformer_depth[level]`` blocks (``models/transformer.py``) that
attends to the text ``context``, and ``adm_in_channels`` adds SGM's vector
condition ``y`` (``label_emb``: Linear -> SiLU -> Linear) to the time
embedding; :func:`sdxl_vector` builds ``y``.  Without ``context_dim`` the
model is the guided-diffusion U-Net above, module for module.

Layout: the activations are held channels-last in memory
(``torch.channels_last`` strides on ``[N, C, H, W]``) from the entry to the
exit, so that cuDNN's NHWC convolutions, the GroupNorm kernel's
channels-last mode, the attention blocks' token views and the transformers'
``proj_in`` / residual add make no layout copies; ``models/layers.py``
says which op keeps the format.  The public ``forward`` functions take and
return ``[N, H, W, C]``, whose permute to ``[N, C, H, W]`` is already a
channels-last view.

Conv biases: each ResBlock runs its convs without their biases and hands
them to the passes that read the convs' outputs: the first conv's bias (and,
without ``use_scale_shift_norm``, the time embedding) to the norm after it,
the second conv's and the skip conv's to the residual pass
(``ops/residual.py``).  Where autograd does not record (the samplers), those
passes fold them into the reads they make anyway; where it records, they add
them as the convs did (``ops/group_norm.py``'s routes), counted in
``ops/group_norm.BIAS_FOLDS``.

Training mode: dropout is active under ``model.train()``; with
``cfg.use_checkpoint`` each ResBlock whose input holds at least
``remat_min_tokens()`` pixels (H*W) recomputes its activations in the
backward whenever gradients are taken, as the MM-UNet's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.group_norm import channels_last
from ..ops.residual import residual_bias
from .attention import TokenSelfAttention
from .layers import (
    DTYPES,
    Conv2d,
    GroupNorm32,
    Linear,
    TimeEmbedding,
    group_norm_silu,
    image_downsample,
    image_upsample,
    norm_silu_then,
    timestep_embedding,
    zero_module,
)
from .mm_unet import remat_min_tokens
from .transformer import SpatialTransformer


@dataclasses.dataclass(frozen=True)
class ImageUNetConfig:
    image_size: int = 64
    in_channels: int = 3
    model_channels: int = 128
    out_channels: int = 3
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (8, 16, 32)
    dropout: float = 0.0
    channel_mult: Tuple[float, ...] = (1, 2, 4, 8)
    num_classes: Optional[int] = None
    num_heads: int = 4
    num_head_channels: int = -1
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_checkpoint: bool = False  # recompute the large ResBlocks in the backward
    dtype: str = "bfloat16"
    # Text-to-image (SGM's flags): spatial transformers at the attention
    # sites, attending to a [N, L, context_dim] context.
    context_dim: Optional[int] = None
    transformer_depth: Tuple[int, ...] = (1,)  # blocks per site, by level; the middle takes the last
    adm_in_channels: Optional[int] = None  # the vector condition y (num_classes "sequential")

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def heads(self, ch: int, upsample: bool = False) -> int:
        if self.num_head_channels == -1:
            if upsample and self.num_heads_upsample != -1:
                return self.num_heads_upsample
            return self.num_heads
        if ch % self.num_head_channels:
            raise ValueError(f"{ch} channels do not split into heads of {self.num_head_channels}")
        return ch // self.num_head_channels


@dataclasses.dataclass(frozen=True)
class _RB:
    in_ch: int
    out_ch: int
    attn_heads: int = 0  # 0 = no attention after this block
    depth: int = 0  # transformer blocks at the attention site (text-to-image)
    up: bool = False
    down: bool = False


def build_image_plan(cfg: ImageUNetConfig):
    """Encoder / middle / decoder specs, as in the JAX package;
    ``attention_resolutions`` are downsample rates.  With ``context_dim``
    each attention site carries its transformer depth."""
    mc = cfg.model_channels

    def depth(level):
        if cfg.context_dim is None:
            return 0
        return cfg.transformer_depth[-1 if level is None else level]

    ch = int(cfg.channel_mult[0] * mc)
    input_chans = [ch]
    encoder: List[Tuple[Any, ...]] = [("initial",)]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            heads = cfg.heads(int(mult * mc)) if ds in cfg.attention_resolutions else 0
            encoder.append((_RB(ch, int(mult * mc), attn_heads=heads, depth=depth(level)),))
            ch = int(mult * mc)
            input_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            encoder.append((_RB(ch, ch, down=True),) if cfg.resblock_updown else ("downsample",))
            input_chans.append(ch)
            ds *= 2

    middle = (_RB(ch, ch, attn_heads=cfg.heads(ch), depth=depth(None)), _RB(ch, ch))

    decoder: List[Tuple[Any, ...]] = []
    chans = list(input_chans)
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            heads = (
                cfg.heads(int(mult * mc), upsample=True) if ds in cfg.attention_resolutions else 0
            )
            specs: List[Any] = [_RB(ch + ich, int(mult * mc), attn_heads=heads, depth=depth(level))]
            ch = int(mult * mc)
            if level and i == cfg.num_res_blocks:
                specs.append(_RB(ch, ch, up=True) if cfg.resblock_updown else "upsample")
                ds //= 2
            decoder.append(tuple(specs))
    return tuple(encoder), middle, tuple(decoder), ch


class ImageResBlock(nn.Module):
    def __init__(self, spec: _RB, cfg: ImageUNetConfig, emb_ch: int):
        super().__init__()
        self.up, self.down = spec.up, spec.down
        self.use_scale_shift_norm = cfg.use_scale_shift_norm
        i, o = spec.in_ch, spec.out_ch
        self.in_layers = nn.Sequential(GroupNorm32(i), nn.SiLU(), Conv2d(i, o, 3, padding=1))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_ch, 2 * o if cfg.use_scale_shift_norm else o)
        )
        self.out_layers = nn.Sequential(
            GroupNorm32(o), nn.SiLU(), nn.Dropout(cfg.dropout),
            zero_module(Conv2d(o, o, 3, padding=1)),
        )
        self.skip_connection = nn.Identity() if o == i else Conv2d(i, o, 1)

    def forward(self, x, emb):
        """The convs run without their biases; each bias goes to the pass
        that reads the conv's output (module docstring)."""
        conv1, conv2 = self.in_layers[2], self.out_layers[3]
        h = group_norm_silu(self.in_layers[0], x)
        if self.up or self.down:
            resample = image_upsample if self.up else image_downsample
            h, x = resample(h), resample(x)
        h = _conv_without_bias(conv1, h)
        emb_out = self.emb_layers(emb)
        if self.use_scale_shift_norm:
            h = group_norm_silu(self.out_layers[0], h, film=tuple(emb_out.chunk(2, dim=-1)), in_bias=conv1.bias)
        else:
            h = group_norm_silu(self.out_layers[0], h, in_bias=(conv1.bias, emb_out))
        h = _conv_without_bias(conv2, self.out_layers[2](h))
        if isinstance(self.skip_connection, Conv2d):
            skip = self.skip_connection
            return residual_bias(_conv_without_bias(skip, x), h, conv2.bias, skip.bias)
        return residual_bias(x, h, conv2.bias)


def _conv_without_bias(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` without its bias, the weight cast as ``Conv2d.forward``
    casts it."""
    fmt = torch.channels_last if channels_last(x) else torch.preserve_format
    return conv._conv_forward(x, conv.weight.to(dtype=x.dtype, memory_format=fmt), None)


class ImageAttention(TokenSelfAttention):
    """Spatial self-attention on ``[N, C, H, W]`` (the original's
    AttentionBlock: bare GroupNorm, legacy per-head qkv order).  On a
    channels-last ``x`` the ``[N, H*W, C]`` tokens and the returned image
    are views, not copies."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__(channels, num_heads, image=True)

    def forward(self, x):
        n, c, h, w = x.shape
        tokens = super().forward(x.flatten(2).transpose(1, 2))
        return tokens.transpose(1, 2).reshape(n, c, h, w)


class Downsample(nn.Module):
    """Stride-2 3x3 conv, padding 1 on both sides (the original's)."""

    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(image_upsample(x))


class ImageUNet(nn.Module):
    """``(x [N,H,W,C], timesteps [N])`` -> ``[N,H,W,out_channels]``, fp32
    (contiguous); channels-last activations inside (module docstring)."""

    def __init__(self, cfg: ImageUNetConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        emb_ch = 4 * mc
        encoder, middle, decoder, out_ch = build_image_plan(cfg)
        self.time_embed = TimeEmbedding(mc, emb_ch)
        if cfg.num_classes is not None and cfg.adm_in_channels is not None:
            raise ValueError("num_classes and adm_in_channels are two label embeddings; give one")
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, emb_ch)
        if cfg.adm_in_channels is not None:
            self.label_emb = nn.Sequential(
                nn.Sequential(Linear(cfg.adm_in_channels, emb_ch), nn.SiLU(), Linear(emb_ch, emb_ch))
            )

        ch = int(cfg.channel_mult[0] * mc)  # channels entering the next block

        def blocks(specs):
            nonlocal ch
            mods = []
            for spec in specs:
                if spec == "initial":
                    mods.append(Conv2d(cfg.in_channels, ch, 3, padding=1))
                elif spec == "downsample":
                    mods.append(Downsample(ch))
                elif spec == "upsample":
                    mods.append(Upsample(ch))
                else:
                    mods.append(ImageResBlock(spec, cfg, emb_ch))
                    ch = spec.out_ch
                    if spec.attn_heads and cfg.context_dim is not None:
                        mods.append(SpatialTransformer(spec.out_ch, spec.attn_heads, spec.depth, cfg.context_dim))
                    elif spec.attn_heads:
                        mods.append(ImageAttention(spec.out_ch, spec.attn_heads))
            return nn.ModuleList(mods)

        self.input_blocks = nn.ModuleList(blocks(s) for s in encoder)
        self.middle_block = blocks(middle)
        self.output_blocks = nn.ModuleList(blocks(s) for s in decoder)
        self.out = nn.Sequential(
            GroupNorm32(out_ch), nn.SiLU(), zero_module(Conv2d(out_ch, cfg.out_channels, 3, padding=1))
        )

    def _remat(self, h) -> bool:
        if not (self.cfg.use_checkpoint and torch.is_grad_enabled()):
            return False
        return h.shape[2] * h.shape[3] >= remat_min_tokens()

    def _run(self, blocks, h, emb, context=None):
        for m in blocks:
            if isinstance(m, SpatialTransformer):
                h = m(h, context)
            elif not isinstance(m, ImageResBlock):
                h = m(h)
            elif self._remat(h):
                h = checkpoint(m, h, emb, use_reentrant=False)
            else:
                h = m(h, emb)
        return h

    def unet_forward(self, h, timesteps, label=None, context=None, y=None):
        """``[N, C, H, W]`` in, in any memory format (held channels-last
        from here on), fp32 ``[N, C, H, W]`` out, channels-last;
        ``context [N, L, context_dim]`` and ``y [N, adm_in_channels]`` for
        the text-to-image model."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        emb = self.time_embed(timesteps, dt)
        if cfg.num_classes is not None:
            if label is None:
                raise ValueError("a class-conditional model needs a label")
            emb = emb + self.label_emb(label).to(dt)
        if cfg.adm_in_channels is not None:
            if y is None:
                raise ValueError("a model with adm_in_channels needs the vector condition y")
            emb = emb + self.label_emb(y.to(dt))
        if cfg.context_dim is not None:
            if context is None:
                raise ValueError("a model with context_dim needs a context")
            context = context.to(dt)
        h = h.to(dtype=dt, memory_format=torch.channels_last)
        hs = []
        for blocks in self.input_blocks:
            h = self._run(blocks, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context)
        for blocks in self.output_blocks:
            h = self._run(blocks, torch.cat([h, hs.pop()], dim=1), emb, context)
        return norm_silu_then(self.out, h).float()

    def forward(self, x, timesteps, label=None, context=None, y=None):
        h = self.unet_forward(x.permute(0, 3, 1, 2), timesteps, label, context, y)
        return h.permute(0, 2, 3, 1)


class ImageSuperResModel(ImageUNet):
    """The SR U-Net: bilinearly upsample ``low_res`` to the input size and
    concatenate it on channels (``cfg.in_channels`` counts both); the
    permuted inputs are channels-last views, and the resize and the
    concatenation keep that format."""

    def forward(self, x, timesteps, low_res, label=None):
        x = x.permute(0, 3, 1, 2)
        up = F.interpolate(
            low_res.permute(0, 3, 1, 2).to(x.dtype), size=x.shape[-2:],
            mode="bilinear", align_corners=False,
        )
        h = torch.cat([x, up], dim=1)
        return self.unet_forward(h, timesteps, label).permute(0, 2, 3, 1)


def sdxl_vector(pooled: torch.Tensor, original_size=(1024, 1024), crop_top_left=(0, 0),
                target_size=(1024, 1024), size_dim: int = 256) -> torch.Tensor:
    """SGM's vector condition ``y`` of Stable Diffusion XL base: the pooled
    text embedding ``[N, P]``, then its ``ConcatTimestepEmbedderND`` of the
    original size, the crop's top-left corner and the target size, each of
    the six numbers as ``size_dim`` sinusoids ``[cos | sin]``: fp32
    ``[N, P + 6 * size_dim]``."""
    sizes = torch.tensor([*original_size, *crop_top_left, *target_size], dtype=torch.float32)
    emb = timestep_embedding(sizes, size_dim).reshape(1, -1).to(pooled.device)
    return torch.cat([pooled.float(), emb.expand(pooled.shape[0], -1)], dim=-1)
