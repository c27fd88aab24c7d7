"""CLIP's visual (ModifiedResNet RN50) and text towers, and the frozen
AudioCLIP scorer: audio / video embeddings and the AV alignment score.

The port of ``mm_diffusion_tpu/evaluation/clip_model.py``.  AudioCLIP uses
CLIP's ResNet-50 visual tower (layers (3, 4, 6, 3), width 64, embedding
1024).  A video's embedding is the mean of its frames' normalised image
embeddings; the AV score of a pair is ``clamp(exp(logit_scale_ai), 1, 100)
* a_hat . v_hat``.  The ``state_dict`` keys are the original CLIP's
(``visual.layer1.0.downsample.0.weight``, ``visual.attnpool.q_proj``,
``transformer.resblocks.0.attn.in_proj_weight``, ``text_projection``), so
``AudioCLIP-Full-Training.pt`` loads into them without a converter.

The attentions are plain matmuls with an fp32 softmax, as in the JAX
package.  Frames are resized with the torch bicubic of
``evaluation/resize.py``, always: there is no nearest-neighbour fallback.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .audio_embed import audio_channels_first
from .common import load_weights, read_torch_checkpoint, true_divide
from .resize import as_tensor, resize_uint8

IMAGE_SIZE = 224
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPBottleneck(nn.Module):
    """The stride is an average pool after conv2; the downsample branch is
    an average pool, then a 1x1 conv and BN."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * 4
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride > 1 or inplanes != out_ch:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)),
                ("0", nn.Conv2d(inplanes, out_ch, 1, bias=False)),
                ("1", nn.BatchNorm2d(out_ch)),
            ]))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class AttentionPool2d(nn.Module):
    """The mean token prepended, a learned positional embedding, one
    multi-head attention step of the mean token over all, ``c_proj``."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.randn(spacial_dim**2 + 1, embed_dim) / embed_dim**0.5)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)
        self.num_heads = num_heads

    def forward(self, x):  # [B, C, H, W]
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # [B, HW, C]
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1) + self.positional_embedding
        hd = c // self.num_heads
        q = self.q_proj(tokens[:, :1]).reshape(b, 1, self.num_heads, hd)
        k = self.k_proj(tokens).reshape(b, -1, self.num_heads, hd)
        v = self.v_proj(tokens).reshape(b, -1, self.num_heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        pooled = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, c)
        return self.c_proj(pooled)


class CLIPVisualResNet(nn.Module):
    """ModifiedResNet.  Input ``[B, H, W, 3]`` CLIP-normalised images
    (channels-last, as the JAX module; ``input_resolution`` sizes the
    positional embedding: 224 for CLIP); output ``[B, output_dim]``."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), output_dim: int = 1024,
                 heads: int = 32, input_resolution: int = IMAGE_SIZE, width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width // 2, 3, 2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = nn.BatchNorm2d(width)
        inplanes = width
        for li, blocks in enumerate(layers):
            planes = width * 2**li
            stride = 1 if li == 0 else 2
            blocks_ = []
            for bi in range(blocks):
                blocks_.append(CLIPBottleneck(inplanes, planes, stride if bi == 0 else 1))
                inplanes = planes * 4
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks_))
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32, heads, output_dim)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.avg_pool2d(x, 2)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.attnpool(x)


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class _SelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``), computed as plain matmuls."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.n_head = n_head
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, causal: bool):
        b, t, d = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        hd = d // self.n_head
        q, k, v = (y.reshape(b, t, self.n_head, hd) for y in (q, k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if causal:
            logits = logits + torch.full((t, t), float("-inf"), device=x.device).triu(1)
        w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.attn = _SelfAttention(d_model, n_head)
        self.ln_1 = nn.LayerNorm(d_model)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(d_model, d_model * 4)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(d_model * 4, d_model)),
        ]))
        self.ln_2 = nn.LayerNorm(d_model)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x.float()).to(x.dtype), causal=True)
        h = self.ln_2(x.float()).to(x.dtype)
        return x + self.mlp(h)


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.Sequential(*[ResidualAttentionBlock(width, heads) for _ in range(layers)])


class CLIPTextEncoder(nn.Module):
    """CLIP's ``encode_text``: causal transformer, the end-of-text token's
    (highest id's) state, ``text_projection``.  Input ``[B, T]`` token ids."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 heads: int = 8, layers: int = 12, embed_dim: int = 1024):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, width) * 0.01)
        self.transformer = _Transformer(width, layers, heads)
        self.ln_final = nn.LayerNorm(width)
        self.text_projection = nn.Parameter(torch.randn(width, embed_dim) * width**-0.5)

    def forward(self, tokens):
        x = self.token_embedding(tokens) + self.positional_embedding[: tokens.shape[1]]
        x = self.transformer.resblocks(x)
        x = self.ln_final(x.float())
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection


def preprocess_frames_for_clip(videos_uint8, device=None) -> torch.Tensor:
    """uint8 ``[B, F, H, W, 3]`` -> CLIP-normalised float32 ``[B, F, 224,
    224, 3]`` on ``device``: bicubic resize of the shorter side to 224
    (rounded to uint8, as OpenCV returns it), centre crop, mean / std."""
    x = as_tensor(videos_uint8, device if device is not None else getattr(videos_uint8, "device", "cpu"))
    b, f, h, w, _ = x.shape
    flat = x.reshape(b * f, h, w, 3)
    if (h, w) != (IMAGE_SIZE, IMAGE_SIZE):
        scale = IMAGE_SIZE / min(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        flat = resize_uint8(flat, nh, nw, "bicubic")
        top, left = (nh - IMAGE_SIZE) // 2, (nw - IMAGE_SIZE) // 2
        flat = flat[:, top : top + IMAGE_SIZE, left : left + IMAGE_SIZE]
    mean = torch.tensor(IMAGE_MEAN, device=flat.device)
    std = torch.tensor(IMAGE_STD, device=flat.device)
    out = (true_divide(flat.float(), 255.0) - mean) / std
    return out.reshape(b, f, IMAGE_SIZE, IMAGE_SIZE, 3)


class AudioCLIPScorer:
    """Frozen AudioCLIP (audio tower + CLIP visual) on ``device``: audio and
    video embeddings and the per-pair AV score."""

    def __init__(self, audio_model: nn.Module, visual_model: nn.Module, logit_scale_ai: float,
                 device="cuda"):
        self.device = torch.device(device)
        self.audio = audio_model.to(self.device).eval()
        self.visual = visual_model.to(self.device).eval()
        self.scale_ai = float(np.clip(np.exp(logit_scale_ai), 1.0, 100.0))

    @torch.no_grad()
    def embed_audio(self, audio_batch) -> np.ndarray:
        """[B, C, L] or [B, L, C] -> raw (unnormalised) [B, 1024]: FAD's
        embedding."""
        return self.audio(audio_channels_first(audio_batch).to(self.device)).cpu().numpy()

    @torch.no_grad()
    def embed_video(self, videos_uint8) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 [B, F, H, W, 3] -> (the mean of the frames' raw image
        embeddings, the mean of their normalised ones)."""
        pre = preprocess_frames_for_clip(videos_uint8, self.device)
        b, f = pre.shape[:2]
        raw = self.visual(pre.reshape(b * f, IMAGE_SIZE, IMAGE_SIZE, 3)).cpu().numpy()
        normed = raw / np.linalg.norm(raw, axis=-1, keepdims=True)
        return raw.reshape(b, f, -1).mean(axis=1), normed.reshape(b, f, -1).mean(axis=1)

    def av_scores(self, audio_batch, videos_uint8) -> np.ndarray:
        """Per-pair AV alignment scores (the diagonal of AudioCLIP's
        audio-video logits)."""
        a = self.embed_audio(audio_batch)
        a = a / np.linalg.norm(a, axis=-1, keepdims=True)
        _, v_mean_normed = self.embed_video(videos_uint8)
        return self.scale_ai * np.sum(a * v_mean_normed, axis=-1)


def load_audioclip_full(checkpoint_path: str, device="cuda") -> AudioCLIPScorer:
    """The frozen audio + visual AudioCLIP of ``AudioCLIP-Full-Training.pt``
    (``audio.*``, ``visual.*``, ``logit_scale_ai``)."""
    from .audioclip import ESResNeXtFBSP

    sd = read_torch_checkpoint(checkpoint_path)
    audio = load_weights(ESResNeXtFBSP(), sd, prefix="audio.")
    visual = load_weights(CLIPVisualResNet(), sd, prefix="visual.")
    scale_ai = float(sd["logit_scale_ai"]) if "logit_scale_ai" in sd else float(np.log(100.0))
    return AudioCLIPScorer(audio, visual, scale_ai, device)
