"""The AudioCLIP audio tower (ESResNeXt-FBSP), the FAD embedding network.

The port of ``mm_diffusion_tpu/evaluation/audioclip.py``.  AudioCLIP's audio
config: n_fft 2048, hop 561, window 1654 (Blackman-Harris), the normalised
FBSP filterbank, the native spectrogram size (no resize unless
``spec_height`` / ``spec_width`` ask for one), embedding 1024, attention
gates on.  The pipeline:

1. the input scaled from the int16 range to [-1, 1] (as the original does
   with the evaluator's [-1, 1] floats);
2. centred framing, each frame windowed and zero-padded to n_fft;
3. the learned FBSP filterbank as two fp32 matmuls (real, imaginary);
4. power, 3 frequency bands, 10 log10 with a 1e-18 floor;
5. ResNeXt-50 32x4d with multiplicative attention gates, run per audio
   channel, the pooled features summed over channels, then ``fc``.

The ``state_dict`` keys are the original tower's (``fbsp.m``, ``conv1``,
``layer2.0.downsample.1.running_var``, ``att3.conv_depth.weight``, ``fc``),
so ``load_audioclip_audio_tower`` reads the ``audio.*`` keys of
``AudioCLIP-Full-Training.pt`` straight into it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import load_weights, read_torch_checkpoint, true_divide

N_FFT = 2048
HOP_LENGTH = 561
WIN_LENGTH = 1654
EMBED_DIM = 1024
N_BANDS = 3  # conv1's input channels

LAYERS = (3, 4, 6, 3)
PLANES = (64, 128, 256, 512)
ATT_CFG = (  # (kernel, padding) of each gate
    ((3, 1), (1, 0)),
    ((1, 5), (0, 2)),
    ((3, 1), (1, 0)),
    ((1, 5), (0, 2)),
    ((3, 5), (1, 2)),
)


def blackmanharris_window(n: int) -> np.ndarray:
    """scipy.signal.get_window('blackmanharris', n, fftbins=True)."""
    from scipy.signal import get_window

    return get_window("blackmanharris", n, fftbins=True).astype(np.float32)


def scale_int16_range(x: torch.Tensor) -> torch.Tensor:
    """scale(x, -32768, 32767, -1, 1), as the original applies it to the
    evaluator's [-1, 1] floats: ~3e-5 of signal around 1.0 before the final
    subtraction, so the division must round alike on every device."""
    return true_divide(x - (-32768.0), 32767.0 - (-32768.0)) * 2.0 - 1.0


def frame_signal(signal: torch.Tensor, frame_length: int, hop_length: int,
                 window: torch.Tensor) -> torch.Tensor:
    """[B, L] -> [B, num_frames, frame_length], centred zero padding."""
    length = signal.shape[1]
    if length <= frame_length:
        num_frames = 1
    else:
        num_frames = 1 + int(math.ceil((length - frame_length) / hop_length))
    pad_len = (num_frames - 1) * hop_length + frame_length
    if pad_len > length:
        extra = pad_len - length
        signal = F.pad(signal, (extra // 2, extra - extra // 2))
    return signal.unfold(1, frame_length, hop_length) * window


def fbsp_weights(m: torch.Tensor, fb: torch.Tensor, fc: torch.Tensor, in_features: int,
                 normalized: bool = True, eps: float = 1e-8):
    """The complex FBSP filterbank, ``(w_real, w_imag)`` each
    ``[out_features, in_features]``."""
    t = (np.pi * torch.linspace(-1.0, 1.0, in_features, device=m.device))[None, :] + eps
    m_, fb_, fc_ = m[:, None], fb[:, None], fc[:, None]
    kernel_re = torch.cos(fc_ * t)
    kernel_im = -torch.sin(fc_ * t)
    scale = torch.sqrt(fb_)
    win_arg = fb_ * t / (m_ + eps)
    win = torch.where(win_arg == 0, torch.ones_like(win_arg), torch.sin(win_arg) / win_arg)
    # the complex power win^m of a real win: phase 0 for win >= 0, pi below
    mag = win.abs()
    phase = torch.where(win >= 0, torch.zeros_like(win), torch.full_like(win, np.pi))
    pow_mag = (mag**2) ** (0.5 * m_)
    win_re = pow_mag * torch.cos(m_ * phase)
    win_im = pow_mag * torch.sin(m_ * phase)
    w_re = scale * (win_re * kernel_re - win_im * kernel_im)
    w_im = scale * (win_re * kernel_im + win_im * kernel_re)
    if normalized:
        w_re = w_re / (in_features**0.5)
        w_im = w_im / (in_features**0.5)
    return w_re, w_im


class LinearFBSP(nn.Module):
    """The learned Fourier-basis filterbank's parameters (``fbsp.m``,
    ``fbsp.fb``, ``fbsp.fc``)."""

    def __init__(self, out_features: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(out_features))
        self.fb = nn.Parameter(torch.ones(out_features))
        self.fc = nn.Parameter(torch.arange(out_features, dtype=torch.float32))


class Bottleneck(nn.Module):
    """ResNeXt bottleneck (torchvision's key names)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, groups: int = 32,
                 base_width: int = 4, downsample: bool = False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * 4
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, padding=1, groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, out_ch, 1, stride, bias=False), nn.BatchNorm2d(out_ch)
        ) if downsample else None

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu((x if self.downsample is None else self.downsample(x)) + h)


class Attention2d(nn.Module):
    """Multiplicative gate: adaptive max pool to the gated tensor's size,
    depthwise conv, pointwise conv, BN, sigmoid."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, padding):
        super().__init__()
        self.conv_depth = nn.Conv2d(in_channels, in_channels, kernel_size, padding=padding,
                                    groups=in_channels)
        self.conv_point = nn.Conv2d(in_channels, out_channels, 1)
        self.bn = nn.BatchNorm2d(out_channels)

    def forward(self, x, out_hw: Tuple[int, int]):
        x = F.adaptive_max_pool2d(x, out_hw)
        return torch.sigmoid(self.bn(self.conv_point(self.conv_depth(x))))


class ESResNeXtFBSP(nn.Module):
    """Input ``[B, C_audio, L]``, output ``[B, 1024]`` unnormalised
    embeddings (AudioCLIP's raw audio features, FAD's embedding)."""

    def __init__(self, embed_dim: int = EMBED_DIM, apply_attention: bool = True,
                 spec_height: int = -1, spec_width: int = -1):
        super().__init__()
        self.apply_attention, self.spec_height, self.spec_width = apply_attention, spec_height, spec_width
        self.register_buffer("window", torch.from_numpy(blackmanharris_window(WIN_LENGTH)), persistent=False)
        self.fbsp = LinearFBSP(N_FFT // 2 + 1)
        self.conv1 = nn.Conv2d(N_BANDS, 64, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for li, (blocks, planes) in enumerate(zip(LAYERS, PLANES)):
            layer = nn.Sequential(*[
                Bottleneck(inplanes if bi == 0 else planes * 4, planes,
                           stride=(1 if li == 0 else 2) if bi == 0 else 1, downsample=bi == 0)
                for bi in range(blocks)
            ])
            self.add_module(f"layer{li + 1}", layer)
            if apply_attention:
                k, p = ATT_CFG[li]
                self.add_module(f"att{li + 1}", Attention2d(inplanes, planes * 4, k, p))
            inplanes = planes * 4
        if apply_attention:
            k, p = ATT_CFG[4]
            self.att5 = Attention2d(inplanes, inplanes, k, p)
        self.fc = nn.Linear(inplanes, embed_dim)

    def spectrogram(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, C, L] -> the backbone's input, dB ``[B*C, 3, H, W]``."""
        x = scale_int16_range(audio.reshape(-1, audio.shape[-1]).float())
        frames = frame_signal(x, WIN_LENGTH, HOP_LENGTH, self.window)
        pad = N_FFT - WIN_LENGTH
        frames = F.pad(frames, (pad // 2, pad - pad // 2))
        w_re, w_im = fbsp_weights(self.fbsp.m, self.fbsp.fb, self.fbsp.fc, N_FFT)
        pow_spec = (frames @ w_re.T) ** 2 + (frames @ w_im.T) ** 2  # [B*C, T, n_out]
        pow_spec = pow_spec.transpose(-1, -2)
        per_band = pow_spec.shape[1] // N_BANDS
        pow_spec = pow_spec[:, : per_band * N_BANDS].reshape(-1, N_BANDS, per_band, pow_spec.shape[-1])
        sh = per_band if self.spec_height < 1 else self.spec_height
        sw = pow_spec.shape[-1] if self.spec_width < 1 else self.spec_width
        if (sh, sw) != tuple(pow_spec.shape[-2:]):
            pow_spec = F.interpolate(pow_spec, size=(sh, sw), mode="bilinear", align_corners=True)
        pow_spec = torch.where(pow_spec > 0.0, pow_spec, torch.full_like(pow_spec, 1e-18))
        return torch.log10(pow_spec) * 10.0

    def forward(self, audio):
        b, n_ch = audio.shape[0], audio.shape[1]
        h = F.relu(self.bn1(self.conv1(self.spectrogram(audio))))
        h = F.max_pool2d(F.pad(h, (1, 1, 1, 1), value=float("-inf")), 3, 2)
        for li in range(len(LAYERS)):
            gate_in = h
            h = getattr(self, f"layer{li + 1}")(h)
            if self.apply_attention:
                h = h * getattr(self, f"att{li + 1}")(gate_in, tuple(h.shape[2:]))
        pooled = h.mean(dim=(2, 3), keepdim=True)
        if self.apply_attention:
            pooled = pooled * self.att5(h, (1, 1))
        feat = pooled.reshape(b, n_ch, -1).sum(dim=1)
        return self.fc(feat)


def load_audioclip_audio_tower(checkpoint_path: str) -> ESResNeXtFBSP:
    """The tower from the ``audio.*`` keys of ``AudioCLIP-Full-Training.pt``."""
    return load_weights(ESResNeXtFBSP(), read_torch_checkpoint(checkpoint_path), prefix="audio.")
