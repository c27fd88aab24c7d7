"""Audio embeddings for FAD.

* :class:`LogMelEmbedder`: log-mel statistics, the offline fallback (a
  numpy copy of ``mm_diffusion_tpu/evaluation/audio_embed.py``; relative FAD
  numbers only, not the AudioCLIP protocol);
* :func:`load_audioclip`: the AudioCLIP audio tower from the published
  checkpoint, as a batched embedding callable with the same interface.
"""

from __future__ import annotations

import numpy as np
import torch


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, sr: int, fmin=0.0, fmax=None) -> np.ndarray:
    fmax = fmax or sr / 2
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        l, c, r = bins[i], bins[i + 1], bins[i + 2]
        if c > l:
            fb[i, l:c] = (np.arange(l, c) - l) / (c - l)
        if r > c:
            fb[i, c:r] = (r - np.arange(c, r)) / (r - c)
    return fb


class LogMelEmbedder:
    """Per-mel-band mean, std, max and frame-to-frame std of the log-mel
    spectrogram: a deterministic ``4 * n_mels`` embedding."""

    def __init__(self, sample_rate: int = 16000, n_fft: int = 1024,
                 hop: int = 256, n_mels: int = 64):
        self.sr = sample_rate
        self.n_fft = n_fft
        self.hop = hop
        self.fb = mel_filterbank(n_mels, n_fft, sample_rate)
        self.window = np.hanning(n_fft)

    def log_mel(self, audio: np.ndarray) -> np.ndarray:
        """[L] mono -> [frames, n_mels]"""
        a = np.asarray(audio, np.float32).reshape(-1)
        n_frames = max(1, 1 + (len(a) - self.n_fft) // self.hop)
        frames = np.stack(
            [a[i * self.hop : i * self.hop + self.n_fft] for i in range(n_frames)]
        )
        spec = np.abs(np.fft.rfft(frames * self.window, axis=-1)) ** 2
        mel = spec @ self.fb.T
        return np.log(mel + 1e-8)

    def __call__(self, audio_batch: np.ndarray) -> np.ndarray:
        """[B, L] or [B, L, C] -> [B, D] embeddings."""
        a = np.asarray(audio_batch)
        if a.ndim == 3:
            a = a[..., 0]
        out = []
        for x in a:
            lm = self.log_mel(x)
            d = np.concatenate(
                [lm.mean(0), lm.std(0), lm.max(0), np.diff(lm, axis=0).std(0)]
            )
            out.append(d)
        return np.stack(out).astype(np.float32)


def audio_channels_first(audio_batch) -> torch.Tensor:
    """The evaluator's ``[B, L, C]`` (C <= 4) or ``[B, L]`` -> the tower's
    ``[B, C, L]``; ``[B, C, L]`` passes as it is."""
    a = torch.as_tensor(np.asarray(audio_batch, np.float32))
    if a.dim() == 3 and a.shape[-1] <= 4:
        return a.permute(0, 2, 1)
    if a.dim() == 2:
        return a[:, None, :]
    return a


def load_audioclip(checkpoint_path: str, device="cuda"):
    """The ESResNeXt-FBSP audio tower of ``AudioCLIP-Full-Training.pt`` (its
    ``audio.*`` keys) on ``device``, as a callable ``audio [B, L, C] ->
    numpy [B, 1024]`` with :class:`LogMelEmbedder`'s interface."""
    from .audioclip import load_audioclip_audio_tower

    model = load_audioclip_audio_tower(checkpoint_path).to(device)

    @torch.no_grad()
    def embed(audio_batch: np.ndarray) -> np.ndarray:
        return model(audio_channels_first(audio_batch).to(device)).cpu().numpy()

    return embed
