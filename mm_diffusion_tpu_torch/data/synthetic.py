"""Synthetic audio-video dataset (the port's own copy of
``mm_diffusion_tpu/data/synthetic.py``, numpy only: the same seeds give the
same batches as the JAX package's).

Deterministic procedurally-generated AV pairs in the exact tensor contract of
the real loader (`multimodal_datasets.py` semantics: video in [-1,1]
``[F,H,W,C]`` float32, audio mono in [-1,1] ``[L,C]``), correlated across
modalities (a moving blob whose position modulates the audio pitch) so
training has learnable cross-modal structure.  Used by tests, the benchmark,
and the zero-data demo path — the reference has no equivalent (its only smoke
tests require a real dataset); this directly covers SURVEY §4's test-strategy gap.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def synthetic_av_pair(
    seed: int,
    video_shape: Tuple[int, int, int, int] = (16, 64, 64, 3),
    audio_len: int = 25600,
    audio_channels: int = 1,
) -> Dict[str, np.ndarray]:
    """One deterministic AV pair keyed by ``seed``."""
    rng = np.random.RandomState(seed)
    f, h, w, c = video_shape
    cx = rng.uniform(0.2, 0.8)
    cy = rng.uniform(0.2, 0.8)
    vx = rng.uniform(-0.3, 0.3)
    vy = rng.uniform(-0.3, 0.3)
    hue = rng.uniform(0, 1, size=(c,))
    base_freq = rng.uniform(100.0, 800.0)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ys, xs = ys / h, xs / w
    frames = np.zeros((f, h, w, c), np.float32)
    positions = []
    for i in range(f):
        t = i / max(1, f - 1)
        px = (cx + vx * t) % 1.0
        py = (cy + vy * t) % 1.0
        positions.append(px)
        blob = np.exp(-(((xs - px) ** 2 + (ys - py) ** 2) / 0.02))
        for ch in range(c):
            frames[i, :, :, ch] = blob * (0.5 + 0.5 * hue[ch]) + 0.1 * np.sin(
                6.28 * (xs + ys) * (1 + ch) + t
            )
    video = np.clip(frames * 2.0 - 1.0, -1.0, 1.0)

    # audio: pitch follows the blob's x position, frame by frame
    spf = audio_len // f
    tt = np.arange(audio_len, dtype=np.float32) / audio_len
    freq = np.repeat(base_freq * (1.0 + np.asarray(positions, np.float32)), spf)
    freq = np.pad(freq, (0, audio_len - freq.shape[0]), mode="edge")
    phase = np.cumsum(freq) / 16000.0
    audio = 0.8 * np.sin(2 * np.pi * phase).astype(np.float32)
    audio = np.tile(audio[:, None], (1, audio_channels))
    return {"video": video, "audio": audio}


def load_synthetic_data(
    batch_size: int,
    video_size: Tuple[int, int, int, int] = (16, 3, 64, 64),  # (F,C,H,W) ref order
    audio_size: Tuple[int, int] = (1, 25600),  # (C,L) ref order
    seed: int = 0,
    shard: int = 0,
    num_shards: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite generator of batches in the framework's channels-last layout
    (mirrors the reference's infinite ``load_data`` generator contract,
    multimodal_datasets.py:16-103, including per-shard disjoint streams)."""
    f, c, h, w = video_size
    ca, l = audio_size
    idx = seed * 1_000_003 + shard
    while True:
        vids, auds = [], []
        for _ in range(batch_size):
            pair = synthetic_av_pair(idx, (f, h, w, c), l, ca)
            idx += num_shards
            vids.append(pair["video"])
            auds.append(pair["audio"])
        yield {
            "video": np.stack(vids).astype(np.float32),
            "audio": np.stack(auds).astype(np.float32),
        }
