"""End-to-end multimodal evaluation: FVD / KVD / FAD (and the AV-CLIP score
and the I3D video IS) between a real and a generated set.

The port of ``mm_diffusion_tpu/evaluation/evaluator.py``: stream real and
fake AV pairs from sample directories or ``.npz`` batch files at the
protocol resolution (16 x 224^2 video, 1.6 s of 44.1 kHz audio), embed the
video with I3D and the audio with AudioCLIP's audio tower on ``device``
(fp32, TF32 off), and compute the metrics in float64 numpy on the host.
Without the published checkpoints the metrics fall back to pixel-statistics
and log-mel embeddings, tagged ``protocol: "fallback"``; FAD is scaled x1e4;
the metric dict, the provenance tags, the ``allow_fallback`` refusal and the
duplication warning are the JAX package's.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..data.video import list_video_files, load_data
from ..utils import logger
from .audio_embed import LogMelEmbedder
from .common import fp32_precision
from .metrics import frechet_distance, polynomial_mmd, preprocess_videos_for_i3d

VIDEO_SIZE = [16, 3, 224, 224]
AUDIO_RATE = 44100
AUDIO_SIZE = [1, int(AUDIO_RATE * 1.6)]
BATCH_SIZE = 8


def _dir_loader(path: str, batch_size: int = BATCH_SIZE, device="cuda") -> Iterator[Dict[str, np.ndarray]]:
    """AV pairs at the protocol resolution from a sample directory (the
    port's dataset loader, which decodes with OpenCV) or an ``.npz`` batch
    file (``npz_batch.npz_av_loader``, resized in torch on ``device``)."""
    from .npz_batch import is_npz_batch, npz_av_loader

    if is_npz_batch(path):
        return npz_av_loader(
            path,
            batch_size=batch_size,
            video_size=tuple(VIDEO_SIZE),
            audio_size=tuple(AUDIO_SIZE),
            audio_fps=AUDIO_RATE,
            device=device,
        )
    return load_data(
        data_dir=path,
        batch_size=batch_size,
        video_size=tuple(VIDEO_SIZE),
        audio_size=tuple(AUDIO_SIZE),
        audio_fps=AUDIO_RATE,
        random_flip=False,
        num_workers=0,
        shard=0,
        num_shards=1,
    )


def _sample_count(path: str) -> int:
    """Distinct clips behind ``path`` (directory or npz batch)."""
    from .npz_batch import is_npz_batch, npz_batch_len

    if is_npz_batch(path):
        return npz_batch_len(path)
    return len(list_video_files(path))


def make_i3d_embedder(i3d_checkpoint: Optional[str] = None, device="cuda") -> Optional[Callable]:
    """I3D video embedder on ``device`` (``uint8 [B, T, H, W, 3] -> numpy
    [B, 400]``); None when no checkpoint exists."""
    if not i3d_checkpoint or not os.path.exists(i3d_checkpoint):
        return None
    from .i3d import load_i3d

    model = load_i3d(i3d_checkpoint).to(device)

    @torch.no_grad()
    def embed(videos_uint8: np.ndarray) -> np.ndarray:
        return model(preprocess_videos_for_i3d(videos_uint8, device=device)).cpu().numpy()

    return embed


def _pixel_video_embed(videos_uint8: np.ndarray) -> np.ndarray:
    v = videos_uint8.astype(np.float32) / 255.0
    b = v.shape[0]
    flat = v.reshape(b, v.shape[1], -1)
    return np.concatenate(
        [flat.mean(-1), flat.std(-1), np.abs(np.diff(flat, axis=1)).mean(-1).mean(-1, keepdims=True)],
        axis=-1,
    )


@fp32_precision()
def eval_multimodal(
    real_path: str,
    fake_path: str,
    video_size=(16, 3, 64, 64),
    eval_num: int = 2048,
    i3d_checkpoint: Optional[str] = None,
    audioclip_checkpoint: Optional[str] = None,
    audio_embedder: Optional[Callable] = None,
    batch_size: int = BATCH_SIZE,
    compute_is: bool = False,
    allow_fallback: bool = True,
    device="cuda",
) -> Dict[str, float]:
    """``{"fvd", "kvd", "fad"}`` plus the provenance tags (``video_embedder``,
    ``audio_embedder``, ``protocol``), ``av_clip_score_{fake,real}`` with a
    full AudioCLIP checkpoint and ``video_is`` / ``video_is_std`` with
    ``compute_is`` and I3D.  Without an I3D / AudioCLIP checkpoint the
    metrics are the fallback embeddings' (relative numbers only,
    ``protocol: "fallback"``); ``allow_fallback=False`` makes that an error."""
    log = logger.get_current()
    device = torch.device(device)
    video_embed = make_i3d_embedder(i3d_checkpoint, device)
    pixel_fallback = video_embed is None
    audio_fallback = audio_embedder is None and not (
        audioclip_checkpoint and os.path.exists(audioclip_checkpoint)
    )
    if not allow_fallback and (pixel_fallback or audio_fallback):
        missing = []
        if pixel_fallback:
            missing.append(f"I3D ({i3d_checkpoint or 'no --i3d_checkpoint'})")
        if audio_fallback:
            missing.append(f"AudioCLIP ({audioclip_checkpoint or 'no --audioclip_checkpoint'})")
        raise RuntimeError(
            "eval: pretrained embedder checkpoint(s) missing: "
            + "; ".join(missing)
            + " — fallback embeddings are NOT the published FVD/KVD/FAD "
            "protocol. Pass --allow_fallback for relative-only numbers."
        )
    if pixel_fallback:
        log.log("eval: no I3D checkpoint — using pixel-statistics video embeddings "
                "(relative comparisons only)")
        video_embed = _pixel_video_embed

    audio_embedder_name = "custom"
    av_scorer = None
    if audio_embedder is None:
        if not audio_fallback:
            # the full AudioCLIP (audio tower + CLIP visual) gives FAD's
            # embeddings and the per-pair AV scores; a checkpoint with the
            # audio tower alone gives FAD only
            try:
                from .clip_model import load_audioclip_full

                av_scorer = load_audioclip_full(audioclip_checkpoint, device)
                audio_embedder = av_scorer.embed_audio
            except KeyError as e:
                log.log(f"eval: no CLIP visual tower in checkpoint ({e}); FAD only")
                from .audio_embed import load_audioclip

                audio_embedder = load_audioclip(audioclip_checkpoint, device)
            audio_embedder_name = "audioclip"
        else:
            log.log("eval: no AudioCLIP checkpoint — log-mel fallback FAD (relative comparisons only)")
            audio_embedder = LogMelEmbedder(sample_rate=AUDIO_RATE)
            audio_embedder_name = "logmel_fallback"

    def collect(path):
        # the loader is an infinite generator: a set with fewer clips than
        # eval_num repeats clips, which biases the metrics low -- say so
        n_files = _sample_count(path)
        if 0 < n_files < eval_num:
            log.log(
                f"eval WARNING: {path} holds {n_files} clips but eval_num="
                f"{eval_num} — embeddings will repeat clips "
                f"{eval_num / max(n_files, 1):.1f}x; metrics are biased low"
            )
        vid_emb, aud_emb, av_scores = [], [], []
        n = 0
        for batch in _dir_loader(path, batch_size, device):
            videos = ((batch["video"] + 1) * 127.5).clip(0, 255).astype(np.uint8)
            vid_emb.append(video_embed(videos))
            aud_emb.append(audio_embedder(batch["audio"]))
            if av_scorer is not None:
                av_scores.append(av_scorer.av_scores(batch["audio"], videos))
            n += videos.shape[0]
            if n >= eval_num:
                break
        return (
            np.concatenate(vid_emb)[:eval_num],
            np.concatenate(aud_emb)[:eval_num],
            np.concatenate(av_scores)[:eval_num] if av_scores else None,
        )

    log.log(f"embedding fake set: {fake_path}")
    fake_v, fake_a, fake_av = collect(fake_path)
    log.log(f"embedding real set: {real_path}")
    real_v, real_a, real_av = collect(real_path)
    log.log(f"evaluate for {len(real_v)} samples")

    metrics = {
        "fvd": frechet_distance(fake_v, real_v),
        "kvd": polynomial_mmd(fake_v, real_v),
        "fad": frechet_distance(fake_a, real_a) * 10000.0,
        # provenance: fallback numbers never pass for the published protocol
        "video_embedder": "pixel_fallback" if pixel_fallback else "i3d",
        "audio_embedder": audio_embedder_name,
        "protocol": (
            "fallback" if (pixel_fallback or audio_embedder_name == "logmel_fallback") else "reference"
        ),
    }
    if fake_av is not None:
        metrics["av_clip_score_fake"] = float(np.mean(fake_av))
        metrics["av_clip_score_real"] = float(np.mean(real_av))
    if compute_is and not pixel_fallback:
        from .inception_score import inception_score

        is_mean, is_std = inception_score(fake_v)
        metrics["video_is"] = is_mean
        metrics["video_is_std"] = is_std
    return metrics
