"""OpenAI-style ``.npz`` batch files for audio-video sample sets.

The port of ``mm_diffusion_tpu/evaluation/npz_batch.py``, with the same
file contract, so either package reads what the other writes:

* ``arr_0``: uint8 video ``[N, F, H, W, 3]``; ``audio``: float32
  ``[N, L, C]``; ``video_fps`` (float32) and ``audio_fps`` (int32); named
  side arrays (the sampling CLI adds ``video_base``, the pre-SR clips);
* :func:`npz_av_loader` streams protocol-resolution batches from such a
  file with the directory loader's contract, so ``eval_multimodal``
  accepts a batch file wherever it accepts a sample directory.  Its frame
  resize is the torch bicubic of ``evaluation/resize.py`` on ``device``;
  its audio resampling is ``data/video.py::resample_audio`` (scipy).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from .resize import resize_pad_video


def is_npz_batch(path: str) -> bool:
    return path.endswith((".npz", ".npy"))


def _to_uint8_video(videos: np.ndarray) -> np.ndarray:
    videos = np.asarray(videos)
    if videos.dtype != np.uint8:
        videos = ((videos + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    return videos


def save_av_npz_batch(
    path: str,
    videos: np.ndarray,
    audios: np.ndarray,
    video_fps: float = 10.0,
    audio_fps: int = 16000,
    extra_arrays: dict | None = None,
) -> str:
    """Write one AV sample batch.  ``videos``: uint8 ``[N, F, H, W, 3]`` or
    float in [-1, 1]; ``audios``: ``[N, L]`` or ``[N, L, C]``."""
    videos = _to_uint8_video(videos)
    if videos.ndim != 5 or videos.shape[-1] != 3:
        raise ValueError(f"videos must be [N,F,H,W,3], got {videos.shape}")
    audios = np.asarray(audios, np.float32)
    if audios.ndim == 2:
        audios = audios[..., None]
    if audios.ndim != 3:
        raise ValueError(f"audios must be [N,L] or [N,L,C], got {audios.shape}")
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(
        path,
        arr_0=videos,
        audio=audios,
        video_fps=np.float32(video_fps),
        audio_fps=np.int32(audio_fps),
        **(extra_arrays or {}),
    )
    return path


def load_av_npz_batch(path: str) -> Tuple[np.ndarray, np.ndarray, float, int]:
    """-> (videos uint8 [N,F,H,W,3], audios f32 [N,L,C], video_fps, audio_fps)."""
    with np.load(path) as z:
        key = "arr_0" if "arr_0" in z else list(z.keys())[0]
        videos = z[key]
        if videos.ndim == 4:  # image batch: single-frame clips
            videos = videos[:, None]
        if videos.ndim != 5 or videos.shape[-1] != 3:
            raise ValueError(f"{path}: expected [N,F,H,W,3] arr_0, got {videos.shape}")
        if videos.dtype != np.uint8:
            videos = ((videos.astype(np.float32) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        if "audio" in z:
            audios = np.asarray(z["audio"], np.float32)
            if audios.ndim == 2:
                audios = audios[..., None]
        else:  # video-only batch: silent audio at 1 sample/frame
            audios = np.zeros((videos.shape[0], videos.shape[1], 1), np.float32)
        video_fps = float(z["video_fps"]) if "video_fps" in z else 10.0
        audio_fps = int(z["audio_fps"]) if "audio_fps" in z else 16000
    return videos, audios, video_fps, audio_fps


def npz_batch_len(path: str) -> int:
    with np.load(path) as z:
        key = "arr_0" if "arr_0" in z else list(z.keys())[0]
        return int(z[key].shape[0])


def npz_av_loader(
    path: str,
    batch_size: int,
    video_size: Tuple[int, int, int, int],  # (F, C, H, W) protocol order
    audio_size: Tuple[int, int],  # (C, L)
    audio_fps: int,
    device="cuda",
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite protocol-resolution batch stream from an AV npz batch: video
    resized to the protocol square in [-1, 1] (float32 numpy, as the
    directory loader gives it), audio polyphase-resampled to the protocol
    rate, frame / sample counts padded by repetition or trimmed."""
    from ..data.video import resample_audio

    videos, audios, _, src_audio_fps = load_av_npz_batch(path)
    f, _, h, w = video_size
    ca, l = audio_size
    n = videos.shape[0]

    def prep_video(clip: np.ndarray) -> np.ndarray:
        if clip.shape[0] < f:  # repeat the last frame (short-video padding)
            pad = np.repeat(clip[-1:], f - clip.shape[0], axis=0)
            clip = np.concatenate([clip, pad], axis=0)
        clip = clip[:f]
        v = resize_pad_video(clip, h, w, device).cpu().numpy().astype(np.float32)
        return v / 127.5 - 1.0

    def prep_audio(a: np.ndarray) -> np.ndarray:
        if src_audio_fps != audio_fps:
            a = resample_audio(a, src_audio_fps, audio_fps)
        out = np.zeros((l, ca), np.float32)
        m = min(l, a.shape[0])
        out[:m] = a[:m, :ca]
        return out

    idx = 0
    while True:
        vid, aud = [], []
        for _ in range(batch_size):
            i = idx % n
            vid.append(prep_video(videos[i]))
            aud.append(prep_audio(audios[i]))
            idx += 1
        yield {"video": np.stack(vid), "audio": np.stack(aud)}
