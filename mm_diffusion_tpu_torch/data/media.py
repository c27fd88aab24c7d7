"""Media IO: writers for sampled audio/video, and seeding helpers (the
port's own copy of ``mm_diffusion_tpu/data/media.py``; numpy and the
standard library, with OpenCV / imageio used when installed).

Re-design of `mm_diffusion/common.py`:

* audio -> 16-bit PCM WAV via the stdlib ``wave`` module (the reference used
  soundfile; not available here).
* video -> mp4 via OpenCV ``VideoWriter`` when a codec is available, else
  animated GIF via imageio/PIL (parity: save_one_video/save_video,
  common.py:56-82).
* joint mux (common.py:46-54 used moviepy+ffmpeg) is gated: without an ffmpeg
  binary we write side-by-side ``.mp4`` + ``.wav`` with matching basenames.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from typing import Optional

import numpy as np

try:
    import cv2  # type: ignore

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

try:
    import imageio  # type: ignore

    _HAS_IMAGEIO = True
except Exception:  # pragma: no cover
    _HAS_IMAGEIO = False


def to_uint8_video(video: np.ndarray) -> np.ndarray:
    """[-1,1] float video [F,H,W,C] -> uint8 (parity with the reference's
    ((x+1)*127.5).clamp(0,255) decode, multimodal_sample_sr.py:159-161)."""
    v = (np.asarray(video, np.float32) + 1.0) * 127.5
    return np.clip(v, 0, 255).astype(np.uint8)


def save_audio(audio: np.ndarray, path: str, audio_rate: int = 16000):
    """Write mono/multichannel [-1,1] float audio [L,C] or [L] as 16-bit WAV
    (capability parity: common.py:28-33)."""
    a = np.asarray(audio, np.float32)
    if a.ndim == 1:
        a = a[:, None]
    a = np.clip(a, -1.0, 1.0)
    pcm = (a * 32767.0).astype(np.int16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as f:
        f.setnchannels(pcm.shape[1])
        f.setsampwidth(2)
        f.setframerate(audio_rate)
        f.writeframes(pcm.tobytes())


def save_video(video: np.ndarray, path: str, fps: int = 10) -> str:
    """Write [-1,1] float video [F,H,W,C] to mp4 (cv2) or gif (imageio).

    Returns the actual path written (extension may change if mp4 encoding is
    unavailable).  Capability parity: common.py:64-82.
    """
    frames = to_uint8_video(video)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".mp4") and _HAS_CV2:
        h, w = frames.shape[1:3]
        writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
        )
        if writer.isOpened():
            for fr in frames:
                writer.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
            writer.release()
            return path
        writer.release()
    # gif fallback
    gif_path = os.path.splitext(path)[0] + ".gif"
    if _HAS_IMAGEIO:
        imageio.mimsave(gif_path, list(frames), duration=1.0 / fps)
        return gif_path
    # last resort: raw npz
    npz_path = os.path.splitext(path)[0] + ".npz"
    np.savez_compressed(npz_path, video=frames)
    return npz_path


def save_image(img: np.ndarray, path: str) -> str:
    """[-1,1] float image [H,W,C] -> png (parity: save_img, common.py:35-44).

    Returns the path written: ``.npz`` where neither OpenCV nor imageio is
    installed."""
    frames = to_uint8_video(img[None])[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if _HAS_CV2:
        cv2.imwrite(path, cv2.cvtColor(frames, cv2.COLOR_RGB2BGR))
        return path
    if _HAS_IMAGEIO:
        imageio.imwrite(path, frames)
        return path
    npz_path = os.path.splitext(path)[0] + ".npz"
    np.savez_compressed(npz_path, image=frames)
    return npz_path


def _ffmpeg_binary() -> Optional[str]:
    """Resolve the ffmpeg binary used for AV muxing. ``MMDIFF_FFMPEG``
    overrides PATH lookup (also lets tests inject a stub binary); setting it
    to the empty string disables muxing entirely (forces the side-by-side
    layout regardless of PATH)."""
    override = os.environ.get("MMDIFF_FFMPEG")
    if override is not None:
        return override or None
    return shutil.which("ffmpeg")


def mux_av(video_path: str, audio_path: str, out_path: str) -> Optional[str]:
    """Mux a video file and an audio file into one container via ffmpeg
    (parity: save_multimodal's moviepy mux, common.py:46-54).

    Returns ``out_path`` on success, ``None`` when no ffmpeg binary exists or
    the mux fails (callers fall back to side-by-side files).
    """
    ffmpeg = _ffmpeg_binary()
    if ffmpeg is None:
        return None
    cmd = [
        ffmpeg, "-y", "-loglevel", "error",
        "-i", video_path, "-i", audio_path,
        "-c:v", "copy", "-c:a", "aac", "-shortest", out_path,
    ]
    try:
        proc = subprocess.run(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=120
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0 or not os.path.exists(out_path):
        return None
    return out_path


def save_multimodal(
    video: np.ndarray,
    audio: np.ndarray,
    base_path: str,
    fps: int = 10,
    audio_rate: int = 16000,
) -> tuple:
    """Joint AV save (parity: save_multimodal, common.py:46-54).

    When an ffmpeg binary is available (PATH or ``MMDIFF_FFMPEG``; set
    ``MMDIFF_FFMPEG=''`` to force side-by-side) the video and audio are
    muxed into one ``<base>.mp4`` container (the reference used
    moviepy+ffmpeg); otherwise we emit side-by-side ``<base>.mp4`` (or .gif)
    + ``<base>.wav`` with the same basename.

    Returns ``(video_path, audio_path)`` always; ``audio_path`` is ``None``
    when the audio track was muxed into the video container.
    """
    apath = base_path + ".wav"
    save_audio(audio, apath, audio_rate)
    vpath = save_video(video, base_path + "_video.mp4", fps=fps)
    if vpath.endswith(".mp4"):
        muxed = mux_av(vpath, apath, base_path + ".mp4")
        if muxed is not None:
            os.remove(vpath)
            os.remove(apath)
            return muxed, None
    # fallback: side-by-side with matching basenames — <base> + the codec's
    # chosen extension (a substring replace would mangle base paths that
    # themselves contain '_video')
    final_v = base_path + os.path.splitext(vpath)[1]
    os.replace(vpath, final_v)
    return final_v, apath


def save_video_grid(videos: np.ndarray, path: str, fps: int = 10, ncols: Optional[int] = None):
    """Tile a batch of videos [N,F,H,W,C] into one grid video
    (parity: save_one_video grid gif, common.py:56-63)."""
    n, f, h, w, c = videos.shape
    ncols = ncols or int(np.ceil(np.sqrt(n)))
    nrows = int(np.ceil(n / ncols))
    grid = np.full((f, nrows * h, ncols * w, c), -1.0, np.float32)
    for i in range(n):
        r, col = divmod(i, ncols)
        grid[:, r * h : (r + 1) * h, col * w : (col + 1) * w] = videos[i]
    return save_video(grid, path, fps=fps)


def set_seed(seed: int):
    """Deterministic host-side seeding (parity: set_seed_logger, common.py:84-101):
    the host numpy/python RNGs used by data pipelines.  Device randomness
    in the port comes from explicit ``torch.Generator``s."""
    import random

    np.random.seed(seed)
    random.seed(seed)
