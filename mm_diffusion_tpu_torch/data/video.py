"""Host-side paired audio-video dataset (the port's own copy of
``mm_diffusion_tpu/data/video.py``: numpy, the standard library and OpenCV;
the same files, seed and shard give the same batches as the JAX package's).

* **clip index**: one JSON cache per (frames, gap, fps) config holding
  per-file frame counts / native fps; clips are dense windows over
  fps-resampled frame indices (torchvision ``VideoClips`` with
  ``frames_between_clips=1``).
* **video decode**: OpenCV; frames are mapped from target-fps indices back
  to native frame indices and decoded with ONE seek per clip and sequential
  reads.
* **audio**: pts-aligned to the clip window, from the first available
  decoder in the chain PyAV -> ffmpeg subprocess -> ``.wav`` sidecar with
  the same basename.  A clip with NO audio source is a **hard error**,
  never silent zeros.
* **sharding**: ``[shard::num_shards]`` slicing per process, keyed by the
  rank when a process group is initialised (``parallel.process_data_shard``).
* **prefetch**: worker threads own disjoint slices of the clip index and
  decode single items in parallel into a queue (cv2 releases the GIL); the
  consumer assembles batches and raises a dead worker's error.

OpenCV and PyAV are imported where a folder is read, not with the module:
the synthetic dataset (``data_dir="synthetic"``) needs neither.

Tensor contract (channels-last): video ``[F,H,W,C]`` float32 in [-1,1],
audio ``[L,C]`` float32 in [-1,1].
"""

from __future__ import annotations

import json
import os
import queue
import random
import shutil
import subprocess
import threading
import wave
from collections import OrderedDict
from math import gcd
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

VIDEO_EXTS = (".avi", ".gif", ".mp4")


def require_cv2():
    """OpenCV, which every folder dataset needs; an ImportError naming it
    otherwise."""
    try:
        import cv2  # type: ignore
    except ImportError as e:
        raise ImportError(
            "reading a dataset directory needs OpenCV (cv2), which is not installed; "
            "use --data_dir synthetic"
        ) from e
    return cv2


def list_video_files(data_dir: str) -> List[str]:
    """Every video file under ``data_dir``, recursively, sorted."""
    out = []
    for root, _dirs, files in os.walk(data_dir):
        for f in sorted(files):
            if f.lower().endswith(VIDEO_EXTS):
                out.append(os.path.join(root, f))
    return sorted(out)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """stdlib WAV reader -> float32 [L, C] in [-1,1] + sample rate."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        sw = f.getsampwidth()
        raw = f.readframes(n)
    if sw == 2:
        a = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif sw == 1:
        a = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sw == 4:
        a = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {sw}")
    return a.reshape(-1, ch), sr


def resample_audio(a: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample of [L, C] (scipy), linear where scipy is absent."""
    if sr_in == sr_out:
        return a
    try:
        from scipy.signal import resample_poly
    except ImportError:
        n_out = int(round(a.shape[0] * sr_out / sr_in))
        xs = np.linspace(0, a.shape[0] - 1, n_out)
        idx = xs.astype(np.int64)
        frac = (xs - idx)[:, None]
        idx2 = np.minimum(idx + 1, a.shape[0] - 1)
        return ((1 - frac) * a[idx] + frac * a[idx2]).astype(np.float32)
    g = gcd(sr_in, sr_out)
    return resample_poly(a, sr_out // g, sr_in // g, axis=0).astype(np.float32)


def _decode_audio_pyav(path: str, start_t: float, end_t: float) -> Optional[Tuple[np.ndarray, int]]:
    """Embedded-audio decode via PyAV when installed -> ([L,C] float32, sr)."""
    try:
        import av  # type: ignore
    except ImportError:
        return None
    try:
        with av.open(path) as container:
            if not container.streams.audio:
                return None
            stream = container.streams.audio[0]
            sr = stream.rate
            container.seek(int(start_t / stream.time_base), stream=stream, any_frame=False)
            chunks = []
            for frame in container.decode(stream):
                t0 = float(frame.pts * stream.time_base) if frame.pts is not None else 0.0
                arr = frame.to_ndarray()  # [C, S] or [S] packed
                if arr.ndim == 1:
                    arr = arr[None]
                arr = arr.T
                if arr.dtype.kind == "i":
                    arr = arr.astype(np.float32) / np.iinfo(arr.dtype).max
                else:
                    arr = arr.astype(np.float32)
                # trim to [start_t, end_t) by pts
                s0 = max(0, int(round((start_t - t0) * sr)))
                s1 = arr.shape[0] if t0 + arr.shape[0] / sr <= end_t else max(
                    0, int(round((end_t - t0) * sr))
                )
                if s1 > s0:
                    chunks.append(arr[s0:s1])
                if t0 + arr.shape[0] / sr >= end_t:
                    break
            if not chunks:
                return None
            return np.concatenate(chunks, axis=0), sr
    except Exception:  # an undecodable stream falls through to the next decoder
        return None


def _decode_audio_ffmpeg(
    path: str, start_t: float, end_t: float, sr_out: int
) -> Optional[Tuple[np.ndarray, int]]:
    """Embedded-audio decode via an ffmpeg subprocess when a binary exists."""
    binary = shutil.which("ffmpeg")
    if not binary:
        return None
    cmd = [
        binary, "-v", "error",
        "-ss", f"{start_t:.6f}", "-t", f"{end_t - start_t:.6f}",
        "-i", path,
        "-f", "f32le", "-acodec", "pcm_f32le", "-ac", "1", "-ar", str(sr_out),
        "pipe:1",
    ]
    try:
        out = subprocess.run(cmd, capture_output=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0 or not out.stdout:
        return None
    return np.frombuffer(out.stdout, np.float32).reshape(-1, 1), sr_out


def probe_video(path: str) -> Dict:
    """{"fps", "frames"} of one file (30 fps where the container has none)."""
    cv2 = require_cv2()
    cap = cv2.VideoCapture(path)
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0)
        return {"fps": float(fps if fps > 0 else 30.0), "frames": n}
    finally:
        cap.release()


def build_clip_index(
    files: List[str], clip_frames: int, video_fps: float, cache_path: Optional[str]
) -> List[Tuple[int, int]]:
    """Enumerate (file_idx, start_resampled_frame) dense clips, JSON-cached.

    Several processes sharing a filesystem may build the cache at once: the
    write is a temporary file and an atomic ``os.replace``, so a reader
    never sees a half-written file, and a corrupt or stale cache is rebuilt.
    """
    meta = None
    if cache_path and os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                cached = json.load(f)
            if cached.get("files") == files:
                meta = cached["meta"]
        except (json.JSONDecodeError, OSError, KeyError, TypeError, AttributeError):
            meta = None  # partial/corrupt cache: rebuild below
    if meta is None:
        meta = [probe_video(p) for p in files]
        if cache_path:
            tmp = f"{cache_path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump({"files": files, "meta": meta}, f)
                os.replace(tmp, cache_path)
            except OSError:  # read-only dir etc.: the index still works
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
    clips = []
    for i, m in enumerate(meta):
        total_resampled = int(m["frames"] * video_fps / m["fps"])
        for start in range(max(0, total_resampled - clip_frames + 1)):
            clips.append((i, start))
        if 0 < total_resampled < clip_frames:
            clips.append((i, 0))  # short video: padded at decode
    return clips


def resize_pad_video(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Aspect-preserving bicubic resize of ``[F,H,W,C]`` + center pad."""
    cv2 = require_cv2()
    f, h, w, c = frames.shape
    ratio = min(out_h / h, out_w / w)
    nh, nw = int(h * ratio), int(w * ratio)
    resized = np.stack(
        [cv2.resize(fr, (nw, nh), interpolation=cv2.INTER_CUBIC) for fr in frames]
    )
    if resized.ndim == 3:
        resized = resized[..., None]
    pad_h, pad_w = out_h - nh, out_w - nw
    top, left = pad_h // 2, pad_w // 2
    out = np.zeros((f, out_h, out_w, c), resized.dtype)
    out[:, top : top + nh, left : left + nw] = resized
    return out


class MultimodalVideoDataset:
    """Paired audio-video clips of every video under ``data_dir``, this
    shard's slice of the clip index."""

    _AUDIO_CACHE_MAX = 32  # wav files held in RAM

    def __init__(
        self,
        data_dir: str,
        video_size: Tuple[int, int, int, int],  # (F, C, H, W)
        audio_size: Tuple[int, int],  # (C, L)
        video_fps: float = 10.0,
        audio_fps: int = 16000,
        shard: int = 0,
        num_shards: int = 1,
        random_flip: bool = True,
        seed: int = 0,
    ):
        require_cv2()
        self.f, self.c, self.h, self.w = video_size
        self.ca, self.l = audio_size
        self.video_fps = video_fps
        self.audio_fps = audio_fps
        self.random_flip = random_flip
        self.files = list_video_files(data_dir)
        if not self.files:
            raise FileNotFoundError(f"no video files ({', '.join(VIDEO_EXTS)}) under {data_dir}")
        cache = os.path.join(data_dir, f"clip_index_f{self.f}_g1_r{int(video_fps)}.json")
        self.clips = build_clip_index(self.files, self.f, video_fps, cache)
        self.indices = list(range(len(self.clips)))[shard::num_shards]
        self._rng = random.Random(seed + shard)
        self._audio_cache: "OrderedDict[str, Tuple[np.ndarray, int]]" = OrderedDict()
        self._audio_lock = threading.Lock()

    def __len__(self):
        return len(self.indices)

    def _decode_video(self, path: str, start: int) -> np.ndarray:
        """ONE seek to the first needed native frame, then sequential reads
        (per-frame seeking costs a keyframe scan per frame on long-GOP
        files)."""
        cv2 = require_cv2()
        cap = cv2.VideoCapture(path)
        try:
            native_fps = cap.get(cv2.CAP_PROP_FPS) or self.video_fps
            # native index of each target-fps output frame (repeats when the
            # target fps is above the native one)
            need = [
                int(round((start + j) * native_fps / self.video_fps))
                for j in range(self.f)
            ]
            first, last = need[0], need[-1]
            if first > 0:
                cap.set(cv2.CAP_PROP_POS_FRAMES, first)
            decoded: Dict[int, np.ndarray] = {}
            pos = first
            want = sorted(set(need))
            wi = 0
            while pos <= last and wi < len(want):
                ok, fr = cap.read()
                if not ok:
                    break
                if pos == want[wi]:
                    decoded[pos] = cv2.cvtColor(fr, cv2.COLOR_BGR2RGB)
                    wi += 1
                pos += 1
        finally:
            cap.release()
        if not decoded:
            raise IOError(f"decode failed: {path}@{start}")
        # a missing tail repeats the last decoded frame (short videos)
        last_ok = decoded[max(decoded)]
        return np.stack([decoded.get(n, last_ok) for n in need])

    def _read_wav_cached(self, wav_path: str) -> Tuple[np.ndarray, int]:
        with self._audio_lock:
            if wav_path in self._audio_cache:
                self._audio_cache.move_to_end(wav_path)
                return self._audio_cache[wav_path]
        data = read_wav(wav_path)
        with self._audio_lock:
            self._audio_cache[wav_path] = data
            self._audio_cache.move_to_end(wav_path)
            while len(self._audio_cache) > self._AUDIO_CACHE_MAX:
                self._audio_cache.popitem(last=False)
        return data

    def _load_audio_window(self, path: str, start_t: float, end_t: float) -> np.ndarray:
        """The audio of ``[start_t, end_t)`` at ``audio_fps``, from embedded
        audio (PyAV, then ffmpeg) or a ``.wav`` sidecar; no source at all is
        an error."""
        seg_sr = _decode_audio_pyav(path, start_t, end_t)
        if seg_sr is None:
            seg_sr = _decode_audio_ffmpeg(path, start_t, end_t, self.audio_fps)
        if seg_sr is None:
            wav_path = os.path.splitext(path)[0] + ".wav"
            if os.path.exists(wav_path):
                raw, sr = self._read_wav_cached(wav_path)
                seg_sr = (raw[int(start_t * sr) : int(end_t * sr)], sr)
        if seg_sr is None:
            raise IOError(
                f"no audio source for {path}: no embedded-audio decoder is "
                "available (PyAV / ffmpeg not installed) and no .wav sidecar "
                "exists. Training would silently become video-only: provide "
                "sidecars or install a decoder."
            )
        seg, sr = seg_sr
        seg = resample_audio(seg, sr, self.audio_fps)
        if seg.shape[1] > self.ca:  # mono downmix: the first channel
            seg = seg[:, : self.ca]
        audio = np.zeros((self.l, self.ca), np.float32)
        n = min(self.l, seg.shape[0])
        audio[:n] = seg[:n]
        return audio

    def get_item(self, idx: int, rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        """One clip.  A clip that fails to decode is skipped by advancing the
        index; a missing audio *source* raises."""
        rng = rng or self._rng
        frames = None
        for _ in range(len(self.clips)):
            file_idx, start = self.clips[idx]
            path = self.files[file_idx]
            try:
                frames = self._decode_video(path, start)
                break
            except Exception:  # a corrupt clip: try the next one
                idx = (idx + 1) % len(self.clips)
        if frames is None:
            raise IOError("all clips failed to decode")

        video = resize_pad_video(frames, self.h, self.w).astype(np.float32)
        video = video / 127.5 - 1.0
        if self.random_flip and rng.random() < 0.5:
            video = video[:, :, ::-1].copy()

        start_t = start / self.video_fps
        end_t = (start + self.f) / self.video_fps
        audio = self._load_audio_window(path, start_t, end_t)
        return {"video": video, "audio": audio}

    def iter_indices(self, indices, seed: int) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite shuffled item stream over ``indices`` with a private RNG
        (each loader worker owns a disjoint slice)."""
        rng = random.Random(seed)
        order = list(indices)
        while True:
            rng.shuffle(order)
            for i in order:
                yield self.get_item(i, rng)

    def __iter__(self):
        yield from self.iter_indices(self.indices, self._rng.randint(0, 2**31))


def load_data(
    *,
    data_dir: str,
    batch_size: int,
    video_size: Tuple[int, int, int, int],
    audio_size: Tuple[int, int],
    video_fps: float = 10.0,
    audio_fps: int = 16000,
    random_flip: bool = True,
    num_workers: int = 4,
    shard: Optional[int] = None,
    num_shards: Optional[int] = None,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite generator of numpy batches ``{"video": [B,F,H,W,C], "audio":
    [B,L,C]}``.  ``data_dir="synthetic"`` is the procedural dataset (no
    media decode).  A worker's error (no audio source) is raised to the
    consumer while the other workers still produce.  ``shard`` /
    ``num_shards`` default to the process's rank and world size."""
    if shard is None or num_shards is None:
        from ..parallel.mesh import process_data_shard

        shard, num_shards = process_data_shard()
    if data_dir == "synthetic":
        from .synthetic import load_synthetic_data

        yield from load_synthetic_data(
            batch_size, video_size, audio_size, seed=seed, shard=shard, num_shards=num_shards,
        )
        return

    ds = MultimodalVideoDataset(
        data_dir, video_size, audio_size, video_fps, audio_fps,
        shard=shard, num_shards=num_shards, random_flip=random_flip, seed=seed,
    )

    def collate(items):
        return {
            k: np.stack([x[k] for x in items]).astype(np.float32)
            for k in ("video", "audio")
        }

    if num_workers <= 0:
        it = iter(ds)
        while True:
            yield collate([next(it) for _ in range(batch_size)])

    # Each worker thread owns a disjoint slice of the clip index and its own
    # RNG; the consumer assembles batches from the item queue.
    num_workers = min(num_workers, max(1, len(ds.indices)))
    item_q: "queue.Queue" = queue.Queue(maxsize=max(8, 2 * batch_size))
    errors: "queue.Queue" = queue.Queue()

    def worker(w: int):
        try:
            for item in ds.iter_indices(
                ds.indices[w::num_workers], seed * 10007 + shard * 101 + w
            ):
                item_q.put(item)
        except BaseException as e:  # handed to the consumer, which raises it
            errors.put(e)

    for w in range(num_workers):
        threading.Thread(target=worker, args=(w,), daemon=True).start()
    while True:
        items = []
        while len(items) < batch_size:
            # Check for dead workers BEFORE blocking: with >1 worker the
            # survivors keep the queue non-empty, so a dead worker's shard
            # would silently drop out of training.
            if not errors.empty():
                raise errors.get()
            try:
                items.append(item_q.get(timeout=1.0))
            except queue.Empty:
                pass
        yield collate(items)
