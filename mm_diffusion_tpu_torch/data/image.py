"""Image datasets: plain folders and SR training pairs with degradations
(the port's own copy of ``mm_diffusion_tpu/data/image.py``; the same files,
seed and shard give the same batches as the JAX package's).

The resize-pad folder dataset of ``image_datasets.py`` and the SR pairs of
``real_image_datasets.py`` (bicubic downsample, Gaussian noise, JPEG
artifacts).  Channels-last float32 in [-1,1].  OpenCV is imported where an
image is read or degraded, not with the module.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Tuple

import numpy as np

from .video import require_cv2

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def list_image_files(data_dir: str) -> List[str]:
    """Every image file under ``data_dir``, recursively, sorted."""
    out = []
    for root, _dirs, files in os.walk(data_dir):
        for f in sorted(files):
            if f.lower().endswith(IMAGE_EXTS):
                out.append(os.path.join(root, f))
    return sorted(out)


def _shard_files(data_dir: str, shard: int, num_shards: int) -> List[str]:
    files = list_image_files(data_dir)[shard::num_shards]
    if not files:
        raise FileNotFoundError(f"no images ({', '.join(IMAGE_EXTS)}) under {data_dir}")
    return files


def _read_rgb(path: str) -> np.ndarray:
    cv2 = require_cv2()
    img = cv2.imread(path)
    if img is None:
        raise IOError(f"cannot read image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def resize_pad_image(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Aspect-preserving bicubic resize of ``[H,W,C]`` + center pad."""
    cv2 = require_cv2()
    h, w = img.shape[:2]
    ratio = min(out_h / h, out_w / w)
    nh, nw = int(h * ratio), int(w * ratio)
    resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_CUBIC)
    out = np.zeros((out_h, out_w, img.shape[2]), resized.dtype)
    top, left = (out_h - nh) // 2, (out_w - nw) // 2
    out[top : top + nh, left : left + nw] = resized
    return out


def degrade_lr(
    hr: np.ndarray,
    small_size: int,
    rng: random.Random,
    noise_std_range: Tuple[float, float] = (0.0, 0.06),
    jpeg_quality_range: Tuple[int, int] = (40, 95),
    apply_noise: bool = True,
    apply_jpeg: bool = True,
) -> np.ndarray:
    """Bicubic downsample + JPEG artifacts + Gaussian noise of a uint8 HWC
    image; returns the float32 [-1,1] LR image."""
    cv2 = require_cv2()
    lr = cv2.resize(hr, (small_size, small_size), interpolation=cv2.INTER_CUBIC)
    if apply_jpeg:
        q = rng.randint(*jpeg_quality_range)
        ok, enc = cv2.imencode(".jpg", lr, [int(cv2.IMWRITE_JPEG_QUALITY), q])
        if ok:
            lr = cv2.imdecode(enc, cv2.IMREAD_COLOR)
    lr = lr.astype(np.float32) / 127.5 - 1.0
    if apply_noise:
        std = rng.uniform(*noise_std_range)
        lr = lr + np.random.RandomState(rng.randint(0, 2**31)).randn(*lr.shape).astype(
            np.float32
        ) * std
    return np.clip(lr, -1.0, 1.0)


def load_image_data(
    *,
    data_dir: str,
    batch_size: int,
    image_size: int,
    random_flip: bool = True,
    shard: int = 0,
    num_shards: int = 1,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Infinite generator of ``[B, S, S, 3]`` image batches."""
    files = _shard_files(data_dir, shard, num_shards)
    rng = random.Random(seed + shard)
    while True:
        batch = []
        for _ in range(batch_size):
            img = resize_pad_image(_read_rgb(rng.choice(files)), image_size, image_size)
            x = img.astype(np.float32) / 127.5 - 1.0
            if random_flip and rng.random() < 0.5:
                x = x[:, ::-1].copy()
            batch.append(x)
        yield np.stack(batch)


def load_sr_data(
    *,
    data_dir: str,
    batch_size: int,
    large_size: int,
    small_size: int,
    degrade: bool = True,
    random_flip: bool = True,
    shard: int = 0,
    num_shards: int = 1,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite generator of SR training batches: ``high_res`` [B,L,L,3],
    ``low_res`` [B,S,S,3] (degraded when ``degrade``) and ``sr_bicubic``,
    the LR image bicubically upsampled back to L."""
    cv2 = require_cv2()
    files = _shard_files(data_dir, shard, num_shards)
    rng = random.Random(seed + shard)
    while True:
        hrs, lrs, srs = [], [], []
        for _ in range(batch_size):
            img = resize_pad_image(_read_rgb(rng.choice(files)), large_size, large_size)
            if random_flip and rng.random() < 0.5:
                img = img[:, ::-1].copy()
            if degrade:
                lr = degrade_lr(img, small_size, rng)
            else:
                # the third positional argument of cv2.resize is dst, so this
                # is the default (bilinear) interpolation, as in the JAX package
                lr = (
                    cv2.resize(img, (small_size, small_size), cv2.INTER_CUBIC).astype(
                        np.float32
                    )
                    / 127.5
                    - 1.0
                )
            sr_b = cv2.resize(
                ((lr + 1) * 127.5).astype(np.uint8), (large_size, large_size),
                interpolation=cv2.INTER_CUBIC,
            ).astype(np.float32) / 127.5 - 1.0
            hrs.append(img.astype(np.float32) / 127.5 - 1.0)
            lrs.append(lr)
            srs.append(sr_b)
        yield {
            "high_res": np.stack(hrs),
            "low_res": np.stack(lrs),
            "sr_bicubic": np.stack(srs),
        }
