"""Image-set evaluation: IS / FID / sFID / KID / improved precision and
recall.

The port of ``mm_diffusion_tpu/evaluation/image_eval.py``.  Inputs: an
``.npz`` batch (uint8 ``arr_0`` ``[N, H, W, 3]``; a video batch's frames
count as images) or a directory of image files (read with PIL, imported
only for a directory).  Two protocols, each on ``device`` in fp32:

* ``inception_pb`` (``classify_image_graph_def.pb``): the frozen TF1
  InceptionV3 graph executed with torch ops (``evaluation/graphdef.py``):
  Inception-IS, Inception-FID and sFID comparable to published tables;
* ``clip_checkpoint``: CLIP's visual ResNet embeds instead (CLIP-FID / KID,
  self-consistent, not comparable to Inception tables).

Precision / recall use the manifold algorithm (k = 3) in either space.
Without a checkpoint: pixel-statistics embeddings, ``protocol:
"fallback"`` (relative numbers only).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils import logger
from .common import fp32_precision, load_weights, read_torch_checkpoint
from .metrics import frechet_distance, polynomial_mmd, precision_recall

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def require_pil():
    """PIL's ``Image``, or an ImportError that names it (without PIL,
    evaluate an ``.npz`` batch)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading an image directory needs Pillow (pip install pillow); "
            "an .npz batch (uint8 arr_0 [N,H,W,3]) needs no PIL"
        ) from e
    return Image


def list_image_files(path: str) -> List[str]:
    out = []
    for root, _, names in os.walk(path):
        out.extend(os.path.join(root, n) for n in names if n.lower().endswith(IMAGE_EXTS))
    return sorted(out)


def load_image_batch(path: str, limit: Optional[int] = None) -> np.ndarray:
    """``.npz`` / ``.npy`` batch or a directory of images -> uint8
    ``[N, H, W, 3]``."""
    if os.path.isdir(path):
        files = list_image_files(path)
        if not files:
            raise FileNotFoundError(f"no images under {path}")
        if limit:
            files = files[:limit]
        image = require_pil()
        imgs = [np.asarray(image.open(f).convert("RGB"), np.uint8) for f in files]
        shapes = {im.shape for im in imgs}
        if len(shapes) != 1:
            raise ValueError(f"mixed image shapes under {path}: {sorted(shapes)}")
        return np.stack(imgs)
    if path.endswith(".npy"):
        arr = np.load(path)
    else:
        with np.load(path) as z:
            key = "arr_0" if "arr_0" in z else list(z.keys())[0]
            arr = z[key]
    if arr.ndim == 5 and arr.shape[-1] == 3:  # an AV / video batch: all its frames
        arr = arr.reshape(-1, *arr.shape[2:])
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"{path}: expected [N,H,W,3] uint8, got {arr.shape}")
    return arr[:limit].astype(np.uint8) if limit else arr.astype(np.uint8)


def make_clip_image_embedder(checkpoint: Optional[str], device="cuda") -> Optional[Callable]:
    """CLIP-visual image embedder on ``device`` from an AudioCLIP-full or
    OpenAI CLIP checkpoint (both keep the tower under ``visual.``); None
    when the checkpoint is absent."""
    if not checkpoint or not os.path.exists(checkpoint):
        return None
    from .clip_model import CLIPVisualResNet, preprocess_frames_for_clip

    model = load_weights(CLIPVisualResNet(), read_torch_checkpoint(checkpoint), prefix="visual.").to(device)

    @torch.no_grad()
    def embed(images_uint8: np.ndarray) -> np.ndarray:
        pre = preprocess_frames_for_clip(images_uint8[:, None], device)[:, 0]
        return model(pre).cpu().numpy()

    return embed


def _pixel_fallback_embed(images_uint8: np.ndarray) -> np.ndarray:
    x = images_uint8.astype(np.float32) / 255.0
    n = x.shape[0]
    # channel means / stds and a coarse 4x4 pooling: relative comparisons
    # only, not a perceptual space
    flat = x.reshape(n, -1, 3)
    h, w = x.shape[1], x.shape[2]
    gh, gw = max(h // 4, 1), max(w // 4, 1)
    pooled = x[:, : gh * 4, : gw * 4].reshape(n, 4, gh, 4, gw, 3).mean((2, 4))
    return np.concatenate([flat.mean(1), flat.std(1), pooled.reshape(n, -1)], axis=-1)


@fp32_precision()
def eval_images(
    ref_path: str,
    sample_path: str,
    clip_checkpoint: Optional[str] = None,
    eval_num: Optional[int] = None,
    batch_size: int = 64,
    nhood_size: int = 3,
    allow_fallback: bool = True,
    inception_pb: Optional[str] = None,
    device="cuda",
) -> Dict[str, float]:
    """FID / KID / precision / recall between two image sets; with
    ``inception_pb`` the OpenAI evaluator's exact suite (IS, FID, sFID, KID,
    precision, recall) over the frozen graph."""
    log = logger.get_current()
    if inception_pb:
        return _eval_images_inception(ref_path, sample_path, inception_pb, eval_num, batch_size, nhood_size, device)
    embed = make_clip_image_embedder(clip_checkpoint, device)
    fallback = embed is None
    if fallback and not allow_fallback:
        raise RuntimeError(
            "image eval: CLIP checkpoint missing "
            f"({clip_checkpoint or 'no --clip_checkpoint'}) — pixel-fallback "
            "embeddings are NOT a perceptual metric space. Pass "
            "--allow_fallback for relative-only numbers."
        )
    if fallback:
        log.log("image eval: no CLIP checkpoint — pixel-statistics embeddings (relative comparisons only)")
        embed = _pixel_fallback_embed

    def collect(path):
        imgs = load_image_batch(path, limit=eval_num)
        return np.concatenate([embed(imgs[i : i + batch_size]) for i in range(0, len(imgs), batch_size)])

    log.log(f"embedding sample set: {sample_path}")
    sample = collect(sample_path)
    log.log(f"embedding ref set: {ref_path}")
    ref = collect(ref_path)
    log.log(f"evaluate for {len(ref)} ref / {len(sample)} sample images")
    prec, rec = precision_recall(ref, sample, k=nhood_size)
    return {
        "fid": frechet_distance(sample, ref),
        "kid": polynomial_mmd(sample, ref),
        "precision": prec,
        "recall": rec,
        "image_embedder": "pixel_fallback" if fallback else "clip_visual",
        # CLIP-FID even with the checkpoint: the InceptionV3 protocol needs
        # the frozen graph (inception_pb)
        "protocol": "fallback" if fallback else "clip",
    }


def _eval_images_inception(ref_path, sample_path, inception_pb, eval_num, batch_size, nhood_size,
                           device) -> Dict[str, float]:
    """IS on the sample softmax, FID on pool_3, sFID on the mixed_6/conv
    spatial head, KID and precision / recall on pool_3."""
    from .graphdef import InceptionV3Features, inception_score_openai

    log = logger.get_current()
    feats = InceptionV3Features(inception_pb, device)

    def collect(path):
        imgs = load_image_batch(path, limit=eval_num)
        pools, spatials = [], []
        for i in range(0, len(imgs), batch_size):
            p, s = feats.features(imgs[i : i + batch_size].astype(np.float32))
            pools.append(p)
            spatials.append(s)
        return np.concatenate(pools), np.concatenate(spatials)

    log.log(f"inception-embedding sample set: {sample_path}")
    sample_pool, sample_spatial = collect(sample_path)
    log.log(f"inception-embedding ref set: {ref_path}")
    ref_pool, ref_spatial = collect(ref_path)
    log.log(f"evaluate for {len(ref_pool)} ref / {len(sample_pool)} sample images")
    prec, rec = precision_recall(ref_pool, sample_pool, k=nhood_size)
    return {
        "inception_score": inception_score_openai(feats.softmax(sample_pool)),
        "fid": frechet_distance(sample_pool, ref_pool),
        "sfid": frechet_distance(sample_spatial, ref_spatial),
        "kid": polynomial_mmd(sample_pool, ref_pool),
        "precision": prec,
        "recall": rec,
        "image_embedder": "inception_v3_tf1",
        "protocol": "openai",
    }
