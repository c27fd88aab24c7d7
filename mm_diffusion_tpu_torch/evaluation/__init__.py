"""Evaluation of generated samples, the port of ``mm_diffusion_tpu/
evaluation/``: FVD / KVD (I3D), FAD (AudioCLIP's audio tower), the AV-CLIP
score, image IS / FID / sFID / KID / precision-recall (the frozen TF1
InceptionV3 graph or CLIP), the C3D video IS, and the ``.npz`` batch files
that carry sample sets.

The networks run on the caller's device (``cuda`` by default) in fp32 with
TF32 off; the metrics run in float64 numpy on the host.  No module here
needs OpenCV, PIL or TensorFlow: frames are resized in torch
(``evaluation/resize.py``), and PIL is imported only to read an image
directory.
"""

from .audio_embed import LogMelEmbedder
from .evaluator import eval_multimodal
from .image_eval import eval_images
from .metrics import (
    frechet_distance,
    polynomial_kernel,
    polynomial_mmd,
    precision_recall,
    preprocess_videos_for_i3d,
    trace_sqrt_product,
)

__all__ = [
    "frechet_distance",
    "polynomial_kernel",
    "polynomial_mmd",
    "precision_recall",
    "preprocess_videos_for_i3d",
    "trace_sqrt_product",
    "eval_multimodal",
    "eval_images",
    "LogMelEmbedder",
]
