"""Distribution metrics: Fréchet distance (FVD/FAD), polynomial-kernel MMD
(KVD/KID) and improved precision/recall -- float64 numpy on the host -- and
the I3D preprocessing, in torch on the evaluator's device.

A copy of ``mm_diffusion_tpu/evaluation/metrics.py`` (the same float64
arithmetic; ``tests/test_torch_port_eval_metrics.py`` holds the two to
1e-10).  Fréchet distance uses the TF-GAN formulation with the symmetric PSD
square root by eigendecomposition; KVD is the unbiased polynomial MMD with
sklearn's defaults (degree 3, gamma = 1/d, coef0 = 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import true_divide
from .resize import as_tensor, resize_uint8


def _sym_sqrt(mat: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Square root of a symmetric PSD matrix; tiny negative eigenvalues
    from ``eigh`` are clamped to zero."""
    mat = np.asarray(mat, np.float64)
    mat = (mat + mat.T) / 2.0
    w, v = np.linalg.eigh(mat)
    w = np.where(w < eps, np.maximum(w, 0.0), np.sqrt(np.maximum(w, 0.0)))
    return (v * w) @ v.T


def trace_sqrt_product(sigma: np.ndarray, sigma_v: np.ndarray) -> float:
    sqrt_sigma = _sym_sqrt(sigma)
    return float(np.trace(_sym_sqrt(sqrt_sigma @ sigma_v @ sqrt_sigma)))


def frechet_distance(x1: np.ndarray, x2: np.ndarray) -> float:
    """Fréchet distance between two embedding sets ``[N, D]``."""
    x1 = np.asarray(x1, np.float64).reshape(x1.shape[0], -1)
    x2 = np.asarray(x2, np.float64).reshape(x2.shape[0], -1)
    m1, m2 = x1.mean(0), x2.mean(0)
    s1 = np.cov(x1, rowvar=False)
    s2 = np.cov(x2, rowvar=False)
    trace = float(np.trace(s1 + s2)) - 2.0 * trace_sqrt_product(s1, s2)
    return float(np.sum((m1 - m2) ** 2) + trace)


def polynomial_kernel(x: np.ndarray, y: np.ndarray = None, degree: int = 3,
                      gamma: float = None, coef0: float = 1.0) -> np.ndarray:
    """sklearn's polynomial kernel with its defaults."""
    y = x if y is None else y
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef0) ** degree


def polynomial_mmd(x: np.ndarray, y: np.ndarray) -> float:
    """Unbiased polynomial-kernel MMD."""
    x = np.asarray(x, np.float64).reshape(x.shape[0], -1)
    y = np.asarray(y, np.float64).reshape(y.shape[0], -1)
    m, n = x.shape[0], y.shape[0]
    k_xx = polynomial_kernel(x)
    k_yy = polynomial_kernel(y)
    k_xy = polynomial_kernel(x, y)
    s_xx = (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
    s_yy = (k_yy.sum() - np.trace(k_yy)) / (n * (n - 1))
    s_xy = k_xy.sum() / (m * n)
    return float(s_xx + s_yy - 2 * s_xy)


def preprocess_videos_for_i3d(videos_uint8, resolution: int = 224, device=None) -> torch.Tensor:
    """uint8 ``[B, T, H, W, C]`` (numpy or tensor) -> float32 ``[B, T, res,
    res, C]`` in [-1, 1] on ``device``: the shorter side bilinearly scaled to
    ``resolution`` (rounded to uint8, as OpenCV returns it), then a centre
    crop."""
    x = as_tensor(videos_uint8, device if device is not None else getattr(videos_uint8, "device", "cpu"))
    b, t, h, w, c = x.shape
    scale = resolution / min(h, w)
    if h < w:
        nh, nw = resolution, int(math.ceil(w * scale))
    else:
        nh, nw = int(math.ceil(h * scale)), resolution
    frames = resize_uint8(x.reshape(b * t, h, w, c), nh, nw, "bilinear")
    y0, x0 = (nh - resolution) // 2, (nw - resolution) // 2
    frames = frames[:, y0 : y0 + resolution, x0 : x0 + resolution]
    out = true_divide(frames.float(), 255.0)  # then - 0.5 cancels: divide alike on every device
    return ((out - 0.5) * 2.0).reshape(b, t, resolution, resolution, c)


def _pairwise_sq_dists(a: np.ndarray, b: np.ndarray, block: int = 2048) -> np.ndarray:
    """Blocked squared euclidean distances ``[Na, Nb]`` in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    out = np.empty((a.shape[0], b.shape[0]), np.float64)
    b_sq = (b * b).sum(-1)
    for i in range(0, a.shape[0], block):
        chunk = a[i : i + block]
        d = (chunk * chunk).sum(-1)[:, None] + b_sq[None, :] - 2.0 * chunk @ b.T
        out[i : i + block] = np.maximum(d, 0.0)
    return out


def manifold_radii(features: np.ndarray, k: int = 3) -> np.ndarray:
    """Squared distance from each point to its k-th nearest other point of
    the same set (the hypersphere radii of improved precision/recall)."""
    d = _pairwise_sq_dists(features, features)
    np.fill_diagonal(d, np.inf)
    return np.partition(d, k - 1, axis=1)[:, k - 1]


def precision_recall(ref_features: np.ndarray, sample_features: np.ndarray, k: int = 3) -> tuple:
    """Improved precision and recall (Kynkaanniemi et al. 2019):
    precision = share of samples inside any reference hypersphere, recall =
    share of references inside any sample hypersphere."""
    ref = np.asarray(ref_features, np.float64).reshape(ref_features.shape[0], -1)
    sam = np.asarray(sample_features, np.float64).reshape(sample_features.shape[0], -1)
    r_ref = manifold_radii(ref, k)
    r_sam = manifold_radii(sam, k)
    d = _pairwise_sq_dists(sam, ref)
    precision = float(np.mean((d <= r_ref[None, :]).any(axis=1)))
    recall = float(np.mean((d.T <= r_sam[None, :]).any(axis=1)))
    return precision, recall
