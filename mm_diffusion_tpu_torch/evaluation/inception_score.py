"""Inception Score over classifier logits (a numpy copy of
``mm_diffusion_tpu/evaluation/inception_score.py``): IS = exp(E_x[KL(p(y|x)
|| p(y))]) over softmax posteriors, the mean and std over ``splits`` chunks.
The evaluator feeds it I3D's 400-way logits ("video IS")."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def inception_score(
    logits: np.ndarray, splits: int = 10, rng_seed: Optional[int] = None
) -> Tuple[float, float]:
    """IS mean and std of ``logits`` ``[N, C]`` (pre-softmax)."""
    logits = np.asarray(logits, np.float64)
    if rng_seed is not None:
        logits = logits[np.random.RandomState(rng_seed).permutation(len(logits))]
    z = logits - logits.max(axis=1, keepdims=True)
    probs = np.exp(z)
    probs /= probs.sum(axis=1, keepdims=True)

    scores = []
    n = len(probs)
    for i in range(splits):
        part = probs[i * n // splits : (i + 1) * n // splits]
        if len(part) == 0:
            continue
        marginal = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(marginal + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))
