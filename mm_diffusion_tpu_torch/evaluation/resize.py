"""The evaluation's one frame resize, in torch on the frames' device.

The JAX package resizes evaluation frames with OpenCV: ``INTER_LINEAR`` for
I3D (``mm_diffusion_tpu/evaluation/metrics.py:74-95``), ``INTER_CUBIC`` for
the npz loader, CLIP and C3D.  The port's evaluation must run where OpenCV
is absent, so every resize goes through :func:`resize_uint8`:

* ``bicubic``: a = -0.75, half-pixel centres, no antialias -- OpenCV's
  ``INTER_CUBIC`` kernel (OpenCV does not antialias a bicubic downscale
  either);
* ``bilinear``: ``align_corners=False``, no antialias -- ``INTER_LINEAR``'s
  formula;
* the result is rounded and clamped to uint8, as OpenCV returns uint8 for a
  uint8 input.

OpenCV computes uint8 resizes with fixed-point coefficients, so a pixel may
differ from it by one step (``tests/test_torch_port_eval_resize.py`` holds
the function to at most 1 against ``cv2.resize`` at the protocol's shapes).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

Frames = Union[np.ndarray, torch.Tensor]


def as_tensor(frames: Frames, device) -> torch.Tensor:
    """numpy or tensor -> a tensor on ``device`` (no copy when it is there)."""
    if isinstance(frames, np.ndarray):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    return frames.to(device)


def resize_uint8(frames: Frames, out_h: int, out_w: int, mode: str, device=None) -> torch.Tensor:
    """uint8 ``[N, H, W, C]`` -> uint8 ``[N, out_h, out_w, C]`` on ``device``
    (default: the frames' own), ``mode`` ``"bicubic"`` or ``"bilinear"``."""
    if mode not in ("bicubic", "bilinear"):
        raise ValueError(f"resize mode {mode!r}: bicubic or bilinear")
    x = as_tensor(frames, device if device is not None else getattr(frames, "device", "cpu"))
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"expected uint8 [N, H, W, C] frames, got {x.dtype} {tuple(x.shape)}")
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(out_h, out_w), mode=mode,
                      align_corners=False, antialias=False)
    return y.round_().clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def resize_pad_video(frames: Frames, out_h: int, out_w: int, device=None) -> torch.Tensor:
    """Aspect-preserving bicubic resize of uint8 ``[F, H, W, C]`` and a
    centred zero pad to ``out_h x out_w`` (the torch counterpart of
    ``data/video.py::resize_pad_video``, which the JAX npz loader calls)."""
    f, h, w, c = frames.shape
    ratio = min(out_h / h, out_w / w)
    nh, nw = int(h * ratio), int(w * ratio)
    resized = resize_uint8(frames, nh, nw, "bicubic", device)
    top, left = (out_h - nh) // 2, (out_w - nw) // 2
    out = torch.zeros((f, out_h, out_w, c), dtype=torch.uint8, device=resized.device)
    out[:, top : top + nh, left : left + nw] = resized
    return out
