"""C3D (UCF-101) video Inception Score, the TGAN protocol.

The port of ``mm_diffusion_tpu/evaluation/c3d.py``.  The published weights
(``conv3d_deepnetA_ucf.npz``) are chainer's plain numpy ``.npz``:
``{conv1a..conv5b}/W [O, I, kT, kH, kW]`` (already torch's ``Conv3d``
layout) and ``/b``, ``fc{6,7,8}/W [O, I]`` and ``/b`` (leading-slash keys
accepted).  The network: eight 3x3x3 convs (pad 1) with ReLU; pool1
spatial-only, pools 2-5 cubic k = 2 with chainer's ``cover_all`` (ceil)
windows, which turn pool4's 7^2 into pool5's 4^2; fc6 flattens chainer's
channel-major ``(C, T, H, W)``; softmax over the 101 classes.  Dropout is
off (eval mode), as in the JAX package.

Preprocessing: each frame bicubically resized to 128^2 (the torch resize
of ``evaluation/resize.py``, rounded to uint8 as OpenCV returns it), RGB to
BGR, the ``mean2.npz`` clip mean subtracted, the 8:120 crop to 112^2.  IS:
TGAN's single split with eps 1e-7.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import logger
from .common import fp32_precision
from .resize import as_tensor, resize_uint8

CONVS = ("conv1a", "conv2a", "conv3a", "conv3b", "conv4a", "conv4b", "conv5a", "conv5b")
FCS = ("fc6", "fc7", "fc8")


def load_c3d_npz(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Chainer-format C3D weights -> ``{name: {"W": ..., "b": ...}}`` in
    their own (torch) layout."""
    with np.load(path) as z:
        raw = {k.lstrip("/"): np.asarray(z[k], np.float32) for k in z.files}
    params = {}
    for name in CONVS + FCS:
        w = raw[f"{name}/W"]
        if w.ndim != (5 if name in CONVS else 2):
            raise ValueError(f"{name}/W has shape {w.shape}")
        params[name] = {"W": w, "b": raw[f"{name}/b"]}
    return params


class C3D(nn.Module):
    """The C3D graph over the chainer arrays (every size from the
    weights).  Input ``[B, T, H, W, 3]`` BGR, preprocessed (16 x 112^2);
    output class posteriors ``[B, classes]``."""

    def __init__(self, params: Dict[str, Dict[str, np.ndarray]]):
        super().__init__()
        for name in CONVS:
            o, i = params[name]["W"].shape[:2]
            self.add_module(name, nn.Conv3d(i, o, 3, padding=1))
        for name in FCS:
            o, i = params[name]["W"].shape
            self.add_module(name, nn.Linear(i, o))
        with torch.no_grad():
            for name in CONVS + FCS:
                getattr(self, name).weight.copy_(torch.from_numpy(params[name]["W"]))
                getattr(self, name).bias.copy_(torch.from_numpy(params[name]["b"]))
        self.eval().requires_grad_(False)

    def forward(self, x):
        h = x.permute(0, 4, 1, 2, 3)  # -> NCDHW
        h = F.relu(self.conv1a(h))
        h = F.max_pool3d(h, (1, 2, 2), ceil_mode=True)
        h = F.relu(self.conv2a(h))
        h = F.max_pool3d(h, 2, ceil_mode=True)
        for a, b in (("conv3a", "conv3b"), ("conv4a", "conv4b"), ("conv5a", "conv5b")):
            h = F.relu(getattr(self, b)(F.relu(getattr(self, a)(h))))
            h = F.max_pool3d(h, 2, ceil_mode=True)
        h = h.reshape(h.shape[0], -1)  # NCDHW flatten == chainer's order
        h = F.relu(self.fc6(h))
        h = F.relu(self.fc7(h))
        return torch.softmax(self.fc8(h), dim=-1)


def c3d_apply(params: Dict[str, Dict[str, np.ndarray]], x) -> torch.Tensor:
    """One forward of :class:`C3D` built from ``params`` on ``x``'s device."""
    x = torch.as_tensor(x)
    with fp32_precision():
        return C3D(params).to(x.device)(x.float())


def load_c3d_mean(path: str) -> np.ndarray:
    """``mean2.npz`` -> the BGR clip mean ``[3, 1, 16, 128, 128]``."""
    mean = np.load(path)["mean"].astype(np.float32)
    return mean.reshape((3, 1, 16, 128, 171))[:, :, :, :, 21 : 21 + 128]


def preprocess_videos_c3d(videos_rgb, mean: np.ndarray, device=None) -> torch.Tensor:
    """uint8 RGB ``[N, F, H, W, 3]`` -> the model's input ``[N, 16, 112,
    112, 3]`` BGR, mean-subtracted, on ``device``."""
    x = as_tensor(videos_rgb, device if device is not None else getattr(videos_rgb, "device", "cpu"))
    n, f, h, w, c = x.shape
    if f < 16:  # pad short clips by repeating the last frame
        x = torch.cat([x, x[:, -1:].expand(n, 16 - f, h, w, c)], dim=1)[:, :16]
        f = 16
    resized = resize_uint8(x.reshape(n * f, h, w, c), 128, 128, "bicubic").float()
    y = resized.permute(3, 0, 1, 2).reshape(c, n, f, 128, 128)
    y = y.flip(0) - torch.as_tensor(mean, device=y.device)  # RGB -> BGR, then the BGR mean
    y = y[:, :, :, 8 : 8 + 112, 8 : 8 + 112]
    return y.permute(1, 2, 3, 4, 0).contiguous()


def calc_inception_tgan(ys: np.ndarray) -> float:
    """TGAN's IS: one split, eps 1e-7."""
    p_all = np.mean(ys, axis=0, keepdims=True)
    kl = np.sum(ys * np.log(ys + 1e-7) - ys * np.log(p_all + 1e-7)) / ys.shape[0]
    return float(np.exp(kl))


@fp32_precision()
def video_inception_score_c3d(
    videos_rgb: np.ndarray,
    c3d_npz: str,
    mean_npz: str,
    batch_size: int = 16,
    params: Optional[Dict] = None,
    device="cuda",
) -> float:
    """The C3D video IS of uint8 RGB ``[N, F, H, W, 3]`` clips, the network
    on ``device`` in fp32."""
    log = logger.get_current()
    params = load_c3d_npz(c3d_npz) if params is None else params
    mean = load_c3d_mean(mean_npz)
    model = C3D(params).to(device)
    ys = []
    for i in range(0, len(videos_rgb), batch_size):
        x = preprocess_videos_c3d(videos_rgb[i : i + batch_size], mean, device)
        ys.append(model(x).cpu().numpy())
    ys = np.concatenate(ys)
    log.log(f"c3d video IS over {len(ys)} clips")
    return calc_inception_tgan(ys)
