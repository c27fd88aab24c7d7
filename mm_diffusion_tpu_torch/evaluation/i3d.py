"""InceptionI3d (Kinetics-400), the FVD / KVD embedding network.

The port of ``mm_diffusion_tpu/evaluation/i3d.py``: Inception-v1 inflated
to 3-D with TF-SAME padding and frozen BatchNorm (eps 1e-3).  The module
tree and its ``state_dict`` keys are the original PyTorch I3D's
(``Conv3d_1a_7x7.conv3d.weight``, ``Mixed_4d.b1a.bn.running_mean``,
``logits.conv3d.bias``, ...), so ``i3d_pretrained_400.pt`` loads without a
converter, and ``mm_diffusion_tpu.evaluation.i3d.convert_torch_i3d`` reads
this module's ``state_dict``.

TF-SAME pads more at the end when the total is odd (``Conv3d_1a_7x7`` at
stride 2 on 224 pads (2, 3)); ``Conv3d``'s ``padding=`` cannot say that, so
each conv and max pool pads explicitly with ``F.pad`` and runs unpadded.
The max pools pad with -inf (the original pads zeros after a ReLU: equal).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import load_weights, read_torch_checkpoint

# out channels of each inception block's branches (b0, b1a, b1b, b2a, b2b, b3b)
INCEPTION_CFG = {
    "Mixed_3b": [64, 96, 128, 16, 32, 32],
    "Mixed_3c": [128, 128, 192, 32, 96, 64],
    "Mixed_4b": [192, 96, 208, 16, 48, 64],
    "Mixed_4c": [160, 112, 224, 24, 64, 64],
    "Mixed_4d": [128, 128, 256, 24, 64, 64],
    "Mixed_4e": [112, 144, 288, 32, 64, 64],
    "Mixed_4f": [256, 160, 320, 32, 128, 128],
    "Mixed_5b": [256, 160, 320, 32, 128, 128],
    "Mixed_5c": [384, 192, 384, 48, 128, 128],
}


def same_pad(sizes: Sequence[int], kernel: Sequence[int], stride: Sequence[int]) -> Tuple[int, ...]:
    """TF-SAME padding of the trailing dims, in ``F.pad``'s order (last dim
    first): each dim's total ``max((ceil(n/s) - 1) * s + k - n, 0)``, the
    larger half at the end."""
    pads = []
    for n, k, s in zip(sizes, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for lo_hi in reversed(pads) for p in lo_hi)


def max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """TF-SAME 3-D max pool over NCDHW, padded with -inf."""
    x = F.pad(x, same_pad(x.shape[2:], kernel, stride), value=float("-inf"))
    return F.max_pool3d(x, kernel, stride)


class Unit3D(nn.Module):
    """Conv3d (TF-SAME) + frozen BatchNorm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_bn: bool = True, activation: bool = True, use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv3d = nn.Conv3d(in_ch, out_ch, self.kernel, self.stride, padding=0, bias=use_bias)
        self.bn = nn.BatchNorm3d(out_ch, eps=1e-3, momentum=0.01) if use_bn else None

    def forward(self, x):
        x = self.conv3d(F.pad(x, same_pad(x.shape[2:], self.kernel, self.stride)))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    def __init__(self, in_ch: int, oc: Sequence[int]):
        super().__init__()
        self.b0 = Unit3D(in_ch, oc[0])
        self.b1a = Unit3D(in_ch, oc[1])
        self.b1b = Unit3D(oc[1], oc[2], kernel=(3, 3, 3))
        self.b2a = Unit3D(in_ch, oc[3])
        self.b2b = Unit3D(oc[3], oc[4], kernel=(3, 3, 3))
        self.b3b = Unit3D(in_ch, oc[5])

    def forward(self, x):
        return torch.cat([
            self.b0(x),
            self.b1b(self.b1a(x)),
            self.b2b(self.b2a(x)),
            self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1))),
        ], dim=1)


class InceptionI3d(nn.Module):
    """Input ``[B, T, H, W, 3]`` in [-1, 1] (channels-last, as the JAX
    module; 16 x 224^2 is the FVD protocol and the size the final (2, 7, 7)
    average pool admits); output ``[B, num_classes]`` logits averaged over
    time: the FVD embedding."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, kernel=(7, 7, 7), stride=(2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, kernel=(3, 3, 3))
        in_ch = 192
        for name, oc in INCEPTION_CFG.items():
            self.add_module(name, InceptionModule(in_ch, oc))
            in_ch = oc[0] + oc[2] + oc[4] + oc[5]
        self.logits = Unit3D(in_ch, num_classes, use_bn=False, activation=False, use_bias=True)

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3)  # -> NCDHW
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for k in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, k)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        return self.logits(x).mean(dim=(2, 3, 4))


def load_i3d(checkpoint_path: str) -> InceptionI3d:
    """I3D from the original ``.pt`` (``i3d_pretrained_400.pt``) or from the
    TF-Hub module's TensorBundle (a module directory, its ``variables``
    directory or a ``.index`` prefix; read by :mod:`.tf_bundle`)."""
    from .tf_bundle import find_bundle_prefix, load_tf_i3d

    try:
        find_bundle_prefix(checkpoint_path)
    except (FileNotFoundError, ValueError):
        sd = read_torch_checkpoint(checkpoint_path)
    else:
        sd = load_tf_i3d(checkpoint_path)
    return load_weights(InceptionI3d(), sd)
