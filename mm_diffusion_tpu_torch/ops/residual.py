"""The image U-Net ResBlock's last pass: ``skip + h`` with the biases of the
convs that made them, in one read of each input and one write.

* :func:`residual_bias_reference` -- the plain version: ``skip + h`` then
  the per-channel ``bias`` in fp32, one cast back to ``h``'s dtype.
* :func:`residual_bias_cuda` -- the hand-written kernel
  (``csrc/residual_bias.cu``) on bf16 ``[N, C, ...]`` of one shape: the
  plain version's arithmetic, written into ``h``'s storage (the second
  conv's temporary).  Channels-last inputs with ``C % 8 == 0`` and 16-byte
  aligned storage take its vector path, anything else its strided one; an
  input in neither channels-last nor contiguous memory is copied first.
  Launches counted in :data:`LAUNCHES`.
* :func:`residual_bias` -- what the ResBlock calls, its second conv and its
  skip conv having run without their biases.  The route follows the
  tensors, counted in :data:`ROUTES`:

  - ``"autograd"``: autograd records (training, the remat recompute): the
    adds that the convs and the residual made, each in the activations'
    dtype, so that the bias gradients flow as through the convs;
  - ``"cpu"``: a CPU tensor: the plain version, with the two biases summed
    in fp32;
  - ``"kernel"``: bf16 CUDA tensors: the kernel, with that sum;
  - ``"eager"``: a CUDA tensor of another dtype (fp32 models on the card):
    the adds of the autograd route.

  Each call is also counted in ``group_norm.BIAS_FOLDS``: ``"residual"``
  (and ``"skip"`` with a skip conv's bias) where the biases are folded,
  ``"eager"`` where they are added unfolded.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from . import cuda_build
from .group_norm import BIAS_FOLDS, _per_channel, channels_last, records_autograd

# The kernels' symbols as the profiler names them: benchmark/trace.py's
# "elementwise" kind, which none of the earlier kinds' keys match.
KERNEL_NAME = "mmdiff::ew::residual_bias_elementwise_kernel"
STRIDED_KERNEL_NAME = "mmdiff::ew::residual_bias_elementwise_strided_kernel"

LAUNCHES = {"residual_bias": 0}
ROUTES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES["residual_bias"] = 0
    ROUTES.clear()


def residual_bias_reference(skip: torch.Tensor, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``skip + h + bias`` in fp32 (``bias`` [C] over ``h [N, C, ...]``),
    cast once to ``h``'s dtype; the inputs' memory format out."""
    return (skip.float() + h.float() + _per_channel(bias.float(), h)).to(h.dtype)


def residual_bias_cuda(skip: torch.Tensor, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel: bf16 ``skip``, ``h`` [N, C, ...] of one shape on the card,
    ``bias`` [C]; writes ``skip + h + bias`` into ``h`` (into a contiguous
    copy where ``h`` is neither channels-last nor contiguous) and returns
    it, in ``h``'s layout."""
    if not (h.device.type == skip.device.type == "cuda" and h.dtype == skip.dtype == torch.bfloat16
            and skip.shape == h.shape and h.dim() >= 2):
        raise ValueError(f"residual_bias: the kernel takes bf16 CUDA tensors [N, C, ...] of one shape, got "
                         f"{skip.dtype} {tuple(skip.shape)} on {skip.device} / {h.dtype} {tuple(h.shape)} on "
                         f"{h.device}")
    c = h.shape[1]
    if channels_last(h):
        skip, inner = skip.contiguous(memory_format=torch.channels_last), 1
    else:
        h, skip = h.contiguous(), skip.contiguous()
        inner = h[0, 0].numel()
    b = bias.float().contiguous()
    if b.shape != (c,) or b.device != h.device:
        raise ValueError(f"residual_bias: bias of shape {tuple(b.shape)} on {b.device}; expected ({c},) on {h.device}")
    if h.numel() == 0:
        return h
    lib = cuda_build.load().lib
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmdiff_residual_bias(skip.data_ptr(), h.data_ptr(), h.data_ptr(), b.data_ptr(),
                                       h.numel() // (c * inner), c, inner, stream)
    if err:
        raise RuntimeError(f"residual_bias kernel launch failed (cuda error {err}) at {tuple(h.shape)}")
    LAUNCHES["residual_bias"] += 1
    return h


def _route(skip: torch.Tensor, h: torch.Tensor, biases) -> str:
    if records_autograd((skip, h) + biases):
        return "autograd"
    if h.device.type == "cpu":
        return "cpu"
    if h.device.type == "cuda" and h.dtype == skip.dtype == torch.bfloat16:
        return "kernel"
    return "eager"


def residual_bias(skip: torch.Tensor, h: torch.Tensor, bias: torch.Tensor,
                  skip_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(skip + skip_bias) + (h + bias)`` on the route that the tensors
    select (module docstring): ``bias`` the second conv's, ``skip_bias`` the
    skip conv's or None; ``h`` may be overwritten."""
    biases = (bias,) if skip_bias is None else (bias, skip_bias)
    route = _route(skip, h, biases)
    ROUTES[route] += 1
    if route in ("autograd", "eager"):
        BIAS_FOLDS["eager"] += 1
        if skip_bias is not None:
            skip = skip + _per_channel(skip_bias.to(skip.dtype), skip)
        return skip + (h + _per_channel(bias.to(h.dtype), h))
    BIAS_FOLDS["residual"] += 1
    total = bias.float()
    if skip_bias is not None:
        BIAS_FOLDS["skip"] += 1
        total = total + skip_bias.float()
    if route == "kernel":
        return residual_bias_cuda(skip, h, total)
    return residual_bias_reference(skip, h, total)
