"""GroupNorm, FiLM and SiLU as one pass: the ResBlocks' ``norm -> SiLU``.

* :func:`group_norm_silu_reference` -- the plain version: the eager
  modules' arithmetic in fp32 (GroupNorm's statistics and affine, FiLM's
  ``y * (1 + scale) + shift``, the SiLU), one cast back to the input's
  dtype at the end.
* :func:`group_norm_silu_cuda` -- the hand-written kernel
  (``csrc/group_norm_silu.cu``) on bf16 ``x [N, C, ...]``: fp32 statistics,
  FiLM and SiLU in registers, one rounding to bf16 at the store.  Its mode
  follows ``x``'s memory:

  - contiguous (channels-first): a slab of one sample's group of up to
    768 KB is read from device memory once and written once, a larger one
    read twice;
  - channels-last (4-d ``x`` with ``torch.channels_last`` strides: the
    image U-Net's activations): rows of C channels (at most 4,096), each
    sample read twice over a cluster of blocks; the output has the input's
    strides;
  - anything else: a contiguous copy, then the channels-first mode.

  Launches counted in :data:`LAUNCHES`, one entry a mode.
* :func:`group_norm_silu` -- what the models call, with a ``GroupNorm32``
  (or an ``MMNorm`` holding one).  The route follows the tensors, counted in
  :data:`ROUTES`:

  - ``"autograd"``: autograd records (grad mode on and any of ``x``, the
    norm's parameters or the FiLM pair requires grad: training, the remat
    recompute, the gradient-method sampler): the norm module then
    ``F.silu``, the code and the backward these paths always ran;
  - ``"fused"``: a bf16 CUDA tensor otherwise (the samplers, which run under
    ``inference_mode`` or ``no_grad``): the kernel;
  - ``"fused_cl"``: the same, with ``x`` channels-last: the kernel's
    channels-last mode;
  - ``"cpu"``: a CPU tensor: the plain version;
  - ``"eager"``: a CUDA tensor of another dtype (fp32 models on the card):
    the norm module then ``F.silu``, as the kernel takes bf16 only.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .common import Tolerance

Film = Optional[Tuple[torch.Tensor, torch.Tensor]]

# The kernel's symbol as the profiler names it (the "group norm" kind of
# benchmark/trace.py's KINDS, which none of the earlier kinds' keys match).
KERNEL_NAME = "mmdiff::gn::group_norm_silu_kernel"
# The channels-last mode's kernel.
CL_KERNEL_NAME = "mmdiff::gn::group_norm_silu_cl_kernel"
# The kernel against its plain version, both rounded to bf16 once: the fp32
# sums and coefficients are taken in another order, so a value next to a
# rounding boundary may round the other way, one bf16 step (2^-8 of the
# value's binade, at most 2^-7 of the value) apart; the absolute term covers
# outputs near zero, where fp32's own error over |x * w| ~ 10 is ~1e-6.
GN_TOL = Tolerance(1e-4, 2**-7)

# Launches on the main path by mode: channels-first, channels-last (the
# forced two-read mode of the same-run comparison is not counted).
LAUNCHES = {"group_norm_silu": 0, "group_norm_silu_cl": 0}
# Calls of group_norm_silu by route (see the module docstring).
ROUTES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    ROUTES.clear()


def channels_last(x: torch.Tensor) -> bool:
    """Whether ``x [N, C, H, W]`` is held channels-last: ``torch.channels_last``
    strides (its memory a contiguous ``[N, H, W, C]``), and not also
    contiguous channels-first (as a tensor of one pixel or one channel is)."""
    return x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)


def group_norm_silu_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                              eps: float = 1e-5, film: Film = None, silu: bool = True) -> torch.Tensor:
    """``silu(group_norm(x) * (1 + scale) + shift)`` in fp32, cast once to
    ``x``'s dtype; ``x [N, C, ...]``, ``film`` = (scale, shift), [N, C]
    each.  On the CPU a channels-last ``x`` gives a channels-last result."""
    y = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
    if film is not None:
        scale, shift = film
        shape = (y.shape[0], y.shape[1]) + (1,) * (y.dim() - 2)
        y = y * (1.0 + scale.float().reshape(shape)) + shift.float().reshape(shape)
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


def _film_rows(film: Film, x: torch.Tensor):
    """(scale, shift, row stride, bf16?) as the kernel reads them: rows of
    C contiguous elements, the same stride and dtype for both."""
    if film is None:
        return None, None, 0, 0
    n, c = x.shape[:2]
    scale, shift = film
    if scale.dtype not in (torch.bfloat16, torch.float32) or shift.dtype != scale.dtype:
        scale, shift = scale.float(), shift.float()
    if scale.shape != (n, c) or shift.shape != (n, c):
        raise ValueError(f"FiLM pair of shapes {tuple(scale.shape)}, {tuple(shift.shape)}; expected {(n, c)}")
    if scale.stride(1) != 1 or shift.stride(1) != 1 or scale.stride(0) != shift.stride(0):
        scale, shift = scale.contiguous(), shift.contiguous()
    for t in (scale, shift):
        if t.device != x.device:
            raise ValueError(f"FiLM pair on {t.device}, activations on {x.device}")
    return scale, shift, scale.stride(0), int(scale.dtype == torch.bfloat16)


def _launch(x, weight, bias, groups, eps, film, silu, two_read):
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: the CUDA kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"group_norm_silu: the CUDA kernel takes bf16 activations, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"group_norm_silu: expected [N, C, ...], got {tuple(x.shape)}")
    n, c = x.shape[:2]
    if c % groups:
        raise ValueError(f"group_norm_silu: {c} channels in {groups} groups")
    rows = channels_last(x)
    if not rows:
        x = x.contiguous()
    w = weight.float().contiguous()
    b = bias.float().contiguous()
    if w.shape != (c,) or b.shape != (c,) or w.device != x.device or b.device != x.device:
        raise ValueError(f"group_norm_silu: weight / bias of shapes {tuple(w.shape)}, {tuple(b.shape)} on "
                         f"{w.device}; expected ({c},) on {x.device}")
    scale, shift, film_stride, film_bf16 = _film_rows(film, x)
    out = torch.empty_like(x)  # x's strides: channels-last in, channels-last out
    if x.numel() == 0:
        return out
    lib = cuda_build.load().lib
    args = (x.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(),
            scale.data_ptr() if scale is not None else None, shift.data_ptr() if shift is not None else None,
            film_stride, film_bf16, n, c, groups, x[0, 0].numel(), float(eps), int(silu))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        # The channels-last mode always reads twice: it takes no two-read flag.
        err = (lib.mmdiff_group_norm_silu_cl(*args, stream) if rows
               else lib.mmdiff_group_norm_silu(*args, int(two_read), stream))
    if err:
        raise RuntimeError(f"group_norm_silu kernel launch failed (cuda error {err}) at {tuple(x.shape)}, "
                           f"{groups} groups, {'channels-last' if rows else 'channels-first'}")
    if not two_read:
        LAUNCHES["group_norm_silu_cl" if rows else "group_norm_silu"] += 1
    return out


def group_norm_silu_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                         eps: float = 1e-5, film: Film = None, silu: bool = True) -> torch.Tensor:
    """The kernel: bf16 ``x [N, C, ...]`` on the card -> bf16 of the same
    shape and memory format; the mode follows ``x``'s layout (module
    docstring), and an ``x`` neither contiguous nor channels-last is copied
    first."""
    return _launch(x, weight, bias, groups, eps, film, silu, two_read=False)


def _group_norm_silu_two_read_cuda(x, weight, bias, groups, eps=1e-5, film=None, silu=True):
    """The kernel forced into its two-read mode (the same-run comparison):
    the channels-first mode's; a channels-last ``x`` takes its one mode,
    uncounted."""
    return _launch(x, weight, bias, groups, eps, film, silu, two_read=True)


def _route(x: torch.Tensor, tensors) -> str:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return "autograd"
    if x.device.type == "cpu":
        return "cpu"
    if x.dtype != torch.bfloat16:
        return "eager"
    return "fused_cl" if channels_last(x) else "fused"


def group_norm_silu(norm: torch.nn.Module, x: torch.Tensor, film: Film = None, silu: bool = True) -> torch.Tensor:
    """``silu(norm(x, film=film))`` (``silu=False``: the norm alone) for a
    ``GroupNorm32`` ``norm`` or a module holding one as ``.GroupNorm``, on
    the route that the tensors select (module docstring)."""
    gn = getattr(norm, "GroupNorm", norm)
    route = _route(x, (x, gn.weight, gn.bias) + (tuple(film) if film is not None else ()))
    ROUTES[route] += 1
    if route == "cpu":
        return group_norm_silu_reference(x, gn.weight, gn.bias, gn.num_groups, gn.eps, film, silu)
    if route in ("fused", "fused_cl"):
        return group_norm_silu_cuda(x, gn.weight, gn.bias, gn.num_groups, gn.eps, film, silu)
    y = gn(x, film=film)
    return F.silu(y) if silu else y
