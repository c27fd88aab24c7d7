"""Flash multi-head attention (counterpart of
``mm_diffusion_tpu/ops/fused_attention.py``).

* :func:`flash_mha` -- ``[B, T, H, D]`` q, k, v -> ``[B, Tq, H, D]``;
* :func:`flash_mha_bhtd` -- the same over ``[B, H, T, D]``.

Both have the JAX contract: scale ``1/sqrt(D)``, fp32 softmax, the output in
v's dtype, ``Tq != Tk`` allowed, differentiable in q, k and v.  They are one
``torch.autograd.Function`` whose forward and backward are kernels
(``csrc/flash_mha.cu``): the forward writes the output and an fp32
logsumexp, the backward a dq pass and a dk/dv pass.  Both layouts reach the
same kernels through their (batch, head, row) strides, so neither is
transposed in device memory; the kernel masks ragged Tq and Tk.

Each direction has two designs, chosen by one rule (:func:`forward_design`,
:func:`backward_design`): bf16 at kernel head dims 32-128 runs the Hopper
kernels (TMA, mbarrier rings fed by a producer warp, ``wgmma``;
``csrc/attention_sm90.cuh``: the forward K1's, the backward the dq and dk/dv
passes of K4/K5); fp32, and kernel head dims 192 and 256, run the mma.sync
design (``csrc/attention_common.cuh``, ``csrc/attention_bwd_common.cuh``).
Each launch counts in :data:`FORWARD_DESIGNS` or :data:`BACKWARD_DESIGNS` by
design.  Either backward takes either forward's output and logsumexp.

Dispatch: a tensor on the CPU takes the plain version (:func:`mha_reference`
and :func:`mha_backward_reference`); a CUDA tensor launches the kernels or
raises.  The kernels take every head dim ``D`` with ``D % 8 == 0`` and
``8 <= D <= 256`` (JAX's flash gate), on the kernel built for the next of
:data:`HEAD_DIMS` at or above ``D`` (:func:`kernel_head_dim`); a ``D`` that is
not a multiple of 8 runs on copies zero-padded to the next multiple (the
logit scale stays ``1/sqrt(D)``, counted in
``block_attention.HEAD_DIM_ROUTES``), and ``D > 256`` raises ``ValueError``.
There is no size gate and no fallback.  :func:`flash_launch_fwd` and
:func:`flash_launch_bwd` launch the kernels on any strided views the kernels
read, which ``block_attention`` uses for the head dims above 128 of K1-K7.
Each launch counts in :data:`LAUNCHES`.
"""

from __future__ import annotations

import collections
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import block_attention, cuda_build
# The kernels are held to the limits of K1 (forward, logsumexp) and K4
# (backward): the same rounding at the same places.
from .block_attention import BACKWARD_TOL, FORWARD_TOL, KERNEL_DTYPES, LSE_TOL, _softmax_backward  # noqa: F401
from .common import kernel_path

HEAD_DIMS = (32, 64, 96, 128, 192, 256)  # the head dims the kernels are built for
MAX_GRID_DIM = 65535  # B and H are grid dimensions of the kernels

# Launches of each kernel since the last reset_launch_counts().
LAUNCHES = {"flash_mha_fwd": 0, "flash_mha_bwd": 0}
# Each direction's launches by design: "sm90" (Hopper) or "mma" (mma.sync).
FORWARD_DESIGNS: collections.Counter = collections.Counter()
BACKWARD_DESIGNS: collections.Counter = collections.Counter()
# The C entry point of each design (csrc/flash_mha.cu).
FORWARD_ENTRIES = {"sm90": "mmdiff_flash_mha_fwd", "mma": "mmdiff_flash_mha_fwd_mma"}
BACKWARD_ENTRIES = {"sm90": "mmdiff_flash_mha_bwd", "mma": "mmdiff_flash_mha_bwd_mma"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counter in (FORWARD_DESIGNS, BACKWARD_DESIGNS):
        counter.clear()


def kernel_head_dim(d: int) -> int:
    """The built head dim that head dim ``d`` runs on (the rule of
    ``block_attention.kernel_head_dim`` over :data:`HEAD_DIMS`, up to 256)."""
    return block_attention.kernel_head_dim(d, HEAD_DIMS)


def forward_design(d: int, dtype: torch.dtype) -> Tuple[str, int]:
    """``(design, kernel head dim)`` of the forward at head dim ``d`` (before
    the pad to a multiple of 8) and ``dtype``: ``"sm90"`` (the Hopper kernel)
    for bf16 at kernel head dims up to 128, ``"mma"`` (the mma.sync design)
    for fp32 and for kernel head dims 192 and 256.  ``d > 256`` raises
    ``ValueError``."""
    kd = kernel_head_dim(block_attention.padded_head_dim(d))
    hopper = dtype == torch.bfloat16 and kd <= block_attention.HEAD_DIMS[-1]
    return ("sm90" if hopper else "mma"), kd


def backward_design(d: int, dtype: torch.dtype) -> Tuple[str, int]:
    """``(design, kernel head dim)`` of the backward: the rule of
    :func:`forward_design` (the Hopper passes for bf16 at kernel head dims
    up to 128, the mma.sync design for fp32 and 192 / 256)."""
    return forward_design(d, dtype)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float | None = None) -> torch.Tensor:
    """Plain multi-head attention over ``[B, T, H, D]`` in fp32, out in v's
    dtype: the port's counterpart of ``models/attention.py::qkv_attention``
    (one logit scale of ``1/sqrt(D)``, unless ``scale`` is given)."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(v.dtype)


def mha_backward_reference(
    q, k, v, g, scale: float | None = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of :func:`mha_reference` over ``[B, T, H, D]``, in
    fp32: ``(q, k, v, g [B, Tq, H, D]) -> (dq, dk, dv)`` in the inputs'
    dtypes."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    dq, dk, dv = _softmax_backward(q.float(), k.float(), v.float(), g.float(), scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def kernel_layout(x: torch.Tensor) -> bool:
    """Whether the kernels read this ``[B, H, T, D]`` view in place: a
    contiguous ``[B, H, T, D]`` tensor, or a contiguous ``[B, T, H, D]`` one
    with its middle axes swapped."""
    return x.dim() == 4 and (x.is_contiguous() or x.transpose(1, 2).is_contiguous())


def same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes and equal strides on every axis longer than 1 (the
    kernels never step along an axis of length 1)."""
    return a.shape == b.shape and all(
        n == 1 or sa == sb for n, sa, sb in zip(a.shape, a.stride(), b.stride())
    )


def _check_operands(q, k, v):
    """Validate ``[B, H, T, D]`` q, k, v for the wrappers; returns (B, H, Tq, Tk, D)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got {x.device}")
        if x.dtype not in KERNEL_DTYPES:
            raise TypeError(f"{name}: the CUDA kernel takes bf16 or fp32, got {x.dtype}")
        if not kernel_layout(x):
            raise ValueError(
                f"{name}: expected a [B, H, T, D] view of a contiguous [B, H, T, D] or "
                f"[B, T, H, D] tensor, got shape {tuple(x.shape)} strides {x.stride()}"
            )
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the CUDA kernel needs a 16-byte aligned tensor")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if not same_layout(k, v):
        raise ValueError("k and v must share their layout (strides)")
    if len({q.dtype, k.dtype, v.dtype}) > 1 or len({q.device, k.device, v.device}) > 1:
        raise ValueError("q, k and v must share dtype and device")
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"no kernel of the port is built for head dims above {HEAD_DIMS[-1]}, got {d}")
    if min(b, h, tq, tk, d) == 0 or max(b, h) > MAX_GRID_DIM:
        raise ValueError(f"B and H must be in [1, {MAX_GRID_DIM}] and T > 0, got {tuple(q.shape)}, Tk {tk}")
    return b, h, tq, tk, d


def _check_rows(*xs: torch.Tensor) -> None:
    """The kernels read every ``[.., D]`` row as 16-byte vectors: unit
    stride along D, 16-byte aligned rows."""
    for x in xs:
        size = x.element_size()
        if x.stride(-1) != 1 or x.data_ptr() % 16 or any(st * size % 16 for st in x.stride()[:3]):
            raise ValueError(
                f"the flash kernels need 16-byte aligned rows with D contiguous, got strides {x.stride()}"
            )


def _same_strides(name: str, x: torch.Tensor, ref: torch.Tensor) -> None:
    if x.shape != ref.shape or not same_layout(x, ref) or x.dtype != ref.dtype:
        raise ValueError(f"{name}: expected shape {tuple(ref.shape)} and strides {ref.stride()}, "
                         f"got {tuple(x.shape)} {x.stride()}")


def _launch_fwd(entry: str, q, k, v, out, d: int) -> torch.Tensor:
    b, h, tq, dk = q.shape
    tk = k.shape[2]
    _check_rows(q, k, v, out)
    _same_strides("v", v, k)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"out: expected {tuple(q.shape)} {q.dtype}, got {tuple(out.shape)} {out.dtype}")
    lib = cuda_build.load().lib
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, h, tq, tk, dk, kernel_head_dim(dk), 1.0 / math.sqrt(d), *q.stride()[:3],
            *k.stride()[:3], *out.stride()[:3], int(q.dtype == torch.float32), stream,
        )
    if err:
        raise RuntimeError(f"flash MHA forward kernel launch failed ({entry}): CUDA error {err}")
    return lse


def flash_launch_fwd(q, k, v, out, d: int) -> torch.Tensor:
    """Launch the forward kernel of :func:`forward_design` on ``[B, H, T,
    Dk]`` views (any (batch, head, row) strides; ``Dk`` a multiple of 8 up to
    256, ``k`` and ``v`` sharing strides) into ``out`` (q's shape), at the
    logit scale of head dim ``d <= Dk``.  Returns ``lse [B, H, Tq]`` fp32."""
    design = forward_design(q.shape[-1], q.dtype)[0]
    lse = _launch_fwd(FORWARD_ENTRIES[design], q, k, v, out, d)
    LAUNCHES["flash_mha_fwd"] += 1
    FORWARD_DESIGNS[design] += 1
    return lse


def _launch_bwd(entry: str, q, k, v, out, g, lse, dq, dk, dv, d: int) -> None:
    b, h, tq, dk_ = q.shape
    tk = k.shape[2]
    _check_rows(q, k, v, out, g, dq, dk, dv)
    for name, x, ref in (("v", v, k), ("g", g, out), ("dq", dq, q), ("dk", dk, k), ("dv", dv, k)):
        _same_strides(name, x, ref)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, tq) or not lse.is_contiguous():
        raise ValueError(f"lse: expected contiguous fp32 {(b, h, tq)}, got {tuple(lse.shape)}")
    lib = cuda_build.load().lib
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, tq, tk, dk_, kernel_head_dim(dk_), 1.0 / math.sqrt(d), *q.stride()[:3],
            *k.stride()[:3], *out.stride()[:3], int(q.dtype == torch.float32), stream,
        )
    if err:
        raise RuntimeError(f"flash MHA backward kernel launch failed ({entry}): CUDA error {err}")


def flash_launch_bwd(q, k, v, out, g, lse, dq, dk, dv, d: int) -> None:
    """Launch the backward kernels of :func:`backward_design` on the
    forward's views, ``out``, ``lse`` and the output gradient ``g`` (out's
    strides), writing ``dq`` (q's strides), ``dk`` and ``dv`` (k's strides),
    at the logit scale of head dim ``d``."""
    design = backward_design(q.shape[-1], q.dtype)[0]
    _launch_bwd(BACKWARD_ENTRIES[design], q, k, v, out, g, lse, dq, dk, dv, d)
    LAUNCHES["flash_mha_bwd"] += 1
    BACKWARD_DESIGNS[design] += 1


def _pad(x: torch.Tensor, dp: int) -> torch.Tensor:
    return x if x.shape[-1] == dp else F.pad(x, (0, dp - x.shape[-1]))


def _unpad_into(like: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x``'s first D lanes in a tensor with ``like``'s shape and layout."""
    return x if x.shape == like.shape else torch.empty_like(like).copy_(x[..., : like.shape[-1]])


def flash_mha_fwd_cuda(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on ``[B, H, T, D]`` views (see
    :func:`kernel_layout`); a D that is not a multiple of 8 runs on
    zero-padded copies.  Returns ``(out [B, H, Tq, D]`` in q's layout,
    ``lse [B, H, Tq]`` fp32)."""
    d = _check_operands(q, k, v)[4]
    dp = block_attention.padded_head_dim(d)
    if dp != d:
        block_attention.HEAD_DIM_ROUTES["flash_mha_fwd:pad"] += 1
    qp, kp, vp = (_pad(x, dp) for x in (q, k, v))
    out = torch.empty_like(qp)
    lse = flash_launch_fwd(qp, kp, vp, out, d)
    return _unpad_into(q, out), lse


def _check_bwd(q, k, v, out, g) -> int:
    """Validate the backward's operands; returns the head dim."""
    d = _check_operands(q, k, v)[4]
    for name, x in (("out", out), ("g", g)):
        if not same_layout(x, q) or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name}: expected q's shape {tuple(q.shape)}, strides {q.stride()} and dtype, "
                f"got {tuple(x.shape)} {x.stride()} {x.dtype}"
            )
    return d


def flash_mha_bwd_cuda(q, k, v, out, lse, g) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on the forward's q, k, v, ``out`` and
    ``lse`` and the output gradient ``g`` (``out``'s layout); a D that is not
    a multiple of 8 runs on zero-padded copies.  Returns ``(dq, dk, dv)`` in
    the layouts of q, k, v."""
    d = _check_bwd(q, k, v, out, g)
    dp = block_attention.padded_head_dim(d)
    if dp != d:
        block_attention.HEAD_DIM_ROUTES["flash_mha_bwd:pad"] += 1
    qp, kp, vp, op, gp = (_pad(x, dp) for x in (q, k, v, out, g))
    dq, dk, dv = torch.empty_like(qp), torch.empty_like(kp), torch.empty_like(vp)
    if not same_layout(gp, op):
        gp = torch.empty_like(op).copy_(gp)
    flash_launch_bwd(qp, kp, vp, op, gp, lse, dq, dk, dv, d)
    return _unpad_into(q, dq), _unpad_into(k, dk), _unpad_into(v, dv)


# ---------------------------------------------------------------------------
# Autograd function and the two entry points
# ---------------------------------------------------------------------------


def _bthd(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


class FlashMHA(torch.autograd.Function):
    """Attention over ``[B, H, T, D]`` views with its backward: the CUDA
    kernels on a CUDA tensor (the forward's output and logsumexp saved),
    the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v):
        if kernel_path(q) == "cuda":
            q, k, v = (x if kernel_layout(x) else x.contiguous() for x in (q, k, v))
            if not same_layout(k, v):
                k, v = k.contiguous(), v.contiguous()
            out, lse = flash_mha_fwd_cuda(q, k, v)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return _bthd(mha_reference(_bthd(q), _bthd(k), _bthd(v)))

    @staticmethod
    def backward(ctx, g):
        if kernel_path(g) == "cuda":
            q, k, v, out, lse = ctx.saved_tensors
            if not same_layout(g, out):
                g = torch.empty_like(out).copy_(g)
            return flash_mha_bwd_cuda(q, k, v, out, lse, g)
        q, k, v = ctx.saved_tensors
        return tuple(_bthd(x) for x in mha_backward_reference(*map(_bthd, (q, k, v, g))))


def flash_mha_bhtd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention over ``[B, H, T, D]`` tensors: the plain version
    on the CPU, the flash kernels on a GPU."""
    return FlashMHA.apply(q, k, v)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention over ``[B, T, H, D]`` tensors (the contract of
    ``models/attention.py::qkv_attention``); the kernels read this layout in
    place through its strides, and the output is ``[B, Tq, H, D]``."""
    return _bthd(FlashMHA.apply(_bthd(q), _bthd(k), _bthd(v)))
