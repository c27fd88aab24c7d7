"""Attention ops of the MM-UNet and the SR U-Net: plain PyTorch versions,
the hand-written CUDA kernels' wrappers, and the dispatch between them.

Two functions, counterparts of ``mm_diffusion_tpu/ops/block_attention.py``:

* :func:`self_attention` -- multi-head attention over a packed ``[N, T, 3C]``
  qkv projection -> ``[N, T, C]``, scale ``1/sqrt(d)``, fp32 softmax.
  ``layout="thirds"`` reads ``[q | k | v]`` (MM-UNet); ``layout="per_head"``
  reads the SR U-Net's legacy ``[h0: q k v | h1: q k v | ...]`` order.
* :func:`banded_cross_attention_packed` -- RS-MMA: query frame ``f`` of
  ``q_src[..., :C]`` attends to the kv frames ``(f + shift + j) % F``,
  ``j < local_window``, of ``kv_src[..., C:3C]`` under one joint softmax.

Both are ``torch.autograd.Function``s whose backward is a kernel too
(``*_backward_reference`` are the plain versions): the forward saves qkv,
its output and the kernel's logsumexp, and the backward recomputes P from
them.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel (``csrc/``) or raises.  There are no size gates and no
fallback from a failed build or launch to the plain version.  Each kernel
wrapper counts its launches in :data:`LAUNCHES`.

Head dims: the kernels are built for 32, 64, 96 and 128 and take every head
dim ``d`` with ``d % 8 == 0`` and ``8 <= d <= 128`` on the next built size at
or above it (:func:`kernel_head_dim`), the lanes past ``d`` zero-filled and
never stored.  The wrappers take every ``d <= 256`` on the card, each by an
explicit route to a hand kernel, counted in :data:`HEAD_DIM_ROUTES`: a ``d``
that is not a multiple of 8 runs on a copy of the operands zero-padded to
:func:`padded_head_dim` (the logit scale stays ``1/sqrt(d)``, passed to the
kernel), and a (padded) ``d`` above 128 runs on the flash MHA kernels of
``ops/fused_attention.py`` (K8, built up to 256) over strided ``[N, H, T,
d]`` views of the packed operands -- for the banded function over the
window gathered per query frame, its dk/dv summed back into the kv frames.
``d > 256`` raises ``ValueError`` on a CUDA tensor (the plain version on the
CPU takes any ``d``).

One design per kernel and dtype: bf16 runs the Hopper design (TMA,
mbarrier rings, ``wgmma``; ``csrc/attention_sm90.cuh``, and for the banded
forward and backward the window tiling of ``csrc/banded_sm90.cuh``), fp32
the mma.sync design (``csrc/attention_common.cuh``,
``csrc/attention_bwd_common.cuh``) through the same C entry points.

:func:`self_attention_variant` serves the A/B tool
``tools/bench_attn_variants.py`` (the TPU spikes' K1 variants, see
:data:`VARIANTS`); the model never calls it.  Its launches are counted per
variant in :data:`VARIANT_LAUNCHES`.  In bf16, ``rows``, ``nomax`` and
``noexp`` run modes of K1's Hopper kernel (``rows`` at ``T <= 32`` on
persistent blocks, :func:`rows_launch_plan`), built for every head dim in
:data:`VARIANT_HEAD_DIMS`, so a ``d`` above 128 needs no K8 route: it runs
the variant kernel built at 192 or 256 (route ``wide``); ``d % 8 != 0``
takes the zero-padded copy (route ``pad``).  fp32 runs the mma.sync
design, built up to 128.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .common import Tolerance, kernel_path

LAYOUTS = ("thirds", "per_head")
HEAD_DIMS = (32, 64, 96, 128)  # the head dims the kernels are built for
VARIANT_HEAD_DIMS = HEAD_DIMS + (192, 256)  # the bf16 variant kernels' (rows, nomax, noexp)
MAX_HEAD_DIM = 256  # the largest head dim any kernel of the port is built for (K8)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Launches of each kernel since the last reset_launch_counts(); the banded
# kernels' launches are also counted per window size, the self-attention
# backward's per sequence length.
LAUNCHES = {
    "self_attention": 0,
    "banded_attention": 0,
    "self_attention_bwd": 0,
    "banded_attention_bwd": 0,
}
BANDED_WINDOWS: collections.Counter = collections.Counter()
BANDED_BWD_WINDOWS: collections.Counter = collections.Counter()
SELF_BWD_LENGTHS: collections.Counter = collections.Counter()
VARIANT_LAUNCHES: collections.Counter = collections.Counter()
# Calls that took a head-dim route, by "<wrapper>:<route>": "pad" (the
# kernel ran on a zero-padded copy), "flash" (the K8 kernels ran; their
# launches count in fused_attention.LAUNCHES) and "wide" (a variant kernel
# built at head dim 192 or 256 ran).
HEAD_DIM_ROUTES: collections.Counter = collections.Counter()

# The K1 forward's A/B variants (TPU spikes tools/bench_attn_variants.py and
# tools/bench_attn_variants2.py), thirds layout.  On this card hoist, recip
# and exp2 are what the stock kernel already does, so those names launch it;
# rows, nomax and noexp are compile-time modes of it (csrc/self_attention.cu).
VARIANTS = ("stock", "hoist", "recip", "exp2", "rows", "nomax", "noexp")
VARIANT_CODES = {"rows": 1, "nomax": 2, "noexp": 3}
NOMAX_CLAMP = 40.0  # nomax: logits clamped here; exact only below it
NOEXP_SCALE = 1e-3  # noexp: p = NOEXP_SCALE * scaled logits
TILE_ROWS = 64  # rows of a Hopper kernel's tile (wgmma M)

# Each kernel's limit against its plain version (fp32 math on the same bf16
# inputs); the flash MHA kernels (fused_attention.py) are held to the same.
# Forward out: the kernel rounds P to bf16 before P @ V and rounds the
# output to bf16 (relative 2^-9 each).
FORWARD_TOL = Tolerance(1e-2, 1e-2)
# Forward logsumexp: fp32 throughout; at |lse| ~ 7, 1e-3 is far below the
# shift that one stray key would make.
LSE_TOL = Tolerance(1e-3, 1e-4)
# Backward: the kernels round P and dS to bf16 before the gradient products,
# whose terms are of the size of the largest gradient, and round dq / dk / dv
# to bf16, so the error of an element scales with the gradient's magnitude.
# noexp's output is such a sum too (no softmax normalises it), and its values
# are ~1e-3 at T = 16, below any fixed atol that would fit T = 1024.
BACKWARD_TOL = Tolerance(1e-2, 1e-2, scaled=True)
VARIANT_TOL = {**{v: FORWARD_TOL for v in VARIANTS}, "noexp": BACKWARD_TOL}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counter in (BANDED_WINDOWS, BANDED_BWD_WINDOWS, SELF_BWD_LENGTHS, VARIANT_LAUNCHES,
                    HEAD_DIM_ROUTES):
        counter.clear()


# One self-attention backward kernel serves K4 and K5: its launches count as
# K5's at the lengths that the TPU served with the q-chunked kernel (T = 1024
# spatial), as K4's below.
K5_MIN_T = 513


def kernel_launches() -> dict:
    """K1-K7's launches since :func:`reset_launch_counts`, by the TPU kernel
    each replaces: the banded forward (K2 / K3) and backward (K7 / K6) by
    window, the self-attention backward (K5 / K4) by sequence length."""
    return {
        "self_attention": LAUNCHES["self_attention"],
        "banded_attention[lw=1]": BANDED_WINDOWS.get(1, 0),
        "banded_attention[lw>1]": sum(v for k, v in BANDED_WINDOWS.items() if k > 1),
        "self_attention_bwd[T<=512]": sum(v for k, v in SELF_BWD_LENGTHS.items() if k < K5_MIN_T),
        "self_attention_bwd[T>512]": sum(v for k, v in SELF_BWD_LENGTHS.items() if k >= K5_MIN_T),
        "banded_attention_bwd[lw=1]": BANDED_BWD_WINDOWS.get(1, 0),
        "banded_attention_bwd[lw>1]": sum(v for k, v in BANDED_BWD_WINDOWS.items() if k > 1),
    }


def kernel_head_dim(d: int, built: Tuple[int, ...] = HEAD_DIMS) -> int:
    """The built head dim that head dim ``d`` runs on: the smallest of
    ``built`` at or above ``d``.  ``d`` must be a multiple of 8 in
    ``[8, max(built)]`` (16-byte rows for the kernels' copies); any other
    ``d`` raises ``ValueError``."""
    if d % 8 or not 8 <= d <= built[-1]:
        raise ValueError(
            f"the CUDA kernels take head dims d with d % 8 == 0 and 8 <= d <= {built[-1]}, got {d}"
        )
    return next(b for b in built if b >= d)


def padded_head_dim(d: int) -> int:
    """The head dim that head dim ``d`` runs at on the card: ``d`` rounded up
    to a multiple of 8 (the 16-byte rows of the kernels' copies)."""
    return -(-d // 8) * 8


def pad_head_dim(x: torch.Tensor, num_heads: int, dp: int, parts: int, layout: str = "thirds"):
    """A packed ``[..., parts * H * d]`` tensor as ``[..., parts * H * dp]``
    with every head's lanes past ``d`` zero: ``parts`` 3 for a packed qkv
    projection in ``layout``, 1 for an ``[..., C]`` output or gradient.
    Zero q / k lanes add nothing to a logit and zero v lanes give output
    lanes that :func:`unpad_head_dim` drops, so attention over the padded
    copy at the logit scale ``1/sqrt(d)`` is attention over ``x``."""
    *lead, width = x.shape
    d = width // parts // num_heads
    if dp == d:
        return x
    shape = (num_heads, parts, d) if layout == "per_head" else (parts, num_heads, d)
    return F.pad(x.reshape(*lead, *shape), (0, dp - d)).reshape(*lead, parts * num_heads * dp)


def unpad_head_dim(x: torch.Tensor, num_heads: int, d: int, parts: int, layout: str = "thirds"):
    """The inverse of :func:`pad_head_dim`: the first ``d`` lanes of every
    head, as a contiguous ``[..., parts * H * d]`` tensor."""
    *lead, width = x.shape
    dp = width // parts // num_heads
    if dp == d:
        return x
    shape = (num_heads, parts, dp) if layout == "per_head" else (parts, num_heads, dp)
    return x.reshape(*lead, *shape)[..., :d].reshape(*lead, parts * num_heads * d)


def packed_head_views(x: torch.Tensor, num_heads: int, layout: str = "thirds"):
    """A packed ``[N, T, 3C]`` projection as its q, k, v: three strided
    ``[N, H, T, d]`` views (no copy)."""
    n, t, c3 = x.shape
    d = c3 // 3 // num_heads
    if layout == "per_head":
        y = x.view(n, t, num_heads, 3, d).permute(3, 0, 2, 1, 4)
    else:
        y = x.view(n, t, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    return y[0], y[1], y[2]


def _heads_view(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """An ``[N, T, C]`` tensor as a strided ``[N, H, T, d]`` view."""
    n, t, c = x.shape
    return x.view(n, t, num_heads, c // num_heads).transpose(1, 2)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------


def split_packed_qkv(qkv: torch.Tensor, num_heads: int, layout: str = "thirds"):
    """[..., T, 3C] -> q, k, v as [..., T, H, d] views."""
    *lead, t, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    if layout == "thirds":
        q, k, v = qkv.split(c, dim=-1)
        return tuple(x.reshape(*lead, t, num_heads, d) for x in (q, k, v))
    if layout == "per_head":
        x = qkv.reshape(*lead, t, num_heads, 3, d)
        return x[..., 0, :], x[..., 1, :], x[..., 2, :]
    raise ValueError(f"unknown qkv layout {layout!r}; expected one of {LAYOUTS}")


def _scale(d: int, scale) -> float:
    return 1.0 / math.sqrt(d) if scale is None else scale


def self_attention_reference(
    qkv: torch.Tensor, num_heads: int, layout: str = "thirds", scale: float | None = None
) -> torch.Tensor:
    """Plain multi-head attention over packed ``[N, T, 3C]`` qkv, in fp32;
    the logit scale is ``1/sqrt(d)`` unless ``scale`` is given."""
    n, t, c3 = qkv.shape
    q, k, v = split_packed_qkv(qkv.float(), num_heads, layout)
    logits = torch.einsum("nqhd,nkhd->nhqk", q, k) * _scale(q.shape[-1], scale)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("nhqk,nkhd->nqhd", w, v)
    return out.reshape(n, t, c3 // 3).to(qkv.dtype)


def self_attention_variant_reference(
    qkv: torch.Tensor, num_heads: int, variant: str, scale: float | None = None
) -> torch.Tensor:
    """Plain version of one K1 variant over thirds-layout ``[N, T, 3C]``, in
    fp32: softmax attention for stock / hoist / recip / exp2 / rows;
    ``nomax`` normalises ``exp(min(logit, 40))`` with no max subtracted;
    ``noexp`` is ``(NOEXP_SCALE * logits) @ v`` with no softmax.  The logit
    scale is ``1/sqrt(d)`` unless ``scale`` is given."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if variant not in ("nomax", "noexp"):
        return self_attention_reference(qkv, num_heads, scale=scale)
    n, t, c3 = qkv.shape
    q, k, v = split_packed_qkv(qkv.float(), num_heads)
    logits = torch.einsum("nqhd,nkhd->nhqk", q, k) * _scale(q.shape[-1], scale)
    if variant == "nomax":
        p = torch.exp(logits.clamp(max=NOMAX_CLAMP))
        p = p / p.sum(dim=-1, keepdim=True)
    else:
        p = logits * NOEXP_SCALE
    out = torch.einsum("nhqk,nkhd->nqhd", p, v)
    return out.reshape(n, t, c3 // 3).to(qkv.dtype)


def window_frame_indices(frames: int, local_window: int, shift: int, device=None):
    """``idx[f, j] = (f + shift + j) % F`` for ``j < local_window``."""
    f = torch.arange(frames, device=device)[:, None]
    j = torch.arange(local_window, device=device)[None, :]
    return (f + shift + j) % frames


def banded_cross_attention_reference(
    q_src: torch.Tensor,
    kv_src: torch.Tensor,
    shift: int,
    local_window: int,
    num_heads: int,
    channels: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain RS-MMA over packed sources, in fp32: ``q_src`` [N, F, Tq, 3C],
    ``kv_src`` [N, F, Tk, 3C] -> [N, F, Tq, C]; the logit scale is
    ``1/sqrt(d)`` unless ``scale`` is given."""
    n, f, tq, _ = q_src.shape
    tk = kv_src.shape[2]
    c = channels
    d = c // num_heads
    q = q_src[..., :c].float()
    kv = kv_src[..., c : 3 * c].float()
    idx = window_frame_indices(f, local_window, int(shift), q_src.device)
    kvw = kv[:, idx].reshape(n, f, local_window * tk, 2 * c)  # [N, F, lw*Tk, 2C]
    k, v = kvw.split(c, dim=-1)
    qh = q.reshape(n, f, tq, num_heads, d)
    kh = k.reshape(n, f, local_window * tk, num_heads, d)
    vh = v.reshape(n, f, local_window * tk, num_heads, d)
    logits = torch.einsum("nfqhd,nfkhd->nfhqk", qh, kh) * _scale(d, scale)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("nfhqk,nfkhd->nfqhd", w, vh)
    return out.reshape(n, f, tq, c).to(q_src.dtype)


def _softmax_backward(q, k, v, g, scale):
    """Plain attention backward over [..., Tq, H, d] q / g and [..., Tk, H, d]
    k / v, in fp32: P recomputed, ``ds = p * (dp - rowsum(dp * p))``, the
    form the kernels compute.  Returns dq, dk, dv in the input layouts."""
    logits = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    p = torch.softmax(logits, dim=-1)
    dv = torch.einsum("...hqk,...qhd->...khd", p, g)
    dp = torch.einsum("...qhd,...khd->...hqk", g, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq = torch.einsum("...hqk,...khd->...qhd", ds, k)
    dk = torch.einsum("...hqk,...qhd->...khd", ds, q)
    return dq, dk, dv


def self_attention_backward_reference(
    qkv: torch.Tensor, g: torch.Tensor, num_heads: int, layout: str = "thirds",
    scale: float | None = None,
) -> torch.Tensor:
    """Plain backward of :func:`self_attention_reference`: ``(qkv [N, T, 3C],
    g [N, T, C]) -> dqkv [N, T, 3C]`` in ``layout``, computed in fp32."""
    n, t, c3 = qkv.shape
    q, k, v = split_packed_qkv(qkv.float(), num_heads, layout)
    d = q.shape[-1]
    gh = g.float().reshape(n, t, num_heads, d)
    dq, dk, dv = _softmax_backward(q, k, v, gh, _scale(d, scale))
    if layout == "thirds":
        dqkv = torch.cat([x.reshape(n, t, c3 // 3) for x in (dq, dk, dv)], dim=-1)
    else:
        dqkv = torch.stack([dq, dk, dv], dim=3).reshape(n, t, c3)
    return dqkv.to(qkv.dtype)


def banded_attention_backward_reference(
    q_src: torch.Tensor,
    kv_src: torch.Tensor,
    g: torch.Tensor,
    shift: int,
    local_window: int,
    num_heads: int,
    channels: int,
    scale: float | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward of :func:`banded_cross_attention_reference`, in fp32:
    ``(q_src, kv_src, g [N, F, Tq, C]) -> (dq_src, dkv_src)`` packed as the
    sources are: dq in lanes ``[0, C)`` of ``dq_src``, dk | dv in lanes
    ``[C, 3C)`` of ``dkv_src``, zeros elsewhere.  The lw window grads of
    each kv frame are summed (each window position maps the F query frames
    one-to-one onto the F kv frames)."""
    n, f, tq, _ = q_src.shape
    tk = kv_src.shape[2]
    c, lw = channels, local_window
    d = c // num_heads
    idx = window_frame_indices(f, lw, int(shift), q_src.device)
    kv = kv_src[..., c : 3 * c].float()
    k, v = kv[:, idx].reshape(n, f, lw * tk, 2 * c).split(c, dim=-1)
    heads = lambda x, rows: x.reshape(n, f, rows, num_heads, d)  # noqa: E731
    dq, dk, dv = _softmax_backward(
        heads(q_src[..., :c].float(), tq), heads(k, lw * tk), heads(v, lw * tk),
        heads(g.float(), tq), _scale(d, scale),
    )
    dkv_w = torch.cat([x.reshape(n, f, lw, tk, c) for x in (dk, dv)], dim=-1)
    dkv = torch.zeros_like(kv)
    for j in range(lw):
        dkv[:, idx[:, j]] += dkv_w[:, :, j]
    dq_src = torch.cat([dq.reshape(n, f, tq, c), dq.new_zeros((n, f, tq, 2 * c))], dim=-1)
    dkv_src = torch.cat([dkv.new_zeros((n, f, tk, c)), dkv], dim=-1)
    return dq_src.to(q_src.dtype), dkv_src.to(kv_src.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_kernel_input(x: torch.Tensor, name: str, ndim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes bf16 or fp32, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs a contiguous tensor")


def _check_heads(c: int, num_heads: int) -> int:
    if num_heads <= 0 or c % num_heads or c == 0:
        raise ValueError(f"{c} channels do not split into {num_heads} heads")
    d = c // num_heads
    if d > MAX_HEAD_DIM:
        raise ValueError(
            f"no kernel of the port is built for head dims above {MAX_HEAD_DIM}, got d = {d}"
        )
    return d


def _check_aligned(*xs: torch.Tensor) -> None:
    """The Hopper kernels read bf16 operands by TMA, from 16-byte aligned
    addresses."""
    for x in xs:
        if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned bf16 tensors")


def _layout_offsets(layout: str, c: int, d: int) -> Tuple[int, int, int]:
    """(head stride, k offset, v offset) of head h's q/k/v in a packed row."""
    if layout == "thirds":
        return d, c, 2 * c
    if layout == "per_head":
        return 3 * d, d, 2 * d
    raise ValueError(f"unknown qkv layout {layout!r}; expected one of {LAYOUTS}")


def _check_like(x: torch.Tensor, ref: torch.Tensor, name: str, shape) -> None:
    _check_kernel_input(x, name, len(shape))
    if tuple(x.shape) != tuple(shape) or x.dtype != ref.dtype or x.device != ref.device:
        raise ValueError(
            f"{name}: expected {tuple(shape)} {ref.dtype} on {ref.device}, "
            f"got {tuple(x.shape)} {x.dtype} on {x.device}"
        )


def _check_qkv(qkv: torch.Tensor, num_heads: int):
    """Validate packed qkv for the self-attention kernels; returns (N, T, C, d)."""
    _check_kernel_input(qkv, "qkv", 3)
    n, t, c3 = qkv.shape
    if c3 % 3 or n == 0 or t == 0:
        raise ValueError(f"qkv: expected [N, T, 3C] with N, T > 0, got {tuple(qkv.shape)}")
    return n, t, c3 // 3, _check_heads(c3 // 3, num_heads)


def _check_banded(q_src, kv_src, local_window: int, num_heads: int, channels: int):
    """Validate the banded kernels' sources; returns (N, F, Tq, Tk, d)."""
    _check_kernel_input(q_src, "q_src", 4)
    _check_kernel_input(kv_src, "kv_src", 4)
    n, f, tq, cq = q_src.shape
    tk = kv_src.shape[2]
    if cq != 3 * channels or kv_src.shape[-1] != 3 * channels:
        raise ValueError(f"q_src/kv_src must carry 3C = {3 * channels} lanes")
    if kv_src.shape[:2] != (n, f) or kv_src.dtype != q_src.dtype or kv_src.device != q_src.device:
        raise ValueError("q_src and kv_src must share N, F, dtype and device")
    if min(n, f, tq, tk) == 0:
        raise ValueError("empty q_src or kv_src")
    if not 1 <= local_window <= f:
        raise ValueError(f"local_window {local_window} outside [1, {f}]")
    return n, f, tq, tk, _check_heads(channels, num_heads)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _self_attention_launch(qkv: torch.Tensor, num_heads: int, layout: str, d: int):
    """Launch the self-attention forward on ``qkv`` whose head dim the
    kernels are built for, at the logit scale of head dim ``d``."""
    n, t, c, dk = _check_qkv(qkv, num_heads)
    _check_aligned(qkv)
    head_stride, k_off, v_off = _layout_offsets(layout, c, dk)
    lib = cuda_build.load().lib
    out = torch.empty((n, t, c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((n, num_heads, t), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.mmdiff_self_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), n, t, num_heads, dk,
            kernel_head_dim(dk), 1.0 / math.sqrt(d), head_stride, k_off, v_off,
            int(qkv.dtype == torch.float32), _stream(),
        )
    if err:
        raise RuntimeError(f"self-attention kernel launch failed: CUDA error {err}")
    return out, lse


def self_attention_cuda(
    qkv: torch.Tensor, num_heads: int, layout: str = "thirds"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the self-attention kernel (bf16: the Hopper design; fp32: the
    mma.sync one); a head dim it is not built for takes its route (module
    docstring).  Returns ``(out [N, T, C], lse [N, H, T] fp32)``."""
    from . import fused_attention as fa

    n, t, c, d = _check_qkv(qkv, num_heads)
    dp = padded_head_dim(d)
    x = pad_head_dim(qkv, num_heads, dp, 3, layout)
    if dp != d:
        HEAD_DIM_ROUTES["self_attention:pad"] += 1
    if dp > HEAD_DIMS[-1]:
        out = torch.empty((n, t, num_heads * dp), dtype=qkv.dtype, device=qkv.device)
        lse = fa.flash_launch_fwd(*packed_head_views(x, num_heads, layout),
                                  _heads_view(out, num_heads), d)
        HEAD_DIM_ROUTES["self_attention:flash"] += 1
    else:
        out, lse = _self_attention_launch(x, num_heads, layout, d)
        LAUNCHES["self_attention"] += 1
    return unpad_head_dim(out, num_heads, d, 1), lse


def _banded_attention_launch(q_src, kv_src, shift, local_window, num_heads, channels, d):
    """Launch the banded forward on sources whose head dim the kernels
    are built for, at the logit scale of head dim ``d``."""
    n, f, tq, tk, dk = _check_banded(q_src, kv_src, local_window, num_heads, channels)
    _check_aligned(q_src, kv_src)
    c = channels
    lib = cuda_build.load().lib
    out = torch.empty((n, f, tq, c), dtype=q_src.dtype, device=q_src.device)
    lse = torch.empty((n, f, num_heads, tq), dtype=torch.float32, device=q_src.device)
    with torch.cuda.device(q_src.device):
        err = lib.mmdiff_banded_attention_fwd(
            q_src.data_ptr(), kv_src.data_ptr(), out.data_ptr(), lse.data_ptr(), n, f, tq,
            tk, num_heads, dk, kernel_head_dim(dk), 1.0 / math.sqrt(d), int(shift) % f,
            local_window, int(q_src.dtype == torch.float32), _stream(),
        )
    if err:
        raise RuntimeError(f"banded attention kernel launch failed: CUDA error {err}")
    return out, lse


def gathered_window_views(q_src, kv_src, shift, local_window, num_heads):
    """The banded function as N * F attention calls for the K8 kernels:
    ``(q, k, v)`` as ``[N*F, H, T, d]`` views -- q of ``q_src`` in place, k
    and v of the lw-frame window of each query frame gathered from
    ``kv_src`` (one copy, ``[N*F, lw*Tk, 2C]``) -- and the window frame
    indices ``[F, lw]``."""
    n, f, tq, c3 = q_src.shape
    tk, c = kv_src.shape[2], c3 // 3
    idx = window_frame_indices(f, local_window, int(shift) % f, q_src.device)
    kv = kv_src[..., c:][:, idx].reshape(n * f, local_window * tk, 2 * c)
    k, v = _kv_views(kv, num_heads)
    return _q_view(q_src, num_heads), k, v, idx


def _q_view(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The q lanes of a packed ``[N, F, T, 3C]`` source as a strided
    ``[N*F, H, T, d]`` view."""
    n, f, t, c3 = x.shape
    return x.view(n * f, t, 3, num_heads, c3 // 3 // num_heads)[:, :, 0].transpose(1, 2)


def _kv_views(x: torch.Tensor, num_heads: int):
    """A gathered ``[N*F, L, 2C]`` window as its k and v, strided ``[N*F, H,
    L, d]`` views."""
    nf, length, c2 = x.shape
    y = x.view(nf, length, 2, num_heads, c2 // 2 // num_heads).permute(2, 0, 3, 1, 4)
    return y[0], y[1]


def banded_attention_cuda(
    q_src: torch.Tensor,
    kv_src: torch.Tensor,
    shift: int,
    local_window: int,
    num_heads: int,
    channels: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the banded RS-MMA kernel (bf16: the Hopper design; fp32: the
    mma.sync one); a head dim it is not built for takes its route (module
    docstring).  Returns ``(out [N, F, Tq, C], lse [N, F, H, Tq] fp32)``."""
    from . import fused_attention as fa

    n, f, tq, tk, d = _check_banded(q_src, kv_src, local_window, num_heads, channels)
    dp = padded_head_dim(d)
    q_p, kv_p = (pad_head_dim(x, num_heads, dp, 3) for x in (q_src, kv_src))
    if dp != d:
        HEAD_DIM_ROUTES["banded_attention:pad"] += 1
    if dp > HEAD_DIMS[-1]:
        q, k, v, _ = gathered_window_views(q_p, kv_p, shift, local_window, num_heads)
        out = torch.empty((n, f, tq, num_heads * dp), dtype=q_src.dtype, device=q_src.device)
        lse = fa.flash_launch_fwd(q, k, v, _heads_view(out.view(n * f, tq, -1), num_heads), d)
        lse = lse.view(n, f, num_heads, tq)
        HEAD_DIM_ROUTES["banded_attention:flash"] += 1
    else:
        out, lse = _banded_attention_launch(
            q_p, kv_p, shift, local_window, num_heads, num_heads * dp, d
        )
        LAUNCHES["banded_attention"] += 1
        BANDED_WINDOWS[local_window] += 1
    return unpad_head_dim(out, num_heads, d, 1), lse


def _self_attention_bwd_launch(qkv, out, lse, g, num_heads, layout, d) -> torch.Tensor:
    n, t, c, dk = _check_qkv(qkv, num_heads)
    head_stride, k_off, v_off = _layout_offsets(layout, c, dk)
    _check_like(out, qkv, "out", (n, t, c))
    _check_like(g, qkv, "g", (n, t, c))
    _check_aligned(qkv, g)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (n, num_heads, t) or not lse.is_contiguous():
        raise ValueError(f"lse: expected contiguous fp32 {(n, num_heads, t)}, got {tuple(lse.shape)}")
    lib = cuda_build.load().lib
    delta = torch.empty_like(lse)
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        err = lib.mmdiff_self_attention_bwd(
            qkv.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dqkv.data_ptr(), n, t, num_heads, dk, kernel_head_dim(dk), 1.0 / math.sqrt(d),
            head_stride, k_off, v_off, int(qkv.dtype == torch.float32), _stream(),
        )
    if err:
        raise RuntimeError(f"self-attention backward kernel launch failed: CUDA error {err}")
    return dqkv


def self_attention_bwd_cuda(
    qkv: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    num_heads: int,
    layout: str = "thirds",
) -> torch.Tensor:
    """Launch the self-attention backward kernels (bf16: the Hopper design;
    fp32: the mma.sync one) on the forward's ``qkv``, ``out`` and ``lse`` and
    the output gradient ``g`` [N, T, C]; a head dim they are not built for
    takes its route (module docstring).  Returns ``dqkv`` [N, T, 3C] in
    ``layout``."""
    from . import fused_attention as fa

    n, t, c, d = _check_qkv(qkv, num_heads)
    _check_like(out, qkv, "out", (n, t, c))
    _check_like(g, qkv, "g", (n, t, c))
    dp = padded_head_dim(d)
    x = pad_head_dim(qkv, num_heads, dp, 3, layout)
    o, gp = (pad_head_dim(y, num_heads, dp, 1) for y in (out, g))
    if dp != d:
        HEAD_DIM_ROUTES["self_attention_bwd:pad"] += 1
    if dp > HEAD_DIMS[-1]:
        dqkv = torch.empty_like(x)
        fa.flash_launch_bwd(*packed_head_views(x, num_heads, layout), _heads_view(o, num_heads),
                            _heads_view(gp, num_heads), lse,
                            *packed_head_views(dqkv, num_heads, layout), d)
        HEAD_DIM_ROUTES["self_attention_bwd:flash"] += 1
    else:
        dqkv = _self_attention_bwd_launch(x, o, lse, gp, num_heads, layout, d)
        LAUNCHES["self_attention_bwd"] += 1
        SELF_BWD_LENGTHS[t] += 1
    return unpad_head_dim(dqkv, num_heads, d, 3, layout)


def _check_banded_bwd(q_src, kv_src, out, lse, g, local_window, num_heads, channels):
    n, f, tq, tk, d = _check_banded(q_src, kv_src, local_window, num_heads, channels)
    _check_like(out, q_src, "out", (n, f, tq, channels))
    _check_like(g, q_src, "g", (n, f, tq, channels))
    if lse.dtype != torch.float32 or tuple(lse.shape) != (n, f, num_heads, tq) or not lse.is_contiguous():
        raise ValueError(f"lse: expected contiguous fp32 {(n, f, num_heads, tq)}, got {tuple(lse.shape)}")
    return n, f, tq, tk, d


def _banded_attention_bwd_launch(q_src, kv_src, out, lse, g, shift, local_window, num_heads,
                                 channels, d):
    n, f, tq, tk, dk = _check_banded_bwd(q_src, kv_src, out, lse, g, local_window, num_heads,
                                         channels)
    _check_aligned(q_src, kv_src, out, g)
    lib = cuda_build.load().lib
    delta = torch.empty_like(lse)
    dq_src = torch.empty_like(q_src)
    dkv_src = torch.empty_like(kv_src)
    with torch.cuda.device(q_src.device):
        err = lib.mmdiff_banded_attention_bwd(
            q_src.data_ptr(), kv_src.data_ptr(), out.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq_src.data_ptr(), dkv_src.data_ptr(), n, f, tq, tk, num_heads, dk,
            kernel_head_dim(dk), 1.0 / math.sqrt(d), int(shift) % f, local_window,
            int(q_src.dtype == torch.float32), _stream(),
        )
    if err:
        raise RuntimeError(f"banded attention backward kernel launch failed: CUDA error {err}")
    return dq_src, dkv_src


def _banded_flash_bwd(q_p, kv_p, o, lse, gp, shift, local_window, num_heads, d):
    """The banded backward on the K8 kernels over the gathered window: dq
    into the q lanes of a zeroed ``dq_src``, the window's dk | dv summed
    (fp32) into the kv frames it was gathered from."""
    from . import fused_attention as fa

    n, f, tq, c3 = q_p.shape
    tk, c, lw = kv_p.shape[2], c3 // 3, local_window
    q, k, v, idx = gathered_window_views(q_p, kv_p, shift, lw, num_heads)
    dq_src = torch.zeros_like(q_p)
    dkv_w = torch.empty((n * f, lw * tk, 2 * c), dtype=kv_p.dtype, device=kv_p.device)
    dk, dv = _kv_views(dkv_w, num_heads)
    as_heads = lambda y: _heads_view(y.view(n * f, tq, c), num_heads)  # noqa: E731
    fa.flash_launch_bwd(q, k, v, as_heads(o), as_heads(gp), lse.view(n * f, num_heads, tq),
                        _q_view(dq_src, num_heads), dk, dv, d)
    return dq_src, sum_window_grads(dkv_w.view(n, f, lw * tk, 2 * c), idx)


def sum_window_grads(dkv_w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The k | v gradients ``[N, F, lw * Tk, 2C]`` of each query frame's
    gathered window summed (in fp32) into the kv frames they were gathered
    from (``idx [F, lw]``, :func:`window_frame_indices`), packed as
    ``dkv_src [N, F, Tk, 3C]`` with zero q lanes, in ``dkv_w``'s dtype."""
    n, f, rows, c2 = dkv_w.shape
    lw = idx.shape[1]
    tk = rows // lw
    dkv = torch.zeros((n, f, tk, c2), dtype=torch.float32, device=dkv_w.device)
    parts = dkv_w.view(n, f, lw, tk, c2).float()
    for j in range(lw):  # each window position maps the query frames one-to-one onto kv frames
        dkv.index_add_(1, idx[:, j], parts[:, :, j])
    return torch.cat([dkv.new_zeros((n, f, tk, c2 // 2)), dkv], dim=-1).to(dkv_w.dtype)


def banded_attention_bwd_cuda(
    q_src: torch.Tensor,
    kv_src: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    shift: int,
    local_window: int,
    num_heads: int,
    channels: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the banded backward kernels (bf16: the Hopper design; fp32:
    the mma.sync one) on the forward's sources, ``out`` and ``lse`` and the
    output gradient ``g`` [N, F, Tq, C]; a head dim they are not built for
    takes its route (module docstring).  Returns the packed ``(dq_src,
    dkv_src)`` (zeros outside the q and k|v lanes)."""
    d = _check_banded_bwd(q_src, kv_src, out, lse, g, local_window, num_heads, channels)[4]
    dp = padded_head_dim(d)
    q_p, kv_p = (pad_head_dim(x, num_heads, dp, 3) for x in (q_src, kv_src))
    o, gp = (pad_head_dim(y, num_heads, dp, 1) for y in (out, g))
    if dp != d:
        HEAD_DIM_ROUTES["banded_attention_bwd:pad"] += 1
    if dp > HEAD_DIMS[-1]:
        dq_src, dkv_src = _banded_flash_bwd(q_p, kv_p, o, lse, gp, shift, local_window, num_heads, d)
        HEAD_DIM_ROUTES["banded_attention_bwd:flash"] += 1
    else:
        dq_src, dkv_src = _banded_attention_bwd_launch(
            q_p, kv_p, o, lse, gp, shift, local_window, num_heads, num_heads * dp, d
        )
        LAUNCHES["banded_attention_bwd"] += 1
        BANDED_BWD_WINDOWS[local_window] += 1
    return tuple(unpad_head_dim(x, num_heads, d, 3) for x in (dq_src, dkv_src))


def banded_bwd_frames_per_tile(n: int, frames: int, length: int, num_heads: int) -> int:
    """Frames of ``length`` rows that the Hopper banded backward packs into
    one 64-row tile of an ``[N, F, length]`` side on the current card (1
    unless ``length <= 32``; fewer than ``64 // length`` where the grid
    would leave SMs idle).  Needs the built kernels (a CUDA device)."""
    return cuda_build.load().lib.mmdiff_banded_attention_bwd_frames_per_tile(
        n, frames, length, num_heads
    )


class RowsPlan(NamedTuple):
    """The launch of the ``rows`` variant (``mmdiff_self_attention_variant_fwd``):
    ``pack`` whole sequences per 64-row tile; ``blocks`` and ``tiles_per_block``
    -- at ``pack > 1`` a one-dimensional grid of persistent blocks, block b
    taking the work items (tile, head) ``b + i * blocks``, ``i <
    tiles_per_block``; at ``pack == 1`` K1's grid ``(blocks, heads)`` of one
    tile each, ``64 * warpgroups`` query rows of one sequence a block."""

    pack: int
    blocks: int
    tiles_per_block: int
    warpgroups: int


def rows_launch_plan(n: int, t: int, heads: int, kernel_dim: int, sm_count: int,
                     blocks_per_sm: int) -> RowsPlan:
    """The ``rows`` variant's launch on a card of ``sm_count`` SMs holding
    ``blocks_per_sm`` of its persistent blocks each.  At ``T <= 32``:
    ``floor(64 / T)`` whole sequences a tile (never fewer: the grid is sized
    to the card instead), ``ceil(N / pack) * heads`` work items over at most
    ``sm_count * blocks_per_sm`` blocks.  At ``T > 32``: K1's grid, with
    two consumer warpgroups when ``T > 64`` and the 128-row tiles still
    give every SM a block (kernel head dims up to 128)."""
    if t <= TILE_ROWS // 2:
        pack = TILE_ROWS // t
        items = -(-n // pack) * heads
        blocks = min(items, sm_count * blocks_per_sm)
        return RowsPlan(pack, blocks, -(-items // blocks), 1)
    wide = n * heads * -(-t // (2 * TILE_ROWS))
    wg = 2 if kernel_dim <= HEAD_DIMS[-1] and t > TILE_ROWS and wide >= sm_count else 1
    return RowsPlan(1, n * -(-t // (TILE_ROWS * wg)), 1, wg)


_ROWS_BLOCKS_PER_SM: dict = {}


def _rows_plan_on_card(qkv: torch.Tensor, n: int, t: int, heads: int, kernel_dim: int) -> RowsPlan:
    lib = cuda_build.load().lib
    key = (qkv.device.index, kernel_dim)
    if key not in _ROWS_BLOCKS_PER_SM:
        with torch.cuda.device(qkv.device):
            per_sm = lib.mmdiff_self_attention_rows_blocks_per_sm(kernel_dim)
        if per_sm < 1:
            raise RuntimeError(f"the rows kernel at head dim {kernel_dim} fits no block on an SM")
        _ROWS_BLOCKS_PER_SM[key] = per_sm
    sms = torch.cuda.get_device_properties(qkv.device).multi_processor_count
    return rows_launch_plan(n, t, heads, kernel_dim, sms, _ROWS_BLOCKS_PER_SM[key])


def _variant_launch(qkv: torch.Tensor, num_heads: int, variant: str, d: int):
    """Launch a variant on thirds-layout ``qkv`` whose head dim a kernel is
    built for, at the logit scale of head dim ``d``."""
    n, t, c, dk = _check_qkv(qkv, num_heads)
    _check_aligned(qkv)
    fp32 = qkv.dtype == torch.float32
    kd = kernel_head_dim(dk, HEAD_DIMS if fp32 else VARIANT_HEAD_DIMS)
    lib = cuda_build.load().lib
    out = torch.empty((n, t, c), dtype=qkv.dtype, device=qkv.device)
    rows = variant == "rows" and not fp32
    plan = _rows_plan_on_card(qkv, n, t, num_heads, kd) if rows else (0, 0, 0, 0)
    with torch.cuda.device(qkv.device):
        err = lib.mmdiff_self_attention_variant_fwd(
            qkv.data_ptr(), out.data_ptr(), n, t, num_heads, dk, kd, 1.0 / math.sqrt(d),
            VARIANT_CODES[variant], *plan, int(fp32), _stream(),
        )
    if err:
        raise RuntimeError(f"self-attention {variant} kernel launch failed: CUDA error {err}")
    return out


def self_attention_variant_cuda(qkv: torch.Tensor, num_heads: int, variant: str) -> torch.Tensor:
    """Launch one K1 variant's kernel on thirds-layout ``qkv``; returns
    ``out [N, T, C]``.  stock / hoist / recip / exp2 launch the stock kernel
    (and its routes); rows / nomax / noexp take every ``d <= 256`` in bf16
    (module docstring; fp32 up to 128)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if variant not in VARIANT_CODES:
        out, _ = self_attention_cuda(qkv, num_heads)
        VARIANT_LAUNCHES[variant] += 1
        return out
    d = _check_qkv(qkv, num_heads)[3]
    dp = padded_head_dim(d)
    if qkv.dtype == torch.float32 and dp > HEAD_DIMS[-1]:
        raise ValueError(
            f"the fp32 {variant} kernel is built for head dims up to {HEAD_DIMS[-1]}, got d = {d}"
        )
    if dp != d:
        HEAD_DIM_ROUTES["self_attention_variant:pad"] += 1
    if dp > HEAD_DIMS[-1]:
        HEAD_DIM_ROUTES["self_attention_variant:wide"] += 1
    out = _variant_launch(pad_head_dim(qkv, num_heads, dp, 3), num_heads, variant, d)
    VARIANT_LAUNCHES[variant] += 1
    return unpad_head_dim(out, num_heads, d, 1)


# ---------------------------------------------------------------------------
# Autograd functions and dispatch
# ---------------------------------------------------------------------------


class SelfAttention(torch.autograd.Function):
    """:func:`self_attention` with its backward: the CUDA kernels on a CUDA
    tensor (the forward's output and logsumexp saved), the plain versions
    on the CPU."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, layout: str):
        ctx.num_heads, ctx.layout = num_heads, layout
        if kernel_path(qkv) == "cuda":
            qkv = qkv.contiguous()
            out, lse = self_attention_cuda(qkv, num_heads, layout)
            ctx.save_for_backward(qkv, out, lse)
            return out
        ctx.save_for_backward(qkv)
        return self_attention_reference(qkv, num_heads, layout)

    @staticmethod
    def backward(ctx, g):
        if kernel_path(g) == "cuda":
            qkv, out, lse = ctx.saved_tensors
            dqkv = self_attention_bwd_cuda(qkv, out, lse, g.contiguous(), ctx.num_heads, ctx.layout)
        else:
            (qkv,) = ctx.saved_tensors
            dqkv = self_attention_backward_reference(qkv, g, ctx.num_heads, ctx.layout)
        return dqkv, None, None


class BandedCrossAttention(torch.autograd.Function):
    """:func:`banded_cross_attention_packed` with its backward, dispatched
    as :class:`SelfAttention` is.  When ``q_src`` and ``kv_src`` are the two
    modalities' projections, each gets the packed gradient of its lanes and
    autograd sums the two calls' contributions."""

    @staticmethod
    def forward(ctx, q_src, kv_src, shift: int, local_window: int, num_heads: int, channels: int):
        ctx.args = (int(shift), local_window, num_heads, channels)
        if kernel_path(q_src) == "cuda":
            q_src, kv_src = q_src.contiguous(), kv_src.contiguous()
            out, lse = banded_attention_cuda(q_src, kv_src, *ctx.args)
            ctx.save_for_backward(q_src, kv_src, out, lse)
            return out
        ctx.save_for_backward(q_src, kv_src)
        return banded_cross_attention_reference(q_src, kv_src, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        if kernel_path(g) == "cuda":
            q_src, kv_src, out, lse = ctx.saved_tensors
            dq, dkv = banded_attention_bwd_cuda(q_src, kv_src, out, lse, g.contiguous(), *ctx.args)
        else:
            q_src, kv_src = ctx.saved_tensors
            dq, dkv = banded_attention_backward_reference(q_src, kv_src, g, *ctx.args)
        return dq, dkv, None, None, None, None


def self_attention(qkv: torch.Tensor, num_heads: int, layout: str = "thirds") -> torch.Tensor:
    """Packed-qkv MHA: plain version on the CPU, the CUDA kernel on a GPU;
    differentiable through :class:`SelfAttention`."""
    return SelfAttention.apply(qkv, num_heads, layout)


def self_attention_variant(qkv: torch.Tensor, num_heads: int, variant: str) -> torch.Tensor:
    """One K1 variant over thirds-layout ``qkv`` (forward only): the plain
    version on the CPU, its kernel on a GPU."""
    if kernel_path(qkv) == "cuda":
        return self_attention_variant_cuda(qkv, num_heads, variant)
    return self_attention_variant_reference(qkv, num_heads, variant)


def banded_cross_attention_packed(
    q_src: torch.Tensor,
    kv_src: torch.Tensor,
    shift: int,
    local_window: int,
    num_heads: int,
    channels: int,
) -> torch.Tensor:
    """Packed-qkv RS-MMA: plain version on the CPU, the CUDA kernel on a
    GPU; differentiable through :class:`BandedCrossAttention`."""
    return BandedCrossAttention.apply(q_src, kv_src, shift, local_window, num_heads, channels)
