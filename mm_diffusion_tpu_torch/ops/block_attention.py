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

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel (``csrc/``) or raises.  There are no size gates and no
fallback from a failed build or launch to the plain version.  Each kernel
wrapper counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import collections
import math
from typing import Tuple

import torch

from . import cuda_build

LAYOUTS = ("thirds", "per_head")
HEAD_DIMS = (64, 96, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Launches of each kernel since the last reset_launch_counts(); the banded
# kernel's launches are also counted per window size.
LAUNCHES = {"self_attention": 0, "banded_attention": 0}
BANDED_WINDOWS: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    BANDED_WINDOWS.clear()


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


def self_attention_reference(
    qkv: torch.Tensor, num_heads: int, layout: str = "thirds"
) -> torch.Tensor:
    """Plain multi-head attention over packed ``[N, T, 3C]`` qkv, in fp32."""
    n, t, c3 = qkv.shape
    q, k, v = split_packed_qkv(qkv.float(), num_heads, layout)
    d = q.shape[-1]
    logits = torch.einsum("nqhd,nkhd->nhqk", q, k) * (1.0 / math.sqrt(d))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("nhqk,nkhd->nqhd", w, v)
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
) -> torch.Tensor:
    """Plain RS-MMA over packed sources, in fp32: ``q_src`` [N, F, Tq, 3C],
    ``kv_src`` [N, F, Tk, 3C] -> [N, F, Tq, C]."""
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
    logits = torch.einsum("nfqhd,nfkhd->nfhqk", qh, kh) * (1.0 / math.sqrt(d))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("nfhqk,nfkhd->nfqhd", w, vh)
    return out.reshape(n, f, tq, c).to(q_src.dtype)


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
    if num_heads <= 0 or c % num_heads:
        raise ValueError(f"{c} channels do not split into {num_heads} heads")
    d = c // num_heads
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head dims {HEAD_DIMS}, got {d}")
    return d


def self_attention_cuda(
    qkv: torch.Tensor, num_heads: int, layout: str = "thirds"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the self-attention kernel.  Returns ``(out [N, T, C],
    lse [N, H, T] fp32)``."""
    _check_kernel_input(qkv, "qkv", 3)
    n, t, c3 = qkv.shape
    if c3 % 3 or n == 0 or t == 0:
        raise ValueError(f"qkv: expected [N, T, 3C] with N, T > 0, got {tuple(qkv.shape)}")
    c = c3 // 3
    d = _check_heads(c, num_heads)
    if layout == "thirds":
        head_stride, k_off, v_off = d, c, 2 * c
    elif layout == "per_head":
        head_stride, k_off, v_off = 3 * d, d, 2 * d
    else:
        raise ValueError(f"unknown qkv layout {layout!r}; expected one of {LAYOUTS}")
    lib = cuda_build.load().lib
    out = torch.empty((n, t, c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((n, num_heads, t), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmdiff_self_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), n, t, num_heads, d,
            head_stride, k_off, v_off, int(qkv.dtype == torch.float32), stream,
        )
    if err:
        raise RuntimeError(f"self-attention kernel launch failed: CUDA error {err}")
    LAUNCHES["self_attention"] += 1
    return out, lse


def banded_attention_cuda(
    q_src: torch.Tensor,
    kv_src: torch.Tensor,
    shift: int,
    local_window: int,
    num_heads: int,
    channels: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the banded RS-MMA kernel.  Returns ``(out [N, F, Tq, C],
    lse [N, F, H, Tq] fp32)``."""
    _check_kernel_input(q_src, "q_src", 4)
    _check_kernel_input(kv_src, "kv_src", 4)
    n, f, tq, cq = q_src.shape
    tk = kv_src.shape[2]
    c = channels
    if cq != 3 * c or kv_src.shape[-1] != 3 * c:
        raise ValueError(f"q_src/kv_src must carry 3C = {3 * c} lanes")
    if kv_src.shape[:2] != (n, f) or kv_src.dtype != q_src.dtype or kv_src.device != q_src.device:
        raise ValueError("q_src and kv_src must share N, F, dtype and device")
    if min(n, f, tq, tk) == 0:
        raise ValueError("empty q_src or kv_src")
    if not 1 <= local_window <= f:
        raise ValueError(f"local_window {local_window} outside [1, {f}]")
    d = _check_heads(c, num_heads)
    lib = cuda_build.load().lib
    out = torch.empty((n, f, tq, c), dtype=q_src.dtype, device=q_src.device)
    lse = torch.empty((n, f, num_heads, tq), dtype=torch.float32, device=q_src.device)
    with torch.cuda.device(q_src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmdiff_banded_attention_fwd(
            q_src.data_ptr(), kv_src.data_ptr(), out.data_ptr(), lse.data_ptr(), n, f, tq,
            tk, num_heads, d, int(shift) % f, local_window,
            int(q_src.dtype == torch.float32), stream,
        )
    if err:
        raise RuntimeError(f"banded attention kernel launch failed: CUDA error {err}")
    LAUNCHES["banded_attention"] += 1
    BANDED_WINDOWS[local_window] += 1
    return out, lse


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def self_attention(qkv: torch.Tensor, num_heads: int, layout: str = "thirds") -> torch.Tensor:
    """Packed-qkv MHA: plain version on the CPU, the CUDA kernel on a GPU."""
    if qkv.device.type == "cuda":
        return self_attention_cuda(qkv.contiguous(), num_heads, layout)[0]
    if qkv.device.type == "cpu":
        return self_attention_reference(qkv, num_heads, layout)
    raise ValueError(f"no attention path for device {qkv.device}")


def banded_cross_attention_packed(
    q_src: torch.Tensor,
    kv_src: torch.Tensor,
    shift: int,
    local_window: int,
    num_heads: int,
    channels: int,
) -> torch.Tensor:
    """Packed-qkv RS-MMA: plain version on the CPU, the CUDA kernel on a GPU."""
    if q_src.device.type == "cuda":
        return banded_attention_cuda(
            q_src.contiguous(), kv_src.contiguous(), shift, local_window, num_heads, channels
        )[0]
    if q_src.device.type == "cpu":
        return banded_cross_attention_reference(
            q_src, kv_src, shift, local_window, num_heads, channels
        )
    raise ValueError(f"no attention path for device {q_src.device}")
