"""GEMM and convolution kernels of the port's conv spikes: plain PyTorch
versions and the hand-written CUDA kernels' wrappers.

* :func:`skip_gemm` -- the decoder-skip 1x1 conv over two NHWC channel parts
  without a concat: ``x1 . w[:C1] + x2 . w[C1:]``, ``[B, H, W, C1]`` and
  ``[B, H, W, C2]`` -> ``[B, H, W, CO]`` (counterpart of ``skip_gemm`` in
  ``tools/bench_skip_conv.py``, whose CO is fixed at 192; here it is
  ``w.shape[1]``).
* :func:`gemm_blocks` -- ``[Co, K] x [nblk, K, npx] -> [nblk, Co, npx]``,
  the GEMM core of ``tools/conv_chw_spike.py`` (``gemm()``), on the same
  kernel (``csrc/skip_gemm.cu``) with one part.

  The GEMM kernel is the Hopper design (TMA boxes of A K-major and of B
  MN-major, a producer warpgroup feeding a 4-stage ring, ``wgmma``,
  persistent blocks), on block tiles of :func:`gemm_tiles`: 192 rows of A
  by 192 or 256 columns of B, so that a tile covers the short side whole at
  both hot shapes.
* :func:`conv3x3_chw` -- 3x3 SAME conv in channel-major layout, ``[B, Ci,
  H, W]`` and ``[Co, Ci, 3, 3]`` -> ``[B, Co, H, W]``, as a direct implicit
  GEMM that never writes the im2col matrix (``csrc/conv3x3_chw.cu``;
  counterpart of ``conv3x3_chw`` in ``tools/conv_chw_spike.py``).  The
  kernel is the Hopper design (TMA boxes of each tap's shifted input,
  ``wgmma``): the wrapper reorders the weights into tap-major K order
  (:func:`tap_major_weights`), and a kernel of its own copies the input
  into a channels-last layout with a one-pixel zero ring (plain version:
  :func:`channels_last_halo`; launches in :data:`HELPER_LAUNCHES`), on
  which a tap's shift is a box coordinate; ``Ci % 8 != 0`` runs on
  zero-padded channels (counted in :data:`CONV_ROUTES`).

The kernels take bf16 activations only, so each has one design, the
Hopper one; they accumulate in fp32 and return bf16 (the TPU kernels'
contract); the weights are cast to bf16 by the wrapper, as the JAX tools
cast them.  The plain versions compute in fp32 and return the
activations' dtype.  Dispatch: a tensor on the CPU takes the plain version;
a CUDA tensor launches the kernel or raises on what it does not take.  No
model calls these yet: the tools under ``mm_diffusion_tpu_torch/tools/`` are
their entry points.  Each kernel wrapper counts its launches in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.nn.functional as F

from . import cuda_build
from .common import Tolerance, kernel_path

INT_MAX = 2**31 - 1  # the Hopper GEMM's tile count is an int
GEMM_TILE_M = 192  # rows of A per block tile of the Hopper GEMM (three consumer warpgroups)
# The three kernels against their fp32 plain versions: bf16 operands and a
# bf16 output of size ~2 (up to K = 1728 terms of 0.05-scaled weights),
# rounded at 2^-9 relative, fp32 accumulation in another order.
GEMM_TOL = Tolerance(2e-2, 1e-2)

LAUNCHES = {"skip_gemm": 0, "gemm_blocks": 0, "conv3x3_chw": 0}
# Calls that took a route of the conv, by "<wrapper>:<route>": "pad_channels"
# (Ci % 8 != 0: the kernel ran on operands zero-padded to a multiple of 8
# channels, the 16-byte rows that TMA reads).
CONV_ROUTES: collections.Counter = collections.Counter()
# Launches of the conv's input copy (channels_last_halo_cuda), by kernel.
HELPER_LAUNCHES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counter in (CONV_ROUTES, HELPER_LAUNCHES):
        counter.clear()


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------


def skip_gemm_reference(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Concat then one matmul, in fp32: ``cat([x1, x2], -1) @ w``."""
    return (torch.cat([x1, x2], dim=-1).float() @ w.float()).to(x1.dtype)


def gemm_blocks_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matmul in fp32: ``a [Co, K] @ b [nblk, K, npx]``."""
    return torch.matmul(a.float(), b.float()).to(b.dtype)


def conv3x3_chw_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Explicit im2col (``F.unfold``) and one matmul per image, in fp32: the
    kernel's arithmetic, with no cuDNN."""
    b, ci, h, w_px = x.shape
    co = w.shape[0]
    cols = F.unfold(x.float(), kernel_size=3, padding=1)  # [B, Ci*9, H*W], (ci, dy, dx) order
    out = torch.matmul(w.float().reshape(co, ci * 9), cols)
    return out.reshape(b, co, h, w_px).to(x.dtype)


def tap_major_weights(w: torch.Tensor) -> torch.Tensor:
    """``w [Co, Ci, 3, 3]`` in the conv kernel's K order: ``[Co, 9, Ci']``
    with ``[co, 3 dy + dx, ci] = w[co, ci, dy, dx]`` and ``Ci'`` = Ci rounded
    up to a multiple of 8 (zeros past Ci: 16-byte rows for TMA), contiguous,
    in w's dtype."""
    co, ci = w.shape[:2]
    taps = w.permute(0, 2, 3, 1).reshape(co, 9, ci)
    return F.pad(taps, (0, -ci % 8)).contiguous()


def channels_last_halo(x: torch.Tensor) -> torch.Tensor:
    """``x [B, Ci, H, W]`` as the conv kernel reads it: channels-last, ``[B,
    H + 2, W + 2, Ci']``, with a one-pixel ring of zeros (SAME padding) and
    ``Ci'`` = Ci rounded up to a multiple of 8 (zeros past Ci), contiguous.
    Output pixel ``(y, x)``'s tap ``(dy, dx)`` reads pixel ``(y + dy, x +
    dx)`` of it."""
    ci = x.shape[1]
    return F.pad(x.permute(0, 2, 3, 1), (0, -ci % 8, 1, 1, 1, 1)).contiguous()


@dataclasses.dataclass(frozen=True)
class GemmTiles:
    """The Hopper GEMM's block tiles over ``C [batch, M, N]``: ``rows`` x
    ``cols``, ``m_tiles`` x ``n_tiles`` of them per batch entry."""

    rows: int
    cols: int
    m_tiles: int
    n_tiles: int
    batch: int

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles * self.batch


def gemm_tiles(m: int, n: int, batch: int = 1) -> GemmTiles:
    """The tile rule of the Hopper GEMM: 192 rows of A (three consumer
    warpgroups of 64) by 192 columns of B when N <= 192, else 256 (two
    m64n128 ``wgmma`` a warpgroup).  A tile then covers the short side
    whole at both hot shapes: every row of A at the conv core (M = Co =
    192), so each byte of B leaves device memory once; every column of B at
    the skip projection (N = CO = 192), so each row of x1 and x2 is read
    once."""
    cols = 192 if n <= 192 else 256
    return GemmTiles(GEMM_TILE_M, cols, -(-m // GEMM_TILE_M), -(-n // cols), batch)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_bf16(x: torch.Tensor, name: str, ndim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16 activations, got {x.dtype}")
    if x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d tensor, got {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the CUDA kernel needs a 16-byte aligned tensor")


def _weights(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if w.device != like.device:
        raise ValueError(f"w on {w.device}, activations on {like.device}")
    return w.to(torch.bfloat16).contiguous()


def _launch_gemm(a0, lda0, a0_batch, k0, a1, lda1, a1_batch, k1, b, ldb, b_batch, c, ldc,
                 c_batch, m, n, batch, name):
    """Launch the Hopper GEMM on the operands' pointers and element
    strides; counts the launch."""
    if any(x % 8 for x in (k0, k1, n, lda0, lda1, ldb, ldc, a0_batch, a1_batch, b_batch, c_batch)):
        raise ValueError(f"{name}: K of each part, N and the row strides must be multiples of 8")
    if min(m, n, k0 + k1) == 0:
        raise ValueError(f"{name}: empty GEMM (M = {m}, N = {n}, K = {k0 + k1})")
    tiles = gemm_tiles(m, n, batch)
    if tiles.tiles > INT_MAX:
        raise ValueError(f"{name}: {tiles.tiles} tiles are too many for the kernel")
    lib = cuda_build.load().lib
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmdiff_gemm_bf16(
            a0.data_ptr(), lda0, a0_batch, k0,
            a1.data_ptr() if a1 is not None else None, lda1, a1_batch, k1,
            b.data_ptr(), ldb, b_batch, c.data_ptr(), ldc, c_batch, m, n, batch, tiles.cols, stream,
        )
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def skip_gemm_cuda(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the two-part GEMM (the Hopper design) on ``x1 [B, H, W, C1]``,
    ``x2 [B, H, W, C2]`` and ``w [C1 + C2, CO]``; returns ``[B, H, W, CO]``
    bf16."""
    _check_bf16(x1, "x1", 4)
    _check_bf16(x2, "x2", 4)
    c1, c2 = x1.shape[-1], x2.shape[-1]
    if x2.shape[:-1] != x1.shape[:-1] or x2.device != x1.device:
        raise ValueError(f"x1 {tuple(x1.shape)} and x2 {tuple(x2.shape)} differ outside the channels")
    if w.dim() != 2 or w.shape[0] != c1 + c2:
        raise ValueError(f"w: expected [{c1 + c2}, CO], got {tuple(w.shape)}")
    wb = _weights(w, x1)
    co = wb.shape[1]
    m = x1.numel() // c1
    out = torch.empty((*x1.shape[:-1], co), dtype=torch.bfloat16, device=x1.device)
    _launch_gemm(x1, c1, 0, c1, x2, c2, 0, c2, wb, co, 0, out, co, 0, m, co, 1, "skip_gemm")
    return out


def gemm_blocks_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the GEMM (the Hopper design) on ``a [Co, K]`` (shared) and
    ``b [nblk, K, npx]``; returns ``[nblk, Co, npx]`` bf16."""
    _check_bf16(b, "b", 3)
    nblk, k, npx = b.shape
    if a.dim() != 2 or a.shape[1] != k:
        raise ValueError(f"a: expected [Co, {k}], got {tuple(a.shape)}")
    ab = _weights(a, b)
    co = ab.shape[0]
    out = torch.empty((nblk, co, npx), dtype=torch.bfloat16, device=b.device)
    _launch_gemm(ab, k, 0, k, None, 0, 0, 0, b, npx, k * npx, out, npx, co * npx, co, npx, nblk,
                 "gemm_blocks")
    return out


def _check_conv(x: torch.Tensor, w: torch.Tensor) -> None:
    _check_bf16(x, "x", 4)
    ci = x.shape[1]
    if w.dim() != 4 or w.shape[1:] != (ci, 3, 3):
        raise ValueError(f"w: expected [Co, {ci}, 3, 3], got {tuple(w.shape)}")
    if min(w.shape[0], *x.shape) == 0:
        raise ValueError(f"empty conv operands: x {tuple(x.shape)}, w {tuple(w.shape)}")


def channels_last_halo_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the copy kernel of :func:`channels_last_halo` on a contiguous
    bf16 ``x [B, Ci, H, W]``; returns ``[B, H + 2, W + 2, Ci']`` bf16."""
    _check_bf16(x, "x", 4)
    b, ci, h, w_px = x.shape
    cip = ci + (-ci % 8)
    out = torch.empty((b, h + 2, w_px + 2, cip), dtype=torch.bfloat16, device=x.device)
    lib = cuda_build.load().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmdiff_channels_last_halo(x.data_ptr(), out.data_ptr(), b, ci, cip, h, w_px, stream)
    if err:
        raise RuntimeError(f"channels_last_halo kernel launch failed: CUDA error {err}")
    HELPER_LAUNCHES["channels_last_halo"] += 1
    return out


def conv3x3_chw_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the direct 3x3 conv (the Hopper design) on ``x [B, Ci, H, W]``
    and ``w [Co, Ci, 3, 3]``; returns ``[B, Co, H, W]`` bf16."""
    _check_conv(x, w)
    b, ci, h, w_px = x.shape
    wt = tap_major_weights(_weights(w, x))
    co = wt.shape[0]
    xh = channels_last_halo_cuda(x)
    if ci % 8:
        CONV_ROUTES["conv3x3_chw:pad_channels"] += 1
    out = torch.empty((b, co, h, w_px), dtype=torch.bfloat16, device=x.device)
    lib = cuda_build.load().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmdiff_conv3x3_chw(xh.data_ptr(), wt.data_ptr(), out.data_ptr(), b, wt.shape[2],
                                     co, h, w_px, stream)
    if err:
        raise RuntimeError(f"conv3x3_chw kernel launch failed: CUDA error {err}")
    LAUNCHES["conv3x3_chw"] += 1
    return out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def skip_gemm(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``cat([x1, x2], -1) @ w`` without the concat: the plain version on
    the CPU, the two-part GEMM kernel on a GPU."""
    if kernel_path(x1) == "cuda":
        return skip_gemm_cuda(x1, x2, w)
    return skip_gemm_reference(x1, x2, w)


def gemm_blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [Co, K] @ b [nblk, K, npx]``: the plain version on the CPU, the
    GEMM kernel on a GPU."""
    if kernel_path(b) == "cuda":
        return gemm_blocks_cuda(a, b)
    return gemm_blocks_reference(a, b)


def conv3x3_chw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv, ``[B, Ci, H, W]`` -> ``[B, Co, H, W]``: the plain
    version on the CPU, the direct implicit-GEMM kernel on a GPU."""
    if kernel_path(x) == "cuda":
        return conv3x3_chw_cuda(x, w)
    return conv3x3_chw_reference(x, w)
