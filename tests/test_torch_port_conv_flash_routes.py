"""The routes and the arithmetic of the kernels redesigned for Hopper, on
the CPU, where the kernels cannot run:

* the direct 3x3 conv (ops/gemm_conv.py::conv3x3_chw): the kernel's
  arithmetic is a sum over the nine taps of the wrapper's tap-major weights
  (``tap_major_weights``) times the input shifted by (dy - 1, dx - 1) with
  zero fill, read from the channels-last copy with a zero ring that the
  kernel reads (``channels_last_halo``, its channels padded to a multiple
  of 8); composed here from those pieces and held against the JAX tool's
  Pallas kernel (tools/conv_chw_spike.py, interpret mode) and
  ``lax.conv_general_dilated`` at 2e-5 abs (fp32, summation order only),
  at ragged Ci / Co and H, W that are not multiples of 8;
* the flash MHA's design rules (ops/fused_attention.py::forward_design,
  backward_design) for every head dim 1..256 in bf16 and fp32, and d > 256
  refused;
* the GEMM of S3 and the S4 core (ops/gemm_conv.py::skip_gemm,
  gemm_blocks): the tile rule (``gemm_tiles``) at the JAX tools' shapes,
  and the kernel's K order -- each part's 64-deep steps with A's lanes and
  B's rows zero past the part's K, part 1's B rows from row K0 -- composed
  here and held against the JAX tool's Pallas kernel
  (tools/bench_skip_conv.py, interpret mode) at a K0 that is not a
  multiple of 64;
* the CPU paths of both entry points launch no kernel.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_common import one_torch_thread, randn, t  # noqa: F401

from mm_diffusion_tpu_torch.ops import block_attention as pba
from mm_diffusion_tpu_torch.ops import fused_attention as pfu
from mm_diffusion_tpu_torch.ops import gemm_conv as pgc

from mm_diffusion_tpu_torch.tools import bench_skip_conv as port_skip_tool
from mm_diffusion_tpu_torch.tools import conv_chw_spike as port_conv_tool

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
TOL = dict(rtol=0, atol=2e-5)
K_STEP = 64  # the Hopper GEMM's K per ring stage (kGemmKStep in csrc/skip_gemm.cu)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def conv_tool():
    return _load_tool("conv_chw_spike")


@pytest.fixture(scope="module")
def skip_tool():
    return _load_tool("bench_skip_conv")


def nine_tap_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """What the conv kernel computes, from the wrapper's own pieces: the
    channels-last copy of x with its zero ring, [B, H + 2, W + 2, Ci'], the
    tap-major weights [Co, 9, Ci'], and per tap (dy, dx) one [Co, Ci'] x
    [Ci', H * W] product with the copy's window at (dy, dx)."""
    b, ci, h, w_px = x.shape
    xh = pgc.channels_last_halo(x)
    taps = pgc.tap_major_weights(w)
    cip = -(-ci // 8) * 8
    assert xh.shape == (b, h + 2, w_px + 2, cip) and xh.is_contiguous()
    assert taps.shape == (w.shape[0], 9, cip) and taps.is_contiguous()
    assert not taps[:, :, ci:].any() and not xh[..., ci:].any()
    assert not xh[:, [0, -1]].any() and not xh[:, :, [0, -1]].any()
    out = 0
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        window = xh[:, dy:dy + h, dx:dx + w_px].reshape(b, h * w_px, cip)
        out = out + torch.matmul(taps[:, tap], window.transpose(1, 2))
    return out.reshape(b, -1, h, w_px)


@pytest.mark.parametrize("b,ci,co,h,w", [
    (1, 5, 7, 9, 13), (2, 7, 24, 6, 10), (1, 24, 5, 11, 3), (1, 24, 24, 5, 16),
])
def test_nine_tap_decomposition_matches_jax(conv_tool, b, ci, co, h, w):
    x = randn(31, b, ci, h, w)
    wt = randn(32, co, ci, 3, 3, scale=0.1)
    out = nine_tap_conv(t(x), t(wt))
    assert out.shape == (b, co, h, w)
    ref = np.asarray(conv_tool.conv3x3_chw(jnp.asarray(x), jnp.asarray(wt), th=h, interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    ref_xla = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wt), (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW")))
    np.testing.assert_allclose(out.numpy(), ref_xla, **TOL)
    np.testing.assert_allclose(pgc.conv3x3_chw(t(x), t(wt)).numpy(), ref_xla, **TOL)


def test_tap_major_weights_order():
    w = torch.arange(2 * 3 * 9, dtype=torch.float32).reshape(2, 3, 3, 3)
    taps = pgc.tap_major_weights(w)
    assert taps.shape == (2, 9, 8)
    for co in range(2):
        for ci in range(3):
            for dy in range(3):
                for dx in range(3):
                    assert taps[co, 3 * dy + dx, ci] == w[co, ci, dy, dx]
    assert pgc.tap_major_weights(torch.zeros(4, 16, 3, 3)).shape == (4, 9, 16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_forward_design_rule(dtype):
    """Every head dim 1..256: bf16 up to a kernel head dim of 128 takes the
    Hopper kernel, fp32 and kernel head dims 192 / 256 the mma.sync design,
    each at the next built size at or above d rounded up to 8."""
    for d in range(1, 257):
        design, kd = pfu.forward_design(d, dtype)
        dp = -(-d // 8) * 8
        assert kd == min(k for k in pfu.HEAD_DIMS if k >= dp)
        assert design == ("sm90" if dtype == torch.bfloat16 and kd <= 128 else "mma"), (d, design)
        assert pfu.FORWARD_ENTRIES[design].startswith("mmdiff_flash_mha_fwd")
    for d in (257, 264, 512):
        with pytest.raises(ValueError, match="256"):
            pfu.forward_design(d, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_design_rule(dtype):
    """The backward's rule is the forward's: every head dim 8..256 (and
    1..7, on the pad to 8), bf16 up to a kernel head dim of 128 takes the
    Hopper passes, fp32 and kernel head dims 192 / 256 the mma.sync design;
    each design's entry point is the backward's."""
    for d in range(1, 257):
        design, kd = pfu.backward_design(d, dtype)
        assert (design, kd) == pfu.forward_design(d, dtype)
        assert design == ("sm90" if dtype == torch.bfloat16 and kd <= 128 else "mma"), (d, design)
        assert pfu.BACKWARD_ENTRIES[design].startswith("mmdiff_flash_mha_bwd")
    assert pfu.BACKWARD_ENTRIES["sm90"] != pfu.BACKWARD_ENTRIES["mma"]
    for d in (257, 264, 512):
        with pytest.raises(ValueError, match="256"):
            pfu.backward_design(d, dtype)


def test_gemm_tile_rule_at_the_tools_shapes(skip_tool):
    """At the JAX tools' shapes a tile covers the short side whole: at S3
    (16 x 256^2 pixel rows, CO = 192) every column of B, so each row of x1
    and x2 is read once; at the S4 core (Co = 192) every row of A, so each
    byte of B is read once.  At every M and N the tiles cover C."""
    b, h, w, c, co = port_skip_tool.SHAPE
    assert (b, h, w, c, co) == (skip_tool.B, skip_tool.H, skip_tool.W, skip_tool.C, skip_tool.CO)
    s3 = pgc.gemm_tiles(b * h * w, co)
    assert (s3.rows, s3.cols, s3.n_tiles, s3.m_tiles) == (192, 192, 1, -(-b * h * w // 192))
    for npx, nblk in port_conv_tool.GEMM_CASES:  # the JAX tool's gemm() cases
        s4 = pgc.gemm_tiles(port_conv_tool.GEMM_CO, npx, nblk)
        assert (s4.rows, s4.cols, s4.m_tiles) == (192, 256, 1)
        assert s4.n_tiles * s4.cols == npx and s4.tiles == npx // 256 * nblk
    for m in (1, 8, 191, 192, 193, 1000):
        for n in range(8, 1033, 8):
            tl = pgc.gemm_tiles(m, n, 3)
            assert tl.cols == (192 if n <= 192 else 256)
            assert (tl.m_tiles - 1) * tl.rows < m <= tl.m_tiles * tl.rows
            assert (tl.n_tiles - 1) * tl.cols < n <= tl.n_tiles * tl.cols
            assert tl.tiles == tl.m_tiles * tl.n_tiles * 3


def k_step_gemm(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """What the Hopper GEMM computes, step by step in the order its ring
    streams K: for each part, K_STEP-deep steps of the part's A lanes and
    the part's B rows, both zero past the part's K (each part has its own
    tensor maps); part 1's B rows start at row K0 of w."""
    c1 = x1.shape[-1]
    out = 0
    for a, b in ((x1, w[:c1]), (x2, w[c1:])):
        kp = a.shape[-1]
        for k in range(0, kp, K_STEP):
            past = max(0, k + K_STEP - kp)  # lanes / rows of the step past K_p: zero-filled
            a_box = F.pad(a[..., k:k + K_STEP], (0, past))
            b_box = F.pad(b[k:k + K_STEP], (0, 0, 0, past))
            assert a_box.shape[-1] == b_box.shape[0] == K_STEP
            out = out + a_box @ b_box
    return out


@pytest.mark.parametrize("c", [40, 72])  # K0 = c: one step and a part, two steps and a part
def test_k_step_gemm_matches_jax_tool(skip_tool, c):
    from jax.experimental.pallas import tpu as pltpu

    b, h, w = 1, 16, 8
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    x1, x2 = bf(randn(41, b, h, w, c)), bf(randn(42, b, h, w, c))
    wt = bf(randn(43, 2 * c, skip_tool.CO, scale=0.05))
    with pltpu.force_tpu_interpret_mode():
        ref = skip_tool.skip_gemm(jnp.asarray(x1, jnp.bfloat16), jnp.asarray(x2, jnp.bfloat16), jnp.asarray(wt))
    out = k_step_gemm(t(x1), t(x2), t(wt))
    # JAX rounds its fp32 accumulation to bf16 (2^-9 relative).
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32), rtol=2**-8, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), pgc.skip_gemm(t(x1), t(x2), t(wt)).numpy(), **TOL)


def test_cpu_paths_launch_no_kernel():
    pgc.reset_launch_counts()
    pfu.reset_launch_counts()
    pba.reset_launch_counts()
    x = torch.randn(1, 3, 5, 13)
    pgc.conv3x3_chw(x, torch.randn(4, 3, 3, 3))
    q = torch.randn(1, 9, 2, 40, requires_grad=True)
    pfu.flash_mha(q, q, q).sum().backward()
    pfu.flash_mha_bhtd(*(torch.randn(1, 2, 7, 12),) * 3)
    assert pgc.LAUNCHES == {"skip_gemm": 0, "gemm_blocks": 0, "conv3x3_chw": 0}
    assert pfu.LAUNCHES == {"flash_mha_fwd": 0, "flash_mha_bwd": 0}
    for counter in (pgc.CONV_ROUTES, pfu.FORWARD_DESIGNS, pfu.BACKWARD_DESIGNS,
                    pba.HEAD_DIM_ROUTES):
        assert not counter
