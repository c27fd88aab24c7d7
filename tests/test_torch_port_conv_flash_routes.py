"""The routes and the arithmetic of the two kernels redesigned for Hopper,
on the CPU, where the kernels cannot run:

* the direct 3x3 conv (ops/gemm_conv.py::conv3x3_chw): the kernel's
  arithmetic is a sum over the nine taps of the wrapper's tap-major weights
  (``tap_major_weights``) times the input shifted by (dy - 1, dx - 1) with
  zero fill, read from the channels-last copy with a zero ring that the
  kernel reads (``channels_last_halo``, its channels padded to a multiple
  of 8); composed here from those pieces and held against the JAX tool's
  Pallas kernel (tools/conv_chw_spike.py, interpret mode) and
  ``lax.conv_general_dilated`` at 2e-5 abs (fp32, summation order only),
  at ragged Ci / Co and H, W that are not multiples of 8;
* the flash MHA forward's design rule (ops/fused_attention.py::
  forward_design) for every head dim 1..256 in bf16 and fp32, and d > 256
  refused;
* the CPU paths of both entry points launch no kernel.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, randn, t  # noqa: F401

from mm_diffusion_tpu_torch.ops import block_attention as pba
from mm_diffusion_tpu_torch.ops import fused_attention as pfu
from mm_diffusion_tpu_torch.ops import gemm_conv as pgc

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
TOL = dict(rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def conv_tool():
    spec = importlib.util.spec_from_file_location("_jax_tool_conv_chw_spike", TOOLS / "conv_chw_spike.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    Hopper kernel, fp32 and kernel head dims 192 / 256 the previous design,
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
    for counter in (pgc.CONV_ROUTES, pgc.PREVIOUS_LAUNCHES, pfu.FORWARD_DESIGNS,
                    pfu.PREVIOUS_LAUNCHES, pba.HEAD_DIM_ROUTES):
        assert not counter
