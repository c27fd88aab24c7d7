"""The plain versions of the port's spike kernels against the JAX tools'
Pallas kernels, run in TPU interpret mode on the CPU, in fp32 unless said:

* the K1 variants (ops/block_attention.py::self_attention_variant) against
  `attn_v2` (tools/bench_attn_variants.py: hoist, recip, rows_cap) and
  `attn_v3` (tools/bench_attn_variants2.py: stock, exp2, nomax, noexp), 1e-5
  abs (summation order only);
* `skip_gemm` (ops/gemm_conv.py) against the tool's `skip_gemm` (CO fixed at
  192, bf16 out: compared at bf16 rounding) and against the model's
  `PointwiseFromParts` (fp32, 1e-5);
* `conv3x3_chw` against the tool's `conv3x3_chw(..., interpret=True)`, 2e-5;
* `gemm_blocks` against numpy.

The tools are loaded from their paths with importlib; nothing in tools/
changes.  The tools' kernels are all the JAX side has of these functions.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, randn, t  # noqa: F401

from mm_diffusion_tpu.models.layers import PointwiseFromParts
from mm_diffusion_tpu_torch.ops import block_attention as pba
from mm_diffusion_tpu_torch.ops import gemm_conv as pgc

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
TOL = dict(rtol=0, atol=1e-5)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {n: _load_tool(n) for n in ("bench_attn_variants", "bench_attn_variants2",
                                       "bench_skip_conv", "conv_chw_spike")}


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


# (n, T, heads): T = 16 packs several sequences per JAX block behind its
# block-diagonal mask (and is what `rows` packs on the card); T = 128 puts
# one sequence in each JAX chunk.
VARIANT_SHAPES = [(8, 16, 2), (3, 128, 2)]


@pytest.mark.parametrize("n,tt,heads", VARIANT_SHAPES)
@pytest.mark.parametrize(
    "variant,kwargs",
    [("hoist", dict(hoist=True, recip=False)), ("recip", dict(hoist=True, recip=True)),
     ("rows", dict(hoist=True, recip=True, rows_cap=8192))],
)
def test_s1_variants_match_attn_v2(tools, interpret, n, tt, heads, variant, kwargs):
    qkv = randn(11, n, tt, 3 * heads * 64)
    ref = np.asarray(tools["bench_attn_variants"].attn_v2(jnp.asarray(qkv), heads, **kwargs))
    out = pba.self_attention_variant(t(qkv), heads, variant).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


# attn_v3's noexp adds the block-diagonal mask (-1e30) to the logits and
# scales it by 0.001 with no softmax, so where a JAX chunk packs several
# sequences (T = 16) its output mixes them with huge weights: a timing floor,
# not a function.  The port's noexp is per sequence, which JAX's equals where
# a chunk holds one sequence (T = 128).
S2_CASES = [(v, shape) for v in ("stock", "exp2", "nomax") for shape in VARIANT_SHAPES]
S2_CASES.append(("noexp", VARIANT_SHAPES[1]))


@pytest.mark.parametrize("variant,shape", S2_CASES)
def test_s2_variants_match_attn_v3(tools, interpret, variant, shape):
    n, tt, heads = shape
    qkv = randn(12, n, tt, 3 * heads * 64)  # logits ~ N(0, 1): nomax's clamp at 40 never engages
    ref = np.asarray(tools["bench_attn_variants2"].attn_v3(jnp.asarray(qkv), heads, mode=variant))
    out = pba.self_attention_variant(t(qkv), heads, variant).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_nomax_clamps_logits_at_40():
    """Above 40 the clamp changes the result, as exp2(min(l, 40 log2 e))
    does in attn_v3."""
    qkv = torch.zeros(1, 2, 3 * 64)
    qkv[0, :, :64] = 1.0
    qkv[0, 0, 64:128] = 50.0 / 8  # logit of key 0: 64 * 6.25 / 8 = 50
    qkv[0, 1, 64:128] = 30.0 / 8  # key 1: 30
    qkv[0, 0, 128:] = 1.0  # v: key 0 -> 1, key 1 -> 0
    out = pba.self_attention_variant(qkv, 1, "nomax")
    expect = np.exp(40.0) / (np.exp(40.0) + np.exp(30.0))
    np.testing.assert_allclose(out[0, :, 0].numpy(), [expect, expect], rtol=1e-6)
    assert out[0, 0, 0] < pba.self_attention_variant(qkv, 1, "stock")[0, 0, 0]


@pytest.mark.parametrize("fault", ["neighbouring sequence", "unscaled"])
def test_noexp_limit_rejects_planted_faults(fault):
    """noexp's limit (the one the card holds its kernel to) passes the plain
    output rounded to bf16, as the kernel returns it, and rejects a kernel
    that took each sequence's keys from its neighbour or dropped 1/sqrt(d),
    at T = 16, where noexp's values are ~1e-3."""
    n, tt, heads, c = 64, 16, 4, 256
    qkv = t(randn(23, n, tt, 3 * c)).bfloat16().float()
    ref = pba.self_attention_variant_reference(qkv, heads, "noexp")
    tol = pba.VARIANT_TOL["noexp"]
    assert tol.check(ref.bfloat16(), ref)[1]
    if fault == "unscaled":
        bad = ref * (c // heads) ** 0.5
    else:
        bad = pba.self_attention_variant_reference(
            torch.cat([qkv[..., :c], qkv.roll(1, dims=0)[..., c:]], dim=-1), heads, "noexp")
    assert not tol.check(bad, ref)[1]


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def test_skip_gemm_matches_jax_tool(tools, interpret):
    b, h, w, c = 1, 16, 8, 16
    co = tools["bench_skip_conv"].CO  # the JAX tool fixes CO at 192
    x1, x2 = _bf16(randn(13, b, h, w, c)), _bf16(randn(14, b, h, w, c))
    wt = _bf16(randn(15, 2 * c, co, scale=0.05))
    ref = tools["bench_skip_conv"].skip_gemm(
        jnp.asarray(x1, jnp.bfloat16), jnp.asarray(x2, jnp.bfloat16), jnp.asarray(wt)
    )
    assert ref.dtype == jnp.bfloat16
    out = pgc.skip_gemm(t(x1), t(x2), t(wt)).numpy()
    # JAX rounds its fp32 accumulation to bf16 (2^-9 relative); the plain
    # version returns fp32.
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), rtol=2**-8, atol=1e-6)


@pytest.mark.parametrize("c1,c2,co", [(16, 16, 24), (8, 24, 40)])
def test_skip_gemm_matches_pointwise_from_parts(c1, c2, co):
    x1, x2 = randn(16, 2, 4, 5, c1), randn(17, 2, 4, 5, c2)
    wt = randn(18, c1 + c2, co, scale=0.1)
    pw = PointwiseFromParts(co, c1 + c2, lead_ones=2, dtype=jnp.float32)
    params = {"params": {"kernel": jnp.asarray(wt.reshape(1, 1, c1 + c2, co)),
                         "bias": jnp.zeros((co,), jnp.float32)}}
    ref = np.asarray(pw.apply(params, (jnp.asarray(x1), jnp.asarray(x2))))
    out = pgc.skip_gemm(t(x1), t(x2), t(wt)).numpy()
    assert out.shape == (2, 4, 5, co)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("b,ci,co,h,w", [(2, 16, 8, 32, 128), (1, 8, 24, 16, 24)])
def test_conv3x3_chw_matches_jax_interpret(tools, b, ci, co, h, w):
    x = randn(19, b, ci, h, w)
    wt = randn(20, co, ci, 3, 3, scale=0.1)
    ref = np.asarray(tools["conv_chw_spike"].conv3x3_chw(
        jnp.asarray(x), jnp.asarray(wt), th=8, interpret=True))
    out = pgc.conv3x3_chw(t(x), t(wt)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
    ref_xla = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wt), (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW")))
    np.testing.assert_allclose(out, ref_xla, rtol=0, atol=2e-5)


def test_gemm_blocks_matches_numpy():
    """The JAX tool's `gemm()` cannot be run at a small size: its kernel is a
    closure inside it with the shapes fixed at [192, 1728] x [nblk, 1728,
    npx] for three cases of 3.6 GB each, and it only times.  Its function
    is a batched matmul, held here against numpy in float64."""
    a = randn(21, 24, 72, scale=0.1)
    b = randn(22, 3, 72, 40)
    out = pgc.gemm_blocks(t(a), t(b))
    assert out.shape == (3, 24, 40)
    np.testing.assert_allclose(out.numpy(), np.matmul(a.astype(np.float64), b), rtol=1e-5, atol=1e-5)


def test_cpu_paths_launch_no_kernel():
    pgc.reset_launch_counts()
    pba.reset_launch_counts()
    x = torch.randn(1, 4, 4, 8)
    pgc.skip_gemm(x, x, torch.randn(16, 8))
    pgc.conv3x3_chw(x, torch.randn(8, 4, 3, 3))
    pgc.gemm_blocks(torch.randn(8, 4), x)
    pba.self_attention_variant(torch.randn(2, 16, 3 * 64), 1, "rows")
    assert pgc.LAUNCHES == {"skip_gemm": 0, "gemm_blocks": 0, "conv3x3_chw": 0}
    assert not pba.VARIANT_LAUNCHES
