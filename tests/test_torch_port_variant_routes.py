"""The K1 variants' head-dim routes and the ``rows`` launch plan, on the CPU.

* The routes' pieces: what the card computes for ``rows``, ``nomax`` and
  ``noexp`` at a head dim no kernel is built for -- the plain version over
  the operands zero-padded to ``padded_head_dim(d)`` in every head
  (``pad_head_dim``), at the logit scale 1/sqrt(d) of the real d, cut back
  (``unpad_head_dim``) -- against the JAX tools' Pallas kernels ``attn_v2``
  (tools/bench_attn_variants.py, ``rows_cap=8192``) and ``attn_v3``
  (tools/bench_attn_variants2.py, ``mode=...``) at d, run in TPU interpret
  mode, at d = 12, 20, 36 and 136 (136 is a multiple of 8: on the card it
  runs the variant kernel built at 192 with no copy); fp32, 2e-5 abs
  (summation order only).  ``noexp`` only at T = 128, where a JAX chunk
  holds one sequence (tests/test_torch_port_spike_kernels.py says why).
* ``rows_launch_plan`` (ops/block_attention.py) for N in {1, 3, 4095,
  8192}, T in {1, 7, 16, 25, 32, 33, 1024} on 132 SMs: every sequence lies
  whole in exactly one tile, no tile holds more than 64 rows, the
  persistent blocks cover every work item once, and T > 32 gives K1's grid.

The tools are loaded from their paths with importlib; nothing in tools/
changes.
"""

import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_common import one_torch_thread, randn, t  # noqa: F401

from mm_diffusion_tpu_torch.ops import block_attention as pba

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
TOL = dict(rtol=0, atol=2e-5)
ROUTE_DIMS = [12, 20, 36, 136]
SMS = 132  # streaming multiprocessors of an H100 SXM


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {n: _load_tool(n) for n in ("bench_attn_variants", "bench_attn_variants2")}


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _variant_routed(qkv, heads, variant, d):
    """A variant as the card runs it at head dim d: on the zero-padded copy,
    at the scale of the real d, cut back to d."""
    x = pba.pad_head_dim(qkv, heads, pba.padded_head_dim(d), 3)
    out = pba.self_attention_variant_reference(x, heads, variant, scale=1.0 / math.sqrt(d))
    return pba.unpad_head_dim(out, heads, d, 1)


def _jax_variant(tools, qkv, heads, variant):
    x = jnp.asarray(qkv)
    if variant == "rows":
        out = tools["bench_attn_variants"].attn_v2(x, heads, hoist=True, recip=True, rows_cap=8192)
    else:
        out = tools["bench_attn_variants2"].attn_v3(x, heads, mode=variant)
    return np.asarray(out)


# (n, T, heads): T = 16 packs sequences (the persistent rows kernel's case);
# T = 128 puts one sequence in each JAX chunk.
ROUTE_CASES = [(v, d, shape) for v in ("rows", "nomax") for d in ROUTE_DIMS
               for shape in [(8, 16, 2), (3, 128, 2)]]
ROUTE_CASES += [("noexp", d, (3, 128, 2)) for d in ROUTE_DIMS]


@pytest.mark.parametrize("variant,d,shape", ROUTE_CASES)
def test_variant_route_pieces_match_jax(tools, interpret, variant, d, shape):
    n, tt, heads = shape
    qkv = randn(40 + d, n, tt, 3 * heads * d)
    out = _variant_routed(t(qkv), heads, variant, d).numpy()
    assert out.shape == (n, tt, heads * d)
    np.testing.assert_allclose(out, _jax_variant(tools, qkv, heads, variant), **TOL)


@pytest.mark.parametrize("n", [1, 3, 4095, 8192])
@pytest.mark.parametrize("tt", [1, 7, 16, 25, 32, 33, 1024])
def test_rows_launch_plan(n, tt):
    heads = 4
    for kernel_dim, per_sm in ((32, 3), (64, 3), (128, 2), (256, 1)):
        plan = pba.rows_launch_plan(n, tt, heads, kernel_dim, SMS, per_sm)
        if tt > 32:  # K1's grid: (N * ceil(T / (64 wg)), heads), one tile a block
            wg = 2 if kernel_dim <= 128 and tt > 64 and n * heads * math.ceil(tt / 128) >= SMS else 1
            assert plan == (1, n * math.ceil(tt / (64 * wg)), 1, wg)
            continue
        assert plan.pack == 64 // tt and plan.warpgroups == 1
        assert plan.pack * tt <= 64  # no tile holds more than 64 rows
        tiles = math.ceil(n / plan.pack)
        seqs = [list(range(p * plan.pack, min(n, (p + 1) * plan.pack))) for p in range(tiles)]
        assert sorted(s for tile in seqs for s in tile) == list(range(n))  # each sequence once, whole
        items = [b + i * plan.blocks for b in range(plan.blocks) for i in range(plan.tiles_per_block)]
        items = [w for w in items if w < tiles * heads]
        assert sorted(items) == list(range(tiles * heads))  # every (tile, head) once
        assert plan.blocks <= SMS * per_sm and plan.blocks <= tiles * heads
        assert (plan.tiles_per_block - 1) * plan.blocks < tiles * heads  # no block left idle
