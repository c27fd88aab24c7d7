"""The head-dim routes of the port's attention wrappers, on the CPU: what
the card computes for a head dim no kernel is built for, composed from the
same pieces the wrappers use, against the plain versions and the JAX
package's functions.

* d % 8 != 0: the operands zero-padded to ``padded_head_dim(d)`` in every
  head (``pad_head_dim``), the function at the logit scale 1/sqrt(d) of the
  real d, the result cut back (``unpad_head_dim``) -- for self-attention in
  both qkv layouts, the banded function, flash MHA, forward and backward, at
  d = 12, 20 and 36;
* d above 128 (the K8 route): self-attention over strided ``[N, H, T, d]``
  views of the packed qkv (``packed_head_views``) and the banded function
  over the window gathered per query frame (``gathered_window_views``),
  its k | v gradients summed back into the kv frames
  (``sum_window_grads``), with plain attention standing in for the K8
  kernels, at d = 136 and 200.

The JAX functions: ``dispatch_self_attention``,
``dispatch_banded_attention_packed`` (their einsum / XLA paths on the CPU)
and ``flash_mha``, with ``jax.vjp`` for the gradients.  fp32; 2e-5 abs
(summation order only)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, randn, t  # noqa: F401

from mm_diffusion_tpu.ops import block_attention as jba
from mm_diffusion_tpu.ops import fused_attention as jfu
from mm_diffusion_tpu_torch.ops import block_attention as pba
from mm_diffusion_tpu_torch.ops import fused_attention as pfu

TOL = dict(rtol=0, atol=2e-5)
PAD_DIMS = [12, 20, 36]


def _np(x):
    return x.detach().numpy()


@pytest.mark.parametrize("layout", ["thirds", "per_head"])
@pytest.mark.parametrize("parts", [1, 3])
def test_pad_and_unpad(parts, layout):
    """Every head's lanes past d are zero after the pad; the unpad gives the
    input back bit for bit."""
    heads, d, dp = 3, 12, 16
    x = t(randn(0, 2, 5, parts * heads * d))
    y = pba.pad_head_dim(x, heads, dp, parts, layout)
    assert y.shape == (2, 5, parts * heads * dp) and y.is_contiguous()
    shape = (heads, parts, dp) if layout == "per_head" else (parts, heads, dp)
    lanes = y.reshape(2, 5, *shape)
    assert torch.equal(lanes[..., d:], torch.zeros_like(lanes[..., d:]))
    assert torch.equal(pba.unpad_head_dim(y, heads, d, parts, layout), x)
    assert pba.pad_head_dim(x, heads, d, parts, layout) is x


def test_padded_head_dim():
    assert [pba.padded_head_dim(d) for d in (1, 8, 12, 20, 36, 129, 200)] == [8, 8, 16, 24, 40, 136, 200]


def _self_padded(qkv, g, heads, layout, d):
    """Self-attention and its backward as the card runs them at head dim d:
    on the zero-padded copy, at the scale of the real d."""
    dp = pba.padded_head_dim(d)
    scale = 1.0 / math.sqrt(d)
    x = pba.pad_head_dim(qkv, heads, dp, 3, layout)
    out = pba.self_attention_reference(x, heads, layout, scale=scale)
    dqkv = pba.self_attention_backward_reference(x, pba.pad_head_dim(g, heads, dp, 1), heads, layout,
                                                 scale=scale)
    return pba.unpad_head_dim(out, heads, d, 1), pba.unpad_head_dim(dqkv, heads, d, 3, layout)


@pytest.mark.parametrize("layout", ["thirds", "per_head"])
@pytest.mark.parametrize("d", PAD_DIMS)
def test_self_attention_padded_route(d, layout):
    n, tt, heads = 2, 24, 2
    c = heads * d
    qkv, g = randn(d, n, tt, 3 * c), randn(d + 1, n, tt, c)
    out, dqkv = _self_padded(t(qkv), t(g), heads, layout, d)
    np.testing.assert_allclose(_np(out), _np(pba.self_attention_reference(t(qkv), heads, layout)), **TOL)
    np.testing.assert_allclose(
        _np(dqkv), _np(pba.self_attention_backward_reference(t(qkv), t(g), heads, layout)), **TOL
    )
    if layout == "thirds":
        ref, vjp = jax.vjp(lambda x: jba.dispatch_self_attention(x, heads), jnp.asarray(qkv))
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
        np.testing.assert_allclose(_np(dqkv), np.asarray(vjp(jnp.asarray(g))[0]), **TOL)


def _jax_banded(q_src, kv_src, g, shift, lw, heads, c):
    fn = lambda q, kv: jba.dispatch_banded_attention_packed(q, kv, jnp.int32(shift), lw, heads, c)  # noqa: E731
    out, vjp = jax.vjp(fn, jnp.asarray(q_src), jnp.asarray(kv_src))
    return (np.asarray(x) for x in (out, *vjp(jnp.asarray(g))))


@pytest.mark.parametrize("lw,shift", [(1, 3), (2, 3), (4, 1)])
@pytest.mark.parametrize("d", PAD_DIMS)
def test_banded_padded_route(d, lw, shift):
    n, f, tq, tk, heads = 1, 4, 10, 6, 2
    c = heads * d
    dp = pba.padded_head_dim(d)
    q_src, kv_src, g = randn(d + 2, n, f, tq, 3 * c), randn(d + 3, n, f, tk, 3 * c), randn(d + 4, n, f, tq, c)
    args = (shift, lw, heads, heads * dp)
    qp, kvp = (pba.pad_head_dim(t(x), heads, dp, 3) for x in (q_src, kv_src))
    out = pba.banded_cross_attention_reference(qp, kvp, *args, scale=1.0 / math.sqrt(d))
    grads = pba.banded_attention_backward_reference(
        qp, kvp, pba.pad_head_dim(t(g), heads, dp, 1), *args, scale=1.0 / math.sqrt(d)
    )
    out = pba.unpad_head_dim(out, heads, d, 1)
    dq_src, dkv_src = (pba.unpad_head_dim(x, heads, d, 3) for x in grads)
    plain = pba.banded_cross_attention_reference(t(q_src), t(kv_src), shift, lw, heads, c)
    np.testing.assert_allclose(_np(out), _np(plain), **TOL)
    ref_out, ref_dq, ref_dkv = _jax_banded(q_src, kv_src, g, shift, lw, heads, c)
    np.testing.assert_allclose(_np(out), ref_out, **TOL)
    np.testing.assert_allclose(_np(dq_src), ref_dq, **TOL)
    np.testing.assert_allclose(_np(dkv_src), ref_dkv, **TOL)


@pytest.mark.parametrize("d", PAD_DIMS)
def test_flash_mha_padded_route(d):
    """[B, T, H, D] q, k, v padded along D, the plain version at 1/sqrt(d),
    the first d lanes kept: JAX's flash_mha and its vjp."""
    b, tq, tk, h = 2, 12, 20, 2
    dp = pba.padded_head_dim(d)
    arrays = [randn(50 + i, b, tt, h, d) for i, tt in enumerate((tq, tk, tk, tq))]
    q, k, v, g = (torch.nn.functional.pad(t(x), (0, dp - d)) for x in arrays)
    out = pfu.mha_reference(q, k, v, scale=1.0 / math.sqrt(d))[..., :d]
    grads = [x[..., :d] for x in pfu.mha_backward_reference(q, k, v, g, scale=1.0 / math.sqrt(d))]
    ref, vjp = jax.vjp(jfu.flash_mha, *(jnp.asarray(x) for x in arrays[:3]))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)
    for got, r in zip(grads, vjp(jnp.asarray(arrays[3]))):
        np.testing.assert_allclose(_np(got), np.asarray(r), **TOL)


def _mha_views(q, k, v, scale):
    """Plain attention over [B, H, T, D] views, standing in for K8."""
    bthd = lambda x: x.transpose(1, 2)  # noqa: E731
    return bthd(pfu.mha_reference(bthd(q), bthd(k), bthd(v), scale=scale))


@pytest.mark.parametrize("layout", ["thirds", "per_head"])
@pytest.mark.parametrize("d", [136, 200])
def test_self_attention_flash_route_views(d, layout):
    """K1's route above 128: q, k, v as strided views of the packed qkv, the
    output written through an ``[N, H, T, d]`` view of ``[N, T, C]``."""
    n, tt, heads = 2, 9, 2
    qkv = t(randn(d, n, tt, 3 * heads * d))
    views = pba.packed_head_views(qkv, heads, layout)
    assert all(x.data_ptr() >= qkv.data_ptr() and x.stride(-1) == 1 for x in views)
    out = torch.empty((n, tt, heads * d))
    pba._heads_view(out, heads).copy_(_mha_views(*views, 1.0 / math.sqrt(d)))
    np.testing.assert_allclose(_np(out), _np(pba.self_attention_reference(qkv, heads, layout)), **TOL)


@pytest.mark.parametrize("lw,shift", [(1, 3), (3, 2), (4, 0)])
@pytest.mark.parametrize("d", [136, 200])
def test_banded_flash_route_window(d, lw, shift):
    """K2/K3 and K6/K7's route above 128: attention over the window gathered
    per query frame, and its k | v gradients summed back into the kv frames,
    against the plain versions and JAX."""
    n, f, tq, tk, heads = 1, 4, 5, 3, 2
    c = heads * d
    q_src, kv_src, g = randn(d + 5, n, f, tq, 3 * c), randn(d + 6, n, f, tk, 3 * c), randn(d + 7, n, f, tq, c)
    q, k, v, idx = pba.gathered_window_views(t(q_src), t(kv_src), shift, lw, heads)
    assert q.shape == (n * f, heads, tq, d) and k.shape == (n * f, heads, lw * tk, d)
    bthd = lambda x: x.transpose(1, 2)  # noqa: E731
    out = bthd(_mha_views(q, k, v, None)).reshape(n, f, tq, c)
    gh = pba._heads_view(t(g).view(n * f, tq, c), heads)
    dq, dk, dv = pfu.mha_backward_reference(bthd(q), bthd(k), bthd(v), bthd(gh))  # [B, T, H, d]
    dq_src = torch.cat([dq.reshape(n, f, tq, c), torch.zeros((n, f, tq, 2 * c))], dim=-1)
    dkv_w = torch.cat([x.reshape(n, f, lw * tk, c) for x in (dk, dv)], dim=-1)
    dkv_src = pba.sum_window_grads(dkv_w, idx)
    plain = pba.banded_cross_attention_reference(t(q_src), t(kv_src), shift, lw, heads, c)
    np.testing.assert_allclose(_np(out), _np(plain), **TOL)
    ref_out, ref_dq, ref_dkv = _jax_banded(q_src, kv_src, g, shift, lw, heads, c)
    np.testing.assert_allclose(_np(out), ref_out, **TOL)
    np.testing.assert_allclose(_np(dq_src), ref_dq, **TOL)
    np.testing.assert_allclose(_np(dkv_src), ref_dkv, **TOL)


def test_head_dims_above_256_raise_before_any_kernel():
    """d > 256 has no kernel anywhere in the port: the wrappers' checks
    refuse it (here on a CPU tensor, which the kernels would refuse too)."""
    with pytest.raises(ValueError, match="above 256"):
        pba._check_heads(2 * 264, 2)
    assert pba._check_heads(2 * 200, 2) == 200
