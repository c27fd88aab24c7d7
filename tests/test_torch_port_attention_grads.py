"""The port's attention backwards (mm_diffusion_tpu_torch/ops/block_attention.py)
against the JAX package's: the plain backwards against the TPU backward
kernels K4-K7 run in Pallas interpret mode and against ``jax.vjp`` of the
JAX ops, in fp32 on the CPU; the ``autograd.Function``s against
``torch.autograd`` through the plain forwards.  Tolerance 2e-5 abs (fp32
summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, randn, t  # noqa: F401

from mm_diffusion_tpu.ops import block_attention as jba
from mm_diffusion_tpu_torch.ops import block_attention as pba

TOL = dict(rtol=0, atol=2e-5)


def _jax_self_vjp(qkv, g, heads):
    return np.asarray(jax.vjp(lambda x: jba.self_attention_packed(x, heads), jnp.asarray(qkv))[1](
        jnp.asarray(g))[0])


@pytest.mark.parametrize(
    "n,tt,heads,d",
    [(4, 16, 2, 64), (2, 25, 2, 96), (2, 40, 4, 64), (1, 16, 1, 128)],
    ids=["T16", "ragged T25", "T40 4 heads", "d128"],
)
def test_self_backward_matches_k4_interpret_and_vjp(n, tt, heads, d):
    c = heads * d
    qkv, g = randn(0, n, tt, 3 * c), randn(1, n, tt, c)
    out = pba.self_attention_backward_reference(t(qkv), t(g), heads).numpy()
    k4 = np.asarray(jba._self_attention_bwd_pallas(jnp.asarray(qkv), jnp.asarray(g), heads))
    np.testing.assert_allclose(out, k4, **TOL)
    np.testing.assert_allclose(out, _jax_self_vjp(qkv, g, heads), **TOL)


@pytest.mark.parametrize("tt,qblock", [(64, 32), (96, 32)])
def test_self_backward_matches_k5_chunked_interpret(tt, qblock):
    heads, d = 2, 64
    c = heads * d
    qkv, g = randn(2, 2, tt, 3 * c), randn(3, 2, tt, c)
    out = pba.self_attention_backward_reference(t(qkv), t(g), heads).numpy()
    k5 = np.asarray(
        jba._self_attention_bwd_chunked_pallas(jnp.asarray(qkv), jnp.asarray(g), heads, qblock)
    )
    np.testing.assert_allclose(out, k5, **TOL)


F = 4
BANDED_BWD_CASES = [  # (lw, shift, tq, tk): lw 1 / 2 / 4, the wrap, both directions
    (1, 0, 16, 8), (1, 3, 16, 8), (1, 2, 8, 16),
    (2, 0, 16, 8), (2, 3, 8, 16), (2, 2, 16, 8),
    (4, 0, 16, 8), (4, 0, 8, 16),
]


@pytest.mark.parametrize("lw,shift,tq,tk", BANDED_BWD_CASES)
def test_banded_backward_matches_k6_k7_interpret_and_vjp(lw, shift, tq, tk):
    n, heads, d = 1, 2, 64
    c = heads * d
    q_src, kv_src, g = randn(4, n, F, tq, 3 * c), randn(5, n, F, tk, 3 * c), randn(6, n, F, tq, c)
    dq, dkv = pba.banded_attention_backward_reference(t(q_src), t(kv_src), t(g), shift, lw, heads, c)
    dq, dkv = dq.numpy(), dkv.numpy()
    args = (jnp.asarray(q_src), jnp.asarray(kv_src), jnp.asarray(g), shift)
    if lw == 1:
        kq, kkv = jba._banded_bwd_lw1_pallas(*args, heads, c)
    else:
        kq, kkv = jba._banded_bwd_oneshot_pallas(*args, lw, heads, c)
    np.testing.assert_allclose(dq, np.asarray(kq), **TOL)
    np.testing.assert_allclose(dkv, np.asarray(kkv), **TOL)
    # packed-lane zeros: grads only in the q lanes of q_src and k|v lanes of kv_src
    assert not dq[..., c:].any() and not dkv[..., :c].any()
    assert np.abs(dq[..., :c]).max() > 1e-3 and np.abs(dkv[..., c:]).max() > 1e-3
    vq, vkv = jax.vjp(
        lambda q_, kv_: jba.banded_cross_attention_packed(q_, kv_, jnp.int32(shift), lw, heads, c),
        jnp.asarray(q_src), jnp.asarray(kv_src),
    )[1](jnp.asarray(g))
    np.testing.assert_allclose(dq, np.asarray(vq), **TOL)
    np.testing.assert_allclose(dkv, np.asarray(vkv), **TOL)


def _grads(fn, *xs, seed=7):
    xs = [x.clone().requires_grad_() for x in xs]
    out = fn(*xs)
    out.backward(torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)))
    return [x.grad for x in xs]


@pytest.mark.parametrize("layout", ["thirds", "per_head"])
def test_self_attention_function_equals_autograd_of_plain_forward(layout):
    qkv = t(randn(8, 3, 20, 3 * 192))
    got = _grads(lambda x: pba.self_attention(x, 3, layout), qkv)[0]
    ref = _grads(lambda x: pba.self_attention_reference(x, 3, layout), qkv)[0]
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("lw,shift", [(1, 3), (2, 3), (4, 0), (3, 1)])
def test_banded_function_equals_autograd_of_plain_forward(lw, shift):
    q_src, kv_src = t(randn(9, 2, F, 12, 3 * 128)), t(randn(10, 2, F, 6, 3 * 128))
    fn = lambda q, kv: pba.banded_cross_attention_packed(q, kv, shift, lw, 2, 128)  # noqa: E731
    ref = lambda q, kv: pba.banded_cross_attention_reference(q, kv, shift, lw, 2, 128)  # noqa: E731
    for a, b in zip(_grads(fn, q_src, kv_src), _grads(ref, q_src, kv_src)):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


def test_shared_projection_gets_the_sum_of_both_calls():
    """The RS-MMA block feeds each modality's qkv to one call as q_src and
    to the other as kv_src; autograd must sum the two packed gradients."""
    v_qkv, a_qkv = t(randn(11, 1, F, 16, 3 * 128)), t(randn(12, 1, F, 8, 3 * 128))

    def both(attn):
        return lambda v, a: attn(v, a, 1, 2, 2, 128).sum() + attn(a, v, 1, 2, 2, 128).square().sum()

    got = _grads(both(pba.banded_cross_attention_packed), v_qkv, a_qkv)
    ref = _grads(both(pba.banded_cross_attention_reference), v_qkv, a_qkv)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)


def test_backward_wrappers_refuse_cpu_tensors_and_count_nothing_on_cpu():
    pba.reset_launch_counts()
    qkv = t(randn(13, 1, 16, 3 * 128))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pba.self_attention_bwd_cuda(qkv, qkv[..., :128], torch.zeros(1, 2, 16), qkv[..., :128], 2)
    src = t(randn(14, 1, F, 8, 3 * 128))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pba.banded_attention_bwd_cuda(src, src, src[..., :128], torch.zeros(1, F, 2, 8), src[..., :128],
                                      0, 2, 2, 128)
    _grads(lambda x: pba.self_attention(x, 2), qkv)
    assert set(pba.LAUNCHES.values()) == {0}
