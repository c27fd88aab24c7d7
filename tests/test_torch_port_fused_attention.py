"""The port's flash MHA (mm_diffusion_tpu_torch/ops/fused_attention.py)
against the JAX package's, on the CPU (the port's plain path), in fp32:
`flash_mha` / `flash_mha_bhtd` against JAX's (the einsum path on the CPU)
at 1e-5 abs (summation order only), and against JAX's library TPU flash
kernel run in interpret mode -- with the padding and segment-id masks of a
ragged Tk or Tq, as `flash_mha_bhtd` builds them -- outputs and q/k/v
gradients at 2e-4 (tests/test_fused_attention.py's tolerance)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, randn, t  # noqa: F401

from mm_diffusion_tpu.ops import fused_attention as jfu
from mm_diffusion_tpu_torch.ops import fused_attention as pfu

TOL = dict(rtol=0, atol=1e-5)
KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize(
    "b,tq,tk,h,d",
    [(2, 256, 256, 2, 64), (2, 256, 200, 2, 64), (1, 100, 37, 3, 96), (2, 16, 40, 1, 128)],
)
def test_flash_mha_matches_jax_both_layouts(b, tq, tk, h, d):
    q, k, v = randn(0, b, tq, h, d), randn(1, b, tk, h, d), randn(2, b, tk, h, d)
    ref = np.asarray(jfu.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = pfu.flash_mha(t(q), t(k), t(v))
    assert out.shape == (b, tq, h, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    sw = lambda x: np.ascontiguousarray(x.swapaxes(1, 2))  # noqa: E731
    ref_b = np.asarray(jfu.flash_mha_bhtd(*(jnp.asarray(sw(x)) for x in (q, k, v))))
    out_b = pfu.flash_mha_bhtd(*(t(sw(x)) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(out_b, ref_b, **TOL)
    np.testing.assert_allclose(out_b, sw(out.numpy()), **TOL)


def test_output_takes_v_dtype():
    q = torch.randn(1, 8, 2, 64, dtype=torch.float64)
    v = torch.randn(1, 8, 2, 64)
    assert pfu.flash_mha(q, q, v).dtype == torch.float32


@pytest.mark.parametrize("t_q,t_k", [
    pytest.param(256, 256, id="256"),
    pytest.param(256, 200, id="200"),  # the JAX kernel pads Tk to 256 and masks
    pytest.param(100, 256, id="q100-256"),  # a ragged Tq: q padded to 128, its rows masked
])
def test_matches_library_flash_kernel_interpret_mode(t_q, t_k):
    """Outputs and gradients of the library kernel's forward and its dq /
    dkv backward kernels, with the padding and segment ids that
    `flash_mha_bhtd` builds (mm_diffusion_tpu/ops/fused_attention.py:
    every T padded to a multiple of 128, each pad masked by q and kv
    segment ids), against the port's plain forward and backward."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu import flash_attention as fa

    b, h, d = 2, 2, 64
    q, k, v = randn(3, b, h, t_q, d), randn(4, b, h, t_k, d), randn(5, b, h, t_k, d)
    g = randn(6, b, h, t_q, d)
    pad_q, pad_k = (-t_q) % 128, (-t_k) % 128
    seg = None
    if pad_q or pad_k:
        seg = fa.SegmentIds(
            q=(jnp.arange(t_q + pad_q) < t_q).astype(jnp.int32)[None].repeat(b, 0),
            kv=(jnp.arange(t_k + pad_k) < t_k).astype(jnp.int32)[None].repeat(b, 0),
        )

    def loss(q, k, v):
        qp = jnp.pad(q, ((0, 0), (0, 0), (0, pad_q), (0, 0)))
        kp, vp = (jnp.pad(x, ((0, 0), (0, 0), (0, pad_k), (0, 0))) for x in (k, v))
        out = fa.flash_attention(qp, kp, vp, segment_ids=seg, sm_scale=1.0 / math.sqrt(d))[:, :, :t_q]
        return jnp.sum(out * jnp.asarray(g)), out

    with pltpu.force_tpu_interpret_mode():
        (_, ref), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        )

    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    out = pfu.flash_mha_bhtd(*leaves)
    (out * t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **KERNEL_TOL)
    for leaf, ref_grad in zip(leaves, grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref_grad), **KERNEL_TOL)


@pytest.mark.parametrize("tq,tk", [(24, 24), (24, 9), (100, 65), (65, 130)])
def test_gradients_match_jax_vjp(tq, tk):
    """Both layouts' CPU backward (the plain backward behind the autograd
    function) against jax.vjp of JAX's flash_mha (einsum on the CPU), also
    where Tq and Tk cross the kernels' 64-row tile on either side."""
    b, h, d = 2, 3, 64
    q, k, v, g = randn(7, b, tq, h, d), randn(8, b, tk, h, d), randn(9, b, tk, h, d), randn(10, b, tq, h, d)
    _, vjp = jax.vjp(jfu.flash_mha, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(g))
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    pfu.flash_mha(*leaves).backward(t(g))
    for leaf, ref in zip(leaves, refs):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
    bhtd = [t(np.ascontiguousarray(x.swapaxes(1, 2))).requires_grad_() for x in (q, k, v)]
    pfu.flash_mha_bhtd(*bhtd).backward(t(np.ascontiguousarray(g.swapaxes(1, 2))))
    for leaf, ref in zip(bhtd, refs):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref).swapaxes(1, 2), rtol=0, atol=2e-5)


def test_lse_limit_rejects_padded_keys():
    """The logsumexp limit the card holds the forward kernel to rejects a
    kernel that let the zero keys padding Tk = 400 up to 512 into the
    softmax (what the JAX path's segment ids mask)."""
    b, h, tq, tk, d = 2, 2, 64, 400, 64
    q, k = (t(randn(s, b, h, n, d)).bfloat16().float() for s, n in ((24, tq), (25, tk)))
    lse = torch.logsumexp(torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d), dim=-1)
    pad = -tk % 128
    assert pfu.LSE_TOL.check(lse + 1e-4, lse)[1]
    assert not pfu.LSE_TOL.check(torch.logaddexp(lse, lse.new_tensor(math.log(pad))), lse)[1]


def test_cpu_path_launches_no_kernel():
    pfu.reset_launch_counts()
    x = torch.randn(1, 16, 2, 64, requires_grad=True)
    pfu.flash_mha(x, x, x).sum().backward()
    assert pfu.LAUNCHES == {"flash_mha_fwd": 0, "flash_mha_bwd": 0}
    assert not pfu.FORWARD_DESIGNS and not pfu.BACKWARD_DESIGNS
