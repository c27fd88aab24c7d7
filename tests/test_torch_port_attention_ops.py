"""The port's attention ops (mm_diffusion_tpu_torch/ops/block_attention.py)
against the JAX package's: the plain versions against JAX's references and
against its Pallas kernels run in interpret mode, in fp32 on the CPU.
Tolerance 1e-5 abs (fp32 summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, randn, t  # noqa: F401

from mm_diffusion_tpu.ops import block_attention as jba
from mm_diffusion_tpu_torch.ops import block_attention as pba

TOL = dict(rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "n,tt,heads,d",
    [(3, 64, 4, 64), (2, 100, 4, 96), (2, 16, 2, 128), (1, 40, 6, 64), (5, 25, 2, 64)],
)
def test_self_attention_reference_matches_jax(n, tt, heads, d):
    qkv = randn(0, n, tt, 3 * heads * d)
    ref = np.asarray(jba.self_attention_reference(jnp.asarray(qkv), heads))
    out = pba.self_attention(t(qkv), heads).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("n,tt,heads,d", [(2, 64, 4, 64), (3, 16, 2, 96)])
def test_self_attention_matches_pallas_interpret(n, tt, heads, d):
    qkv = randn(1, n, tt, 3 * heads * d)
    ref = np.asarray(jba.self_attention_packed(jnp.asarray(qkv), heads))
    out = pba.self_attention(t(qkv), heads).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("heads,d", [(3, 64), (2, 128)])
def test_per_head_layout_is_a_permuted_thirds_layout(heads, d):
    """The SR U-Net's legacy order [h0(q k v) | h1(q k v) ...] read with
    layout="per_head" equals the thirds-major input read as "thirds"."""
    n, tt, c = 2, 24, heads * d
    thirds = randn(2, n, tt, 3 * c)
    per_head = thirds.reshape(n, tt, 3, heads, d).transpose(0, 1, 3, 2, 4).reshape(n, tt, 3 * c)
    ref = np.asarray(jba.self_attention_reference(jnp.asarray(thirds), heads))
    out = pba.self_attention(t(per_head), heads, layout="per_head").numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pba.self_attention(t(thirds), heads).numpy(), **TOL)


F = 4
BANDED_CASES = [
    (lw, shift, tq, tk)
    for lw in (1, 2, F)
    for shift in range(F - lw + 1 if lw < F else 1)
    for tq, tk in ((16, 8), (8, 16))  # video->audio and audio->video
] + [(2, F - 1, 16, 8), (1, F - 1, 8, 16)]  # shifts past the window span: the wrap


@pytest.mark.parametrize("lw,shift,tq,tk", BANDED_CASES)
def test_banded_reference_matches_jax(lw, shift, tq, tk):
    n, heads, d = 2, 2, 64
    c = heads * d
    q_src = randn(3, n, F, tq, 3 * c)
    kv_src = randn(4, n, F, tk, 3 * c)
    ref = np.asarray(
        jba.banded_cross_attention_reference(
            jnp.asarray(q_src[..., :c]), jnp.asarray(kv_src[..., c:]), shift, lw, heads
        )
    )
    out = pba.banded_cross_attention_packed(t(q_src), t(kv_src), shift, lw, heads, c).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("lw,shift,tq,tk", [(1, 3, 16, 8), (2, 3, 8, 16), (F, 0, 16, 8)])
def test_banded_matches_pallas_interpret(lw, shift, tq, tk):
    n, heads, d = 1, 2, 64
    c = heads * d
    q_src = randn(5, n, F, tq, 3 * c)
    kv_src = randn(6, n, F, tk, 3 * c)
    ref = np.asarray(
        jba.banded_cross_attention_packed(
            jnp.asarray(q_src), jnp.asarray(kv_src), jnp.int32(shift), lw, heads, c
        )
    )
    out = pba.banded_cross_attention_packed(t(q_src), t(kv_src), shift, lw, heads, c).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    pba.reset_launch_counts()
    qkv = t(randn(7, 2, 16, 3 * 128))
    out = pba.self_attention(qkv, 2)
    assert torch.equal(out, pba.self_attention_reference(qkv, 2))
    src = t(randn(8, 1, F, 8, 3 * 128))
    pba.banded_cross_attention_packed(src, src, 1, 2, 2, 128)
    assert set(pba.LAUNCHES.values()) == {0}
    assert not pba.BANDED_WINDOWS


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on a CUDA tensor or raises; it never falls
    back to the plain version."""
    qkv = t(randn(9, 1, 16, 3 * 128))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pba.self_attention_cuda(qkv, 2)
    src = t(randn(10, 1, F, 8, 3 * 128))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pba.banded_attention_cuda(src, src, 0, 2, 2, 128)
