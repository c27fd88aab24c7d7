"""Head dims on the card: the rule that maps a head dim to the kernel built
for it (``kernel_head_dim`` in mm_diffusion_tpu_torch/ops/block_attention.py
for K1-K7, in ops/fused_attention.py for K8), and the port's attention at
head dims that only that rule lets onto the card, against the JAX package
on the CPU:

* ``self_attention`` forward and backward, both qkv layouts, and
  ``banded_cross_attention_packed`` forward and backward, against the JAX
  ops' Pallas kernels (K1, K2/K3, K4, K6/K7) in interpret mode, 2e-5 abs
  (fp32 summation order only);
* ``flash_mha`` at D = 32 and 160 against JAX's ``flash_mha`` and its
  ``jax.vjp`` (the einsum path on the CPU), as
  tests/test_torch_port_fused_attention.py runs it;
* one tiny MM-UNet forward with ``num_head_channels`` 16 against the JAX
  model, rtol 2e-3 / atol 2e-4.

The kernels themselves run on the card only
(tests/test_torch_port_*kernels.py); here every op takes its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, randn, state_dict_numpy, t  # noqa: F401

from mm_diffusion_tpu.models.mm_unet import MMUNetConfig as JaxConfig
from mm_diffusion_tpu.models.mm_unet import MultimodalUNet as JaxUNet
from mm_diffusion_tpu.ops import block_attention as jba
from mm_diffusion_tpu.ops import fused_attention as jfu
from mm_diffusion_tpu.train import torch_import as ti
from mm_diffusion_tpu_torch.models.mm_unet import MMUNetConfig, MultimodalUNet
from mm_diffusion_tpu_torch.ops import block_attention as pba
from mm_diffusion_tpu_torch.ops import fused_attention as pfu
from mm_diffusion_tpu_torch.weights import randomize_

TOL = dict(rtol=0, atol=2e-5)

RULE_CASES = (
    [("K1-K7", d, built) for d, built in (
        (8, 32), (16, 32), (24, 32), (32, 32), (40, 64), (48, 64), (64, 64), (72, 96),
        (96, 96), (112, 128), (128, 128),
    )]
    + [("K8", d, built) for d, built in ((136, 192), (160, 192), (192, 192), (200, 256), (256, 256))]
    + [("K1-K7", d, None) for d in (0, 12, 130)]
    + [("K8", 264, None)]
)


@pytest.mark.parametrize(
    "kernels,d,built", RULE_CASES, ids=[f"{k} d={d}" for k, d, _ in RULE_CASES]
)
def test_head_dim_rule(kernels, d, built):
    """Each accepted head dim runs on the next built size at or above it;
    the rest raise ValueError naming the rule."""
    rule = pba.kernel_head_dim if kernels == "K1-K7" else pfu.kernel_head_dim
    if built is None:
        with pytest.raises(ValueError, match=r"d % 8 == 0 and 8 <= d <= "):
            rule(d)
    else:
        assert rule(d) == built
        assert built in (pba.HEAD_DIMS if kernels == "K1-K7" else pfu.HEAD_DIMS)


def _per_head(x, heads):
    """thirds [.., T, (3, H, d)] -> the SR U-Net's per-head [.., T, (H, 3, d)]."""
    *lead, c3 = x.shape
    d = c3 // 3 // heads
    return np.ascontiguousarray(np.swapaxes(x.reshape(*lead, 3, heads, d), -3, -2)).reshape(x.shape)


def _thirds(x, heads):
    """The inverse of :func:`_per_head`."""
    *lead, c3 = x.shape
    d = c3 // 3 // heads
    return np.ascontiguousarray(np.swapaxes(x.reshape(*lead, heads, 3, d), -3, -2)).reshape(x.shape)


@pytest.mark.parametrize("layout", ["thirds", "per_head"])
@pytest.mark.parametrize("d", [16, 24, 48])
def test_self_attention_matches_k1_k4_interpret(d, layout):
    """Forward against K1 and the gradient against K4, both in Pallas
    interpret mode; the per-head layout is the thirds input permuted."""
    n, tt, heads = 2, 40, 2
    c = heads * d
    qkv, g = randn(d, n, tt, 3 * c), randn(d + 1, n, tt, c)
    out_ref = np.asarray(jba.self_attention_packed(jnp.asarray(qkv), heads))
    dqkv_ref = np.asarray(jba._self_attention_bwd_pallas(jnp.asarray(qkv), jnp.asarray(g), heads))
    x = t(qkv if layout == "thirds" else _per_head(qkv, heads)).requires_grad_()
    out = pba.self_attention(x, heads, layout)
    out.backward(t(g))
    np.testing.assert_allclose(out.detach().numpy(), out_ref, **TOL)
    grad = x.grad.numpy()
    np.testing.assert_allclose(grad if layout == "thirds" else _thirds(grad, heads), dqkv_ref, **TOL)


@pytest.mark.parametrize("lw,shift", [(1, 3), (2, 1)])
@pytest.mark.parametrize("d", [16, 24, 48])
def test_banded_matches_k2_k3_k6_k7_interpret(d, lw, shift):
    """Forward against K2/K3 and both packed gradients against K6 (lw 1) or
    K7 (lw > 1), in Pallas interpret mode."""
    n, f, tq, tk, heads = 1, 4, 16, 8, 2
    c = heads * d
    q_src, kv_src, g = randn(d + 2, n, f, tq, 3 * c), randn(d + 3, n, f, tk, 3 * c), randn(d + 4, n, f, tq, c)
    jq, jkv, jg = jnp.asarray(q_src), jnp.asarray(kv_src), jnp.asarray(g)
    out_ref = np.asarray(jba.banded_cross_attention_packed(jq, jkv, jnp.int32(shift), lw, heads, c))
    if lw == 1:
        dq_ref, dkv_ref = jba._banded_bwd_lw1_pallas(jq, jkv, jg, shift, heads, c)
    else:
        dq_ref, dkv_ref = jba._banded_bwd_oneshot_pallas(jq, jkv, jg, shift, lw, heads, c)
    xq, xkv = t(q_src).requires_grad_(), t(kv_src).requires_grad_()
    out = pba.banded_cross_attention_packed(xq, xkv, shift, lw, heads, c)
    out.backward(t(g))
    np.testing.assert_allclose(out.detach().numpy(), out_ref, **TOL)
    np.testing.assert_allclose(xq.grad.numpy(), np.asarray(dq_ref), **TOL)
    np.testing.assert_allclose(xkv.grad.numpy(), np.asarray(dkv_ref), **TOL)


@pytest.mark.parametrize("d", [32, 160])
def test_flash_mha_matches_jax(d):
    """Output and q/k/v gradients against JAX's flash_mha and jax.vjp."""
    b, tq, tk, h = 2, 24, 40, 2
    q, k, v, g = randn(40, b, tq, h, d), randn(41, b, tk, h, d), randn(42, b, tk, h, d), randn(43, b, tq, h, d)
    ref, vjp = jax.vjp(jfu.flash_mha, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(g))
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    out = pfu.flash_mha(*leaves)
    out.backward(t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    for leaf, r in zip(leaves, refs):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), **TOL)


def test_mm_unet_head_channels_16_matches_jax():
    """A tiny MM-UNet whose attention sites have head dim 16 (2 and 6
    heads), port weights converted to the JAX model: the same outputs."""
    cfg = dict(
        video_size=(2, 3, 8, 8), audio_size=(1, 128), model_channels=32, video_out_channels=6,
        audio_out_channels=2, num_res_blocks=1, cross_attention_resolutions=(2,),
        cross_attention_windows=(1,), cross_attention_shift=False, video_attention_resolutions=(2,),
        audio_attention_resolutions=(-1,), channel_mult=(1, 3), num_heads=2, num_head_channels=16,
        resblock_updown=True, dtype="float32",
    )
    model = randomize_(MultimodalUNet(MMUNetConfig(**cfg)), seed=44).eval()
    params, unused = ti.convert_mm_unet_state_dict(state_dict_numpy(model), JaxConfig(**cfg))
    assert unused == []
    f, c, hh, w = cfg["video_size"]
    video, audio, ts = randn(45, 2, f, hh, w, c), randn(46, 2, cfg["audio_size"][1], 1), np.array([9, 600])
    ref = JaxUNet(JaxConfig(**cfg)).apply(
        {"params": params}, jnp.asarray(video), jnp.asarray(audio), jnp.asarray(ts)
    )
    with torch.no_grad():
        out = model(t(video), t(audio), torch.as_tensor(ts))
    for r, o in zip(ref, out):
        assert o.shape == r.shape and np.abs(np.asarray(r)).max() > 1e-2
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-3, atol=2e-4)
