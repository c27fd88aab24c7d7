"""GroupNorm + FiLM + SiLU as one pass (mm_diffusion_tpu_torch/ops/group_norm.py),
and the image U-Net ResBlock's residual + bias pass (ops/residual.py).

On the CPU: the plain version against float64 arithmetic written out here,
and against ``GroupNorm32`` then ``SiLU`` as the models composed them
before (bit for bit in fp32, one bf16 step in bf16); the routes that the
tensors select and their counter; the three U-Nets' module trees,
``state_dict`` keys and CPU outputs on the plain route against the
autograd route (the modules' own code); the kernel's symbol in the
benchmark's "group norm" kind; the image U-Net's channels-last layout (its
blocks' inputs and outputs, the nearest upsample, the routes that the
layout selects, the norm sites of one evaluation); the input term (a conv's
bias, or the time embedding too) in the plain version and on every route;
the residual pass's plain version, routes and sites.  The kernels
themselves, the norm in both layouts with and without the input term and
the residual pass, against their plain versions in the ``cuda`` tests,
which skip without a card."""

import hashlib
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch_port_common import one_torch_thread  # noqa: F401

from benchmark import trace
from mm_diffusion_tpu_torch import configs
from mm_diffusion_tpu_torch.models.image_unet import (
    ImageAttention,
    ImageResBlock,
    ImageSuperResModel,
    ImageUNet,
    ImageUNetConfig,
    _RB,
    build_image_plan,
)
from mm_diffusion_tpu_torch.models.layers import GroupNorm32, MMNorm, image_downsample, image_upsample
from mm_diffusion_tpu_torch.models.transformer import SpatialTransformer
from mm_diffusion_tpu_torch.models.mm_unet import MMResBlock, MMUNetConfig, MultimodalUNet
from mm_diffusion_tpu_torch.models.single_unet import SingleModalUNet, SingleResBlock, SingleUNetConfig
from mm_diffusion_tpu_torch.ops import group_norm as gn
from mm_diffusion_tpu_torch.ops import residual
from mm_diffusion_tpu_torch.ops.common import Tolerance
from mm_diffusion_tpu_torch.weights import randomize_

# (shape [N, C, ...], groups GroupNorm32 picks): 3-, 4- and 5-d, odd S, and
# narrow widths where the group count halves from 32.
CASES = [
    ((2, 64, 7), 32),
    ((2, 64, 6, 10), 32),
    ((2, 96, 3, 5, 7), 32),
    ((3, 24, 9), 8),
    ((2, 40, 5, 5), 8),
    ((2, 6, 3, 4, 5), 2),
]
# The plain version in bf16 against float64: one rounding of an fp32 value.
BF16_ONE_ROUNDING = Tolerance(1e-5, 2**-8)


def _inputs(shape, film, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    n, c = shape[:2]
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    norm = randomize_(GroupNorm32(c), seed=seed + 1)
    pair = tuple((torch.randn((n, c), generator=g) * 0.3).to(dtype) for _ in range(2)) if film else None
    return x, norm, pair


@torch.no_grad()
def _float64(x, norm, film, silu=True):
    """Group norm, FiLM and SiLU written out in float64."""
    n, c = x.shape[:2]
    g = norm.num_groups
    xs = x.double().reshape(n, g, -1)
    mean = xs.mean(-1, keepdim=True)
    var = ((xs - mean) ** 2).mean(-1, keepdim=True)
    y = ((xs - mean) / torch.sqrt(var + norm.eps)).reshape(x.shape)
    per_c = (1, c) + (1,) * (x.dim() - 2)
    y = y * norm.weight.double().reshape(per_c) + norm.bias.double().reshape(per_c)
    if film is not None:
        per_nc = (n, c) + (1,) * (x.dim() - 2)
        y = y * (1 + film[0].double().reshape(per_nc)) + film[1].double().reshape(per_nc)
    return y * torch.sigmoid(y) if silu else y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("film", [False, True], ids=["plain", "film"])
@pytest.mark.parametrize("shape,groups", CASES, ids=[str(s) for s, _ in CASES])
def test_plain_version_against_float64(shape, groups, film, dtype):
    x, norm, pair = _inputs(shape, film, dtype)
    assert norm.num_groups == groups
    with torch.no_grad():
        out = gn.group_norm_silu(norm, x, pair)
    assert out.dtype == dtype and out.shape == x.shape
    ref = _float64(x, norm, pair)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    else:
        err, ok = BF16_ONE_ROUNDING.check(out, ref.float())
        assert ok, err


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("film", [False, True], ids=["plain", "film"])
def test_plain_version_matches_group_norm32_then_silu(film, silu):
    """fp32: bit for bit the composition the models ran (the same ops).
    bf16: that composition rounds before the SiLU, the plain version only
    at the end: one bf16 step apart at most."""
    for dtype in (torch.float32, torch.bfloat16):
        x, norm, pair = _inputs((2, 64, 4, 6), film, dtype, seed=3)
        with torch.no_grad():
            composed = norm(x, film=pair)
            composed = F.silu(composed) if silu else composed
            plain = gn.group_norm_silu_reference(x, norm.weight, norm.bias, norm.num_groups, norm.eps, pair, silu)
        if dtype == torch.float32 or not silu:
            assert torch.equal(plain, composed)
        else:
            err, ok = gn.GN_TOL.check(plain, composed)
            assert ok, err
            assert (plain != composed).any()  # the rounding before the SiLU is gone


def test_mmnorm_takes_its_group_norm():
    x, _, pair = _inputs((2, 32, 5, 4), True, torch.float32)
    norm = randomize_(MMNorm(32), seed=4)
    with torch.no_grad():
        out = gn.group_norm_silu(norm, x, pair)
        ref = F.silu(norm(x, film=pair))
    assert torch.equal(out, ref)


def test_routes_follow_the_tensors():
    x, norm, pair = _inputs((2, 32, 6), True, torch.float32)
    gn.reset_launch_counts()
    with torch.no_grad():  # the parameters require grad, but nothing records
        cpu = gn.group_norm_silu(norm, x, pair)
    assert dict(gn.ROUTES) == {"cpu": 1}

    # Grad mode with parameters that require grad: the module's own code,
    # whose backward reaches the norm's parameters and the FiLM pair.
    pair_g = tuple(p.clone().requires_grad_(True) for p in pair)
    out = gn.group_norm_silu(norm, x, pair_g)
    assert dict(gn.ROUTES) == {"cpu": 1, "autograd": 1}
    assert out.requires_grad and torch.equal(out.detach(), cpu)
    out.square().sum().backward()
    assert norm.weight.grad is not None and all(p.grad is not None for p in pair_g)

    # Frozen parameters and an input that requires grad (the gradient
    # method): autograd records, so the module's code again.
    norm.requires_grad_(False)
    xg = x.clone().requires_grad_(True)
    gn.group_norm_silu(norm, xg, pair).sum().backward()
    assert xg.grad is not None and gn.ROUTES["autograd"] == 2
    # Nothing requires grad, grad mode on: the plain version.
    gn.group_norm_silu(norm, x, pair)
    assert dict(gn.ROUTES) == {"cpu": 2, "autograd": 2}
    assert gn.LAUNCHES["group_norm_silu"] == 0


def test_non_cuda_devices_never_fall_back():
    """A bf16 tensor off the CPU takes the kernel's route, whose wrapper
    refuses any device but CUDA; another dtype there takes the module."""
    norm = GroupNorm32(32).requires_grad_(False).to("meta")
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensor"):
            gn.group_norm_silu(norm, torch.empty((2, 32, 8), device="meta", dtype=torch.bfloat16))
        gn.reset_launch_counts()
        out = gn.group_norm_silu(norm, torch.empty((2, 32, 8), device="meta"))
    assert out.shape == (2, 32, 8) and dict(gn.ROUTES) == {"eager": 1}


def test_kernel_symbol_is_a_group_norm_kind():
    for resident in ("true", "false"):
        for vector in ("true", "false"):
            name = f"void {gn.KERNEL_NAME}<{resident}, {vector}>(mmdiff::gn::Args)"
            assert trace.kind_of(name) == "group norm", name
    for lanes in (8, 1):  # the channels-last mode's, without and with the input term
        for term in ("false", "true"):
            name = f"void {gn.CL_KERNEL_NAME}<{lanes}, {term}>(mmdiff::gn::RowArgs)"
            assert trace.kind_of(name) == "group norm", name
    assert trace.kind_of(f"void {gn.KERNEL_NAME}<true, true, true>(mmdiff::gn::Args)") == "group norm"
    assert "group norm" in trace.MEMORY_PASS_KINDS


def test_residual_kernel_symbol_is_an_elementwise_kind():
    """The residual pass counts where the adds it replaces counted: a
    memory pass of the benchmark's "elementwise" kind, on either path."""
    for name in (f"void {residual.KERNEL_NAME}(mmdiff::ew::ResidualArgs)",
                 f"void {residual.STRIDED_KERNEL_NAME}(mmdiff::ew::StridedArgs)"):
        assert trace.kind_of(name) == "elementwise", name
    assert "elementwise" in trace.MEMORY_PASS_KINDS


# ---------------------------------------------------------------------------
# The input term and the residual pass
# ---------------------------------------------------------------------------


def _term(kind, n, c, dtype=torch.float32, seed=15):
    """A conv's bias ([C]) or the bias with a time embedding added ([N, C])."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((c,) if kind == "channel" else (n, c), generator=g) * 0.7).to(dtype)


@pytest.mark.parametrize("layout", ["channels_first", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("film", [False, True], ids=["plain", "film"])
@pytest.mark.parametrize("kind", ["channel", "sample"])
def test_plain_version_takes_an_input_term(kind, film, dtype, layout):
    """``in_bias=t`` is the plain version of ``x + t`` taken in fp32: the
    same bits, in the input's layout."""
    x, norm, pair = _inputs((2, 64, 6, 10), film, dtype, seed=16)
    if layout == "channels_last":
        x = _rows(x)
    t = _term(kind, 2, 64)
    args = (norm.weight, norm.bias, norm.num_groups, norm.eps, pair)
    with torch.no_grad():
        out = gn.group_norm_silu_reference(x, *args, in_bias=t)
        shifted = x.float() + (t if kind == "sample" else t[None]).reshape(-1, 64, 1, 1)
        ref = gn.group_norm_silu_reference(shifted, *args).to(dtype)
    assert out.dtype == dtype and torch.equal(out, ref)
    assert gn.channels_last(out) == (layout == "channels_last")
    err, ok = (BF16_ONE_ROUNDING if dtype == torch.bfloat16 else Tolerance(1e-5, 1e-5)).check(
        out, _float64(shifted, norm, pair).float())
    assert ok, err


def test_input_term_on_the_module_routes():
    """The autograd route adds the term before the module's own norm: the
    plain route's values, and gradients that reach the term."""
    x, norm, pair = _inputs((2, 32, 5, 4), True, torch.float32, seed=17)
    t = _term("sample", 2, 32)
    gn.reset_launch_counts()
    with torch.no_grad():
        plain = gn.group_norm_silu(norm, x, pair, in_bias=t)
    tg = t.clone().requires_grad_(True)
    out = gn.group_norm_silu(norm, x, pair, in_bias=tg)
    assert dict(gn.ROUTES) == {"cpu": 1, "autograd": 1}
    np.testing.assert_allclose(out.detach().numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)
    out.square().sum().backward()
    assert tg.grad is not None and tg.grad.abs().sum() > 0


def test_term_rows_as_the_kernel_reads_them():
    """One row for every sample (stride 0) or one a sample; bf16 kept, other
    dtypes in fp32, strided rows made contiguous, other shapes refused."""
    x = torch.empty((3, 16, 4, 4))
    t, stride, is_bf16 = gn._term_rows(torch.zeros(16), x)
    assert stride == 0 and not is_bf16 and t.dtype == torch.float32
    t, stride, is_bf16 = gn._term_rows(torch.zeros((3, 32), dtype=torch.bfloat16)[:, :16], x)
    assert stride == 32 and is_bf16
    t, stride, _ = gn._term_rows(torch.zeros((16, 3)).t(), x)
    assert stride == 16 and t.is_contiguous()
    assert gn._term_rows(torch.zeros(16, dtype=torch.float64), x)[0].dtype == torch.float32
    assert gn._term_rows(None, x) == (None, 0, 0)
    for bad in (torch.zeros(8), torch.zeros((2, 16)), torch.zeros((3, 16, 1))):
        with pytest.raises(ValueError, match="input term"):
            gn._term_rows(bad, x)


@pytest.mark.parametrize("layout", ["channels_first", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_residual_plain_version(dtype, layout):
    """``skip + h + b`` in fp32, rounded once; the inputs' layout out."""
    g = torch.Generator().manual_seed(18)
    skip, h = (torch.randn((2, 24, 5, 7), generator=g).to(dtype) for _ in range(2))
    if layout == "channels_last":
        skip, h = _rows(skip), _rows(h)
    b = torch.randn(24, generator=g)
    out = residual.residual_bias_reference(skip, h, b)
    assert out.dtype == dtype and gn.channels_last(out) == (layout == "channels_last")
    exact = skip.float() + h.float() + b.reshape(1, 24, 1, 1)
    if dtype == torch.float32:
        assert torch.equal(out, exact)
    else:
        assert torch.equal(out, exact.to(dtype))
        err, ok = BF16_ONE_ROUNDING.check(out, skip.double() + h.double() + b.double().reshape(1, 24, 1, 1))
        assert ok, err


def test_residual_routes_follow_the_tensors():
    """The CPU takes the plain version; off the CPU bf16 CUDA tensors reach
    the kernel, in any layout, and anything else takes the unfolded adds
    (here the meta device, where the kernel's wrapper refuses)."""
    residual.reset_launch_counts()
    gn.reset_launch_counts()
    x = torch.randn((2, 16, 4, 4))
    residual.residual_bias(x, x.clone(), torch.zeros(16), torch.ones(16))
    meta = torch.empty((2, 16, 4, 4), device="meta", dtype=torch.bfloat16)
    out = residual.residual_bias(_rows(meta), _rows(meta), torch.zeros(16, device="meta"))
    assert out.shape == meta.shape and gn.channels_last(out)
    assert dict(residual.ROUTES) == {"cpu": 1, "eager": 1} and residual.LAUNCHES == {"residual_bias": 0}
    assert dict(gn.BIAS_FOLDS) == {"residual": 1, "skip": 1, "eager": 1}
    with pytest.raises(ValueError, match="bf16 CUDA"):
        residual.residual_bias_cuda(_rows(meta), _rows(meta), torch.zeros(16, device="meta"))


@pytest.mark.parametrize("skip_bias", [False, True], ids=["identity_skip", "conv_skip"])
def test_residual_autograd_route_adds_as_the_convs_did(skip_bias):
    """With autograd recording, the residual pass makes the convs' bias adds
    and the residual add, each in the activations' dtype: the bits of the
    convs run with their biases, and gradients that reach both biases."""
    g = torch.Generator().manual_seed(19)
    skip, h = (_rows(torch.randn((2, 16, 5, 3), generator=g)) for _ in range(2))
    b, bs = (torch.randn(16, generator=g).requires_grad_(True) for _ in range(2))
    residual.reset_launch_counts()
    out = residual.residual_bias(skip, h, b, bs if skip_bias else None)
    unfolded = (skip + bs.reshape(1, 16, 1, 1) if skip_bias else skip) + (h + b.reshape(1, 16, 1, 1))
    assert torch.equal(out, unfolded) and dict(residual.ROUTES) == {"autograd": 1}
    out.square().sum().backward()
    assert b.grad is not None and b.grad.abs().sum() > 0
    assert (bs.grad is not None) == skip_bias


def test_input_terms_in_turn_on_the_autograd_route():
    """A sequence of terms is added to ``x`` in turn in ``x``'s dtype on the
    autograd route (as the conv's bias add, then the time embedding's add),
    and as its fp32 sum, in one read, on the plain route."""
    x, norm, _ = _inputs((2, 32, 5, 4), False, torch.bfloat16, seed=20)
    b, e = _term("channel", 2, 32, seed=21), _term("sample", 2, 32, torch.bfloat16, seed=22)
    gn.reset_launch_counts()
    with torch.no_grad():
        plain = gn.group_norm_silu(norm, x, in_bias=(b, e))
        want = gn.group_norm_silu_reference(x, norm.weight, norm.bias, norm.num_groups, norm.eps,
                                            in_bias=b + e.float())
    assert torch.equal(plain, want)
    xg = x.clone().requires_grad_(True)
    out = gn.group_norm_silu(norm, xg, in_bias=(b, e))
    stepped = (x + b.bfloat16().reshape(1, 32, 1, 1)) + e.reshape(2, 32, 1, 1)
    assert torch.equal(out, F.silu(norm(stepped)))
    assert dict(gn.ROUTES) == {"cpu": 1, "autograd": 1} and dict(gn.BIAS_FOLDS) == {"norm": 1}


RESBLOCK_KINDS = {"same": _RB(32, 32), "conv_skip": _RB(32, 64), "down": _RB(32, 32, down=True),
                  "up": _RB(32, 32, up=True)}


def _resblock(kind, scale_shift, dtype, device="cpu"):
    """(an image U-Net ResBlock, x, emb), weights random, x channels-last."""
    cfg = ImageUNetConfig(use_scale_shift_norm=scale_shift, dtype=dtype)
    block = randomize_(ImageResBlock(RESBLOCK_KINDS[kind], cfg, 48), seed=23).to(device)
    g = torch.Generator().manual_seed(24)
    x = _rows(torch.randn((2, 32, 8, 8), generator=g)).to(device, cfg.compute_dtype)
    return block, x, torch.randn((2, 48), generator=g).to(device, cfg.compute_dtype)


def _modules_resblock(block, x, emb):
    """The ResBlock as its modules compose it, each conv adding its own bias."""
    if block.up or block.down:
        resample = image_upsample if block.up else image_downsample
        h = block.in_layers[2](resample(F.silu(block.in_layers[0](x))))
        x = resample(x)
    else:
        h = block.in_layers(x)
    emb_out = block.emb_layers(emb)
    if block.use_scale_shift_norm:
        h = F.silu(block.out_layers[0](h, film=tuple(emb_out.chunk(2, dim=-1))))
        h = block.out_layers[3](block.out_layers[2](h))
    else:
        h = block.out_layers(h + emb_out[:, :, None, None])
    return block.skip_connection(x) + h


@pytest.mark.parametrize("scale_shift", [True, False], ids=["film", "emb_add"])
@pytest.mark.parametrize("kind", list(RESBLOCK_KINDS))
def test_resblock_autograd_route_keeps_the_modules_bits(kind, scale_shift):
    """With autograd recording, the ResBlock's biases are added where its
    convs added them: fp32 on the CPU gives the modules' bits, and every
    parameter a gradient (the bias-free convs' biases included)."""
    block, x, emb = _resblock(kind, scale_shift, "float32")
    x.requires_grad_(True)  # as a training step's activations do
    gn.reset_launch_counts()
    out = block(x, emb)
    assert torch.equal(out, _modules_resblock(block, x, emb))
    assert dict(gn.BIAS_FOLDS) == {"eager": 1}
    out.square().sum().backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in (x, *block.parameters()))


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

IMAGE = dict(image_size=32, in_channels=6, model_channels=16, out_channels=6, num_res_blocks=1,
             attention_resolutions=(4,), channel_mult=(1, 2, 2), num_head_channels=16,
             use_scale_shift_norm=True, resblock_updown=True)
MM = dict(video_size=(2, 3, 16, 16), audio_size=(1, 256), model_channels=16, video_out_channels=3,
          audio_out_channels=1, num_res_blocks=1, cross_attention_resolutions=(2,),
          cross_attention_windows=(1,), video_attention_resolutions=(2,), audio_attention_resolutions=(-1,),
          channel_mult=(1, 2), num_heads=2, num_head_channels=-1, resblock_updown=True,
          use_scale_shift_norm=True)
SINGLE = dict(modality="audio", audio_size=(1, 256), model_channels=16, out_channels=1, num_res_blocks=1,
              attention_resolutions=(4,), channel_mult=(1, 2, 2), num_heads=2, resblock_updown=False,
              use_scale_shift_norm=False)


def _image(dtype):
    model = randomize_(ImageSuperResModel(ImageUNetConfig(**IMAGE, dtype=dtype)), seed=5).eval()
    g = torch.Generator().manual_seed(6)
    args = (torch.randn((2, 32, 32, 3), generator=g), torch.tensor([5, 900]),
            torch.randn((2, 8, 8, 3), generator=g))
    return model, args, ImageResBlock, 1  # the out head


def _mm(dtype):
    model = randomize_(MultimodalUNet(MMUNetConfig(**MM, dtype=dtype)), seed=7).eval()
    g = torch.Generator().manual_seed(8)
    args = (torch.randn((2, 2, 16, 16, 3), generator=g), torch.randn((2, 256, 1), generator=g),
            torch.tensor([3, 700]))
    return model, args, MMResBlock, 2


def _single(dtype):
    model = randomize_(SingleModalUNet(SingleUNetConfig(**SINGLE, dtype=dtype)), seed=9).eval()
    g = torch.Generator().manual_seed(10)
    return model, (torch.randn((2, 256, 1), generator=g), torch.tensor([4, 600])), SingleResBlock, 1


MODELS = {"image": _image, "mm": _mm, "single": _single}


def _outputs(model, args):
    out = model(*args)
    return [o.detach() for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("name", list(MODELS))
def test_models_keep_their_tree_and_outputs(name):
    model, args, block_type, heads = MODELS[name]("float32")
    blocks = [m for m in model.modules() if isinstance(m, block_type)]
    norm_silu_sites = 0
    for block in blocks:
        seqs = [s for n, s in block.named_children() if n.endswith("in_layers") or n.endswith("out_layers")]
        for seq in seqs:
            assert isinstance(seq[0], (GroupNorm32, MMNorm)) and isinstance(seq[1], nn.SiLU)
            assert not list(seq[1].parameters())
        norm_silu_sites += len(seqs)
    sd = model.state_dict()
    assert not [k for k in sd if "in_layers.1." in k or "out_layers.1." in k]  # the SiLU keeps index 1
    assert any("in_layers.2." in k for k in sd) and any("out_layers.3." in k for k in sd)

    # The image U-Net's ResBlocks fold their conv biases on the plain route:
    # the same fp32 sums in another order, held within rel 1e-5 (the fold's
    # contract; tests/test_torch_port_image_unet.py).  Each block's output
    # on the modules' route is checked against the plain route's, then
    # replaced by it, so everything around the blocks stays bit for bit.
    folding = [b for b in blocks if name == "image"]
    block_outs = []
    hooks = [b.register_forward_hook(lambda m, i, o: block_outs.append(o)) for b in folding]
    gn.reset_launch_counts()
    with torch.no_grad():
        plain = _outputs(model, args)
    for hook in hooks:
        hook.remove()
    assert dict(gn.ROUTES) == {"cpu": norm_silu_sites + heads}
    plain_block_outs = iter(block_outs)

    def plain_block_out(module, inputs, out):
        ref = next(plain_block_outs)
        assert float((out.detach() - ref).norm() / ref.norm()) <= 1e-5
        return ref

    hooks = [b.register_forward_hook(plain_block_out) for b in folding]
    modules = _outputs(model, args)  # grad mode, parameters require grad: the modules' own code
    for hook in hooks:
        hook.remove()
    assert next(plain_block_outs, None) is None and len(block_outs) == len(folding)
    assert gn.ROUTES["autograd"] == norm_silu_sites + heads
    for a, b in zip(plain, modules):
        assert torch.equal(a, b)

    # bf16: the plain route rounds once where the modules round twice, so
    # it lies no farther from the fp32 outputs (readings: 0.91-0.98 of the
    # modules' distance; the random tiny models amplify rounding, up to 0.4).
    model16, args16, _, _ = MODELS[name]("bfloat16")
    with torch.no_grad():
        plain16 = _outputs(model16, args16)
    modules16 = _outputs(model16, args16)
    for a, b, ref in zip(plain16, modules16, plain):
        assert torch.isfinite(a).all()
        assert (a - ref).norm() <= 1.25 * (b - ref).norm()


# ---------------------------------------------------------------------------
# The layouts
# ---------------------------------------------------------------------------


def _rows(x):
    """``x [N, C, *S]`` with the same values in ``[N, *S, C]`` memory
    (``torch.channels_last`` strides for 4-d)."""
    return x.movedim(1, -1).contiguous().movedim(-1, 1)


def test_channels_last_is_read_from_the_strides():
    """4-d channels-last strides only: the MM-UNet's 3-d audio and 5-d video,
    which it holds channels-first, never take the channels-last mode, even
    where an add leaves them in ``[N, *S, C]`` memory."""
    x = torch.empty((2, 16, 4, 6))
    assert not gn.channels_last(x)
    assert gn.channels_last(x.contiguous(memory_format=torch.channels_last))
    assert not gn.channels_last(_rows(torch.empty((2, 16, 3, 4, 5))))
    assert not gn.channels_last(torch.empty((2, 9, 16)).transpose(1, 2))
    assert not gn.channels_last(x[:, :, ::2])  # neither layout
    assert not gn.channels_last(torch.empty((2, 16, 1, 1)).contiguous(memory_format=torch.channels_last))


def test_routes_follow_the_layout():
    """On bf16 tensors off the CPU the layout picks the kernel's mode: the
    channels-last route for channels-last strides only (here the meta
    device, where the wrapper then refuses to launch)."""
    norm = GroupNorm32(32).requires_grad_(False).to("meta")
    x = torch.empty((2, 32, 8, 8), device="meta", dtype=torch.bfloat16)
    cases = [(x, "fused"), (x.contiguous(memory_format=torch.channels_last), "fused_cl"),
             (torch.empty((2, 8, 32), device="meta", dtype=torch.bfloat16).transpose(1, 2), "fused"),
             (x[:, :, ::2], "fused")]
    with torch.no_grad():
        for t, route in cases:
            gn.reset_launch_counts()
            with pytest.raises(ValueError, match="CUDA tensor"):
                gn.group_norm_silu(norm, t)
            assert dict(gn.ROUTES) == {route: 1}, (t.stride(), dict(gn.ROUTES))
        gn.reset_launch_counts()
        for t in (x.float(), x.float().contiguous(memory_format=torch.channels_last)):
            gn.group_norm_silu(norm, t)
    assert dict(gn.ROUTES) == {"eager": 2} and not any(gn.LAUNCHES.values())
    # On the CPU both layouts take the plain version.
    cpu_norm = GroupNorm32(32).requires_grad_(False)
    with torch.no_grad():
        gn.group_norm_silu(cpu_norm, _rows(torch.randn((2, 32, 4, 4), dtype=torch.bfloat16)))
    assert dict(gn.ROUTES) == {"eager": 2, "cpu": 1}


CL_CPU_CASES = [((2, 64, 6, 10), 32), ((2, 40, 5, 5), 8), ((3, 24, 1, 9), 8), ((2, 6, 4, 5), 2)]


@pytest.mark.parametrize("film", [False, True], ids=["plain", "film"])
@pytest.mark.parametrize("shape,groups", CL_CPU_CASES, ids=[str(s) for s, _ in CL_CPU_CASES])
def test_plain_version_keeps_channels_last(shape, groups, film):
    """The plain route on a channels-last input: the input's layout out, and
    the values of the float64 arithmetic within one bf16 rounding."""
    x, norm, pair = _inputs(shape, film, torch.bfloat16, seed=11)
    x = _rows(x)
    with torch.no_grad():
        out = gn.group_norm_silu(norm, x, pair)
    assert gn.channels_last(out) and out.shape == x.shape
    err, ok = BF16_ONE_ROUNDING.check(out, _float64(x, norm, pair).float())
    assert ok, err


def test_autograd_route_takes_channels_last():
    """GroupNorm32 + SiLU on a channels-last input under autograd: the
    values and the gradients of the channels-first input."""
    x, norm, pair = _inputs((2, 32, 6, 5), True, torch.float32, seed=12)
    pair = tuple(p.requires_grad_(True) for p in pair)
    grads = []
    for t in (x, _rows(x)):
        t = t.clone().requires_grad_(True)
        norm.zero_grad()
        out = gn.group_norm_silu(norm, t, pair)
        (out * torch.arange(out.numel()).reshape(out.shape).float().sin()).sum().backward()
        grads.append((out.detach().contiguous(), t.grad.contiguous(), norm.weight.grad.clone()))
    assert gn.ROUTES["autograd"] >= 2
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["channels_first", "channels_last"])
def test_image_upsample_equals_repeat_interleave(dtype, layout):
    x = torch.randn((2, 12, 5, 7)).to(dtype)
    if layout == "channels_last":
        x = _rows(x)
    up = image_upsample(x)
    assert torch.equal(up, x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))
    assert gn.channels_last(up) == (layout == "channels_last")


TINY_SDXL = dict(adm_in_channels=40, num_classes="sequential", in_channels=4, out_channels=4, model_channels=32,
                 attention_resolutions="4,2", num_res_blocks=2, channel_mult="1,2,4", num_head_channels=8,
                 use_linear_in_transformer=True, transformer_depth="1,2,3", context_dim=24, image_size=16,
                 use_fp16=False)


def _sdxl(dtype):
    model = randomize_(ImageUNet(configs.create_text2img_config(**dict(TINY_SDXL, use_fp16=dtype == "bfloat16"))),
                       seed=13).eval()
    g = torch.Generator().manual_seed(14)
    args = (torch.randn((2, 16, 16, 4), generator=g), torch.tensor([999, 431]))
    kwargs = dict(context=torch.randn((2, 7, 24), generator=g), y=torch.randn((2, 40), generator=g))
    return model, args, kwargs


LAYOUT_MODELS = {
    "sr": lambda dtype: (*_image(dtype)[:2], {}),
    "sdxl": _sdxl,
    "mm": lambda dtype: (*_mm(dtype)[:2], {}),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYOUT_MODELS))
def test_blocks_see_their_models_layout(name, dtype):
    """Forward hooks: every ResBlock, attention block and SpatialTransformer
    of the image U-Net (SR and SDXL-shaped) takes and returns channels-last
    tensors; the MM-UNet's ResBlocks keep channels-first."""
    model, args, kwargs = LAYOUT_MODELS[name](dtype)
    image = name != "mm"
    kinds = (ImageResBlock, ImageAttention, SpatialTransformer) if image else (MMResBlock,)
    seen = []

    def hook(mod, inputs, output):
        for t in (*inputs, *(output if isinstance(output, tuple) else (output,))):
            if isinstance(t, torch.Tensor) and t.dim() >= 4:
                seen.append((type(mod).__name__, gn.channels_last(t), t.is_contiguous()))

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, kinds)]
    try:
        with torch.no_grad():
            outs = _outputs(model, args) if not kwargs else [model(*args, **kwargs)]
    finally:
        for h in handles:
            h.remove()
    assert len(seen) >= 2 * len(handles) > 0
    if image:
        assert all(cl for _, cl, _ in seen), [s for s in seen if not s[1]]
        assert {n for n, _, _ in seen} >= {"ImageResBlock", "SpatialTransformer" if name == "sdxl" else "ImageAttention"}
    else:
        assert all(contig for _, _, contig in seen), [s for s in seen if not s[2]]
    assert all(torch.isfinite(o).all() and (o.is_contiguous() or not image) for o in outs)


def _resblocks(cfg):
    """(ResBlock spec, side of its input, side of its output) of every
    ResBlock of the image U-Net ``cfg``, in order, and the side at the end."""
    encoder, middle, decoder, _ = build_image_plan(cfg)
    blocks, side = [], cfg.image_size
    for spec in (s for specs in (*encoder, middle, *decoder) for s in specs):
        if spec in ("initial", "downsample", "upsample"):
            side = {"initial": side, "downsample": side // 2, "upsample": side * 2}[spec]
            continue
        out = side * 2 if spec.up else side // 2 if spec.down else side
        blocks.append((spec, side, out))
        side = out
    return blocks, side


def image_norm_sites(cfg, n):
    """The fused norms of one evaluation of the image U-Net ``cfg`` at batch
    ``n``, walked from its plan: {(shape, groups, FiLM dtype, silu, eps)}.
    Each ResBlock's input norm (no FiLM), its output norm (FiLM with
    ``use_scale_shift_norm``, in the compute dtype), each SpatialTransformer's
    (no SiLU, eps 1e-6), the out head's."""
    film = cfg.dtype if cfg.use_scale_shift_norm else None
    sites = set()

    def add(ch, side, film=None, silu=True, eps=1e-5):
        sites.add(((n, ch, side, side), GroupNorm32(ch).num_groups, film, silu, eps))

    blocks, side = _resblocks(cfg)
    for spec, side_in, side_out in blocks:
        add(spec.in_ch, side_in)
        add(spec.out_ch, side_out, film)
        if spec.attn_heads and cfg.context_dim is not None:
            add(spec.out_ch, side_out, silu=False, eps=1e-6)
    add(build_image_plan(cfg)[3], side)
    return sites


@pytest.mark.parametrize("name", ["sr", "sdxl"])
def test_norm_sites_walked_from_the_plan(name, monkeypatch):
    """``image_norm_sites`` (the card tests' shapes) names every norm that
    one CPU evaluation of a tiny model of each kind calls, each channels-last."""
    model, args, kwargs = LAYOUT_MODELS[name]("bfloat16")
    calls = set()
    real = gn.group_norm_silu_reference

    def recording(x, weight, bias, groups, eps=1e-5, film=None, silu=True, in_bias=None):
        assert gn.channels_last(x)
        calls.add((tuple(x.shape), groups, None if film is None else str(film[0].dtype).split(".")[-1], silu, eps))
        return real(x, weight, bias, groups, eps, film, silu, in_bias)

    monkeypatch.setattr(gn, "group_norm_silu_reference", recording)
    with torch.no_grad():
        model(*args, **kwargs)
    assert calls == image_norm_sites(model.cfg, 2)


def image_residual_sites(cfg, n):
    """The residual passes of one evaluation of the image U-Net ``cfg`` at
    batch ``n``, walked from its plan: {ResBlock output shape}."""
    return {(n, spec.out_ch, side, side) for spec, _, side in _resblocks(cfg)[0]}


@pytest.mark.parametrize("name", ["sr", "sdxl"])
def test_residual_sites_walked_from_the_plan(name, monkeypatch):
    """``image_residual_sites`` (the card tests' shapes) names every
    residual pass of one CPU evaluation, each on channels-last tensors, with
    the bias of the second conv (plus the skip conv's)."""
    model, args, kwargs = LAYOUT_MODELS[name]("bfloat16")
    calls = set()
    real = residual.residual_bias_reference

    def recording(skip, h, bias):
        assert gn.channels_last(skip) and gn.channels_last(h) and bias.shape == (h.shape[1],)
        calls.add(tuple(h.shape))
        return real(skip, h, bias)

    monkeypatch.setattr(residual, "residual_bias_reference", recording)
    with torch.no_grad():
        model(*args, **kwargs)
    assert calls == image_residual_sites(model.cfg, 2)


# ---------------------------------------------------------------------------
# The kernel (needs a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (shape, film dtype or None): the vector path (S % 8 == 0) and the
# element path (odd S), FiLM in bf16 (the models') and fp32, a slab over
# several blocks of a cluster, narrow widths, a slab past the resident mode.
KERNEL_CASES = [
    ((2, 64, 7), None),
    ((2, 64, 7), torch.float32),
    ((3, 24, 9, 5), torch.bfloat16),
    ((2, 96, 16, 16), torch.bfloat16),
    ((1, 384, 128, 128), torch.bfloat16),
    ((2, 128, 4, 32, 32), None),
    ((2, 256, 6400), torch.bfloat16),
    ((1, 384, 256, 256), torch.bfloat16),  # a 1.5 MB slab: the two-read mode on its own
]


@pytest.mark.cuda
@pytest.mark.parametrize("two_read", [False, True], ids=["resident", "two_read"])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,film", KERNEL_CASES, ids=[str(s) for s, _ in KERNEL_CASES])
def test_kernel_against_plain_version(cuda, shape, film, silu, two_read):
    x, norm, _ = _inputs(shape, False, torch.bfloat16)
    x, norm = x.to(cuda), norm.to(cuda)
    pair = None
    if film is not None:
        emb = (torch.randn((shape[0], 2 * shape[1]), device=cuda) * 0.3).to(film)
        pair = tuple(emb.chunk(2, dim=-1))  # strided rows, as the models pass them
    args = (x, norm.weight, norm.bias, norm.num_groups, norm.eps, pair, silu)
    kernel = gn._group_norm_silu_two_read_cuda(*args) if two_read else gn.group_norm_silu_cuda(*args)
    torch.cuda.synchronize()
    err, ok = gn.GN_TOL.check(kernel, gn.group_norm_silu_reference(*args))
    assert ok, err
    assert kernel.dtype == torch.bfloat16 and math.isfinite(err)


# The channels-last mode at every norm of one evaluation of the benchmark's
# image U-Nets (chip_smoke.py 13.1's sites): the SR U-Net of the sampling
# CLI's flagship flags on one clip's 16 frames at 256^2, SDXL base's at 8
# rows of 128^2 latents.
def _card_sites():
    from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr as cli

    args = cli.create_argparser().parse_args(cli.LAUNCH_SCRIPT_ARGS)
    sr = configs.create_image_sr_config(**vars(args))
    sdxl = configs.create_text2img_config(**configs.sdxl_base_flags())
    return ([("sr",) + site for site in sorted(image_norm_sites(sr, 16), key=str)]
            + [("sdxl",) + site for site in sorted(image_norm_sites(sdxl, 8), key=str)])


CARD_SITES = _card_sites()


def _card_inputs(cuda, shape, groups, film, eps, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    n, c = shape[:2]
    x = _rows((torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).bfloat16())
    norm = GroupNorm32(c, num_groups=groups, eps=eps).to(cuda).requires_grad_(False)
    assert norm.num_groups == groups
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(c, generator=g, device=cuda))
        norm.bias.copy_(0.1 * torch.randn(c, generator=g, device=cuda))
    pair = None
    if film is not None:
        emb = (0.3 * torch.randn((n, 2 * c), generator=g, device=cuda)).to(getattr(torch, str(film).split(".")[-1]))
        pair = tuple(emb.chunk(2, dim=-1))  # strided rows, as the models pass them
    return x, norm, pair


def _check_channels_last(x, norm, pair, silu):
    args = (x, norm.weight, norm.bias, norm.num_groups, norm.eps, pair, silu)
    before = dict(gn.LAUNCHES)
    out = gn.group_norm_silu_cuda(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == x.shape and gn.channels_last(out)
    err, ok = gn.GN_TOL.check(out, gn.group_norm_silu_reference(*args))
    assert ok and math.isfinite(err), err
    counted = {k: gn.LAUNCHES[k] - before[k] for k in gn.LAUNCHES}
    assert counted == {"group_norm_silu": 0, "group_norm_silu_cl": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("model,shape,groups,film,silu,eps", CARD_SITES, ids=[str(s) for s in CARD_SITES])
def test_channels_last_kernel_at_model_sites(cuda, model, shape, groups, film, silu, eps):
    x, norm, pair = _card_inputs(cuda, shape, groups, film, eps, seed=21)
    _check_channels_last(x, norm, pair, silu)


# (shape, groups, film dtype): group widths of 6, 18 and 40 channels (the SR
# U-Net's 192 and 576, SDXL's 1280), 12 (384) with FiLM in fp32, C % 8 != 0
# (element loads), samples of one cluster block and of many, a sample of
# one row, odd H and W.
CL_CASES = [
    ((16, 192, 32, 32), 32, torch.bfloat16),
    ((2, 576, 16, 16), 32, torch.float32),
    ((3, 1280, 8, 8), 32, None),
    ((2, 384, 64, 64), 32, torch.bfloat16),
    ((2, 20, 9, 7), 4, torch.float32),
    ((3, 36, 40, 40), 6, None),
    ((4, 40, 1, 1), 8, torch.bfloat16),
    ((2, 64, 3, 101), 32, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,groups,film", CL_CASES, ids=[str(s) for s, _, _ in CL_CASES])
def test_channels_last_kernel_cases(cuda, shape, groups, film, silu):
    x, norm, pair = _card_inputs(cuda, shape, groups, film, 1e-5, seed=22)
    if shape[2:] == (1, 1):  # one row a sample: channels-last and contiguous at once, the channels-first mode
        x = x.contiguous()
        out = gn.group_norm_silu_cuda(x, norm.weight, norm.bias, groups, norm.eps, pair, silu)
        err, ok = gn.GN_TOL.check(out, gn.group_norm_silu_reference(x, norm.weight, norm.bias, groups, norm.eps,
                                                                     pair, silu))
        assert ok, err
        return
    _check_channels_last(x, norm, pair, silu)


@pytest.mark.cuda
def test_channels_first_mode_keeps_its_bytes_at_the_b8_shapes(cuda):
    """The base MM-UNet's norms at batch 8 (video 128-512 channels at 16 x
    64^2 down to 8^2, audio at 25,600 down to 400) stay on the channels-first
    mode: counted there, the same bytes on every launch, within GN_TOL; a
    copy in [N, *S, C] memory (not 4-d channels-last) takes it too."""
    for shape in ((8, 128, 16, 64, 64), (8, 384, 16, 32, 32), (8, 512, 16, 8, 8), (8, 256, 6400)):
        x, norm, pair = _card_inputs(cuda, shape, 32, torch.bfloat16, 1e-5, seed=23)
        x = x.contiguous()
        args = (x, norm.weight, norm.bias, 32, norm.eps, pair, True)
        gn.reset_launch_counts()
        first = gn.group_norm_silu_cuda(*args)
        again = gn.group_norm_silu_cuda(*args)
        assert gn.LAUNCHES == {"group_norm_silu": 2, "group_norm_silu_cl": 0}
        assert first.is_contiguous() and torch.equal(first, again)
        plain = gn.group_norm_silu_reference(*args)
        err, ok = gn.GN_TOL.check(first, plain)
        assert ok, err
        rows = gn.group_norm_silu_cuda(_rows(x), *args[1:])
        err, ok = gn.GN_TOL.check(rows, plain)
        assert ok and gn.LAUNCHES == {"group_norm_silu": 3, "group_norm_silu_cl": 0}, err


# The channels-first mode's bf16 output at four of the base MM-UNet's batch-8
# norm shapes, FiLM in bf16 or none, SiLU on, from _b8_inputs: the first 16
# hex digits of the sha256 of its bytes, as the kernel gave them on an H100
# before the channels-last mode was added.  The kernel's order of sums is
# fixed, so its bytes are too.
CF_B8_DIGESTS = {
    ((8, 128, 16, 64, 64), True): "3a6d5d3b9706de06",
    ((8, 128, 16, 64, 64), False): "338c768a56eec966",
    ((8, 384, 16, 32, 32), True): "6e281536c0624edf",
    ((8, 384, 16, 32, 32), False): "2bf6f6c2ea4e4f7d",
    ((8, 512, 16, 8, 8), True): "4abed3d0f4f137a8",
    ((8, 512, 16, 8, 8), False): "ec566272c322741e",
    ((8, 256, 6400), True): "72ba5e60f211bdf7",
    ((8, 256, 6400), False): "1cdcf175696ea04b",
}


def _b8_inputs(shape, film, device):
    g = torch.Generator().manual_seed(23)
    n, c = shape[:2]
    x = (torch.randn(shape, generator=g) * 2 + 0.5).bfloat16().to(device)
    weight = (1 + 0.1 * torch.randn(c, generator=g)).to(device)
    bias = (0.1 * torch.randn(c, generator=g)).to(device)
    pair = None
    if film:
        emb = (0.3 * torch.randn((n, 2 * c), generator=g)).bfloat16().to(device)
        pair = tuple(emb.chunk(2, dim=-1))  # strided rows, as the models pass them
    return x, weight, bias, pair


@pytest.mark.cuda
@pytest.mark.parametrize("shape,film", sorted(CF_B8_DIGESTS, key=str), ids=str)
def test_channels_first_mode_gives_the_pinned_bytes(cuda, shape, film):
    x, weight, bias, pair = _b8_inputs(shape, film, cuda)
    out = gn.group_norm_silu_cuda(x, weight, bias, 32, 1e-5, pair, True)
    digest = hashlib.sha256(out.cpu().view(torch.int16).numpy().tobytes()).hexdigest()[:16]
    assert digest == CF_B8_DIGESTS[(shape, film)]


# ---------------------------------------------------------------------------
# The input term and the residual pass on the card
# ---------------------------------------------------------------------------


def _card_term(cuda, shape, film, seed):
    """The term the image U-Net passes at a norm site: the first conv's bias
    [C] where the site takes FiLM (use_scale_shift_norm), else the bias with
    the time embedding added, [N, C]; fp32 as the ResBlock makes both."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n, c = shape[:2]
    return 0.5 * torch.randn((c,) if film is not None else (n, c), generator=g, device=cuda)


def _check_term(x, norm, pair, silu, t, two_read=False):
    args = (x, norm.weight, norm.bias, norm.num_groups, norm.eps, pair, silu)
    out = (gn._group_norm_silu_two_read_cuda if two_read else gn.group_norm_silu_cuda)(*args, in_bias=t)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == x.shape and gn.channels_last(out) == gn.channels_last(x)
    err, ok = gn.GN_TOL.check(out, gn.group_norm_silu_reference(*args, in_bias=t))
    assert ok and math.isfinite(err), err


@pytest.mark.cuda
@pytest.mark.parametrize("model,shape,groups,film,silu,eps", CARD_SITES, ids=[str(s) for s in CARD_SITES])
def test_input_term_at_model_sites(cuda, model, shape, groups, film, silu, eps):
    """The channels-last mode with the input term at every norm shape of one
    SR and one SDXL evaluation (the term the site's ResBlock would pass)."""
    x, norm, pair = _card_inputs(cuda, shape, groups, film, eps, seed=24)
    _check_term(x, norm, pair, silu, _card_term(cuda, shape, film, seed=25))


@pytest.mark.cuda
@pytest.mark.parametrize("two_read", [False, True], ids=["resident", "two_read"])
@pytest.mark.parametrize("term", ["channel_fp32", "sample_bf16"])
@pytest.mark.parametrize("shape,film", KERNEL_CASES, ids=[str(s) for s, _ in KERNEL_CASES])
def test_input_term_channels_first(cuda, shape, film, term, two_read):
    """The channels-first mode with the input term: a [C] fp32 row or [N, C]
    bf16 rows, on the vector and element paths, resident and two reads."""
    x, norm, _ = _inputs(shape, False, torch.bfloat16)
    x, norm = x.to(cuda), norm.to(cuda)
    pair = None
    if film is not None:
        pair = tuple((torch.randn((shape[0], 2 * shape[1]), device=cuda) * 0.3).to(film).chunk(2, dim=-1))
    kind, dtype = term.split("_")
    t = _term(kind, shape[0], shape[1], getattr(torch, {"fp32": "float32", "bf16": "bfloat16"}[dtype])).to(cuda)
    _check_term(x, norm, pair, True, t, two_read)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout", [((16, 192, 256, 256), "cl"), ((8, 640, 64, 64), "cl"),
                                          ((8, 128, 16, 64, 64), "cf"), ((2, 64, 7), "cf")], ids=str)
def test_zero_term_gives_the_same_bytes(cuda, shape, layout):
    """An all-zero term adds nothing: the kernel's bytes without a term."""
    x, norm, pair = _card_inputs(cuda, shape, 32, torch.bfloat16, 1e-5, seed=26)
    if layout == "cf":
        x = x.contiguous()
    args = (x, norm.weight, norm.bias, 32, norm.eps, pair, True)
    gn.reset_launch_counts()
    bare = gn.group_norm_silu_cuda(*args)
    for zero in (torch.zeros(shape[1], device=cuda), torch.zeros(shape[:2], device=cuda, dtype=torch.bfloat16)):
        assert torch.equal(gn.group_norm_silu_cuda(*args, in_bias=zero), bare)
    assert sum(gn.LAUNCHES.values()) == 3


def _residual_card_sites():
    from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr as cli

    args = cli.create_argparser().parse_args(cli.LAUNCH_SCRIPT_ARGS)
    sr = configs.create_image_sr_config(**vars(args))
    sdxl = configs.create_text2img_config(**configs.sdxl_base_flags())
    return sorted(image_residual_sites(sr, 16)) + sorted(image_residual_sites(sdxl, 8))


def _residual_inputs(cuda, shape, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    skip, h = (_rows(torch.randn(shape, generator=g, device=cuda).bfloat16()) for _ in range(2))
    return skip, h, 0.1 * torch.randn(shape[1], generator=g, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _residual_card_sites(), ids=str)
def test_residual_kernel_at_model_sites(cuda, shape):
    """The residual pass at every ResBlock output of one SR and one SDXL
    evaluation: the plain version's bits (the same fp32 adds, one rounding),
    written into ``h``, counted."""
    skip, h, b = _residual_inputs(cuda, shape, seed=27)
    plain = residual.residual_bias_reference(skip, h, b)
    residual.reset_launch_counts()
    out = residual.residual_bias(skip, h, b)
    torch.cuda.synchronize()
    assert out.data_ptr() == h.data_ptr() and gn.channels_last(out)
    assert torch.equal(out, plain)
    assert dict(residual.ROUTES) == {"kernel": 1} and residual.LAUNCHES == {"residual_bias": 1}


@pytest.mark.cuda
def test_residual_kernel_bandwidth(cuda):
    """At the SR U-Net's largest residual (16 frames of 256^2 x 192) the pass
    moves its 6 bytes an element at 80% or more of the H100's 3.35 TB/s."""
    from mm_diffusion_tpu_torch.utils.timing import device_ms

    skip, h, b = _residual_inputs(cuda, (16, 192, 256, 256), seed=28)
    ms = device_ms(lambda: residual.residual_bias_cuda(skip, h, b))
    rate = 6 * h.numel() / (ms * 1e-3)
    assert rate >= 0.8 * 3.35e12, f"{ms:.4f} ms, {rate / 1e12:.3f} TB/s"


@pytest.mark.cuda
@pytest.mark.parametrize("scale_shift", [True, False], ids=["film", "emb_add"])
@pytest.mark.parametrize("kind", list(RESBLOCK_KINDS))
def test_resblock_autograd_route_keeps_the_modules_bits_on_the_card(cuda, kind, scale_shift):
    """bf16 on the card, autograd recording: cuDNN's conv adds its bias in a
    pass of its own, so adding it there instead gives the modules' bits."""
    block, x, emb = _resblock(kind, scale_shift, "bfloat16", cuda)
    out = block(x, emb)
    torch.cuda.synchronize()
    assert torch.equal(out, _modules_resblock(block, x, emb))


def _offset_rows(x):
    """``_rows(x)`` in storage that starts one element past an allocation."""
    n, c, h, w = x.shape
    rows = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    return rows.copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout", [((2, 12, 9, 7), "cl"), ((2, 8200, 2, 3), "cl"), ((2, 64, 5, 6), "cf"),
                                          ((3, 24, 11), "cf"), ((2, 64, 6, 6), "offset")], ids=str)
def test_residual_kernel_strided_path(cuda, shape, layout):
    """The kernel's strided path: C % 8 != 0, C > 8192, channels-first
    memory, and views that start off a 16-byte boundary all take the
    kernel, with the plain version's bits, in ``h``'s layout."""
    g = torch.Generator(device=cuda).manual_seed(29)
    skip, h = (torch.randn(shape, generator=g, device=cuda).bfloat16() for _ in range(2))
    if layout == "cl":
        skip, h = _rows(skip), _rows(h)
    elif layout == "offset":  # channels-last views one bf16 element into their storage
        skip, h = (_offset_rows(t) for t in (skip, h))
        assert h.data_ptr() % 16 and skip.data_ptr() % 16 and gn.channels_last(h)
    b = 0.1 * torch.randn(shape[1], generator=g, device=cuda)
    plain = residual.residual_bias_reference(skip, h, b)
    residual.reset_launch_counts()
    out = residual.residual_bias(skip, h, b)
    torch.cuda.synchronize()
    assert torch.equal(out, plain) and gn.channels_last(out) == gn.channels_last(h)
    assert dict(residual.ROUTES) == {"kernel": 1} and residual.LAUNCHES == {"residual_bias": 1}
