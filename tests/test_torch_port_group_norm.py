"""GroupNorm + FiLM + SiLU as one pass (mm_diffusion_tpu_torch/ops/group_norm.py).

On the CPU: the plain version against float64 arithmetic written out here,
and against ``GroupNorm32`` then ``SiLU`` as the models composed them
before (bit for bit in fp32, one bf16 step in bf16); the routes that the
tensors select and their counter; the three U-Nets' module trees,
``state_dict`` keys and CPU outputs on the plain route against the
autograd route (the modules' own code); the kernel's symbol in the
benchmark's "group norm" kind; the image U-Net's channels-last layout (its
blocks' inputs and outputs, the nearest upsample, the routes that the
layout selects, the norm sites of one evaluation).  The kernel itself, in
both layouts, against the plain version in the ``cuda`` tests, which skip
without a card."""

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
    build_image_plan,
)
from mm_diffusion_tpu_torch.models.layers import GroupNorm32, MMNorm, image_upsample
from mm_diffusion_tpu_torch.models.transformer import SpatialTransformer
from mm_diffusion_tpu_torch.models.mm_unet import MMResBlock, MMUNetConfig, MultimodalUNet
from mm_diffusion_tpu_torch.models.single_unet import SingleModalUNet, SingleResBlock, SingleUNetConfig
from mm_diffusion_tpu_torch.ops import group_norm as gn
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
    for name in (f"void {gn.CL_KERNEL_NAME}<8>(mmdiff::gn::RowArgs)",  # the channels-last mode's
                 f"void {gn.CL_KERNEL_NAME}<1>(mmdiff::gn::RowArgs)"):
        assert trace.kind_of(name) == "group norm", name
    assert "group norm" in trace.MEMORY_PASS_KINDS


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

    gn.reset_launch_counts()
    with torch.no_grad():
        plain = _outputs(model, args)
    assert dict(gn.ROUTES) == {"cpu": norm_silu_sites + heads}
    modules = _outputs(model, args)  # grad mode, parameters require grad: the modules' own code
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


def image_norm_sites(cfg, n):
    """The fused norms of one evaluation of the image U-Net ``cfg`` at batch
    ``n``, walked from its plan: {(shape, groups, FiLM dtype, silu, eps)}.
    Each ResBlock's input norm (no FiLM), its output norm (FiLM with
    ``use_scale_shift_norm``, in the compute dtype), each SpatialTransformer's
    (no SiLU, eps 1e-6), the out head's."""
    encoder, middle, decoder, out_ch = build_image_plan(cfg)
    film = cfg.dtype if cfg.use_scale_shift_norm else None
    sites = set()

    def add(ch, side, film=None, silu=True, eps=1e-5):
        sites.add(((n, ch, side, side), GroupNorm32(ch).num_groups, film, silu, eps))

    def walk(specs, side):
        for spec in specs:
            if spec in ("initial", "downsample", "upsample"):
                side = {"initial": side, "downsample": side // 2, "upsample": side * 2}[spec]
                continue
            add(spec.in_ch, side)
            side = side * 2 if spec.up else side // 2 if spec.down else side
            add(spec.out_ch, side, film)
            if spec.attn_heads and cfg.context_dim is not None:
                add(spec.out_ch, side, silu=False, eps=1e-6)
        return side

    side = cfg.image_size
    for specs in encoder:
        side = walk(specs, side)
    side = walk(middle, side)
    for specs in decoder:
        side = walk(specs, side)
    add(out_ch, side)
    return sites


@pytest.mark.parametrize("name", ["sr", "sdxl"])
def test_norm_sites_walked_from_the_plan(name, monkeypatch):
    """``image_norm_sites`` (the card tests' shapes) names every norm that
    one CPU evaluation of a tiny model of each kind calls, each channels-last."""
    model, args, kwargs = LAYOUT_MODELS[name]("bfloat16")
    calls = set()
    real = gn.group_norm_silu_reference

    def recording(x, weight, bias, groups, eps=1e-5, film=None, silu=True):
        assert gn.channels_last(x)
        calls.add((tuple(x.shape), groups, None if film is None else str(film[0].dtype).split(".")[-1], silu, eps))
        return real(x, weight, bias, groups, eps, film, silu)

    monkeypatch.setattr(gn, "group_norm_silu_reference", recording)
    with torch.no_grad():
        model(*args, **kwargs)
    assert calls == image_norm_sites(model.cfg, 2)


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
