"""GroupNorm + FiLM + SiLU as one pass (mm_diffusion_tpu_torch/ops/group_norm.py).

On the CPU: the plain version against float64 arithmetic written out here,
and against ``GroupNorm32`` then ``SiLU`` as the models composed them
before (bit for bit in fp32, one bf16 step in bf16); the routes that the
tensors select and their counter; the three U-Nets' module trees,
``state_dict`` keys and CPU outputs on the plain route against the
autograd route (the modules' own code); the kernel's symbol in the
benchmark's "group norm" kind.  The kernel itself against the plain
version in the ``cuda`` tests, which skip without a card."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch_port_common import one_torch_thread  # noqa: F401

from benchmark import trace
from mm_diffusion_tpu_torch.models.image_unet import ImageResBlock, ImageSuperResModel, ImageUNetConfig
from mm_diffusion_tpu_torch.models.layers import GroupNorm32, MMNorm
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
