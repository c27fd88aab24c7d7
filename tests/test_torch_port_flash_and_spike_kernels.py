"""The flash MHA kernels (K8) and the spike kernels (S1-S4) against their
plain PyTorch versions, on the card: both K8 layouts, Tq != Tk with ragged
ends, head dims on every built size (32 and 192 included) and between two;
the K1 variants at ragged and packed lengths (rows on its persistent kernel
at T <= 32, with a partial last pack) and at head dims 12-200 through their
routes, nomax at its clamp; the GEMM and the conv at ragged sizes; the
launch counters showing which design (K8: Hopper or mma.sync, by its design
rule) and which route ran.

CUDA kernels have no CPU or interpret mode, so every test here is marked
``cuda`` and skips without a CUDA device.  On a GPU machine:

    python -m pytest --noconftest tests/test_torch_port_flash_and_spike_kernels.py -q
"""

import pytest
import torch
import torch.nn.functional as F

from mm_diffusion_tpu_torch.ops import block_attention as ba
from mm_diffusion_tpu_torch.ops import fused_attention as fa
from mm_diffusion_tpu_torch.ops import gemm_conv as gc

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, tol=fa.FORWARD_TOL):
    assert out.shape == ref.shape
    err, ok = tol.check(out, ref)
    assert ok, f"max |error| {err} against max |plain| {ref.float().abs().max().item()}: not {tol}"


def _bwd_close(out, ref):
    assert out.dtype == ref.dtype
    _close(out, ref, fa.BACKWARD_TOL)


def _operands(gen, dev, b, h, tq, tk, d, layout, dtype=torch.bfloat16):
    def make(t):
        shape = (b, h, t, d) if layout == "bhtd" else (b, t, h, d)
        x = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return x if layout == "bhtd" else x.transpose(1, 2)

    return make(tq), make(tk), make(tk), make(tq)


def _bthd(*xs):
    return [x.transpose(1, 2) for x in xs]


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 192])
@pytest.mark.parametrize("tq,tk", [(1, 5), (17, 33), (64, 64), (100, 1024), (130, 65), (1024, 400)])
def test_flash_mha_kernels_ragged(cuda, layout, d, tq, tk):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, dout = _operands(g, cuda, 3, 2, tq, tk, d, layout)
    fa.reset_launch_counts()
    out, lse = fa.flash_mha_fwd_cuda(q, k, v)
    assert fa.FORWARD_DESIGNS == {"sm90" if d <= 128 else "mma": 1}
    assert out.stride() == q.stride()
    _close(out, fa.mha_reference(*_bthd(q, k, v)).transpose(1, 2))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / d**0.5
    _close(lse, torch.logsumexp(logits, dim=-1), fa.LSE_TOL)
    grads = fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout)
    assert fa.BACKWARD_DESIGNS == {"sm90" if d <= 128 else "mma": 1}
    refs = fa.mha_backward_reference(*_bthd(q, k, v, dout))
    for got, ref, like in zip(grads, refs, (q, k, v)):
        assert got.stride() == like.stride()
        _bwd_close(got, ref.transpose(1, 2))


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("tq,tk", [(1, 5), (17, 33), (64, 64), (100, 1024), (130, 65), (1024, 400)])
def test_flash_mha_bwd_matches_previous_design(cuda, layout, d, tq, tk):
    """The Hopper backward at two heads of three rows of a second draw, in
    the caller's strides: each gradient within the limit of the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(15)
    q, k, v, dout = _operands(g, cuda, 2, 3, tq, tk, d, layout)
    out, lse = fa.flash_mha_fwd_cuda(q, k, v)
    fa.reset_launch_counts()
    grads = fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout)
    assert fa.BACKWARD_DESIGNS == {"sm90": 1}
    refs = fa.mha_backward_reference(*_bthd(q, k, v, dout))
    for got, ref, like in zip(grads, refs, (q, k, v)):
        assert got.stride() == like.stride()
        _bwd_close(got, ref.transpose(1, 2))


def test_flash_mha_bwd_design_counts(cuda):
    """bf16 up to kernel head dim 128 launches the Hopper backward, fp32 and
    192 / 256 the mma.sync design."""
    g = torch.Generator(device=cuda).manual_seed(16)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (32, 40, 128, 136, 256):
            q, k, v, dout = _operands(g, cuda, 1, 2, 70, 90, d, "bthd", dtype)
            out, lse = fa.flash_mha_fwd_cuda(q, k, v)
            fa.reset_launch_counts()
            fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout)
            design = "sm90" if dtype == torch.bfloat16 and d <= 128 else "mma"
            assert fa.backward_design(d, dtype)[0] == design
            assert fa.BACKWARD_DESIGNS == {design: 1} and fa.LAUNCHES["flash_mha_bwd"] == 1


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("tq,tk", [(1, 5), (100, 1024), (130, 65), (1024, 400)])
def test_flash_mha_fwd_matches_previous_design(cuda, layout, d, tq, tk):
    """The Hopper forward at two heads of three rows of a second draw: out
    (in q's strides) and lse within the limits of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, _ = _operands(g, cuda, 2, 3, tq, tk, d, layout)
    fa.reset_launch_counts()
    out, lse = fa.flash_mha_fwd_cuda(q, k, v)
    assert fa.FORWARD_DESIGNS == {"sm90": 1} and out.stride() == q.stride()
    ref = fa.mha_reference(*_bthd(q, k, v)).transpose(1, 2)
    lse_ref = torch.logsumexp(torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / d**0.5, -1)
    _close(out, ref)
    _close(lse, lse_ref, fa.LSE_TOL)


def test_flash_mha_fwd_design_counts(cuda):
    """bf16 up to kernel head dim 128 launches the Hopper forward, fp32 and
    192 / 256 the mma.sync design."""
    g = torch.Generator(device=cuda).manual_seed(13)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (32, 40, 128, 136, 256):
            q, k, v, _ = _operands(g, cuda, 1, 2, 70, 90, d, "bthd", dtype)
            fa.reset_launch_counts()
            fa.flash_mha_fwd_cuda(q, k, v)
            design = "sm90" if dtype == torch.bfloat16 and d <= 128 else "mma"
            assert fa.forward_design(d, dtype)[0] == design
            assert fa.FORWARD_DESIGNS == {design: 1} and fa.LAUNCHES["flash_mha_fwd"] == 1


def test_flash_mha_autograd_both_entry_points_and_counts(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    fa.reset_launch_counts()
    leaves = [torch.randn((2, t, 4, 64), generator=g, device=cuda).requires_grad_() for t in (50, 70, 70)]
    dout = torch.randn((2, 50, 4, 64), generator=g, device=cuda)
    fa.flash_mha(*leaves).backward(dout)
    refs = fa.mha_backward_reference(*(x.detach() for x in leaves), dout)
    for leaf, ref in zip(leaves, refs):
        _bwd_close(leaf.grad, ref)
    bhtd = [x.detach().transpose(1, 2).contiguous().requires_grad_() for x in leaves]
    out = fa.flash_mha_bhtd(*bhtd)
    assert out.dtype == torch.float32 and out.is_contiguous()
    out.backward(dout.transpose(1, 2))
    for leaf, ref in zip(bhtd, refs):
        _bwd_close(leaf.grad, ref.transpose(1, 2))
    assert fa.LAUNCHES == {"flash_mha_fwd": 2, "flash_mha_bwd": 2}
    assert fa.BACKWARD_DESIGNS == {"mma": 2}  # fp32 leaves


def test_flash_mha_backward_is_deterministic(cuda):
    """Bitwise equal gradients over two runs: the Hopper backward (bf16)
    and the mma.sync design (fp32), Tq and Tk ragged."""
    g = torch.Generator(device=cuda).manual_seed(2)
    for dtype, design in ((torch.bfloat16, "sm90"), (torch.float32, "mma")):
        q, k, v, dout = _operands(g, cuda, 4, 4, 300, 129, 64, "bthd", dtype)
        out, lse = fa.flash_mha_fwd_cuda(q, k, v)
        fa.reset_launch_counts()
        first = fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout)
        second = fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout)
        assert fa.BACKWARD_DESIGNS == {design: 2}
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("d", [8, 40, 160, 256])
def test_flash_mha_head_dims_between_built_sizes(cuda, d):
    """Head dims that run on the next larger built kernel (the lanes past d
    zero-filled and never stored), forward and backward."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, dout = _operands(g, cuda, 2, 3, 70, 50, d, "bthd")
    out, lse = fa.flash_mha_fwd_cuda(q, k, v)
    _close(out, fa.mha_reference(*_bthd(q, k, v)).transpose(1, 2))
    grads = fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout)
    for got, ref in zip(grads, fa.mha_backward_reference(*_bthd(q, k, v, dout))):
        _bwd_close(got, ref.transpose(1, 2))


def test_flash_mha_unsupported_inputs_raise(cuda):
    """D > 256 (no kernel of the port is built for it; D = 12 computes on a
    zero-padded copy, tests/test_torch_port_kernels.py), a dtype the
    kernels do not take, a strided view."""
    x = torch.randn((1, 2, 16, 264), device=cuda)
    with pytest.raises(ValueError, match=r"above 256"):
        fa.flash_mha_bhtd(x, x, x)
    with pytest.raises(TypeError):
        fa.flash_mha_fwd_cuda(*(torch.randn((1, 2, 16, 64), device=cuda).half(),) * 3)
    y = torch.randn((1, 2, 32, 64), device=cuda)
    with pytest.raises(ValueError, match="view"):
        fa.flash_mha_fwd_cuda(y[:, :, ::2], y[:, :, ::2], y[:, :, ::2])


@pytest.mark.parametrize("variant", ba.VARIANTS)
@pytest.mark.parametrize("n,t", [(1, 1), (5, 7), (9, 16), (3, 25), (4, 32), (2, 33), (3, 100),
                                 (4099, 16), (41, 25)])
def test_attention_variants(cuda, variant, n, t):
    """Each variant against its plain version at head dims 64, 96, 128 and,
    through their routes, 12 and 36 (a zero-padded copy) and 136 and 200
    (rows / nomax / noexp: the kernels built at 192 and 256); T <= 32 runs
    rows on its persistent kernel (N = 4099, T = 16 and N = 41, T = 25 end
    on a partial pack); the counts show what ran."""
    g = torch.Generator(device=cuda).manual_seed(3)
    for heads, c in ((2, 128), (2, 192), (2, 256), (2, 24), (2, 72), (2, 272), (2, 400)):
        d = c // heads
        qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
        ref = ba.self_attention_variant_reference(qkv, heads, variant)
        tol = ba.VARIANT_TOL[variant]
        ba.reset_launch_counts()
        _close(ba.self_attention_variant(qkv, heads, variant), ref, tol)
        assert dict(ba.VARIANT_LAUNCHES) == {variant: 1}
        if variant not in ba.VARIANT_CODES:
            continue
        dp = ba.padded_head_dim(d)
        routes = {"self_attention_variant:pad": int(dp != d), "self_attention_variant:wide": int(dp > 128)}
        assert dict(ba.HEAD_DIM_ROUTES) == {k: v for k, v in routes.items() if v}
        assert ba.LAUNCHES["self_attention"] == 0


def test_nomax_at_the_clamp(cuda):
    """nomax with logits far above its clamp at 40: P = e^40 ~ 2.4e17 for
    every key whose logit reaches it, finite when packed to bf16 and summed
    in fp32 over T = 1024 keys, and the output within the limit."""
    g = torch.Generator(device=cuda).manual_seed(9)
    n, t, heads, c = 2, 1024, 2, 128
    qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    qkv[..., : 2 * c] *= 4  # logits ~ N(0, 16^2): many far above 40
    ref = ba.self_attention_variant_reference(qkv, heads, "nomax")
    logits = torch.einsum("nqhd,nkhd->nhqk", *ba.split_packed_qkv(qkv.float(), heads)[:2]) / 8
    assert (logits > 2 * ba.NOMAX_CLAMP).any()
    out = ba.self_attention_variant(qkv, heads, "nomax")
    assert torch.isfinite(out).all()
    _close(out, ref, ba.VARIANT_TOL["nomax"])


@pytest.mark.parametrize("variant", sorted(ba.VARIANT_CODES))
def test_attention_variant_unsupported_inputs_raise(cuda, variant):
    """d > 256 (no kernel is built for it), and fp32 above 128 (the fp32
    variants are the mma.sync design, built up to 128)."""
    with pytest.raises(ValueError, match="above 256"):
        ba.self_attention_variant(torch.randn((1, 16, 3 * 264), device=cuda, dtype=torch.bfloat16), 1, variant)
    with pytest.raises(ValueError, match="up to 128"):
        ba.self_attention_variant(torch.randn((1, 16, 3 * 136), device=cuda), 1, variant)


def test_attention_variant_counts(cuda):
    ba.reset_launch_counts()
    qkv = torch.randn((8, 16, 3 * 128), device=cuda, dtype=torch.bfloat16)
    for variant in ba.VARIANTS:
        ba.self_attention_variant(qkv, 2, variant)
    assert dict(ba.VARIANT_LAUNCHES) == {v: 1 for v in ba.VARIANTS}
    assert ba.LAUNCHES["self_attention"] == 4  # stock, hoist, recip, exp2 launch the stock kernel


# M = 21 .. 2080 rows (ragged past 192 at (3, 7, 13) and (2, 40, 26)); K0 = 16, 40, 64, 72
# (not a multiple of 64 but for 64 and 192); CO 8 .. 264 (one or two 192- or 256-column tiles).
@pytest.mark.parametrize("shape,c1,c2,co", [
    ((1, 3, 7), 16, 40, 8), ((2, 5, 9), 192, 192, 192), ((1, 4, 33), 64, 8, 200),
    ((3, 7, 13), 40, 192, 192), ((2, 40, 26), 72, 24, 264),
])
def test_skip_gemm(cuda, shape, c1, c2, co):
    """The Hopper GEMM through the API against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x1 = torch.randn((*shape, c1), generator=g, device=cuda, dtype=torch.bfloat16)
    x2 = torch.randn((*shape, c2), generator=g, device=cuda, dtype=torch.bfloat16)
    w = torch.randn((c1 + c2, co), generator=g, device=cuda) * 0.05
    gc.reset_launch_counts()
    out = gc.skip_gemm(x1, x2, w)
    assert gc.LAUNCHES["skip_gemm"] == 1
    assert out.dtype == torch.bfloat16 and out.shape == (*shape, co)
    _close(out, gc.skip_gemm_reference(x1, x2, w), gc.GEMM_TOL)


# Co 8 .. 200 (ragged past 192 at 200), K 8 .. 1728 (72, 136: not multiples of 64), npx 8 .. 264
# (ragged past 256 at 264).
@pytest.mark.parametrize("co,k,nblk,npx", [
    (192, 1728, 2, 256), (100, 72, 3, 24), (8, 8, 1, 8), (200, 136, 2, 264),
])
def test_gemm_blocks(cuda, co, k, nblk, npx):
    """The Hopper GEMM through the API against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn((co, k), generator=g, device=cuda) * 0.05
    b = torch.randn((nblk, k, npx), generator=g, device=cuda, dtype=torch.bfloat16)
    gc.reset_launch_counts()
    out = gc.gemm_blocks(a, b)
    assert gc.LAUNCHES["gemm_blocks"] == 1
    _close(out, gc.gemm_blocks_reference(a, b), gc.GEMM_TOL)


@pytest.mark.parametrize("b,ci,co,h,w", [
    (1, 5, 7, 9, 13), (2, 16, 64, 3, 130), (1, 192, 192, 17, 256), (1, 20, 70, 8, 1),
    (1, 200, 200, 6, 40), (2, 200, 200, 3, 136),
])
def test_conv3x3_chw(cuda, b, ci, co, h, w):
    """The Hopper conv against the plain version and F.conv2d; Ci % 8 != 0
    takes the counted padded-channel route."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((b, ci, h, w), generator=g, device=cuda, dtype=torch.bfloat16)
    wt = torch.randn((co, ci, 3, 3), generator=g, device=cuda) * 0.05
    gc.reset_launch_counts()
    out = gc.conv3x3_chw(x, wt)
    assert gc.CONV_ROUTES == ({"conv3x3_chw:pad_channels": 1} if ci % 8 else {})
    assert gc.LAUNCHES["conv3x3_chw"] == 1
    assert out.dtype == torch.bfloat16 and out.shape == (b, co, h, w)
    _close(out, gc.conv3x3_chw_reference(x, wt), gc.GEMM_TOL)
    _close(out, F.conv2d(x.float(), wt.float(), padding=1), gc.GEMM_TOL)


@pytest.mark.parametrize("b,ci,h,w", [(1, 5, 9, 13), (2, 64, 3, 130), (1, 200, 2, 62), (1, 8, 1, 1)])
def test_channels_last_halo_kernel(cuda, b, ci, h, w):
    """The conv's input copy (channels-last, zero ring, channels padded to a
    multiple of 8) equals its plain version exactly."""
    g = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn((b, ci, h, w), generator=g, device=cuda, dtype=torch.bfloat16)
    gc.reset_launch_counts()
    out = gc.channels_last_halo_cuda(x)
    assert gc.HELPER_LAUNCHES == {"channels_last_halo": 1}
    assert torch.equal(out, gc.channels_last_halo(x))


def test_gemm_conv_counts_and_refusals(cuda):
    gc.reset_launch_counts()
    x = torch.randn((1, 4, 4, 8), device=cuda, dtype=torch.bfloat16)
    gc.skip_gemm(x, x, torch.randn((16, 8), device=cuda))
    gc.gemm_blocks(torch.randn((8, 8), device=cuda), torch.randn((2, 8, 8), device=cuda).bfloat16())
    gc.conv3x3_chw(x, torch.randn((8, 4, 3, 3), device=cuda))
    assert gc.LAUNCHES == {"skip_gemm": 1, "gemm_blocks": 1, "conv3x3_chw": 1}
    x6 = torch.randn((1, 4, 4, 6), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        gc.skip_gemm(x6, x6, torch.randn((12, 8), device=cuda))
    with pytest.raises(TypeError):
        gc.conv3x3_chw(x.float(), torch.randn((8, 4, 3, 3), device=cuda))
