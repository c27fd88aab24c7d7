"""The hand-written CUDA backward kernels against their plain PyTorch
backwards, on the card, at the flagship training step's main-path shapes
(the lists of mm_diffusion_tpu_torch/tools/ab_self_attention.py), every
banded shift included; the self-attention backward (K4/K5) also at ragged T
with N >= 2 and at T = 16 with an N that does not fill the last packed
tile; K4-K7 at head dims that run on a larger built kernel (32, 48, 72).
The banded backward (K6/K7) also at the training shapes with N >= 2 (rows past a clip's last frame are the next
clip's), at frames of 25, 100 and 400 rows that cross 64-row tile
boundaries (lw = 1, F - 1 with the largest shifts, F), at head dims 32, 48,
96 and 128, with the frames packed per tile chosen by grid size, and two
runs bitwise equal at every training shape.  The forward (K1) and the
backward (K4/K5) also at the SR U-Net's training shapes (the per-head qkv
order, 6 and 12 heads) and the single-modal audio U-Net's (T = 6400, 1600
and 400 at head dims 64, 96, 128).

CUDA kernels have no CPU or interpret mode, so every test here is marked
``cuda`` and skips without a CUDA device.  On a GPU machine:

    python -m pytest --noconftest tests/test_torch_port_backward_kernels.py -q
"""

import pytest
import torch

from chip_smoke import AUDIO_TRAIN_SELF_SHAPES, SR_TRAIN_SELF_SHAPES
from mm_diffusion_tpu_torch.ops import block_attention as ba
from mm_diffusion_tpu_torch.tools.ab_self_attention import TRAIN_BANDED_SHAPES, TRAIN_SELF_SHAPES

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err, ok = ba.BACKWARD_TOL.check(out, ref)
    assert ok, f"max |error| {err} against max |plain| {ref.float().abs().max().item()}"


@pytest.mark.parametrize(
    "label,n,t,c,heads,layout", TRAIN_SELF_SHAPES, ids=[s[0] for s in TRAIN_SELF_SHAPES]
)
def test_self_attention_backward_kernel(cuda, label, n, t, c, heads, layout):
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    dout = torch.randn((n, t, c), generator=g, device=cuda, dtype=torch.bfloat16)
    out, lse = ba.self_attention_cuda(qkv, heads, layout)
    dqkv = ba.self_attention_bwd_cuda(qkv, out, lse, dout, heads, layout)
    _close(dqkv, ba.self_attention_backward_reference(qkv, dout, heads, layout))


SLICE_SHAPES = SR_TRAIN_SELF_SHAPES + AUDIO_TRAIN_SELF_SHAPES


@pytest.mark.parametrize("label,n,t,c,heads,layout", SLICE_SHAPES, ids=[s[0] for s in SLICE_SHAPES])
def test_self_attention_kernels_at_sr_and_audio_training_shapes(cuda, label, n, t, c, heads, layout):
    """K1's out and lse, and K4/K5's gradient, at the SR U-Net's and the
    single-modal audio U-Net's training shapes, against the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(13)
    qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    dout = torch.randn((n, t, c), generator=g, device=cuda, dtype=torch.bfloat16)
    out, lse = ba.self_attention_cuda(qkv, heads, layout)
    err, ok = ba.FORWARD_TOL.check(out, ba.self_attention_reference(qkv, heads, layout))
    assert ok, f"forward max |error| {err}"
    q, k, _ = ba.split_packed_qkv(qkv.float(), heads, layout)
    lse_ref = torch.logsumexp(torch.einsum("nqhd,nkhd->nhqk", q, k) / q.shape[-1] ** 0.5, dim=-1)
    err, ok = ba.LSE_TOL.check(lse, lse_ref)
    assert ok, f"lse max |error| {err}"
    del q, k, lse_ref
    dqkv = ba.self_attention_bwd_cuda(qkv, out, lse, dout, heads, layout)
    _close(dqkv, ba.self_attention_backward_reference(qkv, dout, heads, layout))
    assert torch.equal(dqkv, ba.self_attention_bwd_cuda(qkv, out, lse, dout, heads, layout))


@pytest.mark.parametrize("layout", ["thirds", "per_head"])
@pytest.mark.parametrize("t", [16, 25, 100, 130])
def test_self_attention_backward_ragged_and_layouts(cuda, layout, t):
    g = torch.Generator(device=cuda).manual_seed(1)
    for heads, c in ((4, 256), (4, 384), (4, 512)):
        qkv = torch.randn((3, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
        dout = torch.randn((3, t, c), generator=g, device=cuda, dtype=torch.bfloat16)
        out, lse = ba.self_attention_cuda(qkv, heads, layout)
        dqkv = ba.self_attention_bwd_cuda(qkv, out, lse, dout, heads, layout)
        _close(dqkv, ba.self_attention_backward_reference(qkv, dout, heads, layout))


@pytest.mark.parametrize(
    "label,n,t,c,heads,layout", TRAIN_SELF_SHAPES, ids=[s[0] for s in TRAIN_SELF_SHAPES]
)
def test_self_attention_backward_new_and_previous_designs_agree(cuda, label, n, t, c, heads, layout):
    """The Hopper backward on a second draw of inputs at each training
    shape: the gradient against the plain backward."""
    g = torch.Generator(device=cuda).manual_seed(6)
    qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    dout = torch.randn((n, t, c), generator=g, device=cuda, dtype=torch.bfloat16)
    out, lse = ba.self_attention_cuda(qkv, heads, layout)
    new = ba.self_attention_bwd_cuda(qkv, out, lse, dout, heads, layout)
    _close(new, ba.self_attention_backward_reference(qkv, dout, heads, layout))


@pytest.mark.parametrize("n,t,c,heads,layout", [
    (3, 400, 512, 4, "thirds"), (3, 400, 512, 4, "per_head"), (5, 100, 256, 4, "thirds"),
    (5, 100, 256, 4, "per_head"), (1023, 16, 256, 4, "thirds"), (1023, 16, 256, 4, "per_head"),
])
def test_self_attention_backward_ragged_and_packed(cuda, n, t, c, heads, layout):
    """Ragged T with N >= 2 (the rows past T are the next sequence's) and a
    partial last pack at T = 16."""
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    dout = torch.randn((n, t, c), generator=g, device=cuda, dtype=torch.bfloat16)
    out, lse = ba.self_attention_cuda(qkv, heads, layout)
    dqkv = ba.self_attention_bwd_cuda(qkv, out, lse, dout, heads, layout)
    _close(dqkv, ba.self_attention_backward_reference(qkv, dout, heads, layout))


@pytest.mark.parametrize("d", [32, 48, 72])
def test_backward_head_dims_on_larger_kernels(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(8)
    heads, c = 3, 3 * d
    for n, t, layout in ((3, 100, "thirds"), (7, 16, "per_head")):
        qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
        dout = torch.randn((n, t, c), generator=g, device=cuda, dtype=torch.bfloat16)
        out, lse = ba.self_attention_cuda(qkv, heads, layout)
        dqkv = ba.self_attention_bwd_cuda(qkv, out, lse, dout, heads, layout)
        _close(dqkv, ba.self_attention_backward_reference(qkv, dout, heads, layout))
    q_src = torch.randn((2, 4, 40, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    kv_src = torch.randn((2, 4, 24, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    dout = torch.randn((2, 4, 40, c), generator=g, device=cuda, dtype=torch.bfloat16)
    for shift, lw in ((3, 1), (1, 2)):
        out, lse = ba.banded_attention_cuda(q_src, kv_src, shift, lw, heads, c)
        dq, dkv = ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, shift, lw, heads, c)
        rq, rkv = ba.banded_attention_backward_reference(q_src, kv_src, dout, shift, lw, heads, c)
        _close(dq, rq)
        _close(dkv, rkv)
        assert not dq[..., c:].any() and not dkv[..., :c].any()


@pytest.mark.parametrize(
    "label,n,f,tq,tk,c,heads,lw", TRAIN_BANDED_SHAPES, ids=[s[0] for s in TRAIN_BANDED_SHAPES]
)
def test_banded_backward_kernel_every_shift(cuda, label, n, f, tq, tk, c, heads, lw):
    g = torch.Generator(device=cuda).manual_seed(2)
    n = 1  # one clip: every shift of the span at N = 1 stays inside the time limit
    q_src = torch.randn((n, f, tq, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    kv_src = torch.randn((n, f, tk, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    dout = torch.randn((n, f, tq, c), generator=g, device=cuda, dtype=torch.bfloat16)
    for shift in range(f - lw + 1):
        out, lse = ba.banded_attention_cuda(q_src, kv_src, shift, lw, heads, c)
        dq, dkv = ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, shift, lw, heads, c)
        rq, rkv = ba.banded_attention_backward_reference(q_src, kv_src, dout, shift, lw, heads, c)
        _close(dq, rq)
        _close(dkv, rkv)
        assert not dq[..., c:].any() and not dkv[..., :c].any()


def _banded_check(q_src, kv_src, dout, shift, lw, heads, c):
    """The Hopper banded backward against the plain backward, and its zero
    lanes."""
    out, lse = ba.banded_attention_cuda(q_src, kv_src, shift, lw, heads, c)
    new = ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, shift, lw, heads, c)
    ref = ba.banded_attention_backward_reference(q_src, kv_src, dout, shift, lw, heads, c)
    for got, want in zip(new, ref):
        _close(got, want)
    assert not new[0][..., c:].any() and not new[1][..., :c].any()


def _banded_inputs(g, n, f, tq, tk, c):
    make = lambda *shape: torch.randn(shape, generator=g, device=g.device, dtype=torch.bfloat16)  # noqa: E731
    return make(n, f, tq, 3 * c), make(n, f, tk, 3 * c), make(n, f, tq, c)


@pytest.mark.parametrize(
    "label,n,f,tq,tk,c,heads,lw", TRAIN_BANDED_SHAPES, ids=[s[0] for s in TRAIN_BANDED_SHAPES]
)
def test_banded_backward_new_and_previous_designs_agree(cuda, label, n, f, tq, tk, c, heads, lw):
    """N = 2 clips (a tile's rows past its clip's last frame are the next
    clip's), shifts 0, the middle and the last of the span (the wrap)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q_src, kv_src, dout = _banded_inputs(g, 2, f, tq, tk, c)
    for shift in sorted({0, (f - lw) // 2, f - lw}):
        _banded_check(q_src, kv_src, dout, shift, lw, heads, c)


FRAME_ROWS = [(25, 64), (64, 25), (100, 256), (256, 100), (400, 25), (25, 400), (25, 25)]


@pytest.mark.parametrize("tq,tk", FRAME_ROWS, ids=[f"{a}x{b}" for a, b in FRAME_ROWS])
def test_banded_backward_frames_across_tiles(cuda, tq, tk):
    """Frames of 25, 100 and 400 rows, whose ranges cross 64-row boxes and
    frames; lw = 1, F - 1 (with the largest shifts, the wrap) and F."""
    g = torch.Generator(device=cuda).manual_seed(10)
    f, heads, c = 8, 2, 128
    q_src, kv_src, dout = _banded_inputs(g, 3, f, tq, tk, c)
    for lw, shifts in ((1, (0, 5, f - 1)), (3, (2, f - 3, f - 1)), (f - 1, (1, f - 2, f - 1)),
                       (f, (0, 3, f - 1))):
        for shift in shifts:
            _banded_check(q_src, kv_src, dout, shift, lw, heads, c)


@pytest.mark.parametrize("d", [32, 48, 96, 128])
def test_banded_backward_head_dims(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(11)
    heads, f = 2, 6
    c = heads * d
    for tq, tk, lw, shift in ((25, 64, 4, 5), (64, 25, 6, 0), (100, 40, 1, 3)):
        q_src, kv_src, dout = _banded_inputs(g, 2, f, tq, tk, c)
        _banded_check(q_src, kv_src, dout, shift, lw, heads, c)


def test_banded_backward_packing_by_grid_size(cuda):
    """Frames of T <= 32 rows share a 64-row tile, fewer where the grid
    would leave SMs without a block; the gradient is right either way."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count

    def expected(n, f, t, heads):
        pack = min(64 // t, f) if t <= 32 else 1
        while pack > 1 and n * -(-f // pack) * heads < sms:
            pack -= 1
        return pack

    cases = [(4, 16, 25, 8), (1, 16, 25, 8), (1, 16, 25, 1), (4, 16, 16, 8), (2, 16, 8, 4),
             (4, 16, 64, 8), (4, 16, 400, 4)]
    for n, f, t, heads in cases:
        assert ba.banded_bwd_frames_per_tile(n, f, t, heads) == expected(n, f, t, heads)
    assert ba.banded_bwd_frames_per_tile(4, 16, 25, 8) == 2  # the ds8 / middle training shapes
    assert ba.banded_bwd_frames_per_tile(1, 16, 25, 2) == 1  # a grid smaller than the card
    g = torch.Generator(device=cuda).manual_seed(12)
    for n, heads, tq, tk in ((1, 2, 25, 64), (1, 2, 64, 25), (2, 2, 16, 8), (6, 4, 25, 25)):
        q_src, kv_src, dout = _banded_inputs(g, n, 16, tq, tk, heads * 64)
        for lw, shift in ((8, 8), (16, 3), (1, 15)):
            _banded_check(q_src, kv_src, dout, shift, lw, heads, heads * 64)


def test_fp32_backward_and_autograd(cuda):
    """fp32 tensors through the autograd functions: bf16 operands, fp32
    accumulation, fp32 gradients; the launch counts see both backwards."""
    g = torch.Generator(device=cuda).manual_seed(3)
    ba.reset_launch_counts()
    qkv = torch.randn((4, 100, 3 * 256), generator=g, device=cuda).requires_grad_()
    ba.self_attention(qkv, 4).square().sum().backward()
    ref = qkv.detach().requires_grad_()
    ba.self_attention_reference(ref, 4).square().sum().backward()
    _close(qkv.grad, ref.grad)
    src = torch.randn((2, 4, 32, 3 * 128), generator=g, device=cuda).requires_grad_()
    other = torch.randn((2, 4, 20, 3 * 128), generator=g, device=cuda).requires_grad_()
    (ba.banded_cross_attention_packed(src, other, 1, 2, 2, 128).sum()
     + ba.banded_cross_attention_packed(other, src, 1, 2, 2, 128).square().sum()).backward()
    rs, ro = src.detach().requires_grad_(), other.detach().requires_grad_()
    (ba.banded_cross_attention_reference(rs, ro, 1, 2, 2, 128).sum()
     + ba.banded_cross_attention_reference(ro, rs, 1, 2, 2, 128).square().sum()).backward()
    _close(src.grad, rs.grad)
    _close(other.grad, ro.grad)
    assert ba.LAUNCHES["self_attention_bwd"] == 1
    assert ba.LAUNCHES["banded_attention_bwd"] == 2
    assert dict(ba.BANDED_BWD_WINDOWS) == {2: 2} and dict(ba.SELF_BWD_LENGTHS) == {100: 1}


def test_backward_kernels_are_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    for n, t, c in ((4, 400, 512), (1023, 16, 256), (8, 1024, 256)):
        qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
        dout = torch.randn((n, t, c), generator=g, device=cuda, dtype=torch.bfloat16)
        out, lse = ba.self_attention_cuda(qkv, 4)
        first = ba.self_attention_bwd_cuda(qkv, out, lse, dout, 4)
        assert torch.equal(first, ba.self_attention_bwd_cuda(qkv, out, lse, dout, 4))
    for label, n, f, tq, tk, c, heads, lw in TRAIN_BANDED_SHAPES:
        q_src, kv_src, dout = _banded_inputs(g, n, f, tq, tk, c)
        shift = f - lw  # the wrap
        out, lse = ba.banded_attention_cuda(q_src, kv_src, shift, lw, heads, c)
        first = ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, shift, lw, heads, c)
        second = ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, shift, lw, heads, c)
        assert all(torch.equal(a, b) for a, b in zip(first, second)), label
