"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at the flagship sampler's main-path shapes (the lists of
mm_diffusion_tpu_torch/tools/ab_self_attention.py); the self-attention
forward (K1) also at ragged T with N >= 2 (the rows past T of one sequence
are the next one's) and at T = 16 with an N that does not fill the last
packed tile; K1 and K2/K3 at head dims that run on a larger built kernel
(32, 48, 72).  The banded forward (K2/K3) also at N = 2 at every shift of
every main-path shape (the wrap included), with lw = F, with
frames packed per tile (Tq = 25 at N = 4), at ragged Tq / Tk that cross
64-row boxes and frames, and at head dims 32, 48, 96 and 128.  Every
attention entry point (K1-K8) at head dims the kernels are not built for
(12, 20, 36: a zero-padded copy; 136, 200: the flash kernels K8), forward
and backward, with the launch counters showing the kernel that ran.

CUDA kernels have no CPU or interpret mode, so every test here is marked
``cuda`` and skips without a CUDA device.  On a GPU machine:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -q
"""

import pytest
import torch

from mm_diffusion_tpu_torch.ops import block_attention as ba
from mm_diffusion_tpu_torch.ops import fused_attention as fa
from mm_diffusion_tpu_torch.tools.ab_self_attention import BANDED_SHAPES, SELF_SHAPES

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(out, ref, tol=ba.FORWARD_TOL):
    torch.testing.assert_close(out.float(), ref.float(), atol=tol.atol, rtol=tol.rtol)


@pytest.mark.parametrize("label,n,t,c,heads,layout", SELF_SHAPES, ids=[s[0] for s in SELF_SHAPES])
def test_self_attention_kernel(cuda, label, n, t, c, heads, layout):
    _self_check(cuda, 0, n, t, c, heads, layout)


def _self_check(cuda, seed, n, t, c, heads, layout):
    """K1's out and lse on random bf16 qkv against the plain version and
    the logsumexp of the scaled logits."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    out, lse = ba.self_attention_cuda(qkv, heads, layout)
    _close(out, ba.self_attention_reference(qkv, heads, layout))
    q, k, _ = ba.split_packed_qkv(qkv.float(), heads, layout)
    logits = torch.einsum("nqhd,nkhd->nhqk", q, k) / (c // heads) ** 0.5
    _close(lse, torch.logsumexp(logits, dim=-1), tol=ba.LSE_TOL)


@pytest.mark.parametrize("label,n,t,c,heads,layout", SELF_SHAPES, ids=[s[0] for s in SELF_SHAPES])
def test_self_attention_new_and_previous_designs_agree(cuda, label, n, t, c, heads, layout):
    """The Hopper kernel on a second draw of inputs at each shape: out and
    lse against the plain version."""
    _self_check(cuda, 3, n, t, c, heads, layout)


SELF_EXTRA = [  # (n, t, c, heads, layout): ragged T with N >= 2, T = 16 with a partial pack
    (3, 400, 512, 4, "thirds"), (3, 400, 512, 4, "per_head"), (5, 100, 256, 4, "thirds"),
    (5, 100, 256, 4, "per_head"), (1023, 16, 256, 4, "thirds"), (1023, 16, 256, 4, "per_head"),
]


@pytest.mark.parametrize("n,t,c,heads,layout", SELF_EXTRA)
def test_self_attention_ragged_and_packed(cuda, n, t, c, heads, layout):
    _self_check(cuda, 4, n, t, c, heads, layout)


@pytest.mark.parametrize("layout", ["thirds", "per_head"])
@pytest.mark.parametrize("d", [32, 48, 72])
def test_head_dims_on_larger_kernels(cuda, d, layout):
    """K1 (ragged T, a partial pack) and K2/K3 at a head dim below the
    built size it runs on (the lanes past d zero-filled, never stored)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    heads, c = 3, 3 * d
    for n, t in ((3, 100), (7, 16)):
        qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
        out, lse = ba.self_attention_cuda(qkv, heads, layout)
        _close(out, ba.self_attention_reference(qkv, heads, layout))
        q, k, _ = ba.split_packed_qkv(qkv.float(), heads, layout)
        _close(lse, torch.logsumexp(torch.einsum("nqhd,nkhd->nhqk", q, k) / d**0.5, dim=-1), tol=ba.LSE_TOL)
    q_src = torch.randn((2, 4, 40, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    kv_src = torch.randn((2, 4, 24, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    for shift, lw in ((3, 1), (1, 2), (0, 4)):
        out, _ = ba.banded_attention_cuda(q_src, kv_src, shift, lw, heads, c)
        _close(out, ba.banded_cross_attention_reference(q_src, kv_src, shift, lw, heads, c))


@pytest.mark.parametrize(
    "label,f,tq,tk,c,heads,lw", BANDED_SHAPES, ids=[s[0] for s in BANDED_SHAPES]
)
def test_banded_kernel_every_shift(cuda, label, f, tq, tk, c, heads, lw):
    g = torch.Generator(device=cuda).manual_seed(1)
    q_src = torch.randn((1, f, tq, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    kv_src = torch.randn((1, f, tk, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    for shift in range(f - lw + 1):
        _banded_check(q_src, kv_src, shift, lw, heads, c)


def _banded_check(q_src, kv_src, shift, lw, heads, c):
    """The banded forward's out and lse against the plain version and the
    logsumexp over the window."""
    n, f, tq, _ = q_src.shape
    tk, d = kv_src.shape[2], c // heads
    out, lse = ba.banded_attention_cuda(q_src, kv_src, shift, lw, heads, c)
    _close(out, ba.banded_cross_attention_reference(q_src, kv_src, shift, lw, heads, c))
    idx = ba.window_frame_indices(f, lw, shift, q_src.device)
    q = q_src[..., :c].float().reshape(n, f, tq, heads, d)
    k = kv_src[..., c:2 * c].float()[:, idx].reshape(n, f, lw * tk, heads, d)
    logits = torch.einsum("nfqhd,nfkhd->nfhqk", q, k) / d**0.5
    _close(lse, torch.logsumexp(logits, dim=-1), tol=ba.LSE_TOL)


@pytest.mark.parametrize(
    "label,f,tq,tk,c,heads,lw", BANDED_SHAPES, ids=[s[0] for s in BANDED_SHAPES]
)
def test_banded_new_and_previous_designs_agree(cuda, label, f, tq, tk, c, heads, lw):
    """N = 2 clips (rows past a clip's last frame are the next clip's) at
    every shift of the span, lw = F at three shifts: the plain version and
    the logsumexp."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q_src = torch.randn((2, f, tq, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    kv_src = torch.randn((2, f, tk, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    for shift in range(f - lw + 1):
        _banded_check(q_src, kv_src, shift, lw, heads, c)
    for shift in (0, 5, f - 1):
        _banded_check(q_src, kv_src, shift, f, heads, c)


def test_banded_packed_frames_at_batch_4(cuda):
    """Tq = 25 at N = 4 (frames packed per 64-row tile, the grid full) and
    Tk = 25 against Tq = 64, every shift of lw 8 and lw = F."""
    g = torch.Generator(device=cuda).manual_seed(7)
    f, heads, c = 16, 8, 512
    for tq, tk in ((25, 64), (64, 25)):
        q_src = torch.randn((4, f, tq, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
        kv_src = torch.randn((4, f, tk, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
        for shift in range(f - 8 + 1):
            _banded_check(q_src, kv_src, shift, 8, heads, c)
        _banded_check(q_src, kv_src, 3, f, heads, c)
    assert ba.banded_bwd_frames_per_tile(4, f, 25, heads) == 2


RAGGED = [(25, 64), (64, 25), (100, 256), (256, 100), (400, 25), (25, 400), (1, 7), (33, 31), (130, 70)]


@pytest.mark.parametrize("tq,tk", RAGGED, ids=[f"{a}x{b}" for a, b in RAGGED])
def test_banded_ragged_frames(cuda, tq, tk):
    """Frames whose rows cross 64-row boxes and frames; N = 3; lw = 1, 3,
    F - 1 and F with the largest shifts (the wrap)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    f, heads, c = 8, 2, 128
    q_src = torch.randn((3, f, tq, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    kv_src = torch.randn((3, f, tk, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    for lw, shifts in ((1, (0, 5, f - 1)), (3, (2, f - 3, f - 1)), (f - 1, (1, f - 2, f - 1)),
                       (f, (0, 3, f - 1))):
        for shift in shifts:
            _banded_check(q_src, kv_src, shift, lw, heads, c)


@pytest.mark.parametrize("d", [32, 48, 96, 128])
def test_banded_head_dims(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(9)
    heads, f = 2, 6
    c = heads * d
    for tq, tk, lw, shift in ((25, 64, 4, 5), (64, 25, 6, 0), (100, 40, 1, 3), (300, 70, 2, 5)):
        q_src = torch.randn((2, f, tq, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
        kv_src = torch.randn((2, f, tk, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
        _banded_check(q_src, kv_src, shift, lw, heads, c)


def test_banded_dispatch_needs_aligned_sources(cuda):
    """The Hopper kernel reads both sources by TMA: a bf16 source that is
    not 16-byte aligned raises instead of launching."""
    x = torch.randn((1 * 4 * 8 * 3 * 64 + 1,), device=cuda, dtype=torch.bfloat16)
    src = x[1:].view(1, 4, 8, 3 * 64)
    with pytest.raises(ValueError, match="aligned"):
        ba.banded_attention_cuda(src, src, 0, 1, 1, 64)


ROUTE_DIMS = [12, 20, 36, 136, 200]


def _expect_route(name, d, flash_name):
    route_flash = ba.padded_head_dim(d) > ba.HEAD_DIMS[-1]
    assert ba.LAUNCHES[name] == (0 if route_flash else 1)
    assert fa.LAUNCHES[flash_name] == (1 if route_flash else 0)
    assert ba.HEAD_DIM_ROUTES[f"{name}:pad"] == int(d % 8 != 0)
    assert ba.HEAD_DIM_ROUTES[f"{name}:flash"] == int(route_flash)


def _reset():
    ba.reset_launch_counts()
    fa.reset_launch_counts()


@pytest.mark.parametrize("layout", ["thirds", "per_head"])
@pytest.mark.parametrize("d", ROUTE_DIMS)
def test_self_attention_head_dim_routes(cuda, d, layout):
    """K1 and K4/K5 at a head dim no kernel is built for: the forward's out
    and lse and the backward's dqkv against the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(12)
    heads, n, t = 2, 3, 70
    c = heads * d
    qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    dout = torch.randn((n, t, c), generator=g, device=cuda, dtype=torch.bfloat16)
    _reset()
    out, lse = ba.self_attention_cuda(qkv, heads, layout)
    _expect_route("self_attention", d, "flash_mha_fwd")
    _close(out, ba.self_attention_reference(qkv, heads, layout))
    q, k, _ = ba.split_packed_qkv(qkv.float(), heads, layout)
    _close(lse, torch.logsumexp(torch.einsum("nqhd,nkhd->nhqk", q, k) / d**0.5, dim=-1), tol=ba.LSE_TOL)
    _reset()
    dqkv = ba.self_attention_bwd_cuda(qkv, out, lse, dout, heads, layout)
    _expect_route("self_attention_bwd", d, "flash_mha_bwd")
    err, ok = ba.BACKWARD_TOL.check(dqkv, ba.self_attention_backward_reference(qkv, dout, heads, layout))
    assert ok and dqkv.shape == qkv.shape, err


@pytest.mark.parametrize("d", ROUTE_DIMS)
def test_banded_head_dim_routes(cuda, d):
    """K2/K3 and K6/K7 at a head dim no kernel is built for, lw 1, 3 and F
    with the wrap: forward and both packed gradients against the plain
    versions."""
    g = torch.Generator(device=cuda).manual_seed(13)
    heads, n, f, tq, tk = 2, 2, 6, 40, 25
    c = heads * d
    q_src = torch.randn((n, f, tq, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    kv_src = torch.randn((n, f, tk, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    dout = torch.randn((n, f, tq, c), generator=g, device=cuda, dtype=torch.bfloat16)
    for lw, shift in ((1, 5), (3, 4), (f, 2)):
        _reset()
        _banded_check(q_src, kv_src, shift, lw, heads, c)
        _expect_route("banded_attention", d, "flash_mha_fwd")
        out, lse = ba.banded_attention_cuda(q_src, kv_src, shift, lw, heads, c)
        _reset()
        grads = ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, shift, lw, heads, c)
        _expect_route("banded_attention_bwd", d, "flash_mha_bwd")
        refs = ba.banded_attention_backward_reference(q_src, kv_src, dout, shift, lw, heads, c)
        for got, ref in zip(grads, refs):
            err, ok = ba.BACKWARD_TOL.check(got, ref)
            assert ok and got.shape == ref.shape, err


@pytest.mark.parametrize("d", ROUTE_DIMS)
def test_flash_mha_head_dim_routes(cuda, d):
    """K8 at D = 12, 20, 36 (zero-padded copies) and 136, 200 (built
    sizes), through autograd in the [B, T, H, D] layout."""
    g = torch.Generator(device=cuda).manual_seed(14)
    leaves = [torch.randn((2, t, 3, d), generator=g, device=cuda, dtype=torch.bfloat16).requires_grad_()
              for t in (50, 70, 70)]
    dout = torch.randn((2, 50, 3, d), generator=g, device=cuda, dtype=torch.bfloat16)
    _reset()
    out = fa.flash_mha(*leaves)
    out.backward(dout)
    assert fa.LAUNCHES == {"flash_mha_fwd": 1, "flash_mha_bwd": 1}
    assert ba.HEAD_DIM_ROUTES["flash_mha_fwd:pad"] == int(d % 8 != 0)
    plain = [x.detach() for x in leaves]
    _close(out, fa.mha_reference(*plain))
    for x, ref in zip(leaves, fa.mha_backward_reference(*plain, dout)):
        err, ok = ba.BACKWARD_TOL.check(x.grad, ref)
        assert ok and x.grad.shape == ref.shape, err


def test_fp32_inputs(cuda):
    """fp32 tensors: bf16 operands, fp32 accumulation, fp32 output."""
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn((4, 100, 3 * 256), generator=g, device=cuda)
    out, _ = ba.self_attention_cuda(qkv, 4)
    assert out.dtype == torch.float32
    _close(out, ba.self_attention_reference(qkv, 4))


def test_dispatch_launches_and_counts(cuda):
    ba.reset_launch_counts()
    qkv = torch.randn((2, 64, 3 * 256), device=cuda, dtype=torch.bfloat16)
    ba.self_attention(qkv, 4)
    src = torch.randn((1, 4, 32, 3 * 128), device=cuda, dtype=torch.bfloat16)
    ba.banded_cross_attention_packed(src, src, 1, 2, 2, 128)
    ba.banded_cross_attention_packed(src, src, 2, 1, 2, 128)
    assert ba.LAUNCHES == {
        "self_attention": 1, "banded_attention": 2, "self_attention_bwd": 0, "banded_attention_bwd": 0,
    }
    assert dict(ba.BANDED_WINDOWS) == {2: 1, 1: 1}
    assert not ba.HEAD_DIM_ROUTES


def test_unsupported_inputs_raise(cuda):
    """d > 256 (no kernel of the port is built for it), a dtype the kernels
    do not take, a strided tensor, a window wider than the clip."""
    with pytest.raises(ValueError, match=r"above 256"):
        ba.self_attention_cuda(torch.randn((1, 16, 3 * 264), device=cuda), 1)  # d = 264
    with pytest.raises(TypeError):
        ba.self_attention_cuda(torch.randn((1, 16, 3 * 64), device=cuda).half(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        ba.self_attention_cuda(torch.randn((1, 32, 3 * 64), device=cuda)[:, ::2], 1)
    src = torch.randn((1, 4, 8, 3 * 64), device=cuda)
    with pytest.raises(ValueError, match="local_window"):
        ba.banded_attention_cuda(src, src, 0, 5, 1, 64)
    src = torch.randn((1, 4, 8, 3 * 264), device=cuda)
    with pytest.raises(ValueError, match=r"above 256"):
        ba.banded_attention_cuda(src, src, 0, 1, 1, 264)


def test_head_dim_20_computes(cuda):
    """d = 20 (not a multiple of 8), which the card refused before the
    padded route: the banded forward and self-attention compute it."""
    g = torch.Generator(device=cuda).manual_seed(15)
    src = torch.randn((1, 4, 8, 3 * 20), generator=g, device=cuda)
    out, _ = ba.banded_attention_cuda(src, src, 0, 1, 1, 20)
    _close(out, ba.banded_cross_attention_reference(src, src, 0, 1, 1, 20))
    qkv = torch.randn((2, 16, 3 * 40), generator=g, device=cuda)
    out, _ = ba.self_attention_cuda(qkv, 2)
    _close(out, ba.self_attention_reference(qkv, 2))
