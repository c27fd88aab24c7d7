"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at the flagship sampler's main-path shapes (chip_smoke.py's lists);
the self-attention forward (K1) also at ragged T with N >= 2 (the rows past
T of one sequence are the next one's), at T = 16 with an N that does not
fill the last packed tile, and against its previous design; K1 and K2/K3 at
head dims that run on a larger built kernel (32, 48, 72).

CUDA kernels have no CPU or interpret mode, so every test here is marked
``cuda`` and skips without a CUDA device.  On a GPU machine:

    python -m pytest tests/test_torch_port_kernels.py -q
"""

import pytest
import torch

from chip_smoke import BANDED_SHAPES, SELF_SHAPES
from mm_diffusion_tpu_torch.ops import block_attention as ba

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
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    out, lse = ba.self_attention_cuda(qkv, heads, layout)
    _close(out, ba.self_attention_reference(qkv, heads, layout))
    q, k, _ = ba.split_packed_qkv(qkv.float(), heads, layout)
    logits = torch.einsum("nqhd,nkhd->nhqk", q, k) / (c // heads) ** 0.5
    _close(lse, torch.logsumexp(logits, dim=-1), tol=ba.LSE_TOL)


@pytest.mark.parametrize("label,n,t,c,heads,layout", SELF_SHAPES, ids=[s[0] for s in SELF_SHAPES])
def test_self_attention_new_and_previous_designs_agree(cuda, label, n, t, c, heads, layout):
    """The Hopper kernel and the previous (mma.sync) design on the same
    inputs: the same outputs within the forward limit."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    out, lse = ba.self_attention_cuda(qkv, heads, layout)
    prev_out, prev_lse = ba._self_attention_previous_cuda(qkv, heads, layout)
    _close(out, prev_out)
    _close(lse, prev_lse, tol=ba.LSE_TOL)


SELF_EXTRA = [  # (n, t, c, heads, layout): ragged T with N >= 2, T = 16 with a partial pack
    (3, 400, 512, 4, "thirds"), (3, 400, 512, 4, "per_head"), (5, 100, 256, 4, "thirds"),
    (5, 100, 256, 4, "per_head"), (1023, 16, 256, 4, "thirds"), (1023, 16, 256, 4, "per_head"),
]


@pytest.mark.parametrize("n,t,c,heads,layout", SELF_EXTRA)
def test_self_attention_ragged_and_packed(cuda, n, t, c, heads, layout):
    g = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn((n, t, 3 * c), generator=g, device=cuda, dtype=torch.bfloat16)
    out, lse = ba.self_attention_cuda(qkv, heads, layout)
    _close(out, ba.self_attention_reference(qkv, heads, layout))
    q, k, _ = ba.split_packed_qkv(qkv.float(), heads, layout)
    logits = torch.einsum("nqhd,nkhd->nhqk", q, k) / (c // heads) ** 0.5
    _close(lse, torch.logsumexp(logits, dim=-1), tol=ba.LSE_TOL)


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
        out, _ = ba.banded_attention_cuda(q_src, kv_src, shift, lw, heads, c)
        _close(out, ba.banded_cross_attention_reference(q_src, kv_src, shift, lw, heads, c))


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


def test_unsupported_inputs_raise(cuda):
    with pytest.raises(ValueError, match=r"d % 8 == 0 and 8 <= d <= 128"):
        ba.self_attention_cuda(torch.randn((1, 16, 3 * 24), device=cuda), 2)  # d = 12
    with pytest.raises(ValueError, match=r"d % 8 == 0 and 8 <= d <= 128"):
        ba.self_attention_cuda(torch.randn((1, 16, 3 * 136), device=cuda), 1)  # d = 136
    with pytest.raises(TypeError):
        ba.self_attention_cuda(torch.randn((1, 16, 3 * 64), device=cuda).half(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        ba.self_attention_cuda(torch.randn((1, 32, 3 * 64), device=cuda)[:, ::2], 1)
    src = torch.randn((1, 4, 8, 3 * 64), device=cuda)
    with pytest.raises(ValueError, match="local_window"):
        ba.banded_attention_cuda(src, src, 0, 5, 1, 64)
    src = torch.randn((1, 4, 8, 3 * 20), device=cuda)
    with pytest.raises(ValueError, match=r"d % 8 == 0"):
        ba.banded_attention_cuda(src, src, 0, 1, 1, 20)  # d = 20
