"""Wan 2.1's text-to-video transformer in the port against the benchmark's
plain float32 reference (``benchmark/reference/wan.py``, ``dpm_flow.py``)
on the CPU, at a tiny Wan-shaped size: dim 64, 2 heads of 32, ffn 128, 2
blocks, a 16x3x8x8 latent (48 tokens), an 8x32 context, weights from
``benchmark/weights.py``.  Also the published configuration's size on the
meta device, the 3-D RoPE against Wan's complex form, the flow-matching
DPM-Solver++ against the reference solver, the spans and the site counter,
the text-to-image sampler's operations unchanged, and the cell's run at the
tiny size (sound, each listed fault, the fp8 control).  The ``cuda`` case
runs one published block on a card against the reference's block; it skips
here."""

import copy
import hashlib
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_port_common import one_torch_thread  # noqa: F401

from benchmark import calibrate, run, work_sdxl, work_wan
from benchmark.reference import dpm_flow
from benchmark.reference import wan as ref_wan
from benchmark.reference.layers import Precision, set_precision
from benchmark.weights import load_seeded_
from mm_diffusion_tpu_torch import configs, sampling
from mm_diffusion_tpu_torch.models import wan
from mm_diffusion_tpu_torch.samplers import DPMSolver, NoiseScheduleFlow, wrap_model
from mm_diffusion_tpu_torch.utils import tracing

CELL = "wan-t2v-480p81-dpmpp20"
TINY = dict(configs.wan_t2v_1_3b_flags(), dim=64, num_heads=2, ffn_dim=128, num_layers=2, text_len=8, text_dim=32)
SEED = 2**31 + 26
# fp32 against fp32: the same products and sums in another order (one
# packed qkv GEMM, the patch conv as a linear, RoPE as real products);
# measured ~2.7e-7.
FP32_LIMIT = 1e-5
# bf16 against fp32: every linear's operands and output round at 2^-9
# relative; measured ~3.5e-3 for one evaluation, where the reference with
# fp8 products (e4m3, 2^-4 relative) reads ~7e-2.
BF16_LIMIT = 2e-2
# The sampler end to end in fp32: the port's model time is float32(1000)
# x float32(sigma), the reference's float64, and x_0 = x - sigma v comes
# out of the noise form at alpha = 2e-4 on the first step; measured ~1.1e-5.
SAMPLER_LIMIT = 1e-4


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def port_model(dtype="float32"):
    return load_seeded_(wan.WanModel(configs.create_text2video_config(**{**TINY, "dtype": dtype})).eval(), SEED)


def reference_model():
    return load_seeded_(ref_wan.WanRef(ref_wan.WanRefConfig.from_flags(TINY)).eval(), SEED)


def inputs(n=2):
    g = torch.Generator().manual_seed(3)
    return (torch.randn(n, 16, 3, 8, 8, generator=g), torch.tensor([999.8, 431.25][:n]),
            torch.randn(n, 8, 32, generator=g))


def test_published_configuration_on_the_meta_device():
    """Wan2.1-T2V-1.3B has 1,418,996,800 parameters in 30 blocks, the
    reference's keys and shapes; one row-evaluation at 832x480x81 is 2.83e14
    FLOPs by the yardstick, 70% of it self-attention over 32,760 tokens."""
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    config = run.cell_files(spec, CELL)[1]
    assert config["model"] == configs.wan_t2v_1_3b_flags()
    with torch.device("meta"):
        model = wan.WanModel(configs.create_text2video_config(**config["model"]))
        ref = ref_wan.WanRef(ref_wan.WanRefConfig.from_flags(config["model"]))
    assert sum(p.numel() for p in model.parameters()) == 1_418_996_800 == config["published"]["parameters"]
    assert len(model.blocks) == 30 and model.cfg.head_dim == 128
    port, want = model.state_dict(), ref.state_dict()
    assert sorted(port) == sorted(want) and all(port[k].shape == want[k].shape for k in port)
    for key in ("patch_embedding.weight", "text_embedding.2.bias", "time_projection.1.weight", "head.modulation",
                "blocks.29.self_attn.norm_k.weight", "blocks.0.cross_attn.o.bias", "blocks.3.norm3.weight",
                "blocks.7.ffn.2.weight", "blocks.11.modulation", "head.head.weight"):
        assert key in port, key
    latent = work_wan.latent_shape(config["video"])
    assert latent == (16, 21, 60, 104)
    flops, sites = work_wan.eval_work(config["model"], 1, latent)
    assert flops == pytest.approx(2.830e14, rel=1e-3)
    self_flops = sum(work_sdxl.site_work(s)[0] for s in sites if s[0] == "self")
    assert self_flops / flops == pytest.approx(0.699, abs=1e-3)
    assert sorted(set(sites)) == [("cross", 1, 32760, 512, 1536, 12), ("self", 1, 32760, 1536, 12)]
    assert len(sites) == 60
    with pytest.raises(NotImplementedError):
        configs.create_text2video_config(**{**config["model"], "window_size": "256,256"})


def test_port_matches_the_reference_in_fp32():
    x, t, ctx = inputs()
    with torch.no_grad():
        assert rel(port_model()(x, t, ctx), reference_model()(x, t, ctx)) < FP32_LIMIT


def test_port_in_bf16_stays_near_the_reference_and_fp8_does_not():
    x, t, ctx = inputs()
    ref = reference_model()
    with torch.no_grad():
        want = ref(x, t, ctx)
        got = port_model("bfloat16")(x, t, ctx)
        fp8 = set_precision(ref, Precision("fp8"))(x, t, ctx)
    assert got.dtype == torch.float32
    assert 1e-4 < rel(got, want) < BF16_LIMIT < rel(fp8, want)


def _rope_one_table(grid, head_dim, device=None):
    """A fault: every axis on the frame axis' frequencies."""
    angles = []
    inv = torch.pow(10000.0, -torch.arange(0, head_dim, 2, dtype=torch.float64) / head_dim)
    for axis, (n, width) in enumerate(zip(grid, wan.rope_lanes(head_dim))):
        shape = [1, 1, 1, width // 2]
        shape[axis] = n
        a = torch.outer(torch.arange(n, dtype=torch.float64), inv[: width // 2]).view(shape)
        angles.append(a.expand(*grid, width // 2))
    theta = torch.cat(angles, dim=-1).reshape(-1, head_dim // 2)
    cos = theta.cos().repeat_interleave(2, dim=-1)
    sin = torch.stack([-theta.sin(), theta.sin()], dim=-1).flatten(-2)
    return cos.float()[:, None], sin.float()[:, None]


def _rope_rows_and_columns_swapped(grid, head_dim, device=None):
    """A fault: the row lanes turned by the column index and back."""
    f, h, w = grid
    cos, sin = wan.rope_tables((f, w, h), head_dim)
    swap = lambda x: x.view(f, w, h, -1).transpose(1, 2).reshape(f * h * w, 1, -1)  # noqa: E731
    return swap(cos), swap(sin)


@pytest.mark.parametrize("tables", ["port", "rows_and_columns_swapped", "one_table"])
def test_rope_matches_wans_complex_form(tables):
    """The port's real rotation equals the reference's complex one; with the
    rows' and columns' positions swapped, or one frequency table for all
    three axes, it does not."""
    grid, heads, d = (3, 4, 5), 2, 128
    y = torch.randn(2, math.prod(grid), heads, d, generator=torch.Generator().manual_seed(1))
    make = {"port": wan.rope_tables, "rows_and_columns_swapped": _rope_rows_and_columns_swapped,
            "one_table": _rope_one_table}[tables]
    out = torch.empty_like(y)
    wan.apply_rope(y, *make(grid, d), out=out)
    want = ref_wan.rope_apply(y, grid, ref_wan.rope_freqs(d))
    assert wan.rope_lanes(d) == (44, 42, 42)
    assert (rel(out, want) < 1e-6) is (tables == "port"), rel(out, want)


def _gaussian_velocity(mean=0.3, std=0.7):
    """The exact velocity field of x_0 ~ N(mean, std^2), per element: a
    model with a closed form, nonlinear in sigma."""

    def v(x, sigma):
        a = 1.0 - sigma
        x0 = mean + a * std**2 / (a * a * std**2 + sigma * sigma) * (x - a * mean)
        return (x - x0) / sigma

    return v


@pytest.mark.parametrize("shift", [1.0, 5.0])
def test_flow_solver_matches_the_reference(shift):
    """The port's DPMSolver on the flow schedule equals ``dpm_flow.py`` over
    5 steps; its first update is first-order from x_T, and its last, to
    sigma = 0, returns the last data prediction."""
    field = _gaussian_velocity()
    seen = []

    def raw(x, t_model):
        seen.append(x.double())
        return field(x, t_model[0].item() / 1000.0)

    x = torch.randn(2, 3, 5, generator=torch.Generator().manual_seed(4))
    ns = NoiseScheduleFlow(shift=shift)
    got = DPMSolver(wrap_model(raw, ns), ns, predict_x0=True).sample(x, steps=5, order=2, method="multistep")
    sigmas = dpm_flow.shifted_sigmas(5, shift)
    want = dpm_flow.sample(x, sigmas, lambda xx, i, s: field(xx, s))
    assert len(seen) == 5 and rel(got, want) < 1e-5
    assert ns.time_steps(5).tolist() == pytest.approx(sigmas, rel=1e-6)
    s0, s1 = sigmas[0], sigmas[1]
    h = math.log((1 - s1) / s1) - math.log((1 - s0) / s0)
    x0 = x.double() - s0 * field(x.double(), s0)
    # float32 state: x_0 comes out of the noise form divided by alpha = 1 -
    # sigma (1e-3 at the first step), which multiplies the rounding by 1/alpha.
    assert rel(seen[1], (s1 / s0) * x.double() - (1 - s1) * math.expm1(-h) * x0) < 1e-4
    assert rel(got, seen[4] - sigmas[4] * field(seen[4], sigmas[4])) < 1e-5


def test_text2video_sampler_matches_the_reference_with_spans_and_sites():
    """Three guided evaluations on the tiny model, end to end; the site
    counter and the spans."""
    x, _, ctx = inputs()
    model = port_model()
    sample = sampling.build_text2video_sampler(model, steps=3, shift=5.0, guidance_scale=5.0)
    tracing.disable()
    tracing.drain()
    wan.SITES.clear()
    got = sample({"context": ctx[1:]}, {"context": ctx[:1]}, x[:1])
    assert tracing.drain() == []
    assert wan.SITES == {("self", 48, 48): 6, ("cross", 48, 8): 6}
    with torch.no_grad():
        want = dpm_flow.guided_sample(reference_model(), x[:1], ctx[1:], ctx[:1], 3, 5.0, 5.0)
    assert rel(got, want) < SAMPLER_LIMIT
    assert rel(got, x[:1]) > 0.1  # the solver moved the latent
    tracing.enable()
    try:
        sample({"context": ctx[1:]}, {"context": ctx[:1]}, x[:1])
    finally:
        tracing.disable()
    spans = tracing.drain()
    names = [s.name for s in spans]
    assert names.count("sample.call") == 1 and names.count("sample.nfe") == 3
    for name in ("wan.block", "wan.qk_prep", "wan.self_attn", "wan.cross_attn", "wan.ffn"):
        assert names.count(name) == 3 * 2, name
    for s in spans:
        if s.name.startswith("wan.") and s.name != "wan.block":
            assert spans[s.parent].name == "wan.block"


class _Ops(TorchDispatchMode):
    """The sampler's own operations, in order; those inside the model left out."""

    def __init__(self):
        super().__init__()
        self.ops, self.inside = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.inside:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


# The text-to-image sampler's operations outside the model in one 3-step
# call of the tiny SDXL model of test_torch_port_sdxl.py, as the parent of
# the flow-matching path launched them: 1129 operations.
TEXT2IMG_OPS_SHA256 = "3d55ce2b271bcba9140dc6e56141e62adf7cb4a69dba2cafc1916bf47a606ba8"


def test_text2img_sampler_runs_the_same_operations():
    """SDXL's guided DPM-Solver++ call keeps its operations, in order, beside
    the flow schedule's branches in ``wrap_model`` and ``DPMSolver``."""
    from test_torch_port_sdxl import inputs as sdxl_inputs
    from test_torch_port_sdxl import port_model as sdxl_model

    log = _Ops()
    model = sdxl_model()

    class Outside:
        cfg = model.cfg

        def parameters(self):
            return model.parameters()

        def __call__(self, *args, **kwargs):
            log.inside += 1
            try:
                return model(*args, **kwargs)
            finally:
                log.inside -= 1

    x, _, ctx, y = sdxl_inputs()
    cond, uncond = {"context": ctx, "y": y}, {"context": torch.zeros_like(ctx), "y": torch.zeros_like(y)}
    diffusion = configs.create_gaussian_diffusion(steps=1000, noise_schedule="scaled_linear")
    sample = sampling.build_text2img_sampler(Outside(), diffusion, steps=3, guidance_scale=5.0)
    with log:
        sample(cond, uncond, x_T=x)
    assert len(log.ops) == 1129
    assert hashlib.sha256("\n".join(log.ops).encode()).hexdigest() == TEXT2IMG_OPS_SHA256


# -- the cell at a tiny size ------------------------------------------------------------


def _tiny_cell():
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    _, config, traffic = run.cell_files(spec, CELL)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["model"] = dict(TINY)
    config["video"].update(frames=9, height=64, width=64)  # a 16x3x8x8 latent
    traffic.update(steps=3)
    return spec, config, traffic


def _rope_columns_dropped(monkeypatch):
    real = wan.rope_tables

    def tables(grid, head_dim, device=None):
        cos, sin = real(grid, head_dim, device)
        cols = wan.rope_lanes(head_dim)[2]
        return torch.cat([cos[..., :-cols], torch.ones_like(cos[..., -cols:])], -1), \
            torch.cat([sin[..., :-cols], torch.zeros_like(sin[..., -cols:])], -1)

    monkeypatch.setattr(wan, "rope_tables", tables)


def _qk_norm_skipped(monkeypatch):
    monkeypatch.setattr(wan.RMSNorm, "forward", lambda self, x: x.float())


def _last_gate_zeroed(monkeypatch):
    """The last block's FFN gate m5 = 0 (of 2 blocks here, of 30 at full size)."""
    real = wan.WanAttentionBlock.forward

    def forward(self, x, e0, context, rope):
        if self is self._model_blocks[-1]:
            e0 = e0.clone()
            e0[:, 5] = -self.modulation[0, 5]
        return real(self, x, e0, context, rope)

    real_init = wan.WanModel.__init__

    def init(self, cfg):
        real_init(self, cfg)
        for block in self.blocks:
            object.__setattr__(block, "_model_blocks", list(self.blocks))

    monkeypatch.setattr(wan.WanAttentionBlock, "forward", forward)
    monkeypatch.setattr(wan.WanModel, "__init__", init)


def _sampler_with(**changes):
    def fault(monkeypatch):
        real = sampling.build_text2video_sampler

        def build(model, steps=50, shift=5.0, guidance_scale=5.0):
            kw = {"steps": steps, "shift": shift, "guidance_scale": guidance_scale, **changes}
            return real(model, **kw)

        monkeypatch.setattr(sampling, "build_text2video_sampler", build)

    return fault


FAULTS = {
    "rope_columns_dropped": _rope_columns_dropped,
    "qk_norm_skipped": _qk_norm_skipped,
    "last_gate_zeroed": _last_gate_zeroed,
    "guidance_4.5": _sampler_with(guidance_scale=4.5),
    "shift_3": _sampler_with(shift=3.0),
}
# Faults the cell's limits do not see, here as at the cell's size (PERF.md
# section 4): dropping RoPE's column axis moves the velocity gap from ~0.009
# to ~0.02 here (0.014 to 0.019-0.020 at 832x480x81), under its limit.
UNSEEN = {"rope_columns_dropped"}


def _tiny_readings(fault, monkeypatch, control=False):
    spec, config, traffic = _tiny_cell()
    if fault:
        FAULTS[fault](monkeypatch)
    got = calibrate.readings(spec, CELL, SEED, torch.device("cpu"), control, False, config=config, traffic=traffic)
    monkeypatch.undo()
    return got, traffic["limits"]


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_the_cell_at_a_tiny_size(fault, monkeypatch):
    """The driver's timed path and check (as ``benchmark/run.py`` runs them,
    without its process's look for JAX, which this suite loads): a sound run
    passes both of the cell's limits, and the reference in fp8 in the
    program's place fails one; each listed fault fails one, but those in
    :data:`UNSEEN`, which still move what the check reads."""
    got, limits = _tiny_readings(fault, monkeypatch, control=fault is None)
    failed = [n for n, v in got["program"].items() if not v <= limits[n]]
    if fault is None:
        assert not failed and any(not v <= limits[n] for n, v in got["fp8"].items()), got
    elif fault in UNSEEN:
        sound = _tiny_readings(None, monkeypatch)[0]["program"]["velocity_rel_l2"]
        assert got["program"]["velocity_rel_l2"] > 1.5 * sound, (got, sound)
    else:
        assert failed, got


# -- on a card -------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K8")
    return torch.device("cuda")


@pytest.mark.cuda
def test_published_block_on_the_card(cuda, monkeypatch):
    """One published block in bf16 (K1 self-attention at T = 32,760 and head
    dim 128, K8 cross-attention at Tk = 512) against the reference's block in
    float32 (TF32 off), on one row: the bf16 limit, one launch of each
    kernel."""
    from mm_diffusion_tpu_torch.ops import block_attention, fused_attention

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    flags = configs.wan_t2v_1_3b_flags()
    cfg = configs.create_text2video_config(**flags)
    with torch.device(cuda):
        block = load_seeded_(wan.WanAttentionBlock(cfg).eval(), SEED)
        ref = set_precision(load_seeded_(ref_wan.AttentionBlock(ref_wan.WanRefConfig.from_flags(flags)).eval(),
                                         SEED), Precision())
    grid = (21, 30, 52)
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(1, math.prod(grid), cfg.dim, generator=g, device=cuda)
    e0 = 0.3 * torch.randn(1, 6, cfg.dim, generator=g, device=cuda)
    ctx = torch.randn(1, 512, cfg.dim, generator=g, device=cuda)
    block_attention.reset_launch_counts()
    fused_attention.reset_launch_counts()
    with torch.no_grad():
        got = block(x, e0, ctx.bfloat16(), wan.rope_tables(grid, cfg.head_dim, cuda))
        want = ref(x, e0, ctx, grid, ref_wan.rope_freqs(cfg.head_dim, cuda))
    torch.cuda.synchronize()
    assert block_attention.LAUNCHES["self_attention"] == 1
    assert fused_attention.FORWARD_DESIGNS["sm90"] == 1
    assert rel(got - x, want - x) < BF16_LIMIT  # the block's update, the residual taken off
