"""The text-to-image U-Net (Stable Diffusion XL base) of the port against the
benchmark's plain float32 reference (``benchmark/reference/sdxl_unet.py``,
``dpm_pp.py``) on the CPU, at a tiny SDXL-shaped size: channels 32, mult
1,2,4, transformers at downsample rates 4 and 2 of head channels 8 and
depths 1,2,3, a 7x24 context, a 40-wide vector condition, 4x16x16 latents,
batch 2, weights from ``benchmark/weights.py``.  Also the published
configuration's size on the meta device, the scaled-linear schedule, the
spans, and the cell's run at the tiny size (sound, broken, fp8 control).
The ``cuda`` case runs one transformer block on a card at the published
64^2 and 32^2 shapes against the reference's block; it skips here."""

import copy

import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401

from benchmark import calibrate, run, work_sdxl
from benchmark.reference import dpm_pp
from benchmark.reference.layers import Precision, set_precision
from benchmark.reference.sdxl_unet import BasicTransformerBlock as RefBlock
from benchmark.reference.sdxl_unet import SDXLConfig, SDXLUNet, vector_condition
from benchmark.weights import load_seeded_
from mm_diffusion_tpu_torch import configs, sampling
from mm_diffusion_tpu_torch.diffusion.schedules import get_named_beta_schedule
from mm_diffusion_tpu_torch.models.image_unet import ImageUNet, sdxl_vector
from mm_diffusion_tpu_torch.models.transformer import BasicTransformerBlock, SpatialTransformer
from mm_diffusion_tpu_torch.utils import tracing

TINY = dict(adm_in_channels=40, num_classes="sequential", in_channels=4, out_channels=4, model_channels=32,
            attention_resolutions="4,2", num_res_blocks=2, channel_mult="1,2,4", num_head_channels=8,
            use_linear_in_transformer=True, transformer_depth="1,2,3", context_dim=24, image_size=16,
            use_fp16=False)
SEED = 2**31 + 21
# fp32 against fp32: the same products and sums in another order (the
# port's packed qkv GEMM, its one GroupNorm pass); measured ~1.2e-6.
FP32_LIMIT = 1e-5
# bf16 against fp32: every product's operands and every stored activation
# round at 2^-9 relative, through ~40 products in sequence; measured ~1.6e-2
# for one evaluation, the reference in fp8 reads ~10x that.
BF16_LIMIT = 4e-2


def port_model(**overrides):
    return load_seeded_(ImageUNet(configs.create_text2img_config(**{**TINY, **overrides})).eval(), SEED)


def reference_model():
    return load_seeded_(SDXLUNet(SDXLConfig.from_flags(TINY)).eval(), SEED)


def inputs(n=2):
    g = torch.Generator().manual_seed(3)
    return (torch.randn(n, 16, 16, 4, generator=g), torch.tensor([999, 431][:n]),
            torch.randn(n, 7, 24, generator=g), torch.randn(n, 40, generator=g))


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_scaled_linear_betas_follow_their_formula():
    betas = get_named_beta_schedule("scaled_linear", 1000)
    assert betas[0] == pytest.approx(0.00085, rel=1e-12) and betas[-1] == pytest.approx(0.012, rel=1e-12)
    root = betas**0.5
    assert root[1:] - root[:-1] == pytest.approx([(0.012**0.5 - 0.00085**0.5) / 999] * 999, rel=1e-9)
    assert (betas == dpm_pp.scaled_linear_betas(1000)).all()


def test_state_dict_keys_are_the_references_and_sgms():
    port, ref = port_model().state_dict(), reference_model().state_dict()
    assert sorted(port) == sorted(ref)
    assert all(port[k].shape == ref[k].shape for k in port)
    for key in ("input_blocks.4.1.transformer_blocks.1.attn2.to_k.weight",
                "input_blocks.4.1.proj_in.weight", "middle_block.1.transformer_blocks.2.ff.net.0.proj.weight",
                "output_blocks.2.2.conv.weight", "input_blocks.3.0.op.weight", "label_emb.0.2.bias",
                "output_blocks.0.1.transformer_blocks.2.attn1.to_out.0.bias"):
        assert key in port, key
    assert "input_blocks.4.1.transformer_blocks.0.attn1.to_q.bias" not in port


def test_published_configuration_on_the_meta_device():
    """SDXL base's U-Net has 2,567,463,684 parameters and 70 transformer
    blocks; one row-evaluation is ~6.76 TFLOP by the yardstick."""
    flags = configs.sdxl_base_flags()
    with torch.device("meta"):
        model = ImageUNet(configs.create_text2img_config(**flags))
    assert sum(p.numel() for p in model.parameters()) == 2_567_463_684
    assert sum(isinstance(m, BasicTransformerBlock) for m in model.modules()) == 70
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    cell_flags = run.cell_files(spec, "sdxl-dpmpp20-b4")[1]["model"]
    assert configs.create_text2img_config(**cell_flags) == configs.create_text2img_config(**flags)
    with pytest.raises(NotImplementedError):
        configs.create_text2img_config(**{**flags, "use_linear_in_transformer": False})
    flops, sites = work_sdxl.eval_work(cell_flags, 1, 77, 128)
    assert flops == pytest.approx(6.7612e12, rel=1e-4)
    assert sorted({s[2] for s in sites if s[0] == "self"}) == [1024, 4096]
    assert len([s for s in sites if s[0] == "cross" and s[3] == 77]) == 70


def test_port_matches_the_reference_in_fp32():
    x, t, ctx, y = inputs()
    with torch.no_grad():
        got, ref = port_model()(x, t, context=ctx, y=y), reference_model()(x, t, ctx, y)
    assert rel(got, ref) < FP32_LIMIT


def test_port_in_bf16_stays_near_the_reference():
    x, t, ctx, y = inputs()
    with torch.no_grad():
        got, ref = port_model(use_fp16=True)(x, t, context=ctx, y=y), reference_model()(x, t, ctx, y)
    assert got.dtype == torch.float32
    assert 1e-4 < rel(got, ref) < BF16_LIMIT


def test_vector_condition_matches_the_reference():
    pooled = torch.randn(3, 16, generator=torch.Generator().manual_seed(1))
    got = sdxl_vector(pooled, (1024, 768), (0, 32), (1024, 1024), size_dim=4)
    ref = vector_condition(pooled, (1024, 768, 0, 32, 1024, 1024), 4)
    assert got.shape == (3, 40) and torch.equal(got, ref)


def test_guided_sampler_matches_the_reference():
    """Three evaluations of guided DPM-Solver++ (multistep order 2) from one
    x_T, the unconditional branch a zero context and vector."""
    x, _, ctx, y = inputs()
    cond, uncond = {"context": ctx, "y": y}, {"context": torch.zeros_like(ctx), "y": torch.zeros_like(y)}
    diffusion = configs.create_gaussian_diffusion(steps=1000, noise_schedule="scaled_linear")
    got = sampling.build_text2img_sampler(port_model(), diffusion, steps=3, guidance_scale=5.0)(cond, uncond, x_T=x)
    model = reference_model()
    with torch.no_grad():
        ref = dpm_pp.guided_sample(dpm_pp.scaled_linear_vp(), lambda xx, tt, c: model(xx, tt, c["context"], c["y"]),
                                   x, cond, uncond, steps=3, scale=5.0)
    assert rel(got, ref) < FP32_LIMIT
    assert rel(got, x) > 0.1  # the solver moved the latent


def test_spans_are_recorded_only_when_tracing_is_on():
    x, t, ctx, y = inputs(1)
    model = port_model()
    tracing.disable()
    tracing.drain()
    with torch.no_grad():
        model(x, t, context=ctx, y=y)
        assert tracing.drain() == []
        tracing.enable()
        try:
            model(x, t, context=ctx, y=y)
        finally:
            tracing.disable()
    spans = tracing.drain()
    names = [s.name for s in spans]
    assert names.count("unet.transformer") == sum(isinstance(m, SpatialTransformer) for m in model.modules())
    assert names.count("unet.cross_attn") == sum(isinstance(m, BasicTransformerBlock) for m in model.modules())
    for s in spans:
        if s.name == "unet.cross_attn":
            assert spans[s.parent].name == "unet.transformer"


def test_image_unet_without_context_builds_no_transformer():
    cfg = configs.create_image_sr_config(large_size=64, small_size=16, sr_num_channels=16, sr_num_res_blocks=1,
                                         sr_attention_resolutions="8", sr_num_head_channels=16)
    model = ImageUNet(cfg)
    assert not any(isinstance(m, SpatialTransformer) for m in model.modules())
    assert not any(".transformer_blocks." in k or k.startswith("label_emb") for k in model.state_dict())


def _tiny_cell():
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    _, config, traffic = run.cell_files(spec, "sdxl-dpmpp20-b4")
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["model"] = dict(TINY)
    config["conditioning"].update(context_tokens=7, pooled_dim=16, size_dim=4)
    traffic.update(batch=2, steps=3)
    return spec, config, traffic


def _alter_images(monkeypatch):
    from mm_diffusion_tpu_torch.samplers.dpm import DPMSolver

    real = DPMSolver.sample

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs).clone()
        out[..., 0] *= 1.25  # one of the four latent channels, in proportion (the output is unbounded)
        return out

    monkeypatch.setattr(DPMSolver, "sample", altered)


@pytest.mark.parametrize("broken", [False, True])
def test_the_cell_at_a_tiny_size(broken, monkeypatch):
    """The driver's timed path and check (as ``benchmark/run.py`` runs them,
    without its process's look for JAX, which this suite loads): a sound
    call passes the cell's limit; one with every image's first latent
    channel altered, and the reference in fp8 in the program's place, fail
    it."""
    spec, config, traffic = _tiny_cell()
    if broken:
        _alter_images(monkeypatch)
    got = calibrate.readings(spec, "sdxl-dpmpp20-b4", SEED, torch.device("cpu"), not broken, False,
                             config=config, traffic=traffic)
    limit = traffic["limits"]["latent_rel_l2"]
    assert (got["program"]["latent_rel_l2"] > limit) is broken, got
    if not broken:
        assert got["fp8"]["latent_rel_l2"] > limit, got


# -- on a card -----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1, K8 and the GroupNorm kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("side,channels", [(64, 640), (32, 1280)])
def test_transformer_block_on_the_card(cuda, side, channels, monkeypatch):
    """One published block in bf16 (K1 self-attention, K8 cross-attention at
    Tk = 77) against the reference's block in float32 (TF32 off): the
    bf16 limit, and one launch of each kernel."""
    from mm_diffusion_tpu_torch.ops import block_attention, fused_attention

    heads = channels // 64
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    with torch.device(cuda):
        block = load_seeded_(BasicTransformerBlock(channels, heads, 64, 2048).eval(), SEED)
        ref = set_precision(load_seeded_(RefBlock(channels, heads, 2048).eval(), SEED), Precision())
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(2, side * side, channels, generator=g, device=cuda).bfloat16()
    ctx = torch.randn(2, 77, 2048, generator=g, device=cuda).bfloat16()
    block_attention.reset_launch_counts()
    fused_attention.reset_launch_counts()
    with torch.no_grad():
        got = block(x, ctx).float()
        want = ref(x.float(), ctx.float())
    torch.cuda.synchronize()
    assert block_attention.LAUNCHES["self_attention"] == 1
    assert fused_attention.FORWARD_DESIGNS["sm90"] == 1
    assert rel(got - x.float(), want - x.float()) < BF16_LIMIT  # the block's update, the residual taken off
