"""The port's spans (``mm_diffusion_tpu_torch/utils/tracing.py``) on the
CPU: off, a span is the shared no-op context and neither records nor opens
a profiler range; on, records carry name, id and parent, nest, and the ring
keeps its capacity; the samplers and the train step open their spans at
their layer boundaries (one ``sample.nfe`` per model evaluation inside
``sample.call``; ``train.forward`` / ``train.backward`` /
``train.optimizer`` / ``train.ema`` inside ``train.step``), in the
profiler's trace as in the ring; and outputs are bit-identical with tracing
on and off."""

import copy

import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401

from mm_diffusion_tpu_torch import configs, sampling
from mm_diffusion_tpu_torch.models.image_unet import ImageSuperResModel
from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
from mm_diffusion_tpu_torch.train import create_train_state, make_optimizer, make_train_step
from mm_diffusion_tpu_torch.utils import tracing
from mm_diffusion_tpu_torch.weights import randomize_

BASE_FLAGS = dict(
    video_size="2,3,8,8", audio_size="1,128", num_channels=16, num_res_blocks=1,
    cross_attention_resolutions="2", cross_attention_windows="1", cross_attention_shift=True,
    video_attention_resolutions="2", audio_attention_resolutions="-1", channel_mult="1,2",
    num_heads=2, learn_sigma=True, dropout=0.0, dtype="float32",
)
SR_FLAGS = dict(
    large_size=64, small_size=16, sr_num_channels=16, sr_num_res_blocks=1,
    sr_attention_resolutions="8", sr_num_head_channels=16,
)
BASE_STEPS, SR_STEPS = 4, 3  # NFE: 4 (DPM-Solver orders [3, 1]) and 3 (DDIM)
NAMES = ("sample.call", "sample.nfe", "train.step", "train.forward", "train.backward",
         "train.optimizer", "train.ema")


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and the ring empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


class Counted:
    """A model as a sampler sees it, counting its evaluations."""

    def __init__(self, model):
        self.model, self.cfg, self.calls = model, model.cfg, 0

    def parameters(self):
        return self.model.parameters()

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.model(*args, **kwargs)


def base_sampler():
    model = Counted(randomize_(MultimodalUNet(configs.create_model_config(**BASE_FLAGS)), 1).eval())
    diffusion = configs.create_gaussian_diffusion(learn_sigma=True)
    shifts = torch.Generator()
    sample = sampling.build_base_sampler(model, diffusion, steps=BASE_STEPS, shift_generator=shifts)
    x_T = sample.noise(1, torch.Generator().manual_seed(4))

    def call():
        shifts.manual_seed(3)  # the RS-MMA shifts, alike in every call
        return sample(1, x_T=x_T)

    return model, call


def sr_sampler():
    cfg = configs.create_image_sr_config(**SR_FLAGS)
    model = Counted(randomize_(ImageSuperResModel(cfg), 2).eval())
    diffusion = configs.create_gaussian_diffusion(learn_sigma=True,
                                                  timestep_respacing=f"ddim{SR_STEPS}")
    sr = sampling.build_sr_sampler(model, diffusion, sample_fn="ddim", steps=SR_STEPS)
    g = torch.Generator().manual_seed(5)
    low, x_T = torch.rand(2, 16, 16, 3, generator=g) * 2 - 1, torch.randn(2, 64, 64, 3, generator=g)
    return model, lambda: sr(low, x_T=x_T)


def train_setup():
    torch.manual_seed(0)
    model = randomize_(MultimodalUNet(configs.create_model_config(**BASE_FLAGS)), 1).train()
    state = create_train_state(model, make_optimizer(model, lr=1e-3))
    step = make_train_step(configs.create_gaussian_diffusion(steps=100, learn_sigma=True), shift=1)
    g = torch.Generator().manual_seed(6)
    batch = {"video": torch.rand(2, 2, 8, 8, 3, generator=g) * 2 - 1,
             "audio": torch.rand(2, 128, 1, generator=g) * 2 - 1}
    t = torch.tensor([3, 71])
    noise = {k: torch.randn(v.shape, generator=g) for k, v in batch.items()}
    return state, lambda s: step(s, batch, t=t, noise=noise)


def profiled(fn):
    """(fn's result, the program ranges of a CPU profiler window around it:
    (name, start_ns, end_ns) in start order)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = prof.profiler.kineto_results.events()
    ranges = sorted(((e.name(), e.start_ns(), e.end_ns()) for e in events if e.name() in NAMES),
                    key=lambda r: r[1])
    return out, ranges


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_a_span_is_the_shared_null_context_and_records_nothing():
    assert tracing.span("sample.call", 1) is tracing.span("train.step") is tracing._NULL
    with tracing.span("train.step", 0):
        pass
    _, sample = base_sampler()
    state, step = train_setup()
    for fn in (sample, lambda: step(state)):
        _, ranges = profiled(fn)
        assert ranges == []
    assert tracing.drain() == []


def test_on_records_carry_name_id_and_parent_and_nest():
    tracing.enable()
    with tracing.span("a", 7):
        with tracing.span("b"):
            with tracing.span("c", 9):
                pass
        with tracing.span("d"):
            pass
    with tracing.span("e"):
        pass
    tracing.disable()
    with tracing.span("off"):
        pass
    spans = tracing.drain()
    assert [(s.name, s.id, s.parent) for s in spans] == [
        ("a", 7, -1), ("b", 7, 0), ("c", 9, 1), ("d", 7, 0), ("e", None, -1)]
    a, b, c, d, _ = spans
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns <= a.end_ns
    assert tracing.drain() == []


def test_the_ring_keeps_its_capacity(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 4)
    tracing.enable()
    with tracing.span("outer", 1):
        for i in range(6):
            with tracing.span("inner", i):
                pass
    spans = tracing.drain()
    assert len(spans) == 4
    # the oldest went first: the last three inner spans and the outer one, whose
    # record is written when it closes; the inner ones point at it
    assert [(s.name, s.id, s.parent) for s in spans] == [
        ("outer", 1, -1), ("inner", 3, 0), ("inner", 4, 0), ("inner", 5, 0)]


@pytest.mark.parametrize("make,nfe", [(base_sampler, BASE_STEPS), (sr_sampler, SR_STEPS)],
                         ids=["base-dpm", "sr-ddim"])
def test_a_sampler_call_holds_one_nfe_span_per_model_evaluation(make, nfe):
    model, sample = make()
    tracing.enable()
    _, ranges = profiled(sample)
    tracing.disable()
    assert model.calls == nfe
    calls = [r for r in ranges if r[0] == "sample.call"]
    evals = [r for r in ranges if r[0] == "sample.nfe"]
    assert len(calls) == 1 and len(evals) == nfe
    assert all(inside(r, calls[0]) for r in evals)
    spans = tracing.drain()
    assert [s.name for s in spans] == ["sample.call"] + ["sample.nfe"] * nfe
    assert all(s.parent == 0 and s.id == spans[0].id for s in spans[1:])


def test_sampler_calls_are_numbered():
    _, sample = sr_sampler()
    tracing.enable()
    sample()
    sample()
    calls = [s.id for s in tracing.drain() if s.name == "sample.call"]
    assert calls[1] == calls[0] + 1


def test_a_train_step_holds_its_parts():
    state, step = train_setup()
    state.step = 5
    tracing.enable()
    _, ranges = profiled(lambda: step(state))
    tracing.disable()
    steps = [r for r in ranges if r[0] == "train.step"]
    assert len(steps) == 1
    parts = [r for r in ranges if r[0] != "train.step"]
    assert [r[0] for r in parts] == ["train.forward", "train.backward", "train.optimizer",
                                     "train.ema"]
    assert all(inside(r, steps[0]) for r in parts)
    spans = tracing.drain()
    assert [(s.name, s.id, s.parent) for s in spans] == [
        ("train.step", 5, -1), ("train.forward", 5, 0), ("train.backward", 5, 0),
        ("train.optimizer", 5, 0), ("train.ema", 5, 0)]


@pytest.mark.parametrize("make", [base_sampler, sr_sampler], ids=["base-dpm", "sr-ddim"])
def test_sampler_outputs_are_bit_identical_with_tracing_on(make):
    _, sample = make()
    off = sample()
    tracing.enable()
    on = sample()
    tracing.disable()
    for a, b in zip(off.values() if isinstance(off, dict) else [off],
                    on.values() if isinstance(on, dict) else [on]):
        assert torch.equal(a, b)


def test_train_step_is_bit_identical_with_tracing_on():
    state, step = train_setup()
    twin = copy.deepcopy(state)
    off = step(state)
    tracing.enable()
    on = step(twin)
    tracing.disable()
    assert all(torch.equal(off[k], on[k]) for k in off)
    for (name, p), q in zip(state.model.named_parameters(), twin.model.parameters()):
        assert torch.equal(p, q), name
    ema, twin_ema = state.ema[next(iter(state.ema))], twin.ema[next(iter(twin.ema))]
    assert all(torch.equal(ema[n], twin_ema[n]) for n in ema)
