"""The plain reference against the port at tiny sizes on the CPU, both in
float32 (the port on its plain paths): the same ``state_dict`` keys, the
same evaluations with the same seeded weights and RS-MMA shifts, and the
same samples and train steps through the benchmark's own drivers."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import calibrate
from benchmark.reference.image_unet import SRConfig, SRUNet
from benchmark.reference.mm_unet import MMConfig, MMUNet
from benchmark.tests import tiny
from benchmark.weights import load_seeded_


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_mm():
    from mm_diffusion_tpu_torch import configs
    from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet

    return MultimodalUNet(configs.create_model_config(**tiny.MM))


def _port_sr():
    from mm_diffusion_tpu_torch import configs
    from mm_diffusion_tpu_torch.models.image_unet import ImageSuperResModel

    return ImageSuperResModel(configs.create_image_sr_config(**tiny.SR))


def _shapes(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_state_dict_keys_and_shapes_are_the_ports():
    assert _shapes(MMUNet(MMConfig.from_flags(tiny.MM))) == _shapes(_port_mm())
    assert _shapes(SRUNet(SRConfig.from_flags(tiny.SR))) == _shapes(_port_sr())


def test_mm_evaluation_matches_the_port():
    port = load_seeded_(_port_mm().eval(), 5)
    ref = load_seeded_(MMUNet(MMConfig.from_flags(tiny.MM)), 5)
    g = torch.Generator().manual_seed(0)
    video, audio = torch.randn(2, 4, 16, 16, 3, generator=g), torch.randn(2, 1024, 1, generator=g)
    t = torch.tensor([3, 900])
    with torch.no_grad():
        pv, pa = port(video, audio, t, shift=torch.Generator().manual_seed(9))
        rv, ra = ref(video, audio, t, torch.Generator().manual_seed(9))
        other, _ = ref(video, audio, t, torch.Generator().manual_seed(10))
    assert torch.allclose(pv, rv, rtol=1e-5, atol=1e-5)
    assert torch.allclose(pa, ra, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(pv, other, rtol=1e-3, atol=1e-3)  # the shifts matter


def test_sr_evaluation_matches_the_port():
    port = load_seeded_(_port_sr().eval(), 6)
    ref = load_seeded_(SRUNet(SRConfig.from_flags(tiny.SR)), 6)
    g = torch.Generator().manual_seed(1)
    x, low = torch.randn(2, 64, 64, 3, generator=g), torch.rand(2, 16, 16, 3, generator=g)
    t = torch.tensor([10, 700])
    with torch.no_grad():
        assert torch.allclose(port(x, t, low), ref(x, t, low), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("workload", ["sr-ddim25-clip", "base-dpm20-b8"])
def test_samplers_match_the_port(workload):
    config, traffic = tiny.cell(workload)
    got = calibrate.readings(tiny.spec(), workload, 3, torch.device("cpu"), False, False,
                             config=config, traffic=traffic)
    assert all(v < 1e-5 for v in got["program"].values()), got


def test_train_steps_match_the_port():
    config, traffic = tiny.cell("mm-train-b4")
    out = calibrate.readings(tiny.spec(), "mm-train-b4", 4, torch.device("cpu"), False, False,
                             config=config, traffic=traffic)
    got = out["program"]
    assert out["info"]["program"]["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4, out
    # Adam's first steps move each weight by about lr * sign(g): an element
    # whose gradient is near zero rounds either way, in float32 too
    assert got["update_gap"] < 1e-3 and got["ema_gap"] < 1e-3 and got["window_update_gap"] < 1e-3, out


def test_mm_config_reads_every_flag_it_needs():
    cfg = MMConfig.from_flags(tiny.MM)
    assert dataclasses.asdict(cfg)["cross_attention_windows"] == (1, 4, 8)
