"""Every convolution and linear of the port's MM-UNet computes in bf16 when
the model's compute dtype is bf16 (``dtype="bfloat16"``), as the JAX model
computes every conv in bf16: forward pre-hooks on each ``nn.Conv*d`` and
``nn.Linear`` module, and ``F.conv3d`` / ``F.linear`` patched for the
functional calls of ``models/layers.py`` (the video conv's two 3-d
convolutions, the 1x1 ``pointwise`` conv), record the dtype of every input.
A tiny config that reaches every block kind (ResBlocks with up/down
sampling, every attention site, the heads), forward and backward, on the
CPU."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch_port_common import one_torch_thread  # noqa: F401

from mm_diffusion_tpu_torch.models.mm_unet import MMUNetConfig, MultimodalUNet
from mm_diffusion_tpu_torch.weights import randomize_

CFG = dict(
    video_size=(4, 3, 16, 16),
    audio_size=(1, 1024),
    model_channels=32,
    video_out_channels=6,
    audio_out_channels=2,
    num_res_blocks=1,
    cross_attention_resolutions=(2, 4, 8),
    cross_attention_windows=(1, 4, 8),
    cross_attention_shift=True,
    video_attention_resolutions=(2, 4, 8),
    audio_attention_resolutions=(-1,),
    channel_mult=(1, 2, 3, 4),
    num_heads=2,
    num_head_channels=16,
    resblock_updown=True,
    dtype="bfloat16",
)


@pytest.fixture
def recorded(monkeypatch):
    """(site, input dtype) of every conv and linear call in the test."""
    seen = []
    for name in ("conv1d", "conv2d", "conv3d", "linear"):
        fn = getattr(F, name)

        def wrapped(x, *args, _fn=fn, _name=name, **kwargs):
            seen.append((f"F.{_name}", x.dtype))
            return _fn(x, *args, **kwargs)

        monkeypatch.setattr(F, name, wrapped)
    return seen


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_every_conv_and_linear_gets_bf16(recorded, use_checkpoint):
    model = randomize_(MultimodalUNet(MMUNetConfig(**CFG, use_checkpoint=use_checkpoint)), seed=7)
    modules = [(n, m) for n, m in model.named_modules() if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear))]
    assert len(modules) > 50
    hooked = []
    handles = [
        m.register_forward_pre_hook(lambda mod, args, _n=n: hooked.append((_n, args[0].dtype)))
        for n, m in modules
    ]
    f, c, h, w = CFG["video_size"]
    g = torch.Generator().manual_seed(0)
    video = torch.randn((2, f, h, w, c), generator=g)  # fp32 inputs, as the sampler passes them
    audio = torch.randn((2, CFG["audio_size"][1], 1), generator=g)
    out_v, out_a = model.train()(video, audio, torch.tensor([3, 700]), shift=0)
    (out_v.square().mean() + out_a.square().mean()).backward()
    for hd in handles:
        hd.remove()
    # Modules called as modules and modules whose weights feed a functional
    # call (the video conv's spatial / temporal pair, the 1x1 qkv and output
    # projections) both ran, and every call saw bf16.
    assert len({n for n, _ in hooked}) > 20
    assert {"F.conv1d", "F.conv3d", "F.linear"} <= {site for site, _ in recorded}
    wrong = sorted({site for site, dt in hooked + recorded if dt != torch.bfloat16})
    assert not wrong, f"fp32 (or other) inputs at: {wrong}"
    assert out_v.dtype == out_a.dtype == torch.float32
