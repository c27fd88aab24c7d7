"""The port's evaluation against the JAX package's on the network
checkpoint routes, on the CPU: ``eval_multimodal`` with random-weight I3D
and full-AudioCLIP checkpoints and ``eval_images`` with a random CLIP
visual checkpoint, each written once in the original key layout and read
by both packages (the cheaper routes and the CLIs:
test_torch_port_eval_pipeline.py).

Limits: the embeddings differ only through the torch resize's documented
1-step uint8 difference from OpenCV (evaluation/resize.py); FVD / KVD /
FAD over two clips, differences of nearly equal terms, to 1e-2 relative
(the readings: 5e-5 to 3e-3), the video IS to 1e-3, the AV scores --
cosines of random towers, near 0 -- within 1e-3 of the cosine times the
logit scale; CLIP-FID / KID / precision / recall to 1e-3."""

import numpy as np
import pytest
import torch

from mm_diffusion_tpu.evaluation import evaluator as jax_evaluator
from mm_diffusion_tpu.evaluation import image_eval as jax_image_eval
from mm_diffusion_tpu_torch.evaluation import audioclip, clip_model, evaluator, i3d, image_eval
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_eval_common import assert_metrics_close, av_sets, randomize_eval_  # noqa: F401

LOGIT_SCALE = 30.0


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Random-weight I3D and full-AudioCLIP .pt files in the original key
    layout (the gated audio tower at gain 0.5: larger gains saturate its
    sigmoid gates, where fp32 rounding decides the output)."""
    d = tmp_path_factory.mktemp("ckpts")
    torch.save(randomize_eval_(i3d.InceptionI3d(), 20).state_dict(), d / "i3d.pt")
    tower = randomize_eval_(audioclip.ESResNeXtFBSP(), 21, keep=("fbsp.fc", "fbsp.m", "fbsp.fb"), gain=0.5)
    visual = randomize_eval_(clip_model.CLIPVisualResNet(), 22)
    torch.save({**{f"audio.{k}": v for k, v in tower.state_dict().items()},
                **{f"visual.{k}": v for k, v in visual.state_dict().items()},
                "logit_scale_ai": torch.tensor(np.log(LOGIT_SCALE))}, d / "audioclip.pt")
    return {"i3d": str(d / "i3d.pt"), "audioclip": str(d / "audioclip.pt")}


def test_eval_multimodal_checkpoints_match_jax(av_sets, checkpoints):
    """The reference route: I3D video embeddings and IS, AudioCLIP FAD and
    the AV-CLIP scores, each package reading the same .pt files."""
    kw = dict(eval_num=2, batch_size=2, compute_is=True, i3d_checkpoint=checkpoints["i3d"],
              audioclip_checkpoint=checkpoints["audioclip"], allow_fallback=False)
    got = evaluator.eval_multimodal(av_sets["real"], av_sets["fake"], device="cpu", **kw)
    ref = jax_evaluator.eval_multimodal(av_sets["real"], av_sets["fake"], **kw)
    assert got["protocol"] == "reference" and got["audio_embedder"] == "audioclip"
    assert {"av_clip_score_fake", "video_is"} <= set(got)
    for k in ("av_clip_score_fake", "av_clip_score_real"):  # cosines of random towers: held on their scale
        assert abs(got[k] - ref[k]) <= 1e-3 * LOGIT_SCALE, (k, got[k], ref[k])
        got[k] = ref[k]
    assert_metrics_close(got, ref, 1e-2)


def test_eval_images_clip_route_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    for name in ("ref", "sample"):
        np.savez(tmp_path / f"{name}.npz", arr_0=(rng.random((6, 31, 41, 3)) * 255).astype(np.uint8))
        paths.append(str(tmp_path / f"{name}.npz"))
    visual = randomize_eval_(clip_model.CLIPVisualResNet(), 30)
    torch.save({f"visual.{k}": v for k, v in visual.state_dict().items()}, tmp_path / "clip.pt")
    kw = dict(batch_size=6, nhood_size=2, clip_checkpoint=str(tmp_path / "clip.pt"), allow_fallback=False)
    ref = jax_image_eval.eval_images(*paths, **kw)
    got = image_eval.eval_images(*paths, device="cpu", **kw)
    assert got["protocol"] == "clip"
    assert_metrics_close(got, ref, 1e-3)
