"""The port's AudioCLIP networks (evaluation/audioclip.py, clip_model.py)
against the JAX package's flax towers on the CPU, fp32, in both weight
directions: the ESResNeXt-FBSP audio tower at the evaluator's 1.6 s of
44.1 kHz (70560 samples), CLIP's visual ResNet-50 at 64^2 (the JAX suite's
size; the port sizes the positional embedding from input_resolution), the
text tower at a narrow width, and the AV scorer's scores.

Limits, the JAX suite's: the audio tower rtol 5e-3, atol 5e-3 * max|out|
(tests/test_audioclip_parity.py); CLIP visual and text rtol 3e-3, atol
3e-3 * max (tests/test_clip_parity.py); the AV score's formula 1e-4
relative (tests/test_clip_parity.py), the packages' AV scores within 1e-4
of the cosine (times the logit scale); the
front end's power spectrum rtol 1e-4, atol 1e-6 * its max (fp32 sums of
2048 products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_diffusion_tpu.evaluation import audioclip as jax_audioclip
from mm_diffusion_tpu.evaluation import clip_model as jax_clip
from mm_diffusion_tpu_torch.evaluation import audioclip, clip_model
from mm_diffusion_tpu_torch.evaluation.common import load_weights
from mm_diffusion_tpu_torch.weights import (
    audioclip_audio_state_dict_from_jax,
    clip_text_state_dict_from_jax,
    clip_visual_state_dict_from_jax,
)
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_eval_common import assert_close_scaled, randomize_eval_, random_flax_variables, state_dict_np

FBSP_KEEP = ("fbsp.fc",)  # the centre frequencies keep their arange
# spline order small and positive, bandwidths in (0.1, 1): the trained tower's ranges
FBSP_SPECIAL = {
    "fbsp_m": lambda rng, shape: rng.rand(*shape) * 0.5,
    "fbsp_fb": lambda rng, shape: rng.rand(*shape) * 0.9 + 0.1,
    "fbsp_fc": lambda rng, shape: np.arange(shape[0], dtype=np.float32),
}


TOWER_GAIN = 0.5  # larger gains make the gates ill-conditioned: fp32 rounding of the dB input moves them


def _randomize_tower(model, seed):
    randomize_eval_(model, seed, keep=FBSP_KEEP, gain=TOWER_GAIN)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        model.fbsp.m.copy_(torch.rand(model.fbsp.m.shape, generator=g) * 0.5)
        model.fbsp.fb.copy_(torch.rand(model.fbsp.fb.shape, generator=g) * 0.9 + 0.1)
    return model


@pytest.fixture(scope="module")
def audio():
    return np.random.RandomState(2).uniform(-1, 1, (2, 1, 70560)).astype(np.float32)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_audio_tower_matches_jax(direction, audio):
    flax_model = jax_audioclip.ESResNeXtFBSP()
    if direction == "port_to_jax":
        model = _randomize_tower(audioclip.ESResNeXtFBSP(), 0)
        variables = jax_audioclip.convert_audioclip_audio_tower(state_dict_np(model), prefix="")
    else:
        variables = random_flax_variables(flax_model, 4, audio[:, :, :22050], special=FBSP_SPECIAL,
                                          gain=TOWER_GAIN)
        model = load_weights(audioclip.ESResNeXtFBSP(), audioclip_audio_state_dict_from_jax(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(audio)).numpy()
    ref = np.asarray(jax.jit(flax_model.apply)(variables, audio))
    assert got.shape == (2, 1024)
    assert_close_scaled(got, ref, 5e-3)


def test_fbsp_spectrogram_matches_jax():
    """The front end alone (int16 scaling, framing, FBSP matmuls, bands,
    dB) against the JAX pieces, stereo, at a length that pads the frames."""
    model = _randomize_tower(audioclip.ESResNeXtFBSP(), 5)
    x = np.random.RandomState(6).uniform(-1, 1, (1, 2, 22000)).astype(np.float32)
    with torch.no_grad():
        got = model.spectrogram(torch.from_numpy(x)).numpy()
    sig = jax_audioclip.scale_int16_range(jnp.asarray(x.reshape(2, -1)))
    # the int16 scaling keeps ~3e-5 of signal around 1.0: it must round as
    # JAX's true division does, bit for bit (CUDA's scalar division would not)
    np.testing.assert_array_equal(audioclip.scale_int16_range(torch.from_numpy(x.reshape(2, -1))).numpy(),
                                  np.asarray(sig))
    frames = jax_audioclip.frame_signal(sig, 1654, 561, jnp.asarray(jax_audioclip.blackmanharris_window(1654)))
    frames = jnp.pad(frames, ((0, 0), (0, 0), (197, 197)))
    w_re, w_im = jax_audioclip.fbsp_weights(*(jnp.asarray(getattr(model.fbsp, n).detach().numpy()) for n in ("m", "fb", "fc")),
                                            2048, normalized=True)
    pow_spec = jnp.swapaxes((frames @ w_re.T) ** 2 + (frames @ w_im.T) ** 2, -1, -2)[:, :1023]
    ref = np.asarray(pow_spec).reshape(2, 3, 341, -1)
    got = 10 ** (got.astype(np.float64) / 10)  # back to power: dB is ill-conditioned where power is tiny
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_clip_visual_matches_jax(direction):
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    flax_model = jax_clip.CLIPVisualResNet()
    if direction == "port_to_jax":
        model = randomize_eval_(clip_model.CLIPVisualResNet(input_resolution=64), 0)
        variables = jax_clip.convert_clip_visual(state_dict_np(model, "visual."))
    else:
        variables = random_flax_variables(flax_model, 7, x)
        model = load_weights(clip_model.CLIPVisualResNet(input_resolution=64),
                             clip_visual_state_dict_from_jax(variables, prefix="visual."), prefix="visual.")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(flax_model.apply)(variables, x))
    assert got.shape == (2, 1024)
    assert_close_scaled(got, ref, 3e-3)


TEXT = dict(vocab_size=100, context_length=16, width=32, heads=4, layers=2, embed_dim=64)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_clip_text_matches_jax(direction):
    tokens = np.random.RandomState(1).randint(1, 99, size=(3, 16)).astype(np.int64)
    tokens[:, -1] = 99  # the highest id is the end-of-text token
    tokens[1, 9], tokens[1, 10:] = 99, 0  # a shorter text: pooled at its eot, not the last slot
    flax_model = jax_clip.CLIPTextEncoder(**TEXT)
    if direction == "port_to_jax":
        model = randomize_eval_(clip_model.CLIPTextEncoder(**TEXT), 1)
        variables = jax_clip.convert_clip_text(state_dict_np(model), layers=2)
    else:
        variables = random_flax_variables(flax_model, 8, jnp.asarray(tokens, jnp.int32))
        model = load_weights(clip_model.CLIPTextEncoder(**TEXT), clip_text_state_dict_from_jax(variables, layers=2))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    ref = np.asarray(jax.jit(flax_model.apply)(variables, jnp.asarray(tokens, jnp.int32)))
    assert got.shape == (3, 64)
    assert_close_scaled(got, ref, 3e-3)


def test_av_scorer_matches_jax():
    """The same towers' AV scores, raw audio embeddings and per-frame video
    embeddings through both scorers (64^2 frames resized to 224 bicubically:
    torch here, OpenCV in JAX, within 1 in uint8)."""
    rng = np.random.RandomState(2)
    audio = rng.uniform(-1, 1, (2, 22050, 1)).astype(np.float32)
    video = rng.randint(0, 256, (2, 3, 64, 64, 3)).astype(np.uint8)
    tower = _randomize_tower(audioclip.ESResNeXtFBSP(), 9)
    visual = randomize_eval_(clip_model.CLIPVisualResNet(layers=(1, 1, 1, 1)), 10)
    scorer = clip_model.AudioCLIPScorer(tower, visual, np.log(50.0), device="cpu")
    jax_scorer = jax_clip.AudioCLIPScorer(
        jax_audioclip.ESResNeXtFBSP(), jax_audioclip.convert_audioclip_audio_tower(state_dict_np(tower), prefix=""),
        jax_clip.CLIPVisualResNet(layers=(1, 1, 1, 1)),
        jax_clip.convert_clip_visual(state_dict_np(visual, "visual."), layers=(1, 1, 1, 1)), np.log(50.0))
    assert scorer.scale_ai == pytest.approx(jax_scorer.scale_ai, rel=1e-6)
    assert_close_scaled(scorer.embed_audio(audio), jax_scorer.embed_audio(audio), 5e-3)
    raw, normed = scorer.embed_video(video)
    jraw, jnormed = jax_scorer.embed_video(video)
    assert_close_scaled(raw, jraw, 3e-3)
    scores = scorer.av_scores(audio, video)
    a = scorer.embed_audio(audio)
    a_hat = a / np.linalg.norm(a, axis=-1, keepdims=True)
    np.testing.assert_allclose(scores, 50.0 * np.sum(a_hat * normed, axis=-1), rtol=1e-4, atol=1e-5)
    # random towers give near-orthogonal embeddings (cosines ~1e-3), so the
    # packages' scores are held on the cosine's scale: within 1e-4 of it
    np.testing.assert_allclose(scores, jax_scorer.av_scores(audio, video), rtol=0, atol=1e-4 * 50.0)


def test_full_checkpoint_loads_by_the_original_keys(tmp_path):
    """A full AudioCLIP .pt (audio.*, visual.*, logit_scale_ai and the text
    keys the scorer leaves) loads into the scorer without a converter; a
    checkpoint missing a key the towers need is refused by name."""
    tower = _randomize_tower(audioclip.ESResNeXtFBSP(), 11)
    visual = randomize_eval_(clip_model.CLIPVisualResNet(), 12)
    sd = {**{f"audio.{k}": v for k, v in tower.state_dict().items()},
          **{f"visual.{k}": v for k, v in visual.state_dict().items()},
          "logit_scale_ai": torch.tensor(np.log(20.0)), "logit_scale": torch.tensor(1.0),
          "token_embedding.weight": torch.zeros(4, 2)}
    torch.save(sd, tmp_path / "audioclip.pt")
    scorer = clip_model.load_audioclip_full(str(tmp_path / "audioclip.pt"), device="cpu")
    assert scorer.scale_ai == pytest.approx(20.0, rel=1e-5)
    for k, v in visual.state_dict().items():
        assert torch.equal(scorer.visual.state_dict()[k], v)
    del sd["visual.attnpool.c_proj.weight"]
    torch.save(sd, tmp_path / "broken.pt")
    with pytest.raises(KeyError, match="attnpool.c_proj.weight"):
        clip_model.load_audioclip_full(str(tmp_path / "broken.pt"), device="cpu")
