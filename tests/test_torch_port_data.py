"""The port's data modules (mm_diffusion_tpu_torch/data/video.py, image.py and
the synthetic SR pairs of scripts/image_sr_train.py) against the JAX
package's, on mp4 fixtures written by OpenCV with .wav sidecars (as
tests/test_video_data.py and tests/test_data_audio.py make them).

Tolerances: 0 -- the clip index, the items and batches of a seed and shard,
resize-pad, the wav reader and resampler, the degradations and the SR
pairs are the same numpy / OpenCV arithmetic, so they must be equal; the
synthetic SR pairs' LR images are torch's bicubic where the JAX package
calls cv2.resize, held to 1e-6 (the same kernel; the border handling
differs, and a 4x downscale never reads past the edge).  Then the port's
own contracts: the missing-audio and dead-worker errors, the shard from
torch.distributed, the error that names OpenCV, and the three CLIs that
now read a dataset directory."""

import os
import random

import numpy as np
import pytest
from torch_port_common import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

from mm_diffusion_tpu.data import image as jimage  # noqa: E402
from mm_diffusion_tpu.data import video as jvideo  # noqa: E402
from mm_diffusion_tpu.scripts import image_sr_train as jsr_cli  # noqa: E402
from mm_diffusion_tpu_torch.data import image as pimage  # noqa: E402
from mm_diffusion_tpu_torch.data import media  # noqa: E402
from mm_diffusion_tpu_torch.data import video as pvideo  # noqa: E402
from mm_diffusion_tpu_torch.scripts import audio2video_sample_sr as a2v_cli  # noqa: E402
from mm_diffusion_tpu_torch.scripts import image_sr_train as psr_cli  # noqa: E402
from mm_diffusion_tpu_torch.scripts import multimodal_train  # noqa: E402
from mm_diffusion_tpu_torch.scripts import video2audio_sample as v2a_cli  # noqa: E402

VIDEO_SIZE, AUDIO_SIZE = (4, 3, 16, 16), (1, 1024)
LOADER = dict(video_size=VIDEO_SIZE, audio_size=AUDIO_SIZE, video_fps=10, audio_fps=8000)


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    """Three tiny 10 fps videos (a brightness ramp, a moving square, 32x24
    so resize-pad pads) with tonal wav sidecars at 16 kHz (resampled to
    8 kHz by the loader)."""
    d = tmp_path_factory.mktemp("vids")
    fps, n_frames = 10, 14
    for vi in range(3):
        writer = cv2.VideoWriter(str(d / f"clip{vi}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), fps, (32, 24))
        assert writer.isOpened()
        for fr in range(n_frames):
            img = np.zeros((24, 32, 3), np.uint8)
            img[:, :, vi % 3] = int(255 * fr / n_frames)
            img[4:12, 2 * fr : 2 * fr + 8] = 200
            writer.write(img)
        writer.release()
        sr = 16000
        tt = np.arange(int(n_frames / fps * sr)) / sr
        tone = 0.5 * np.sin(2 * np.pi * (200 + 100 * vi) * tt).astype(np.float32)
        media.save_audio(tone, str(d / f"clip{vi}.wav"), audio_rate=sr)
    return str(d)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate(((40, 56), (64, 64), (30, 20))):
        cv2.imwrite(str(d / f"img{i}.png"), (rng.rand(h, w, 3) * 255).astype(np.uint8))
    return str(d)


def _equal_batches(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the video dataset ----------------------------------------------------------


def test_file_list_and_clip_index_match_jax(video_dir, tmp_path):
    files = pvideo.list_video_files(video_dir)
    assert files == jvideo.list_video_files(video_dir) and len(files) == 3
    p_cache, j_cache = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    clips = pvideo.build_clip_index(files, 4, 10, p_cache)
    assert clips == jvideo.build_clip_index(files, 4, 10, j_cache)
    assert len(clips) == 3 * 11
    with open(p_cache) as f, open(j_cache) as g:
        assert f.read() == g.read()
    assert pvideo.build_clip_index(files, 4, 10, p_cache) == clips  # from the cache
    with open(p_cache, "w") as f:
        f.write('{"files": [')  # a torn write is rebuilt
    assert pvideo.build_clip_index(files, 4, 10, p_cache) == clips
    # short videos pad at decode; a target fps above the native one repeats frames
    assert pvideo.build_clip_index(files, 20, 10, None) == jvideo.build_clip_index(files, 20, 10, None)
    assert pvideo.build_clip_index(files, 4, 25, None) == jvideo.build_clip_index(files, 4, 25, None)


def test_resize_pad_and_audio_helpers_match_jax(video_dir):
    frames = np.random.RandomState(1).randint(0, 255, (2, 20, 40, 3)).astype(np.uint8)
    for size in ((32, 32), (16, 24), (40, 8)):
        np.testing.assert_array_equal(pvideo.resize_pad_video(frames, *size),
                                      jvideo.resize_pad_video(frames, *size))
    path = os.path.join(video_dir, "clip1.wav")
    (a, sr), (b, sr_j) = pvideo.read_wav(path), jvideo.read_wav(path)
    assert sr == sr_j == 16000
    np.testing.assert_array_equal(a, b)
    for sr_out in (8000, 16000, 44100):
        np.testing.assert_array_equal(pvideo.resample_audio(a, sr, sr_out),
                                      jvideo.resample_audio(b, sr, sr_out))


@pytest.mark.parametrize("shard,num_shards", [(0, 1), (0, 2), (1, 2)])
def test_dataset_items_match_jax(video_dir, shard, num_shards):
    kw = dict(LOADER, shard=shard, num_shards=num_shards, random_flip=True, seed=5)
    p = pvideo.MultimodalVideoDataset(video_dir, **kw)
    j = jvideo.MultimodalVideoDataset(video_dir, **kw)
    assert p.indices == j.indices and len(p) == len(j)
    pit, jit = p.iter_indices(p.indices, 17), j.iter_indices(j.indices, 17)
    for _ in range(6):
        _equal_batches(next(pit), next(jit))
    item = p.get_item(p.indices[-1])
    assert item["video"].shape == (4, 16, 16, 3) and item["audio"].shape == (1024, 1)
    assert float(np.abs(item["audio"]).max()) > 0.1  # the sidecar's tone, not silence


@pytest.mark.parametrize("num_workers", [0, 1])
@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 2)])
def test_load_data_batches_match_jax(video_dir, num_workers, shard, num_shards):
    kw = dict(LOADER, data_dir=video_dir, batch_size=3, num_workers=num_workers,
              shard=shard, num_shards=num_shards, seed=2)
    p, j = pvideo.load_data(**kw), jvideo.load_data(**kw)
    for _ in range(2):
        _equal_batches(next(p), next(j))


def test_synthetic_data_matches_jax():
    kw = dict(data_dir="synthetic", batch_size=2, video_size=VIDEO_SIZE, audio_size=AUDIO_SIZE, seed=3)
    _equal_batches(next(pvideo.load_data(**kw, shard=1, num_shards=2)),
                   next(jvideo.load_data(**kw, shard=1, num_shards=2)))


def test_shard_comes_from_torch_distributed(video_dir, monkeypatch):
    """Without a process group the shard is (0, 1); with one, the rank and
    world size -- the batches of JAX's loader at that shard.  The loader
    asks the parallel layer (``parallel.process_data_shard``, the one
    helper; ``data/video.py`` keeps no copy of it)."""
    from mm_diffusion_tpu_torch.parallel import process_data_shard

    assert process_data_shard() == (0, 1) and not hasattr(pvideo, "data_shard")
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert process_data_shard() == (1, 2)
    kw = dict(LOADER, data_dir=video_dir, batch_size=2, num_workers=0, seed=4)
    _equal_batches(next(pvideo.load_data(**kw)), next(jvideo.load_data(**kw, shard=1, num_shards=2)))


def test_missing_audio_source_is_a_hard_error(tmp_path):
    media.save_video(np.zeros((6, 16, 16, 3), np.float32), str(tmp_path / "mute.mp4"), fps=10)
    ds = pvideo.MultimodalVideoDataset(str(tmp_path), **LOADER)
    with pytest.raises(IOError, match="no audio source"):
        ds.get_item(0)
    it = pvideo.load_data(data_dir=str(tmp_path), batch_size=2, num_workers=2, **LOADER)
    with pytest.raises(IOError, match="no audio source"):
        next(it)


def test_dead_worker_error_surfaces(tmp_path):
    """A worker that hits the missing-audio error stops the batch generator
    while the other worker keeps producing."""
    for name, with_wav in (("good", True), ("mute", False)):
        writer = cv2.VideoWriter(str(tmp_path / f"{name}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (16, 16))
        for _ in range(24):
            writer.write(np.zeros((16, 16, 3), np.uint8))
        writer.release()
        if with_wav:
            media.save_audio(0.5 * np.ones(2400, np.float32), str(tmp_path / f"{name}.wav"), audio_rate=1000)
    gen = pvideo.load_data(data_dir=str(tmp_path), batch_size=2, num_workers=2, **LOADER)
    with pytest.raises(IOError, match="no audio source"):
        for _ in range(64):
            next(gen)


def test_a_folder_without_opencv_names_it(video_dir, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        pvideo.MultimodalVideoDataset(video_dir, **LOADER)
    with pytest.raises(ImportError, match="cv2"):
        next(pimage.load_sr_data(data_dir=video_dir, batch_size=1, large_size=16, small_size=4))
    next(pvideo.load_data(data_dir="synthetic", batch_size=1, video_size=VIDEO_SIZE, audio_size=AUDIO_SIZE))
    next(psr_cli.synthetic_sr_data(1, 64, 16))


# -- the image datasets -----------------------------------------------------------


def test_image_helpers_and_degradations_match_jax(image_dir):
    assert pimage.list_image_files(image_dir) == jimage.list_image_files(image_dir)
    img = cv2.cvtColor(cv2.imread(pimage.list_image_files(image_dir)[0]), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(pimage.resize_pad_image(img, 32, 32), jimage.resize_pad_image(img, 32, 32))
    for kw in ({}, {"apply_noise": False}, {"apply_jpeg": False}):
        a = pimage.degrade_lr(img, 8, random.Random(3), **kw)
        b = jimage.degrade_lr(img, 8, random.Random(3), **kw)
        assert a.dtype == np.float32 and a.shape == (8, 8, 3)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("degrade", [True, False])
def test_sr_and_image_batches_match_jax(image_dir, degrade):
    kw = dict(data_dir=image_dir, batch_size=3, large_size=32, small_size=8, degrade=degrade, seed=1,
              shard=0, num_shards=1)
    p, j = pimage.load_sr_data(**kw), jimage.load_sr_data(**kw)
    for _ in range(2):
        _equal_batches(next(p), next(j))
    kw = dict(data_dir=image_dir, batch_size=2, image_size=24, seed=2, shard=1, num_shards=2)
    np.testing.assert_array_equal(next(pimage.load_image_data(**kw)), next(jimage.load_image_data(**kw)))


def test_synthetic_sr_pairs_without_opencv_match_jax():
    for large, small in ((64, 16), (256, 64)):
        p, j = next(psr_cli.synthetic_sr_data(3, large, small, 7)), next(jsr_cli.synthetic_sr_data(3, large, small, 7))
        np.testing.assert_array_equal(p["high_res"], j["high_res"])
        assert p["low_res"].dtype == np.float32 and p["low_res"].shape == j["low_res"].shape
        np.testing.assert_allclose(p["low_res"], j["low_res"], rtol=0, atol=1e-6)


# -- the CLIs on a dataset directory ------------------------------------------------

TINY_MM = (
    "--video_size 4,3,16,16 --audio_size 1,1024 --num_channels 16 --num_res_blocks 1 "
    "--cross_attention_resolutions 2 --cross_attention_windows 1 --video_attention_resolutions 2 "
    "--audio_attention_resolutions -1 --channel_mult 1,2 --num_heads 2 --device cpu "
    "--video_fps 10 --audio_fps 8000"
).split()


def test_train_cli_reads_a_dataset_directory(video_dir, tmp_path):
    loop = multimodal_train.main(TINY_MM + [
        "--data_dir", video_dir, "--batch_size", "2", "--num_workers", "2", "--max_steps", "2",
        "--log_interval", "1", "--output_dir", str(tmp_path / "run"),
    ])
    assert loop.state.step == 2 and all(np.isfinite(r["loss"]) for r in loop.history)
    assert set(loop.last_batch) == {"video", "audio"}
    assert tuple(loop.last_batch["video"].shape) == (2, 4, 16, 16, 3)


@pytest.mark.parametrize("cli,prefix", [(a2v_cli, "a2v"), (v2a_cli, "v2a")])
def test_conditional_clis_read_a_dataset_directory(video_dir, tmp_path, monkeypatch, cli, prefix):
    """The ground truth of a conditional CLI is the loader's first batch
    (JAX's loader at the same seed, shard 0 of 1, no workers)."""
    seen = []
    real = cli.run_conditional.__globals__["load_data"]

    def spy(**kw):
        gen = real(**kw)
        for batch in gen:
            seen.append(batch)
            yield batch

    monkeypatch.setitem(cli.run_conditional.__globals__, "load_data", spy)
    args = (TINY_MM + ["--channel_mult", "1,2,3,4", "--num_head_channels", "8", "--resblock_updown", "True",
                       "--timestep_respacing", "3", "--sample_num", "1", "--data_dir", video_dir,
                       "--output_dir", str(tmp_path), "--sr_model_path", "", "--seed", "5"])
    result = cli.main(args)
    assert result["samples"]["video"].shape == (1, 4, 16, 16, 3)
    assert any(os.path.basename(p).startswith(f"{prefix}_00000_gt") for p in result["paths"])
    ref = next(jvideo.load_data(data_dir=video_dir, batch_size=1, num_workers=0, shard=0, num_shards=1,
                                seed=5, **LOADER))
    _equal_batches(seen[0], ref)


def test_sr_train_cli_reads_an_image_folder(image_dir, tmp_path):
    loop = psr_cli.main([
        "--device", "cpu", "--data_dir", image_dir, "--large_size", "64", "--small_size", "16",
        "--sr_num_channels", "16", "--sr_num_res_blocks", "1", "--sr_attention_resolutions", "8",
        "--sr_num_head_channels", "16", "--batch_size", "2", "--max_steps", "1", "--log_interval", "1",
        "--sr_diffusion_steps", "100", "--output_dir", str(tmp_path),
    ])
    assert loop.state.step == 1 and np.isfinite(loop.history[0]["loss"])
    assert set(loop.last_batch) == {"high_res", "low_res", "sr_bicubic"}
    assert tuple(loop.last_batch["low_res"].shape) == (2, 16, 16, 3)
