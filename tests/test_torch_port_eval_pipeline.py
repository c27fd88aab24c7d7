"""The port's evaluation entry points against the JAX package's on the same
npz fixtures, on the CPU: ``eval_multimodal`` on the fallback route,
``eval_images`` on the pixel and frozen-graph routes (the network
checkpoint routes: test_torch_port_eval_checkpoints.py),
``video_inception_score_c3d``, the CLIs ``scripts/eval.py``,
``image_eval.py`` and ``video_is.py``, and the sampling CLI's
``--save_type npz --run_eval`` (also on two gloo ranks, where only rank 0
writes and evaluates).

Limits.  The embeddings differ only through the torch resize's documented
1-step uint8 difference from OpenCV (bicubic: ~0.1% of pixels, bilinear:
~12%; evaluation/resize.py); everything after them is the same fp32 /
float64 arithmetic.  The metrics are held to 1e-3 relative (the C3D IS
too); FAD on the log-mel route, which no resize touches, to 1e-9."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from mm_diffusion_tpu.evaluation import c3d as jax_c3d
from mm_diffusion_tpu.evaluation import evaluator as jax_evaluator
from mm_diffusion_tpu.evaluation import image_eval as jax_image_eval
from mm_diffusion_tpu.evaluation.npz_batch import load_av_npz_batch as jax_load_av_npz_batch
from mm_diffusion_tpu.scripts import eval as jax_eval_cli
from mm_diffusion_tpu.scripts import image_eval as jax_image_eval_cli
from mm_diffusion_tpu.scripts import video_is as jax_video_is_cli
from mm_diffusion_tpu_torch.evaluation import c3d, evaluator, image_eval
from mm_diffusion_tpu_torch.scripts import eval as eval_cli
from mm_diffusion_tpu_torch.scripts import image_eval as image_eval_cli
from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr
from mm_diffusion_tpu_torch.scripts import video_is as video_is_cli
from test_c3d import _fake_weights, _save_npz
from test_graphdef import _mini_inception
from test_torch_port_sampling import CLI_ARGS
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_eval_common import assert_metrics_close, av_sets  # noqa: F401
from torch_port_parallel_worker import Launch

@pytest.fixture(scope="module")
def c3d_files(tmp_path_factory):
    """C3D weights and a clip mean in chainer's npz."""
    d = tmp_path_factory.mktemp("c3d")
    rng = np.random.default_rng(23)
    _save_npz(d / "c3d.npz", _fake_weights(rng))
    np.savez(d / "mean2.npz", mean=rng.uniform(0, 255, (3, 16, 128, 171)).astype(np.float32))
    return str(d / "c3d.npz"), str(d / "mean2.npz")


def test_eval_multimodal_fallback_matches_jax(av_sets):
    kw = dict(eval_num=4, batch_size=2)
    got = evaluator.eval_multimodal(av_sets["real"], av_sets["fake"], device="cpu", **kw)
    ref = jax_evaluator.eval_multimodal(av_sets["real"], av_sets["fake"], **kw)
    assert got["protocol"] == "fallback"
    assert_metrics_close(got, ref, 1e-3, exact=("fad",))
    with pytest.raises(RuntimeError, match="I3D"):
        evaluator.eval_multimodal(av_sets["real"], av_sets["fake"], allow_fallback=False, device="cpu", **kw)


@pytest.fixture(scope="module")
def image_sets(tmp_path_factory):
    d = tmp_path_factory.mktemp("image_sets")
    rng = np.random.default_rng(1)
    for name in ("ref", "sample"):
        np.savez(d / f"{name}.npz", arr_0=(rng.random((6, 31, 41, 3)) * 255).astype(np.uint8))
    return str(d / "ref.npz"), str(d / "sample.npz"), d


@pytest.mark.parametrize("route", ["fallback", "inception"])
def test_eval_images_matches_jax(image_sets, route, tmp_path):
    """The pixel-statistics and frozen-graph routes (the CLIP route:
    test_torch_port_eval_checkpoints.py)."""
    ref_path, sample_path, _ = image_sets
    kw = dict(batch_size=6, nhood_size=2)  # one batch per set: one JAX compile
    if route == "inception":
        (tmp_path / "graph.pb").write_bytes(_mini_inception(np.random.default_rng(4))[1])
        kw["inception_pb"] = str(tmp_path / "graph.pb")
    ref = jax_image_eval.eval_images(ref_path, sample_path, **kw)
    got = image_eval.eval_images(ref_path, sample_path, device="cpu", **kw)
    assert got["protocol"] == {"fallback": "fallback", "inception": "openai"}[route]
    assert_metrics_close(got, ref, 1e-3)


def _json_out(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_eval_cli_matches_jax(av_sets, tmp_path):
    argv = ["--ref_dir", av_sets["real"], "--fake_dir", av_sets["fake"], "--sample_num", "4", "--batch_size", "2",
            "--allow_fallback"]
    got = _json_out(eval_cli.main, argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    ref = _json_out(jax_eval_cli.main, argv + ["--output_dir", str(tmp_path / "jax")])
    assert_metrics_close(got, ref, 1e-3, exact=("fad",))
    if not torch.cuda.is_available():  # --device defaults to cuda, never to a silent CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_cli.main(argv + ["--output_dir", str(tmp_path / "cuda")])


def test_image_eval_cli_matches_jax(image_sets, tmp_path):
    ref_path, sample_path, _ = image_sets
    (tmp_path / "graph.pb").write_bytes(_mini_inception(np.random.default_rng(4))[1])
    argv = [ref_path, sample_path, "--inception_pb", str(tmp_path / "graph.pb"), "--batch_size", "6"]
    got = _json_out(image_eval_cli.main, argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    ref = _json_out(jax_image_eval_cli.main, argv + ["--output_dir", str(tmp_path / "jax")])
    assert got["protocol"] == "openai"
    assert_metrics_close(got, ref, 1e-3)


def test_video_is_cli_and_c3d_score_match_jax(av_sets, c3d_files, tmp_path):
    argv = [av_sets["fake"], "--c3d_npz", c3d_files[0], "--mean", c3d_files[1], "--batch_size", "1"]
    got = _json_out(video_is_cli.main, argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    ref = _json_out(jax_video_is_cli.main, argv + ["--output_dir", str(tmp_path / "jax")])
    assert got["clips"] == ref["clips"] == 2 and got["protocol"] == ref["protocol"]
    assert got["video_is"] == pytest.approx(ref["video_is"], rel=1e-3)
    videos = jax_load_av_npz_batch(av_sets["real"])[0]
    args = (videos, *c3d_files)
    assert c3d.video_inception_score_c3d(*args, batch_size=2, device="cpu") == pytest.approx(
        jax_c3d.video_inception_score_c3d(*args, batch_size=2), rel=1e-3)


SMALL_EVAL = dict(eval_num=2, batch_size=2)


def test_sampling_cli_npz_and_run_eval_match_jax(av_sets, tmp_path, monkeypatch):
    """``--save_type npz --run_eval --ref_path``: one batch file that the JAX
    package reads with JAX's CLI's keys, shapes and dtypes, and the metrics
    of JAX's eval_multimodal on it.  The CLI evaluates with the JAX CLI's
    defaults (2048 clips per side); the test cuts that to 2 by wrapping the
    evaluator, as a CPU run of 2048 protocol clips would take minutes."""
    calls = []

    def small_eval(real, fake, **kw):
        calls.append((real, fake, kw))
        return evaluator.eval_multimodal(real, fake, **kw, **SMALL_EVAL)

    monkeypatch.setattr(multimodal_sample_sr, "eval_multimodal", small_eval)
    result = multimodal_sample_sr.main(CLI_ARGS + [
        "--output_dir", str(tmp_path), "--save_type", "npz", "--run_eval", "True",
        "--ref_path", av_sets["real"], "--sample_num", "2", "--batch_size", "2"])
    (npz_path,) = result["paths"]
    assert os.path.basename(npz_path) == "dpm_solver_samples_2.npz"
    assert calls == [(av_sets["real"], npz_path, {"device": torch.device("cpu")})]
    with np.load(npz_path) as z:
        layout = {k: (z[k].dtype, z[k].shape) for k in z.files}
    assert layout == {"arr_0": (np.uint8, (2, 4, 64, 64, 3)), "audio": (np.float32, (2, 1024, 1)),
                      "video_fps": (np.float32, ()), "audio_fps": (np.int32, ()),
                      "video_base": (np.float32, (2, 4, 16, 16, 3))}
    videos, audio, video_fps, audio_fps = jax_load_av_npz_batch(npz_path)
    np.testing.assert_array_equal(videos, ((result["samples"]["sr_video"] + 1) * 127.5).clip(0, 255)
                                  .astype(np.uint8))
    np.testing.assert_array_equal(audio, result["samples"]["audio"])
    assert (video_fps, audio_fps) == (10.0, 16000)
    ref = jax_evaluator.eval_multimodal(av_sets["real"], npz_path, **SMALL_EVAL)
    assert_metrics_close(result["metrics"], ref, 1e-3, exact=("fad",))


def test_sampling_cli_npz_on_two_ranks_writes_once(av_sets, tmp_path):
    """Under --n_sample_data 2 on two gloo ranks, rank 0 alone writes the
    batch file (both ranks' clips) and the other rank writes nothing."""
    argv = CLI_ARGS + ["--save_type", "npz", "--sample_num", "2", "--batch_size", "2"]
    torch.save({"sample_argvs": {"npz": argv}}, tmp_path / "init.pt")
    ranks = Launch("sample", tmp_path, 2, tmp_path / "out").results()
    one = multimodal_sample_sr.main(argv + ["--output_dir", str(tmp_path / "one")])
    assert ranks[1]["npz"]["paths"] == []
    (path,) = ranks[0]["npz"]["paths"]
    written = [f for f in os.listdir(tmp_path / "out" / "npz") if f.endswith(".npz")]
    assert written == [os.path.basename(path)] == [os.path.basename(p) for p in one["paths"]]
    with np.load(path) as got, np.load(one["paths"][0]) as ref:
        assert sorted(got.files) == sorted(ref.files)
        assert got["arr_0"].shape == (2, 4, 64, 64, 3)
        for k in ref.files:  # the ranks' samples equal one process's within 1e-5: uint8 within a step
            np.testing.assert_allclose(got[k].astype(np.float32), ref[k].astype(np.float32), rtol=0,
                                       atol=1.0 if k == "arr_0" else 1e-5, err_msg=k)
