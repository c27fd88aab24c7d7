"""The port's logger sinks (mm_diffusion_tpu_torch/utils/logger.py) against
the JAX package's: TensorBoard scalars written and read back; wandb
streaming against a stub module (as tests/test_wandb_logging.py does: the
init arguments, the scalars with their step, media by extension), with the
same calls as JAX's logger on the same input; without wandb the same
degraded behaviour; the train loop's preview hook; and the train CLIs'
``--use_db``, which now streams instead of raising.  Exact comparisons."""

import sys
import types

import numpy as np
import pytest
from torch_port_common import one_torch_thread  # noqa: F401

from mm_diffusion_tpu.utils import logger as jlogger
from mm_diffusion_tpu_torch.scripts import multimodal_train
from mm_diffusion_tpu_torch.train import TrainLoop
from mm_diffusion_tpu_torch.utils import logger as plogger

TINY_ARGV = (
    "--video_size 2,3,8,8 --audio_size 1,128 --num_channels 16 --num_res_blocks 1 "
    "--cross_attention_resolutions 2 --cross_attention_windows 1 --video_attention_resolutions 2 "
    "--audio_attention_resolutions -1 --channel_mult 1,2 --num_heads 2 --batch_size 2 "
    "--diffusion_steps 100 --device cpu --log_interval 1 --sample_fn ddim"
).split()


class _StubWandb(types.ModuleType):
    def __init__(self):
        super().__init__("wandb")
        self.init_calls = []
        self.log_calls = []

    def init(self, **kw):
        self.init_calls.append(kw)
        return types.SimpleNamespace(**kw)

    def log(self, payload, step=None):
        self.log_calls.append((payload, step))

    def Video(self, path):
        return ("video", path)

    def Image(self, path):
        return ("image", path)

    def Audio(self, path):
        return ("audio", path)


@pytest.fixture
def stub(monkeypatch):
    mod = _StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


@pytest.fixture(autouse=True)
def reset_default_logger():
    yield
    plogger.configure(None, stdout=False)


def _drive(lg, media_dir):
    """The same calls on either logger; returns what they returned."""
    out = [lg.enable_wandb("landscape_runs", name="run_a")]
    lg.logkv("step", 42)
    lg.logkv_mean("loss", 0.5)
    lg.logkv_mean("loss", 1.5)
    out.append(lg.dumpkvs())
    lg.logkv("grad_norm", 2.0)  # no step key -> step None
    out.append(lg.dumpkvs())
    for ext in ("mp4", "gif", "png", "jpg", "wav", "txt"):
        path = media_dir / f"preview.{ext}"
        path.write_bytes(b"x")
        out.append(lg.log_media(str(path), step=7))
    out.append(lg.log_media(str(media_dir / "missing.mp4")))
    return out


def test_wandb_streams_as_jax_does(stub, tmp_path):
    got = _drive(plogger.KVLogger(stdout=False), tmp_path)
    calls = (list(stub.init_calls), list(stub.log_calls))
    stub.init_calls.clear()
    stub.log_calls.clear()
    ref = _drive(jlogger.KVLogger(stdout=False), tmp_path)
    assert got == ref
    assert calls == (stub.init_calls, stub.log_calls)
    assert calls[0][0]["project"] == "landscape_runs" and calls[0][0]["name"] == "run_a"
    assert calls[1][0] == ({"step": 42.0, "loss": 1.0}, 42)
    assert [next(iter(p.values()))[0] for p, _ in calls[1][2:]] == ["video", "video", "image", "image", "audio"]


def test_without_wandb_degrades_as_jax_does(monkeypatch, tmp_path, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import -> ImportError
    got = _drive(plogger.KVLogger(stdout=True), tmp_path)
    port_out = capsys.readouterr().out
    ref = _drive(jlogger.KVLogger(stdout=True), tmp_path)
    assert got == ref and got[0] is False and not any(got[3:])
    assert port_out == capsys.readouterr().out  # the same notice and tables


def test_tensorboard_scalars_are_written(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    lg = plogger.configure(str(tmp_path), stdout=False, tensorboard=True)
    for step, loss in ((1, 0.5), (2, 0.25)):
        lg.logkv("step", step)
        lg.logkv_mean("loss", loss)
        lg.dumpkvs()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert {"loss", "step"} <= set(acc.Tags()["scalars"])
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [(1, 0.5), (2, 0.25)]
    assert not (tmp_path / "off").exists()
    plogger.configure(str(tmp_path / "off"), stdout=False)  # off by default
    assert not (tmp_path / "off" / "tb").exists()


def test_preview_hook_streams_the_task_media(stub, tmp_path):
    lg = plogger.configure(str(tmp_path), stdout=False)
    lg.enable_wandb("p")
    preview = tmp_path / "step_000005_grid.mp4"
    preview.write_bytes(b"x")

    class _Task:
        def preview(self, loop, step):
            return str(preview)

    assert TrainLoop.sample_preview(types.SimpleNamespace(task=_Task()), 5) == str(preview)
    assert stub.log_calls[-1] == ({"sample": ("video", str(preview))}, 5)


def test_train_cli_use_db_streams_scalars_and_previews(stub, tmp_path):
    out = tmp_path / "landscape" / "run_b"
    loop = multimodal_train.main(TINY_ARGV + ["--use_db", "True", "--max_steps", "2", "--save_interval", "2",
                                              "--output_dir", str(out)])
    loop.close()
    assert stub.init_calls == [dict(project="landscape", name="run_b", config=None, job_type="training",
                                    reinit=True)]
    scalars = [(p, s) for p, s in stub.log_calls if "loss" in p]
    assert [s for _, s in scalars] == [1, 2] and all(np.isfinite(p["loss"]) for p, _ in scalars)
    media = [p["sample"] for p, _ in stub.log_calls if "sample" in p]
    assert len(media) == 1 and media[0][1].endswith(("_grid.mp4", "_grid.gif"))


def test_train_cli_use_db_without_wandb_trains(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "wandb", None)
    loop = multimodal_train.main(TINY_ARGV + ["--use_db", "True", "--max_steps", "1",
                                              "--output_dir", str(tmp_path)])
    loop.close()
    assert loop.state.step == 1 and np.isfinite(loop.history[0]["loss"])
