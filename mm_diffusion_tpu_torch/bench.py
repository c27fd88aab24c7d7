"""Benchmark of the port: AV-pair throughput of the flagship base + SR
sampling pipeline on one card, per-evaluation latency, and the training
step (counterpart of the JAX package's root ``bench.py``).

    python -m mm_diffusion_tpu_torch.bench            # the card (--device cuda)
    python -m mm_diffusion_tpu_torch.bench --device cpu

Without a card ``--device cuda`` stops; the CPU runs only when asked for,
and its numbers are host-clock times of the plain versions.

Prints the headline JSON line twice: once as soon as the two mandatory
probes (the base chain, the SR chain) finish, and once, with the optional
probes' numbers, at the end, so that an external time limit still finds
the early line.  A line before the last holds the attention kernels'
launches per base evaluation (K1-K3) and per train step (K1-K7): zero on a
card means the wrong path ran.

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

Protocol (:data:`FLAGSHIP`, key for key the JAX bench's):

* base model: the reference's config (128 channels, RS-MMA at 2/4/8 with
  windows 1/4/8 and the shift on, head channels 64, bf16) at batch 8, one
  evaluation ``v <- 0.99 v + 0.1 out`` chained on the last; the SR model
  (192 channels, attention at 32/16/8, learn_sigma, bf16) on one clip's 16
  frames at 256^2, ``x <- 0.9 x + 0.1 out[..., :3]``.  Every parameter is
  0.02: values do not move the time.
* latency: the slope between two eager chain lengths (:func:`time_chained`),
  which removes the per-chain constant (the first launch, the final
  synchronisation) and keeps the host's launch cost per evaluation, which
  the samplers pay too.
* headline: ``1 / (NFE_base * t_base / B + NFE_sr * t_sr)`` pairs/s, the
  20-NFE DPM-Solver base and ddim25 SR per clip (:func:`headline`).
* ``vs_baseline``: the JAX bench's analytic estimate of the PyTorch
  reference on one A100 (312e12 FLOP/s at 0.35 utilisation over the FLOPs
  per pair); the FLOP constants are the model's, from the JAX package's
  cost analysis, not readings of a card.

Optional probes, in order (each records a reason under ``skipped_probes``
when it cannot run, so that none can starve the headline): the train step
(batch 4, remat, AdamW, EMA), training over the real loader (media files
written by ``save_multimodal``, ``load_data`` with 4 workers, the
prefetcher; it needs OpenCV), and the sampling pipeline end to end
(``sample_base_and_sr``).  ``MMDIFF_BENCH_BUDGET_S`` (default 900) is the
wall budget: a probe whose cold-cost estimate exceeds what is left is
skipped.  A mandatory probe that fails ends the run with a non-zero exit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import configs
from .data.media import save_multimodal
from .data.video import load_data, require_cv2
from .models.image_unet import ImageSuperResModel, ImageUNetConfig
from .models.mm_unet import MMUNetConfig, MultimodalUNet, remat_min_tokens
from .ops import block_attention as ba
from .sampling import build_base_sampler, build_sr_sampler, sample_base_and_sr
from .train.loop import _DevicePrefetcher
from .train.state import create_train_state, make_optimizer, make_train_step
from .utils.timing import nvidia_smi_line, resolve_device, sync

METRIC = "AV pairs/sec/chip (64x64x16f base 20-NFE + 64->256 SR ddim25)"
FLOPS_BASE_PER_PAIR_EVAL = 1.468e12  # the JAX package's cost analysis, einsum variant
FLOPS_SR_PER_CLIP_EVAL = 20.11e12  # 16 frames at 256^2, the same analysis
A100_FLOPS, A100_UTIL = 312e12, 0.35  # the analytic baseline's card and utilisation
PARAM_VALUE = 0.02  # every parameter of the timed models

TRAIN_STEPS = 10  # timed train steps after one warm step (two over the real loader)
MEDIA_FILES, MEDIA_FRAMES, MEDIA_SIZE, MEDIA_AUDIO_S = 6, 48, 64, 5  # the real-data probe's files
LOADER_WORKERS = 4

# Cold cost of each optional probe on an H100 (seconds): building its
# models, cuDNN's first calls at its shapes, and its timed work.  A probe
# runs only while the budget has this much left.
EST_TRAIN_S = 60.0
EST_REAL_DATA_S = 60.0
EST_PIPELINE_S = 150.0

K1_K3 = ("self_attention", "banded_attention[lw=1]", "banded_attention[lw>1]")


@dataclasses.dataclass(frozen=True)
class Protocol:
    """What the bench runs: the two models' configs, the base batch, the
    NFEs of the headline, the chain lengths of each slope (short, long), the
    chains timed per length, and the train probe's batch."""

    base: MMUNetConfig
    sr: ImageUNetConfig
    batch: int
    nfe_base: int
    nfe_sr: int
    base_chain: Tuple[int, int]
    sr_chain: Tuple[int, int]
    n_outer: int
    train_batch: int

    @property
    def frames(self) -> int:
        return self.base.video_size[0]

    @property
    def low_size(self) -> int:
        return self.base.video_size[2]

    @property
    def sr_size(self) -> int:
        return self.sr.image_size


FLAGSHIP = Protocol(
    base=configs.create_model_config(
        video_size="16,3,64,64", audio_size="1,25600", num_channels=128, num_res_blocks=2,
        num_head_channels=64, cross_attention_resolutions="2,4,8", cross_attention_windows="1,4,8",
        cross_attention_shift=True, video_attention_resolutions="2,4,8",
        audio_attention_resolutions="-1", use_scale_shift_norm=True, resblock_updown=True,
        use_fp16=True,
    ),
    sr=configs.create_image_sr_config(
        large_size=256, small_size=64, sr_num_channels=192, sr_num_res_blocks=2,
        sr_attention_resolutions="32,16,8", sr_learn_sigma=True, sr_num_head_channels=64,
        sr_use_scale_shift_norm=True, sr_resblock_updown=True, use_fp16=True,
    ),
    batch=8,
    nfe_base=20,
    nfe_sr=25,
    base_chain=(4, 20),
    sr_chain=(5, 25),
    n_outer=2,
    train_batch=4,
)


def fill_params_(model: torch.nn.Module, value: float = PARAM_VALUE) -> torch.nn.Module:
    """Every parameter set to ``value`` (the JAX bench's ``fake_params``)."""
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(value)
    return model


def base_chain_step(model, t: torch.Tensor, shift) -> Callable:
    """One chained base evaluation, ``(v, a) -> (0.99 v + 0.1 out_v, 0.99 a
    + 0.1 out_a)``, at timesteps ``t`` and RS-MMA shift ``shift`` (an int,
    or a host generator that each shifting site draws from)."""

    def step(carry):
        v, a = carry
        vo, ao = model(v, a, t, shift=shift)
        return v * 0.99 + 0.1 * vo.to(v.dtype), a * 0.99 + 0.1 * ao.to(a.dtype)

    return step


def sr_chain_step(model, t: torch.Tensor, low_res: torch.Tensor) -> Callable:
    """One chained SR evaluation, ``x -> 0.9 x + 0.1 out[..., :3]``."""

    def step(x):
        return x * 0.9 + 0.1 * model(x, t, low_res)[..., :3].to(x.dtype)

    return step


def time_chained(fn_one: Callable, init, n_short: int, n_long: int, n_outer: int,
                 sync_fn: Callable[[], None], clock: Callable[[], float] = time.perf_counter) -> float:
    """Seconds per call of ``fn_one(carry) -> carry``: one warm chain of
    ``n_long`` calls, then for each length ``n_outer`` chains, each ended by
    ``sync_fn()`` (a device synchronisation); the slope ``(t_long -
    t_short) / (n_long - n_short)`` of the mean chain times."""

    def chain(n):
        carry = init
        for _ in range(n):
            carry = fn_one(carry)
        sync_fn()

    chain(n_long)
    means = []
    for n in (n_short, n_long):
        t0 = clock()
        for _ in range(n_outer):
            chain(n)
        means.append((clock() - t0) / n_outer)
    return (means[1] - means[0]) / (n_long - n_short)


def headline(base_s: float, sr_s: float, protocol: Protocol) -> Dict[str, float]:
    """Pairs/s from the per-evaluation seconds of the base batch and of one
    SR clip, the base stage alone, and the analytic A100 baseline."""
    t_per_pair = protocol.nfe_base * base_s / protocol.batch + protocol.nfe_sr * sr_s
    flops_per_pair = (protocol.nfe_base * FLOPS_BASE_PER_PAIR_EVAL
                      + protocol.nfe_sr * FLOPS_SR_PER_CLIP_EVAL)
    baseline = A100_FLOPS * A100_UTIL / flops_per_pair
    return {
        "pairs_per_sec": 1.0 / t_per_pair,
        "base_only_pairs_per_sec": protocol.batch / (protocol.nfe_base * base_s),
        "flops_per_pair_total": flops_per_pair,
        "baseline_pairs_per_sec": baseline,
        "vs_baseline": 1.0 / t_per_pair / baseline,
    }


class _Peak:
    """Peak device memory of a probe (``max_memory_allocated``); None on
    the CPU."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    def reset(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)

    def gib(self) -> Optional[float]:
        if self.dev.type != "cuda":
            return None
        return torch.cuda.max_memory_allocated(self.dev) / 2**30


def device_name(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu (host clock, plain versions; not a device measurement)"
    power = nvidia_smi_line().split(",")[-1].strip()
    return f"{torch.cuda.get_device_name(dev)}, power limit {power}"


def _randn(generator, dev, *shape):
    return torch.randn(shape, generator=generator, device=dev)


def _base_inputs(cfg: MMUNetConfig, n: int, generator, dev):
    f, c, h, w = cfg.video_size
    ca, length = cfg.audio_size
    return _randn(generator, dev, n, f, h, w, c), _randn(generator, dev, n, length, ca)


def train_probe(protocol: Protocol, dev: torch.device):
    """The train step at the bench config with ``use_checkpoint`` (batch
    ``train_batch``, AdamW lr 1e-4, EMA 0.9999): one warm step (whose K1-K7
    launches are counted), then TRAIN_STEPS steps ended by fetching the
    loss.  Returns ``(ms per step, launches per step, (state, step fn,
    generators))``."""
    tmodel = MultimodalUNet(dataclasses.replace(protocol.base, use_checkpoint=True)).to(dev).train()
    diffusion = configs.create_gaussian_diffusion(steps=1000, noise_schedule="linear").to(dev)
    state = create_train_state(tmodel, make_optimizer(tmodel, lr=1e-4), ema_rates=(0.9999,))
    step = make_train_step(diffusion, shift=torch.Generator().manual_seed(0))
    gens = (torch.Generator().manual_seed(1), torch.Generator(device=dev).manual_seed(2))
    video, audio = _base_inputs(protocol.base, protocol.train_batch,
                                torch.Generator(device=dev).manual_seed(0), dev)
    batch = {"video": video, "audio": audio}
    ba.reset_launch_counts()
    step(state, batch, *gens)["loss"].item()
    launches = ba.kernel_launches()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics = step(state, batch, *gens)
    metrics["loss"].item()
    ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    return ms, launches, (state, step, gens)


def real_data_probe(protocol: Protocol, dev: torch.device, train_objs) -> Dict[str, float]:
    """Training over the real loader: MEDIA_FILES synthetic clips written by
    ``save_multimodal``, ``load_data`` with LOADER_WORKERS workers, the
    train loop's prefetcher.  Loader batches/s over 4 batches, one host
    batch's copy to the device (MB/s, to a synchronisation), and steps/s
    over TRAIN_STEPS steps after two warm ones."""
    state, step, gens = train_objs
    f, _, h, w = protocol.base.video_size
    media_dir = tempfile.mkdtemp(prefix="bench_media_")
    prefetch = None
    try:
        rng = np.random.RandomState(0)
        for i in range(MEDIA_FILES):
            vid = rng.randint(0, 255, (MEDIA_FRAMES, MEDIA_SIZE, MEDIA_SIZE, 3), np.uint8)
            aud = rng.uniform(-0.5, 0.5, (16000 * MEDIA_AUDIO_S, 1)).astype(np.float32)
            save_multimodal(vid.astype(np.float32) / 127.5 - 1.0, aud,
                            os.path.join(media_dir, f"clip_{i:02d}"), fps=10)
        data = load_data(
            data_dir=media_dir, batch_size=protocol.train_batch, video_size=(f, 3, h, w),
            audio_size=protocol.base.audio_size, video_fps=10.0, audio_fps=16000,
            num_workers=LOADER_WORKERS, shard=0, num_shards=1,
        )
        first = next(data)
        t0 = time.perf_counter()
        for _ in range(4):
            next(data)
        loader_batches_per_sec = 4 / (time.perf_counter() - t0)
        nbytes = sum(v.nbytes for v in first.values())
        t0 = time.perf_counter()
        moved = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
        sync(dev)
        h2d_mbps = nbytes / 1e6 / (time.perf_counter() - t0)
        del moved
        prefetch = _DevicePrefetcher(data, dev)
        for _ in range(2):
            step(state, next(prefetch), *gens)["loss"].item()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            metrics = step(state, next(prefetch), *gens)
        metrics["loss"].item()
        steps_per_sec = TRAIN_STEPS / (time.perf_counter() - t0)
    finally:
        if prefetch is not None:
            prefetch.close()
        shutil.rmtree(media_dir, ignore_errors=True)
    return {
        "train_steps_per_sec_real_data": steps_per_sec,
        "train_data_loader_batches_per_sec": loader_batches_per_sec,
        "host_to_device_MBps": h2d_mbps,
    }


def pipeline_probe(protocol: Protocol, model, sr_model, dev: torch.device) -> Dict[str, float]:
    """``sample_base_and_sr`` end to end: the base DPM-Solver at ``nfe_base``
    and the SR ddim at ``nfe_sr`` on a learn-sigma diffusion respaced to
    it, at the protocol's batch; one warm call, then one timed call."""
    diffusion = configs.create_gaussian_diffusion(steps=1000, noise_schedule="linear")
    sr_diffusion = configs.create_gaussian_diffusion(
        steps=1000, learn_sigma=True, noise_schedule="linear",
        timestep_respacing=f"ddim{protocol.nfe_sr}",
    )
    base = build_base_sampler(model, diffusion, sample_fn="dpm_solver", steps=protocol.nfe_base,
                              shift_generator=torch.Generator().manual_seed(2))
    sr = build_sr_sampler(sr_model, sr_diffusion, sample_fn="ddim", steps=protocol.nfe_sr)
    generator = torch.Generator(device=dev).manual_seed(0)

    def run():
        timings = {}
        t0 = time.perf_counter()
        out = sample_base_and_sr(base, sr, protocol.batch, protocol.sr_size, protocol.frames,
                                 generator=generator, timings=timings)
        sync(dev)
        return time.perf_counter() - t0, timings, out

    run()
    wall, timings, _ = run()
    return {
        "pipeline_pairs_per_sec": protocol.batch / wall,
        "pipeline_base_s": timings["base_s"],
        "pipeline_sr_s": timings["sr_s"],
    }


def _opencv_missing() -> Optional[str]:
    try:
        require_cv2()
    except ImportError as e:
        return str(e)
    return None


def main(argv=None, protocol: Protocol = FLAGSHIP) -> dict:
    """Run the bench; prints the early and the final headline lines (and
    the launch line before the last) and returns the final result."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; stops without a card) or cpu (plain versions, host clock)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    start = time.monotonic()
    budget_s = float(os.environ.get("MMDIFF_BENCH_BUDGET_S", "900"))

    def remaining() -> float:
        return budget_s - (time.monotonic() - start)

    peak, peaks, skipped = _Peak(dev), {}, {}
    dev_sync = lambda: sync(dev)  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(3)

    # -- base model (mandatory) --------------------------------------------
    peak.reset()
    model = fill_params_(MultimodalUNet(protocol.base)).to(dev).eval()
    video, audio = _base_inputs(protocol.base, protocol.batch, gen, dev)
    t = torch.zeros(protocol.batch, dtype=torch.long, device=dev)
    base_step = base_chain_step(model, t, torch.Generator().manual_seed(2))
    with torch.inference_mode():
        base_s = time_chained(base_step, (video, audio), *protocol.base_chain, protocol.n_outer, dev_sync)
        ba.reset_launch_counts()
        base_step((video, audio))
        dev_sync()
        base_launches = {k: v for k, v in ba.kernel_launches().items() if k in K1_K3}
    peaks["base"] = peak.gib()
    del video, audio

    # -- SR model (mandatory): one clip's frames ----------------------------
    peak.reset()
    sr_model = fill_params_(ImageSuperResModel(protocol.sr)).to(dev).eval()
    n, s, low = protocol.frames, protocol.sr_size, protocol.low_size
    sr_x, sr_low = _randn(gen, dev, n, s, s, 3), _randn(gen, dev, n, low, low, 3)
    sr_t = torch.zeros(n, dtype=torch.long, device=dev)
    with torch.inference_mode():
        sr_s = time_chained(sr_chain_step(sr_model, sr_t, sr_low), sr_x, *protocol.sr_chain,
                            protocol.n_outer, dev_sync)
    peaks["sr"] = peak.gib()
    del sr_x, sr_low

    # -- headline: printed now, before an optional probe can starve it -------
    head = headline(base_s, sr_s, protocol)
    device = device_name(dev)

    def result(extra):
        return {
            "metric": METRIC,
            "value": head["pairs_per_sec"],
            "unit": "pairs/sec",
            "vs_baseline": head["vs_baseline"],
            "detail": {
                "base_denoise_step_ms_b8": base_s * 1e3,
                "base_only_pairs_per_sec": head["base_only_pairs_per_sec"],
                "sr_eval_ms_16f_256": sr_s * 1e3,
                "sr_seconds_per_clip_ddim25": protocol.nfe_sr * sr_s,
                "flops_per_pair_total": head["flops_per_pair_total"],
                "baseline": "analytic A100 fp16 estimate (312e12 * 0.35 util)",
                "baseline_pairs_per_sec": head["baseline_pairs_per_sec"],
                # `value` composes the slopes of the chained evaluations
                # (no sampler glue); `pipeline_pairs_per_sec` times the
                # samplers end to end and is the cross-check.
                "headline_derivation": (
                    "analytic: 1/(NFE_base*t_base/B + NFE_sr*t_sr), "
                    "t = slope of 2 eager chain lengths, each chain ended by a device sync"
                ),
                "device": device,
                "knobs": {"MMDIFF_REMAT_MIN_TOKENS": str(remat_min_tokens())},
                "budget_s": budget_s,
                "elapsed_s": time.monotonic() - start,
                "peak_gib": dict(peaks),
                **extra,
            },
        }

    print(json.dumps(result({"stage": "headline-only (optional probes pending)"})), flush=True)

    def optional(name: str, est_s: float, fn: Callable):
        """Run probe ``fn`` unless the budget is short; a failure is
        recorded with its traceback on stderr, never raised."""
        if remaining() < est_s:
            skipped[name] = f"budget ({remaining():.0f} s left < {est_s:.0f} s est)"
            return None
        peak.reset()
        try:
            out = fn()
        except Exception as e:  # one probe must not take the headline down
            traceback.print_exc()
            skipped[name] = f"error: {type(e).__name__}: {e}"
            return None
        peaks[name] = peak.gib()
        return out

    # -- optional probes ------------------------------------------------------
    train_ms = train_launches = train_objs = None
    train = optional("train_step", EST_TRAIN_S, lambda: train_probe(protocol, dev))
    if train is not None:
        train_ms, train_launches, train_objs = train

    real, no_opencv = None, _opencv_missing()
    if train_objs is None:
        skipped["train_real_data"] = "train-step probe unavailable"
    elif no_opencv:
        skipped["train_real_data"] = no_opencv
    else:
        real = optional("train_real_data", EST_REAL_DATA_S,
                        lambda: real_data_probe(protocol, dev, train_objs))
    del train, train_objs
    real = real or dict.fromkeys(
        ("train_steps_per_sec_real_data", "train_data_loader_batches_per_sec", "host_to_device_MBps"))

    pipe = optional("pipeline", EST_PIPELINE_S, lambda: pipeline_probe(protocol, model, sr_model, dev))
    pipe = pipe or dict.fromkeys(("pipeline_pairs_per_sec", "pipeline_base_s", "pipeline_sr_s"))

    print(json.dumps({"launches": {"base_eval": base_launches, "train_step": train_launches},
                      "batch": protocol.batch, "train_batch": protocol.train_batch}), flush=True)
    final = result({
        "stage": "final",
        "pipeline_pairs_per_sec": pipe["pipeline_pairs_per_sec"],
        "train_step_ms_b4_remat": train_ms,
        "train_examples_per_sec": None if train_ms is None else protocol.train_batch / train_ms * 1e3,
        **{k: real[k] for k in ("train_steps_per_sec_real_data", "train_data_loader_batches_per_sec",
                                "host_to_device_MBps")},
        "pipeline_base_s": pipe["pipeline_base_s"],
        "pipeline_sr_s": pipe["pipeline_sr_s"],
        "skipped_probes": skipped or None,
    })
    print(json.dumps(final), flush=True)
    return final


if __name__ == "__main__":
    main()
