"""Where the device time goes in one base evaluation and one SR step of the
flagship sampler (random non-zero weights, batch 1, bf16), in one step of
zero-shot audio->video sampling by the gradient method (the same base
model: a forward and an input-only backward), in one step of the
flagship training (batch 4, remat, bf16 compute, fp32
AdamW and EMA), and in one train step of the SR U-Net (the sampler's SR
config) and of the single-modal video and audio U-Nets (the single-modal
CLI's defaults), each at batch 4 with use_checkpoint, by kernel kind, with
torch.profiler.  Needs one CUDA device.

    python -m mm_diffusion_tpu_torch.scripts.profile_flagship

For each stage it prints the host wall time per call (to a device
synchronisation), the summed device time of the kernels of one profiled
call, the device's idle share of that call's kernel window (the profiler's
host overhead stretches it) and of the unprofiled wall time, and the
device time by kind and by kernel.
"""

from __future__ import annotations

import argparse
import collections
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import configs
from ..models.image_unet import ImageSuperResModel
from ..models.mm_unet import MultimodalUNet
from ..parallel.bootstrap import refuse_launcher
from ..weights import randomize_
from .multimodal_sample_sr import LAUNCH_SCRIPT_ARGS, create_argparser

KINDS = (  # (kind, substrings of the kernel name), first match wins
    ("attention (hand CUDA)", ("attention_fwd_kernel", "attention_sm90_kernel", "attention_fwd_sm90")),
    ("attention backward (hand CUDA)", ("attention_bwd",)),
    ("optimizer / EMA", ("multi_tensor", "foreach", "adam")),
    ("convolution", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "implicit", "winograd",
                     "nchw", "nhwc")),
    ("gemm (linears)", ("gemm", "cutlass", "cublas", "kernel2")),
    ("group norm", ("group_norm", "groupnorm", "welford", "rowwisemoments")),
    ("copies / layout", ("copy", "transpose", "permute", "cat", "index", "repeat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def profile_call(fn, iters: int = 5, grad: bool = False):
    with torch.inference_mode(not grad):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    # device events, without the GPU spans of annotated ranges (e.g. the
    # optimizer's record_function), which would count their kernels twice
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    return wall_ms, kernels


def report(stage: str, wall_ms: float, kernels) -> None:
    print(f"\n== {stage}: {wall_ms:.2f} ms per call (host clock, 5 calls)")
    if not kernels:
        print("   torch.profiler recorded no device kernels: device time not measured")
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    window = (end - start) / 1e3
    print(f"   device kernels {busy:.2f} ms in a {window:.2f} ms window of the profiled call: "
          f"idle share {1 - busy / window:.3f}; against the unprofiled {wall_ms:.2f} ms per call: "
          f"{max(0.0, 1 - busy / wall_ms):.3f}; {len(kernels)} kernel launches")
    by_kind, by_name = collections.Counter(), collections.Counter()
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_kind[kind_of(e.name)] += us
        by_name[e.name[:90]] += us
    for kind, us in by_kind.most_common():
        print(f"   {kind:24s} {us / 1e3:8.3f} ms  {us / 1e3 / busy:6.1%}")
    print("   top kernels:")
    for name, us in by_name.most_common(12):
        print(f"     {us / 1e3:8.3f} ms  {name}")


def _train_step_closure(model, diffusion, batch, dev: torch.device, seed: int, **step_kw):
    """One train step of ``model`` on the numpy ``batch`` as a closure
    (AdamW and one EMA rate, uniform timesteps)."""
    from ..train import create_train_state, make_optimizer, make_train_step

    model = model.to(dev).train()
    state = create_train_state(model, make_optimizer(model, 1e-4), (0.9999,))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    step = make_train_step(diffusion.to(dev), **step_kw)
    gens = torch.Generator().manual_seed(seed), torch.Generator(device=dev).manual_seed(seed)
    return lambda: step(state, batch, *gens)


def train_step_call(dev: torch.device, seed: int):
    """One flagship train step (batch 4) as a closure (the CLI's default
    initialisation, synthetic data, uniform timesteps)."""
    from ..data.synthetic import load_synthetic_data
    from .multimodal_train import create_argparser as train_argparser

    flags = vars(train_argparser().parse_args(
        "--num_channels 128 --num_head_channels 64 --resblock_updown True --use_fp16 True "
        "--use_checkpoint True --batch_size 4".split()
    ))
    cfg = configs.create_model_config(**flags)
    batch = next(load_synthetic_data(4, video_size=cfg.video_size, audio_size=cfg.audio_size, seed=seed))
    return _train_step_closure(MultimodalUNet(cfg), configs.create_gaussian_diffusion(steps=1000), batch,
                               dev, seed, shift=torch.Generator().manual_seed(seed))


def sr_train_step_call(dev: torch.device, seed: int):
    """One SR U-Net train step (the sampler's SR flags, use_checkpoint,
    synthetic pairs 256 <- 64) as a closure."""
    from ..train import ImageSRTask
    from .image_sr_train import synthetic_sr_data

    flags = vars(create_argparser().parse_args(LAUNCH_SCRIPT_ARGS))
    model = ImageSuperResModel(configs.create_image_sr_config(**{**flags, "use_checkpoint": True}))
    return _train_step_closure(model, configs.create_gaussian_diffusion(steps=1000, learn_sigma=True),
                               next(synthetic_sr_data(4, 256, 64, seed)), dev, seed,
                               adapter=ImageSRTask().adapter(None))


def single_train_step_call(modality: str, dev: torch.device, seed: int):
    """One single-modal train step (the CLI's defaults, use_checkpoint,
    synthetic data) as a closure."""
    from ..data.synthetic import load_synthetic_data
    from ..models.single_unet import SingleModalUNet
    from ..train import SingleModalTask
    from .single_modal_train import create_single_config, single_model_defaults

    cfg = create_single_config(**{**single_model_defaults(), "modality": modality, "use_checkpoint": True})
    av = next(load_synthetic_data(4, video_size=cfg.video_size, audio_size=cfg.audio_size, seed=seed))
    return _train_step_closure(SingleModalUNet(cfg), configs.create_gaussian_diffusion(steps=1000),
                               {"x": av[modality]}, dev, seed, adapter=SingleModalTask().adapter(None))


def a2v_step_call(base, dev: torch.device, seed: int):
    """One gradient-method step of audio->video sampling (the middle of 25
    respaced steps) as a closure, the base model frozen."""
    from ..samplers import conditional_gradient_step
    from ..sampling import mm_raw_model

    base.requires_grad_(False)
    diffusion = configs.create_gaussian_diffusion(timestep_respacing="25").to(dev)
    raw = mm_raw_model(base, torch.Generator().manual_seed(seed))
    f, c, h, w = base.cfg.video_size
    g = torch.Generator(device=dev).manual_seed(seed)
    x = {"video": torch.randn((1, f, h, w, c), generator=g, device=dev),
         "audio": torch.randn((1, base.cfg.audio_size[1], 1), generator=g, device=dev)}
    cond = torch.rand((1, base.cfg.audio_size[1], 1), generator=g, device=dev) * 2 - 1
    t = torch.full((1,), 12, device=dev)

    def step():
        with torch.no_grad():
            return conditional_gradient_step(
                diffusion, lambda xx, tt: raw(xx, tt, strip_sigma=False), x, t, cond, "audio", x["audio"],
                generator=g,
            )

    return step


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    refuse_launcher("profile_flagship")
    if not torch.cuda.is_available():
        raise RuntimeError("profile_flagship needs a CUDA device")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    torch.cuda.reset_peak_memory_stats()
    report("train step, flagship config, batch 4 (remat, bf16)",
           *profile_call(train_step_call(dev, args.seed), grad=True))
    print(f"   peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for stage, call in (("SR U-Net train step, batch 4 (use_checkpoint, bf16)", sr_train_step_call),
                        ("single-modal video train step, batch 4 (use_checkpoint, bf16)",
                         lambda d, s: single_train_step_call("video", d, s)),
                        ("single-modal audio train step, batch 4 (use_checkpoint, bf16)",
                         lambda d, s: single_train_step_call("audio", d, s))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        report(stage, *profile_call(call(dev, args.seed), grad=True))
        print(f"   peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    flags = vars(create_argparser().parse_args(LAUNCH_SCRIPT_ARGS))
    base = randomize_(MultimodalUNet(configs.create_model_config(**flags)), args.seed)
    sr = randomize_(ImageSuperResModel(configs.create_image_sr_config(**flags)), args.seed + 1)
    base.to(dev).eval()
    sr.to(dev).eval()
    f, c, h, w = base.cfg.video_size
    video = torch.randn((1, f, h, w, c), device=dev)
    audio = torch.randn((1, base.cfg.audio_size[1], 1), device=dev)
    shift = torch.Generator().manual_seed(args.seed)
    t = torch.full((1,), 500, device=dev)
    x = torch.randn((f, 256, 256, 3), device=dev)
    low = torch.randn((f, 64, 64, 3), device=dev)
    ts = torch.full((f,), 500, device=dev)
    report("base MM-UNet evaluation (1 of 20 NFE)", *profile_call(lambda: base(video, audio, t, shift)))
    report("SR U-Net step, 16 frames (1 of 25)", *profile_call(lambda: sr(x, ts, low)))
    torch.cuda.reset_peak_memory_stats()
    report("a2v gradient step, batch 1 (forward + input-only backward)",
           *profile_call(a2v_step_call(base, dev, args.seed), grad=True))
    print(f"   peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
