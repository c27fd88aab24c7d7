#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (mm_diffusion_tpu_torch) on one card.

    python3 chip_smoke.py            # all phases, one CUDA device

Phases, each printed as it runs; any failure exits non-zero:
  1. toolchain: torch / CUDA versions, nvcc, the card's name and power limit;
     TF32 off for matmuls and convolutions.
  2. build: the hand-written attention kernels from ops/csrc with nvcc
     (sm_90a), timed.
  3. kernels vs their plain PyTorch versions on the card, in bf16, at every
     main-path shape of the flagship sampler (several RS-MMA shifts, the
     wrap included); max |error| against the stated tolerance, and both
     times (CUDA events, after a warm-up).
  4. one model evaluation on the card (bf16, kernels) against the CPU (fp32,
     plain versions) with the same random non-zero weights: the stock
     MM-UNet at batch 1, and the SR U-Net on 2 frames; relative L2 error.
  5. the flagship CLI, scripts/multimodal_sample_sr.py, end to end at the
     launch-script config (20-NFE DPM-Solver base, ddim25 SR of all 16
     frames) with random non-zero weights saved to .pt files; the kernels'
     launch counts over that run, finite outputs, stage wall times.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``; the card's ``nvidia-smi`` name and power
limit line comes just before them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# bf16 kernel vs its plain version (fp32 math on the same bf16 inputs):
# |kernel - plain| <= ATOL + RTOL * |plain| elementwise.  The kernel rounds P
# to bf16 before P @ V and rounds the output to bf16 (relative 2^-9 each).
KERNEL_ATOL, KERNEL_RTOL = 1e-2, 1e-2
# bf16 model on the card vs fp32 on the CPU, relative L2 over the output.
MODEL_REL_L2_TOL = 5e-2
BANDED_SHIFTS = 3  # shifts per banded shape: 0, the middle and the last of the span

# Main-path shapes at batch 1 of the flagship config (16x64x64 video, 25600
# audio samples, 128 channels, mult 1,2,3,4; SR 192 channels, head dim 64).
SELF_SHAPES = [  # (label, N, T, C, heads, layout)
    ("mm spatial ds2", 16, 1024, 256, 4, "thirds"),
    ("mm spatial ds4", 16, 256, 384, 4, "thirds"),
    ("mm spatial ds8", 16, 64, 512, 4, "thirds"),
    ("mm temporal ds2", 1024, 16, 256, 4, "thirds"),
    ("mm temporal ds4", 256, 16, 384, 4, "thirds"),
    ("mm temporal ds8", 64, 16, 512, 4, "thirds"),
    ("mm middle audio", 1, 400, 512, 4, "thirds"),
    ("sr ds8", 16, 1024, 384, 6, "per_head"),
    ("sr ds16", 16, 256, 768, 12, "per_head"),
    ("sr ds32", 16, 64, 768, 12, "per_head"),
]
BANDED_SHAPES = [  # (label, F, Tq, Tk, C, heads, lw)
    ("ds2 video->audio", 16, 1024, 400, 256, 4, 1),
    ("ds2 audio->video", 16, 400, 1024, 256, 4, 1),
    ("ds4 video->audio", 16, 256, 100, 384, 6, 4),
    ("ds4 audio->video", 16, 100, 256, 384, 6, 4),
    ("ds8 video->audio", 16, 64, 25, 512, 8, 8),
    ("ds8 audio->video", 16, 25, 64, 512, 8, 8),
    ("middle video->audio", 16, 64, 25, 512, 8, 16),
    ("middle audio->video", 16, 25, 64, 512, 8, 16),
]
KERNEL_SOURCE = {
    "self_attention": "mm_diffusion_tpu_torch/ops/csrc/self_attention.cu",
    "banded_attention": "mm_diffusion_tpu_torch/ops/csrc/banded_attention.cu",
}
REPLACES = {  # the Pallas kernel bodies in the JAX package
    "self_attention": "mm_diffusion_tpu/ops/block_attention.py:165",
    "banded_attention[lw>1]": "mm_diffusion_tpu/ops/block_attention.py:609",
    "banded_attention[lw=1]": "mm_diffusion_tpu/ops/block_attention.py:534",
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(out, ref):
    """(max |out - ref|, whether every element is within tolerance)."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()).all())
    return diff.max().item(), ok


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def toolchain() -> str:
    import torch

    from mm_diffusion_tpu_torch.ops import cuda_build

    phase("1. toolchain")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvcc: {cuda_build.find_nvcc()}")
    print(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    print(f"nvidia-smi: {smi}")
    print("TF32: matmul off, cudnn off")
    return smi


def build() -> None:
    from mm_diffusion_tpu_torch.ops import cuda_build

    phase("2. build kernels")
    t0 = time.perf_counter()
    built = cuda_build.load()
    print(f"library: {built.path}")
    print(f"nvcc compile {built.build_seconds:.2f} s, load total {time.perf_counter() - t0:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())


def kernel_parity():
    """Phase 3; returns {kernel name: {"err", "ms", "plain_ms"}} summed over shapes."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    phase(f"3. kernels vs plain versions (bf16, |err| <= {KERNEL_ATOL} + {KERNEL_RTOL}*|plain|)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    summary = {}

    def record(name, err, ms, plain_ms):
        s = summary.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += ms
        s["plain_ms"] += plain_ms

    for label, n, t, c, h, layout in SELF_SHAPES:
        qkv = torch.randn((n, t, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
        out, lse = ba.self_attention_cuda(qkv, h, layout)
        ref = ba.self_attention_reference(qkv, h, layout)
        q, k, _ = ba.split_packed_qkv(qkv.float(), h, layout)
        lse_ref = torch.logsumexp(
            torch.einsum("nqhd,nkhd->nhqk", q, k) / (c // h) ** 0.5, dim=-1
        )
        torch.cuda.synchronize()
        err, ok = compare(out, ref)
        lse_err, lse_ok = compare(lse, lse_ref)
        ms = time_ms(lambda: ba.self_attention_cuda(qkv, h, layout))
        plain_ms = time_ms(lambda: ba.self_attention_reference(qkv, h, layout))
        print(
            f"self_attention {label:18s} N={n:5d} T={t:5d} C={c:4d} H={h:2d} {layout:8s} "
            f"err={err:.3e} lse_err={lse_err:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms"
        )
        check(ok and lse_ok, f"self_attention {label}: err {err}, lse {lse_err}")
        record("self_attention", max(err, lse_err), ms, plain_ms)

    for label, f, tq, tk, c, h, lw in BANDED_SHAPES:
        q_src = torch.randn((1, f, tq, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
        kv_src = torch.randn((1, f, tk, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
        span = f - lw
        shifts = sorted({0, span // 2, span})[:BANDED_SHIFTS]
        name = "banded_attention[lw=1]" if lw == 1 else "banded_attention[lw>1]"
        worst = 0.0
        for s in shifts:
            out, _ = ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c)
            ref = ba.banded_cross_attention_reference(q_src, kv_src, s, lw, h, c)
            torch.cuda.synchronize()
            err, ok = compare(out, ref)
            check(ok, f"banded {label} shift {s}: err {err}")
            worst = max(worst, err)
        s = shifts[-1]
        ms = time_ms(lambda: ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c))
        plain_ms = time_ms(lambda: ba.banded_cross_attention_reference(q_src, kv_src, s, lw, h, c))
        print(
            f"banded_attention {label:20s} F={f} Tq={tq:5d} Tk={tk:5d} C={c} H={h} lw={lw:2d} "
            f"shifts={shifts} err={worst:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms"
        )
        record(name, worst, ms, plain_ms)
    return summary


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def model_parity() -> None:
    import torch

    from mm_diffusion_tpu_torch import configs
    from mm_diffusion_tpu_torch.models.image_unet import ImageSuperResModel
    from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
    from mm_diffusion_tpu_torch.weights import randomize_

    phase("4. one model evaluation: card (bf16, kernels) vs CPU (fp32, plain versions)")
    torch.set_num_threads(os.cpu_count() or 1)
    dev = torch.device("cuda")
    rng = torch.Generator().manual_seed(1)
    flags = dict(
        num_channels=128, num_head_channels=64, resblock_updown=True,
        cross_attention_resolutions="2,4,8", cross_attention_windows="1,4,8",
        video_attention_resolutions="2,4,8", audio_attention_resolutions="-1",
    )
    cfg32 = configs.create_model_config(**flags)
    cfg16 = configs.create_model_config(**flags, use_fp16=True)
    cpu_model = randomize_(MultimodalUNet(cfg32), seed=11).eval()
    gpu_model = MultimodalUNet(cfg16)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(dev).eval()
    f, c, h, w = cfg32.video_size
    video = torch.randn((1, f, h, w, c), generator=rng)
    audio = torch.randn((1, cfg32.audio_size[1], 1), generator=rng)
    t = torch.tensor([500])
    with torch.inference_mode():
        t0 = time.perf_counter()
        rv, ra = cpu_model(video, audio, t, shift=3)
        cpu_s = time.perf_counter() - t0
        gv, ga = gpu_model(video.to(dev), audio.to(dev), t.to(dev), shift=3)
        torch.cuda.synchronize()
    ev, ea = rel_l2(gv.cpu(), rv), rel_l2(ga.cpu(), ra)
    print(f"MM-UNet stock config, batch 1, shift 3: rel L2 video {ev:.3e} audio {ea:.3e} "
          f"(tolerance {MODEL_REL_L2_TOL}); CPU forward {cpu_s:.1f} s")
    check(ev <= MODEL_REL_L2_TOL and ea <= MODEL_REL_L2_TOL, "MM-UNet card vs CPU")
    del cpu_model, gpu_model

    sr_flags = dict(
        large_size=256, small_size=64, sr_num_channels=192, sr_attention_resolutions="32,16,8",
        sr_num_head_channels=64, sr_resblock_updown=True, sr_learn_sigma=True,
    )
    cpu_sr = randomize_(ImageSuperResModel(configs.create_image_sr_config(**sr_flags)), 12).eval()
    gpu_sr = ImageSuperResModel(configs.create_image_sr_config(**sr_flags, use_fp16=True))
    gpu_sr.load_state_dict(cpu_sr.state_dict())
    gpu_sr.to(dev).eval()
    x = torch.randn((2, 256, 256, 3), generator=rng)
    low = torch.randn((2, 64, 64, 3), generator=rng)
    ts = torch.tensor([900, 100])
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu_sr(x, ts, low)
        cpu_s = time.perf_counter() - t0
        out = gpu_sr(x.to(dev), ts.to(dev), low.to(dev))
        torch.cuda.synchronize()
    e = rel_l2(out.cpu(), ref)
    print(f"SR U-Net, 2 frames 64->256: rel L2 {e:.3e} (tolerance {MODEL_REL_L2_TOL}); "
          f"CPU forward {cpu_s:.1f} s")
    check(e <= MODEL_REL_L2_TOL, "SR U-Net card vs CPU")


def flagship(tmp: str):
    """Phase 5; returns the launch counts of the main path's run."""
    import numpy as np
    import torch

    from mm_diffusion_tpu_torch import configs
    from mm_diffusion_tpu_torch.models.image_unet import ImageSuperResModel
    from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr as cli
    from mm_diffusion_tpu_torch.weights import randomize_

    phase("5. flagship CLI: scripts/multimodal_sample_sr.py, 20-NFE DPM-Solver + ddim25 SR")
    flagship_args = cli.LAUNCH_SCRIPT_ARGS
    args = cli.create_argparser().parse_args(flagship_args)
    base_cfg = configs.create_model_config(**vars(args))
    sr_cfg = configs.create_image_sr_config(**vars(args))
    base_pt, sr_pt = os.path.join(tmp, "base.pt"), os.path.join(tmp, "sr.pt")
    torch.save(randomize_(MultimodalUNet(base_cfg), seed=21).state_dict(), base_pt)
    torch.save(randomize_(ImageSuperResModel(sr_cfg), seed=22).state_dict(), sr_pt)
    argv = flagship_args + [
        "--multimodal_model_path", base_pt, "--sr_model_path", sr_pt,
        "--output_dir", os.path.join(tmp, "samples"), "--device", "cuda",
    ]
    print("argv:", " ".join(argv))
    ba.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(ba.LAUNCHES)
    windows = dict(ba.BANDED_WINDOWS)
    samples = result["samples"]
    for key, shape in (("video", (1, 16, 64, 64, 3)), ("audio", (1, 25600, 1)),
                       ("sr_video", (1, 16, 256, 256, 3))):
        arr = samples[key]
        check(arr.shape == shape, f"{key} shape {arr.shape} != {shape}")
        check(bool(np.isfinite(arr).all()), f"{key} has non-finite values")
        print(f"{key}: shape {arr.shape}, finite, mean {arr.mean():.4f}, std {arr.std():.4f}")
    print(f"outputs written: {result['paths']}")
    print(f"stage wall times: {result['timings'][0]} (CLI total incl. weight loading {wall:.1f} s)")
    print(f"launches over the run: {launches}, banded by window: {windows}")
    check(launches["self_attention"] > 0, "self-attention kernel never launched")
    check(windows.get(1, 0) > 0, "banded kernel never launched with lw=1")
    check(sum(v for k, v in windows.items() if k > 1) > 0, "banded kernel never launched with lw>1")
    return {
        "self_attention": launches["self_attention"],
        "banded_attention[lw=1]": windows.get(1, 0),
        "banded_attention[lw>1]": sum(v for k, v in windows.items() if k > 1),
    }


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "mm_diffusion_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        smi = toolchain()
        build()
        summary = kernel_parity()
        model_parity()
        with tempfile.TemporaryDirectory() as tmp:
            launches = flagship(tmp)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE[name.split("[")[0]],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": summary[name]["max_abs_err"],
            "ms": summary[name]["ms"],
            "plain_ms": summary[name]["plain_ms"],
        }
        for name in REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
