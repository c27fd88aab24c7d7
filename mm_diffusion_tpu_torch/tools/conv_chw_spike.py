"""Channel-major (CHW) direct 3x3 conv and its GEMM core on the card: the
port's counterpart of the JAX spike ``tools/conv_chw_spike.py``.

The premise carried over: compute the transposed output
``out_T[Co, px] = W'[Co, 9 Ci] . im2col[9 Ci, px]`` per image with Co on
the GEMM's M side, channel-major activations, and the im2col tile built on
chip (``ops/gemm_conv.py::conv3x3_chw``).  Modes:

  check  the kernel against its plain version (explicit unfold + matmul in
         fp32) and against ``F.conv2d`` at a small shape
  bench  the kernel against cuDNN's ``F.conv2d`` in NCHW and in NHWC
         (channels_last) at the SR U-Net's 16 x 192 x 256^2 -> 192; on the
         card also the kernel's input copy alone
  gemm   the GEMM core alone, ``[192, 1728] x [nblk, 1728, npx]`` for the
         JAX tool's three (npx, nblk) cases, against ``torch.matmul``

Times are device milliseconds per call (``calls`` calls captured in one CUDA
graph, replayed ``replays`` times); on the CPU, host-clock ms.

    python -m mm_diffusion_tpu_torch.tools.conv_chw_spike {check,bench,gemm}
        [--device cuda] [--calls 10] [--replays 5] [--small]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from ..ops import gemm_conv
from ..utils.timing import device_header, resolve_device, timer
from . import check_close

CHECK_SHAPE = (2, 16, 8, 32, 128)  # B, Ci, Co, H, W (the JAX tool's check)
BENCH_SHAPE = (16, 192, 192, 256, 256)
SMALL_BENCH_SHAPE = (2, 16, 24, 16, 20)
GEMM_CO, GEMM_K = 192, 9 * 192
GEMM_CASES = ((4096, 256), (2048, 512), (8192, 128))  # (npx per block, blocks)
SMALL_GEMM_CASES = ((64, 4), (32, 8))


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mode", nargs="?", default="bench", choices=("check", "bench", "gemm"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--calls", type=int, default=10, help="calls captured per CUDA graph")
    p.add_argument("--replays", type=int, default=5, help="graph replays timed")
    p.add_argument("--small", action="store_true", help="small shapes (CPU rehearsal)")
    return p


def check(dev, dtype, gen, args) -> dict:
    torch.backends.cudnn.allow_tf32 = False  # F.conv2d as an fp32 reference
    b, ci, co, h, w_px = CHECK_SHAPE
    x = torch.randn((b, ci, h, w_px), generator=gen, device=dev, dtype=dtype)
    w = torch.randn((co, ci, 3, 3), generator=gen, device=dev) * 0.1
    out = gemm_conv.conv3x3_chw(x, w)
    plain = gemm_conv.conv3x3_chw_reference(x, w)
    conv = F.conv2d(x.float(), w.float(), padding=1)
    errs = {
        "plain": check_close(out, plain, gemm_conv.GEMM_TOL, "kernel vs plain"),
        "conv2d": check_close(out, conv, gemm_conv.GEMM_TOL, "kernel vs conv2d"),
    }
    print(f"check {dtype}: max err vs plain {errs['plain']:.2e}, vs F.conv2d {errs['conv2d']:.2e} "
          f"(shape {tuple(out.shape)})", flush=True)
    return errs


def bench(dev, dtype, gen, args) -> dict:
    b, ci, co, h, w_px = SMALL_BENCH_SHAPE if args.small else BENCH_SHAPE
    x = torch.randn((b, ci, h, w_px), generator=gen, device=dev, dtype=dtype)
    w = (torch.randn((co, ci, 3, 3), generator=gen, device=dev) * 0.05).to(dtype)
    x_nhwc = x.contiguous(memory_format=torch.channels_last)
    w_nhwc = w.contiguous(memory_format=torch.channels_last)
    flops = 2 * b * h * w_px * 9 * ci * co
    time_fn = timer(dev, args.calls, args.replays)
    results = {}
    convs = [
        ("conv2d NCHW", lambda: F.conv2d(x, w, padding=1)),
        ("conv2d NHWC", lambda: F.conv2d(x_nhwc, w_nhwc, padding=1)),
        ("kernel CHW", lambda: gemm_conv.conv3x3_chw(x, w)),
    ]
    if dev.type == "cuda":  # the kernel's input copy alone
        convs.append(("input copy", lambda: gemm_conv.channels_last_halo_cuda(x)))
    for name, fn in convs:
        results[name] = ms = time_fn(fn)
        rate = "" if name == "input copy" else f" ({flops / ms / 1e9:.0f} GFLOP/s)"
        print(f"{name:12s}: {ms:8.4f} ms{rate} B={b} Ci={ci} Co={co} {h}x{w_px}", flush=True)
    return results


def gemm(dev, dtype, gen, args) -> dict:
    time_fn = timer(dev, args.calls, args.replays)
    results = {}
    for npx, nblk in SMALL_GEMM_CASES if args.small else GEMM_CASES:
        a = torch.randn((GEMM_CO, GEMM_K), generator=gen, device=dev, dtype=dtype) * 0.05
        bb = torch.randn((nblk, GEMM_K, npx), generator=gen, device=dev, dtype=dtype)
        flops = 2 * GEMM_CO * GEMM_K * npx * nblk
        row = {
            "matmul": time_fn(lambda: torch.matmul(a, bb)),
            "kernel": time_fn(lambda: gemm_conv.gemm_blocks(a, bb)),
        }
        results[(npx, nblk)] = row
        print(f"gemm [{GEMM_CO}x{GEMM_K}]x[{GEMM_K}x{npx}] x{nblk}: "
              + "  ".join(f"{k} {v:.4f} ms ({flops / v / 1e9:.0f} GFLOP/s)" for k, v in row.items()),
              flush=True)
        del bb
    return results


def main(argv=None) -> dict:
    args = create_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    print(device_header(dev), flush=True)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    return {"check": check, "bench": bench, "gemm": gemm}[args.mode](dev, dtype, gen, args)


if __name__ == "__main__":
    main()
