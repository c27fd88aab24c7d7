"""A/B the decoder-skip projection at the SR U-Net's hot shape: a 1x1 conv
over the virtual concat of two NHWC parts, (192 + 192) -> 192 channels at
16 x 256^2 (the port's counterpart of the JAX tool ``tools/bench_skip_conv.py``):

  split   one matmul per part, the partials summed (what the JAX model's
          ``PointwiseFromParts`` computes)
  concat  the concat written to device memory, then one matmul
  gemm    the hand-written two-part GEMM (``ops/gemm_conv.py::skip_gemm``),
          which stacks both parts along K on chip with no concat

The kernel is first checked against its plain version (concat + matmul in
fp32).  Times are device milliseconds per call (``calls`` calls captured in
one CUDA graph, replayed ``replays`` times); on the CPU, host-clock ms.

    python -m mm_diffusion_tpu_torch.tools.bench_skip_conv [--device cuda]
        [--calls 10] [--replays 5] [--small]
"""

from __future__ import annotations

import argparse

import torch

from ..ops import gemm_conv
from ..utils.timing import device_header, resolve_device, timer
from . import check_close

SHAPE = (16, 256, 256, 192, 192)  # B, H, W, C per part, CO
SMALL_SHAPE = (2, 16, 16, 32, 24)


def create_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--calls", type=int, default=10, help="calls captured per CUDA graph")
    p.add_argument("--replays", type=int, default=5, help="graph replays timed")
    p.add_argument("--small", action="store_true", help="small shapes (CPU rehearsal)")
    return p


def main(argv=None) -> dict:
    args = create_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    print(device_header(dev), flush=True)
    time_fn = timer(dev, args.calls, args.replays)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    b, h, w, c, co = SMALL_SHAPE if args.small else SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    x1 = torch.randn((b, h, w, c), generator=gen, device=dev, dtype=dtype)
    x2 = torch.randn((b, h, w, c), generator=gen, device=dev, dtype=dtype)
    wfull = torch.randn((2 * c, co), generator=gen, device=dev) * 0.05
    wd = wfull.to(dtype)

    err = check_close(gemm_conv.skip_gemm(x1, x2, wfull), gemm_conv.skip_gemm_reference(x1, x2, wfull),
                      gemm_conv.GEMM_TOL, "skip_gemm vs plain")
    print(f"gemm check: max err {err:.3e} ({gemm_conv.GEMM_TOL})", flush=True)

    cases = {
        "split": lambda: x1 @ wd[:c] + x2 @ wd[c:],
        "concat": lambda: torch.cat([x1, x2], dim=-1) @ wd,
        "gemm": lambda: gemm_conv.skip_gemm(x1, x2, wfull),
    }
    results = {"max_abs_err": err, "ms": {}}
    for name, fn in cases.items():
        results["ms"][name] = ms = time_fn(fn)
        print(f"{name:8s}: {ms:8.4f} ms  (B={b} H={h} W={w} C={c}+{c} -> {co})", flush=True)
    return results


if __name__ == "__main__":
    main()
