"""A/B the packed self-attention forward's variants at the model's hot
shapes: the port's counterpart of the JAX tools ``tools/bench_attn_variants.py``
(hoist, recip, rows) and ``tools/bench_attn_variants2.py`` (ident, stock,
noexp, exp2, nomax), on the variants of ``ops/block_attention.py``
(:data:`VARIANTS`):

  ident  harness floor: a copy of the q lanes, no attention
  stock  the main path's kernel; hoist, recip and exp2 are what it already
         does on this card, so they launch it too
  rows   several T <= 32 sequences packed per 64-row query tile
  nomax  exp2 with a clamp at 40 instead of the row max (exact while the
         logits stay below 40; diagnostic only)
  noexp  the two products with no softmax (a floor, not attention)

Each variant is first checked against its plain version on the same input.
Times are device milliseconds per call (``calls`` calls captured in one CUDA
graph, replayed ``replays`` times); on the CPU, host-clock milliseconds.
On the card, rows, nomax and noexp run K1's Hopper kernel in their mode.

    python -m mm_diffusion_tpu_torch.tools.bench_attn_variants [--device cuda]
        [--calls 10] [--replays 5] [--small]
"""

from __future__ import annotations

import argparse

import torch

from ..ops import block_attention as ba
from ..utils.timing import device_header, resolve_device, timer
from . import check_close

# (label, N, T, C, heads): the two JAX tools' cases.
CASES = [
    ("base spatial", 128, 1024, 256, 4),
    ("base temporal", 8192, 16, 256, 4),
    ("SR spatial", 16, 1024, 384, 6),
    ("SR mid", 16, 256, 768, 12),
]
SMALL_CASES = [  # --small: the same kinds of shape at a CPU-friendly size
    ("base spatial", 2, 64, 128, 2),
    ("base temporal", 24, 16, 128, 2),
    ("SR spatial", 2, 64, 192, 3),
    ("SR mid", 2, 25, 256, 4),
]


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
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for label, n, t, c, h in SMALL_CASES if args.small else CASES:
        qkv = torch.randn((n, t, 3 * c), generator=gen, device=dev, dtype=dtype)
        row = {"ident": time_fn(lambda: qkv[..., :c].contiguous())}
        errs = {}
        for variant in ba.VARIANTS:
            errs[variant] = check_close(
                ba.self_attention_variant(qkv, h, variant),
                ba.self_attention_variant_reference(qkv, h, variant), ba.VARIANT_TOL[variant],
                f"{label} {variant} vs plain",
            )
            row[variant] = time_fn(lambda v=variant: ba.self_attention_variant(qkv, h, v))
        results[label] = {"ms": row, "max_abs_err": errs}
        print(f"{label:14s} N={n:5d} T={t:5d} C={c:4d} H={h:2d}  "
              + "  ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f"  ms; max err {max(errs.values()):.2e}", flush=True)
    return results


if __name__ == "__main__":
    main()
