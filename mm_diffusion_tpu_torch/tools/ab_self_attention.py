"""Time the attention kernels of several checkouts of the port on one card,
in turns.

    python -m mm_diffusion_tpu_torch.tools.ab_self_attention DIR [DIR ...]
        [--rounds 2] [--backward] [--kernels attention,flash,gemm,variants]
        [--calls 10] [--replays 10]

Each DIR holds a checkout: its ``mm_diffusion_tpu_torch`` builds its own
kernels into ``DIR/build/kernels`` and runs in a fresh process, on the shape
lists of the checkout the tool runs from.  The checkouts run in order, then in
reverse order, ``--rounds`` times in all (A B B A ...), so that drift on the
card shows beside the difference.  Every time is device ms per call from
CUDA-graph replays (``utils/timing.py::device_ms``) of the bf16 self-attention
forward (K1) at the flagship sampler's shapes (:data:`SELF_SHAPES`), of the
banded forward (K2/K3) at the sampler's shapes (batch 1,
:data:`BANDED_SHAPES`) and the training step's (batch 4,
:data:`TRAIN_BANDED_SHAPES`), the last shift of the span, and, with
``--backward``, of the self-attention backward (K4/K5) and of the banded
backward (K6/K7) at the training step's shapes (:data:`TRAIN_SELF_SHAPES`,
:data:`TRAIN_BANDED_SHAPES`, with each pass's device time from torch.profiler
beside it).  With ``--kernels`` naming ``flash``, the flash MHA forward (K8) at
its hot shapes (:data:`FLASH_SHAPES`) and, with ``--backward``, its backward
with each pass's device time; naming ``gemm``, the GEMM of S3 and the S4 core
at the JAX tools' shapes; naming ``variants``, the K1 variants rows, nomax and
noexp at the A/B tool's cases (``bench_attn_variants.CASES``; nomax and noexp
at the first three); ``attention`` (the default) is K1-K7 as above.  Each
output is checked against the plain version first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# Main-path shapes at batch 1 of the flagship config (16x64x64 video, 25600
# audio samples, 128 channels, mult 1,2,3,4; SR 192 channels, head dim 64),
# and of the text-to-image cell.
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
    # Stable Diffusion XL base's self-attention in the benchmark's
    # text-to-image cell: 8 rows an evaluation (4 images with guidance),
    # 64x64 and 32x32 latent tokens, 64-wide heads.
    ("sdxl 64x64", 8, 4096, 640, 10, "thirds"),
    ("sdxl 32x32", 8, 1024, 1280, 20, "thirds"),
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
# Main-path shapes of the flagship training step (batch 4):
# the sampler's shapes with N scaled by 4.
TRAIN_SELF_SHAPES = [  # (label, N, T, C, heads, layout)
    ("spatial ds2", 64, 1024, 256, 4, "thirds"),
    ("spatial ds4", 64, 256, 384, 4, "thirds"),
    ("spatial ds8", 64, 64, 512, 4, "thirds"),
    ("temporal ds2", 4096, 16, 256, 4, "thirds"),
    ("temporal ds4", 1024, 16, 384, 4, "thirds"),
    ("temporal ds8", 256, 16, 512, 4, "thirds"),
    ("middle audio", 4, 400, 512, 4, "thirds"),
]
TRAIN_BANDED_SHAPES = [  # (label, N, F, Tq, Tk, C, heads, lw)
    ("ds2 video->audio", 4, 16, 1024, 400, 256, 4, 1),
    ("ds2 audio->video", 4, 16, 400, 1024, 256, 4, 1),
    ("ds4 video->audio", 4, 16, 256, 100, 384, 6, 4),
    ("ds4 audio->video", 4, 16, 100, 256, 384, 6, 4),
    ("ds8 video->audio", 4, 16, 64, 25, 512, 8, 8),
    ("ds8 audio->video", 4, 16, 25, 64, 512, 8, 8),
    ("middle video->audio", 4, 16, 64, 25, 512, 8, 16),
    ("middle audio->video", 4, 16, 25, 64, 512, 8, 16),
]
# The flash MHA kernels' (K8) hot shapes, those of ops/fused_attention.py's
# docstring and SDXL's and Wan's cross-attention.  (label, B, H, Tq, Tk, D, layout);
# B = batch * frames.
FLASH_SHAPES = [
    ("self", 128, 4, 1024, 1024, 64, "bhtd"),
    ("video->audio", 128, 4, 1024, 400, 64, "bthd"),
    ("audio->video", 128, 4, 100, 1024, 64, "bthd"),
    # SDXL's cross-attention to the 77-token text context, 8 rows.
    ("sdxl 64x64 cross", 8, 10, 4096, 77, 64, "bthd"),
    ("sdxl 32x32 cross", 8, 20, 1024, 77, 64, "bthd"),
    # Wan2.1-T2V-1.3B's cross-attention: 32,760 video tokens (an 832x480x81
    # clip) against the 512-token text context, 12 heads of 128, 2 rows.
    ("wan cross", 2, 12, 32760, 512, 128, "bthd"),
]


def child(root: str, backward: bool, kernels, calls: int, replays: int) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from mm_diffusion_tpu_torch.ops import cuda_build
    from mm_diffusion_tpu_torch.utils.timing import device_ms, nvidia_smi_line

    built = cuda_build.load()
    print(f"[{root}] {nvidia_smi_line()}; library {built.path}, built in {built.build_seconds:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(0)
    time = lambda fn: device_ms(fn, calls=calls, replays=replays)  # noqa: E731
    if "attention" in kernels:
        attention(root, g, time, backward)
    if "flash" in kernels:
        flash(root, g, time, backward)
    if "gemm" in kernels:
        gemm(root, g, time)
    if "variants" in kernels:
        variants(root, g, time)


def attention(root, g, time, backward) -> None:
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    for kind, shapes in (("fwd", SELF_SHAPES), ("bwd", TRAIN_SELF_SHAPES if backward else [])):
        total = 0.0
        for label, n, t, c, h, layout in shapes:
            qkv = torch.randn((n, t, 3 * c), generator=g, device="cuda", dtype=torch.bfloat16)
            out, lse = ba.self_attention_cuda(qkv, h, layout)
            if kind == "fwd":
                err, ok = ba.FORWARD_TOL.check(out, ba.self_attention_reference(qkv, h, layout))
                ms = time(lambda: ba.self_attention_cuda(qkv, h, layout))
            else:
                dout = torch.randn((n, t, c), generator=g, device="cuda", dtype=torch.bfloat16)
                got = ba.self_attention_bwd_cuda(qkv, out, lse, dout, h, layout)
                ref = ba.self_attention_backward_reference(qkv, dout, h, layout)
                err, ok = ba.BACKWARD_TOL.check(got, ref)
                ms = time(lambda: ba.self_attention_bwd_cuda(qkv, out, lse, dout, h, layout))
            if not ok:
                raise SystemExit(f"[{root}] {kind} {label}: error {err} over the limit")
            total += ms
            print(f"[{root}] {kind} {label:18s} N={n:5d} T={t:5d} C={c:4d} H={h:2d} {ms:.4f} ms")
        if shapes:
            print(f"[{root}] {kind} summed {total:.4f} ms")
    banded_forward(root, g, time)
    if backward:
        banded_backward(root, g, time)


def banded_forward(root, g, time) -> None:
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    shapes = [(f"{label} N=1", 1, *rest) for label, *rest in BANDED_SHAPES]
    shapes += [(f"{label} N={n}", n, *rest) for label, n, *rest in TRAIN_BANDED_SHAPES]
    totals = {}
    for label, n, f, tq, tk, c, h, lw in shapes:
        make = lambda *shape: torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)  # noqa: E731
        q_src, kv_src = make(n, f, tq, 3 * c), make(n, f, tk, 3 * c)
        s = f - lw
        out, _ = ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c)
        err, ok = ba.FORWARD_TOL.check(out, ba.banded_cross_attention_reference(q_src, kv_src, s, lw, h, c))
        if not ok:
            raise SystemExit(f"[{root}] banded fwd {label}: error {err} over the limit")
        ms = time(lambda: ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c))
        key = f"{'K3' if lw == 1 else 'K2'} N={n}"
        totals[key] = totals.get(key, 0.0) + ms
        print(f"[{root}] banded fwd {label:24s} F={f} Tq={tq:5d} Tk={tk:5d} lw={lw:2d} {ms:.4f} ms")
    for key, total in totals.items():
        print(f"[{root}] banded fwd {key} summed {total:.4f} ms")


def banded_backward(root, g, time) -> None:
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    totals = {}
    for label, n, f, tq, tk, c, h, lw in TRAIN_BANDED_SHAPES:
        make = lambda *shape: torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)  # noqa: E731
        q_src, kv_src, dout = make(n, f, tq, 3 * c), make(n, f, tk, 3 * c), make(n, f, tq, c)
        s = f - lw
        out, lse = ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c)
        got = ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, s, lw, h, c)
        ref = ba.banded_attention_backward_reference(q_src, kv_src, dout, s, lw, h, c)
        for a, b in zip(got, ref):
            err, ok = ba.BACKWARD_TOL.check(a, b)
            if not ok:
                raise SystemExit(f"[{root}] banded bwd {label}: error {err} over the limit")
        call = lambda: ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, s, lw, h, c)  # noqa: E731
        ms = time(call)
        kind = "K6" if lw == 1 else "K7"
        totals[kind] = totals.get(kind, 0.0) + ms
        passes = ", ".join(f"{k} {us:.1f} us" for k, us in pass_us(call, "banded_attention_bwd").items())
        print(f"[{root}] banded bwd {label:20s} N={n} F={f} Tq={tq:5d} Tk={tk:5d} lw={lw:2d} {ms:.4f} ms "
              f"(torch.profiler, per pass: {passes})")
    for kind, total in totals.items():
        print(f"[{root}] banded bwd {kind} summed {total:.4f} ms")


def flash(root, g, time, backward) -> None:
    import torch

    from mm_diffusion_tpu_torch.ops import fused_attention as fa

    totals = {}
    for label, b, h, tq, tk, d, layout in FLASH_SHAPES:
        def make(t):
            shape = (b, h, t, d) if layout == "bhtd" else (b, t, h, d)
            x = torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
            return x if layout == "bhtd" else x.transpose(1, 2)  # [B, H, T, D] views

        q, k, v, dout = make(tq), make(tk), make(tk), make(tq)
        bthd = [x.transpose(1, 2) for x in (q, k, v, dout)]
        out, lse = fa.flash_mha_fwd_cuda(q, k, v)
        err, ok = fa.FORWARD_TOL.check(out, fa.mha_reference(*bthd[:3]).transpose(1, 2))
        if not ok:
            raise SystemExit(f"[{root}] flash fwd {label}: error {err} over the limit")
        runs = {"fwd": lambda: fa.flash_mha_fwd_cuda(q, k, v)}
        if backward:
            for a, r in zip(fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout), fa.mha_backward_reference(*bthd)):
                err, ok = fa.BACKWARD_TOL.check(a, r.transpose(1, 2))
                if not ok:
                    raise SystemExit(f"[{root}] flash bwd {label}: error {err} over the limit")
            runs["bwd"] = lambda: fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout)
        for kind, call in runs.items():
            ms = time(call)
            totals[kind] = totals.get(kind, 0.0) + ms
            passes = ""
            if kind == "bwd":
                us = pass_us(call, "flash_mha_bwd")
                passes = " (torch.profiler, per pass: " + ", ".join(f"{k} {x:.1f} us" for k, x in us.items()) + ")"
            print(f"[{root}] flash {kind} {label:13s} B={b} H={h} Tq={tq:5d} Tk={tk:5d} D={d} {ms:.4f} ms{passes}")
    for kind, total in totals.items():
        print(f"[{root}] flash {kind} summed {total:.4f} ms")


def gemm(root, g, time) -> None:
    import torch

    from mm_diffusion_tpu_torch.ops import gemm_conv as gc
    from mm_diffusion_tpu_torch.tools import bench_skip_conv, conv_chw_spike

    bf = torch.bfloat16
    b, h, w, c, co = bench_skip_conv.SHAPE
    x1, x2 = (torch.randn((b, h, w, c), generator=g, device="cuda", dtype=bf) for _ in range(2))
    wt = torch.randn((2 * c, co), generator=g, device="cuda") * 0.05
    err, ok = gc.GEMM_TOL.check(gc.skip_gemm_cuda(x1, x2, wt), gc.skip_gemm_reference(x1, x2, wt))
    if not ok:
        raise SystemExit(f"[{root}] skip_gemm: error {err} over the limit")
    print(f"[{root}] gemm S3 B={b} {h}x{w} C={c}+{c} -> {co} {time(lambda: gc.skip_gemm_cuda(x1, x2, wt)):.4f} ms")
    del x1, x2
    total = 0.0
    for npx, nblk in conv_chw_spike.GEMM_CASES:
        a = torch.randn((conv_chw_spike.GEMM_CO, conv_chw_spike.GEMM_K), generator=g, device="cuda") * 0.05
        bb = torch.randn((nblk, conv_chw_spike.GEMM_K, npx), generator=g, device="cuda", dtype=bf)
        err, ok = gc.GEMM_TOL.check(gc.gemm_blocks_cuda(a, bb), gc.gemm_blocks_reference(a, bb))
        if not ok:
            raise SystemExit(f"[{root}] gemm_blocks: error {err} over the limit")
        ms = time(lambda: gc.gemm_blocks_cuda(a, bb))
        total += ms
        print(f"[{root}] gemm S4 core npx={npx} nblk={nblk} {ms:.4f} ms")
        del bb
    print(f"[{root}] gemm S4 core summed {total:.4f} ms")


def variants(root, g, time) -> None:
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.tools.bench_attn_variants import CASES

    for variant, cases in (("rows", CASES), ("nomax", CASES[:3]), ("noexp", CASES[:3])):
        total = 0.0
        for label, n, t, c, h in cases:
            qkv = torch.randn((n, t, 3 * c), generator=g, device="cuda", dtype=torch.bfloat16)
            err, ok = ba.VARIANT_TOL[variant].check(ba.self_attention_variant_cuda(qkv, h, variant),
                                                    ba.self_attention_variant_reference(qkv, h, variant))
            if not ok:
                raise SystemExit(f"[{root}] {variant} {label}: error {err} over the limit")
            ms = time(lambda: ba.self_attention_variant_cuda(qkv, h, variant))
            total += ms
            print(f"[{root}] variant {variant:5s} {label:13s} N={n:5d} T={t:5d} C={c:4d} H={h:2d} {ms:.4f} ms")
        print(f"[{root}] variant {variant} summed {total:.4f} ms")


def pass_us(call, kernel: str, calls: int = 5) -> dict:
    """Device microseconds per call of each pass (dq, dkv) of the backward
    whose kernels' names hold ``kernel``, from torch.profiler's kernel
    events over ``calls`` eager calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name:
            key = "dq" if "_dq_" in e.name else "dkv"
            us[key] = us.get(key, 0.0) + e.time_range.elapsed_us() / calls
    return us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+", help="checkouts to compare")
    ap.add_argument("--rounds", type=int, default=2, help="passes over the checkouts, alternating order")
    ap.add_argument("--backward", action="store_true", help="also time the backwards")
    ap.add_argument("--kernels", default="attention",
                    help="comma-separated: attention (K1-K7), flash (K8), gemm (S3, S4 core), "
                         "variants (S1, S2)")
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--replays", type=int, default=10)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    known = {"attention", "flash", "gemm", "variants"}
    if not set(kernels) <= known:
        ap.error(f"--kernels: unknown {sorted(set(kernels) - known)}")
    if args.child:  # run as a file, outside the package: no relative imports
        child(args.child, args.backward, kernels, args.calls, args.replays)
        return 0
    from ..parallel.bootstrap import refuse_launcher

    refuse_launcher("ab_self_attention")
    for r in range(args.rounds):
        for root in args.dirs if r % 2 == 0 else args.dirs[::-1]:
            # the file, not the module: the child must import the package from `root`
            cmd = [sys.executable, os.path.abspath(__file__), root, "--child", root, "--kernels",
                   args.kernels, "--calls", str(args.calls), "--replays", str(args.replays)]
            rc = subprocess.run(cmd + (["--backward"] if args.backward else [])).returncode
            if rc:
                return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
