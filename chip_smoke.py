#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (mm_diffusion_tpu_torch) on one card.

    python3 chip_smoke.py            # all phases, one CUDA device

Phases, each printed as it runs; any failure exits non-zero:
  1. toolchain: torch / CUDA versions, nvcc, the card's name and power limit,
     OpenCV's version; TF32 off for matmuls and convolutions.
  2. build: the hand-written kernels from ops/csrc with nvcc (sm_90a),
     timed, with each kernel's registers and spills as ptxas reports them.
  3. kernels vs their plain PyTorch versions on the card, in bf16, at every
     main-path shape of the flagship sampler (several RS-MMA shifts, the wrap
     included) and K1 at the text-to-image cell's (SDXL, 8 rows, T = 4096 and
     1024); max |error| against the stated tolerance, the kernel's, the plain
     version's and, where one PyTorch call computes the same function, that
     call's device time, and the bound: the least time the card could take
     for the same work.  K1 is checked at ragged T with N >= 2, at T = 16 with
     a partial pack and at head dims 32 and 48; beside each banded shape, as
     a yardstick and not one call for the same function, SDPA's forward on
     the window gathered into [N*F, H, lw*Tk, d] (the gather untimed).  Both
     forwards also run at head dims 12, 36, 136 and 200, which take the
     wrappers' explicit routes (a zero-padded copy, the flash kernels K8
     above 128), each checked with the launch counters showing the kernel
     that ran.  Every time here and in 3b and 7 is device time: a fixed number
     of calls captured in one CUDA graph and replayed between CUDA events
     (mm_diffusion_tpu_torch/utils/timing.py).
  3b. the backward kernels the same way, at every main-path shape of the
     flagship training step (batch 4; banded shifts 0, the middle and the
     last of the span, where the window wraps), and the forward kernels' out
     and lse that they take, held to phase 3's tolerance at those shapes; the
     self-attention backward (K4/K5) and the banded backward (K6/K7) checked,
     timed and bitwise equal over two runs, K4/K5 also at phase 3's extra
     cases, the banded forward (K2/K3) timed per training shape, and the
     banded forward and backward at phase 3's head-dim cases.  The library
     call timed for the self-attention backward is PyTorch's fused
     attention's backward alone, one autograd.grad replayed in the graph (its
     forward+backward is printed beside it); beside each banded shape, as a
     yardstick and not one call for the same function, the same SDPA backward
     on the window gathered into [N*F, H, lw*Tk, d] (the gather untimed).
     Then K1 and K4/K5 at the SR U-Net's training shapes (the per-head qkv
     order, 6 and 12 heads) and the single-modal audio U-Net's (T = 6400,
     1600 and 400 at head dims 64, 96 and 128), batch 4: out, lse and
     gradient against the plain versions, the gradient bitwise over two runs,
     timed beside the plain version, SDPA and the bound.
  4. one model evaluation on the card (bf16, kernels) against the CPU (fp32,
     plain versions) with the same random non-zero weights: the stock
     MM-UNet at batch 1, and the SR U-Net on 2 frames; relative L2 error.
  5. the flagship CLI, scripts/multimodal_sample_sr.py, end to end at the
     launch-script config (20-NFE DPM-Solver base, ddim25 SR of all 16
     frames) with random non-zero weights saved to .pt files; the kernels'
     launch counts over that run, finite outputs, stage wall times.
  6. training: one loss-and-gradient evaluation on the card (bf16, kernels)
     against the CPU (fp32, plain versions) with the same random non-zero
     weights, at full widths and one ResBlock per level; then the train
     CLI, scripts/multimodal_train.py, end to end at the flagship training
     config (batch 4, remat, bf16, synthetic data) for TRAIN_STEPS steps:
     finite loss and gradient norm, the median step time after two warm-up
     steps, peak device memory, the kernels' launch counts; then a resume
     from its checkpoint for one more step.
  7. the kernels of the remaining entry points: 7.1 the flash MHA forward
     and backward (K8, ops/fused_attention.py) at its hot shapes in both
     layouts (SDXL's cross-attention, Tk = 77, among them) (and at head dims
     32, 256, and 12 and 36 on zero-padded copies), the K1 variants of the
     A/B tool (S1/S2: rows, nomax, noexp; also at head dims 12, 36, 136 and
     200 through their routes, checked with the route and launch counters),
     the two-part skip GEMM (S3), the direct 3x3 conv and its GEMM core
     (S4), each against its plain version as in phase 3 with its device
     time, plain time, library time and bound, and planted faults that the
     lse and noexp limits must reject (for the K8 forward, the zero keys
     that pad Tk to 128 and to 64 let into the softmax); the conv's time
     includes its input copy, conv3x3_chw[halo], also checked and timed
     alone, and the Hopper K8 backward must give bitwise equal gradients in
     two runs; 7.2 the entry points themselves -- flash_mha and
     flash_mha_bhtd forward and backward through autograd at 7.1's hot
     shapes against the plain versions, then each A/B tool under
     mm_diffusion_tpu_torch/tools/ once with few iterations -- with the
     kernels' launch counts over that run, which must show the Hopper
     forward and the Hopper backward alone.
  8. zero-shot conditional sampling at the flagship base config of the
     sampling CLI's LAUNCH_SCRIPT_ARGS: 8.1 one step of the gradient method
     (audio->video, scale 3.0: a forward and an input-only backward of the
     MM-UNet) on the card (bf16, kernels) against the CPU (fp32, plain
     versions) with the same random non-zero weights, inputs, noise and a
     fixed shift -- the consistency loss and the gradient with respect to
     the video, the backward kernels' launches (K4-K7 each), the peak
     memory and the step's median time over a few runs; 8.2 the backward
     kernels K4-K7 at the sampler's batch-1 shapes (phase 3's MM-UNet
     shapes, banded shifts 0, the middle and the last) against their plain
     backwards, with device time and bound; 8.3 the a2v CLI,
     scripts/audio2video_sample_sr.py, at the reference's settings (scale
     3.0, ddim25 SR of all 16 frames) with one cut, 25 respaced steps where
     the reference runs 1000: finite outputs, files written, the median
     gradient step, the stage times, the peak memory and each kernel's
     launches (K1-K7 all), and the projected 1000-step clip; 8.4 the v2a
     CLI (the replacement method: no backward) under the same cut.
  9. SR and single-modal training at full width: 9.1 one SR U-Net loss
     and gradient (the SR flags of LAUNCH_SCRIPT_ARGS, 256 <- 64, batch 1)
     on the card (bf16, kernels, use_checkpoint) against the CPU (fp32,
     plain versions), phase 6.1's limits, the backward through K4/K5 at
     T = 1024, 256 and 64; the same for the single-modal audio U-Net
     (25600 samples, 128 channels, 4 heads; K4/K5 at T = 6400, 1600 and
     400); 9.2 scripts/image_sr_train.py at those flags, batch 4,
     use_checkpoint, synthetic data, SR_TRAIN_STEPS steps with a
     checkpoint and a preview triptych at the last, a resume for one step,
     then the same flags without use_checkpoint, whose peak memory must be
     higher; 9.3 scripts/single_modal_train.py for video (16x64x64) and
     audio, batch 4, use_checkpoint: the median step after two warm-up
     steps, the peak memory and K1/K4/K5's launches of each run.
  10. multi-GPU (parallel/) on the one card, through torchrun: 10.1 DDP
     and 10.2 FSDP2 (--n_fsdp 2) at the flagship training config, 2 ranks
     x batch 2 on gloo over CUDA tensors (NCCL refuses two ranks on one
     device), held to the one-rank batch-4 step at phase 6.1's limits
     (loss and gradient norm, gradient rel L2), with K1-K7 launched on
     every rank, the step ms, peak memory and parameter + optimizer + EMA
     bytes per rank, and the collectives' share of the step (DDP's step
     without its all-reduce, no_sync, against it); FSDP2's state must be
     about half of DDP's; 10.3 the train CLI under torchrun on NCCL (one
     rank) with a resume, and the sampling CLI with --n_sample_data 2 on
     two gloo ranks, whose samples must equal the one-rank run's within
     the one-rank spread (the ranks' rows computed at batch 1 in one
     process against the batch-2 run).
  11. evaluation (evaluation/ and the eval CLIs) at the published
     architectures with seeded random weights, fp32 with TF32 off: 11.1
     I3D, the AudioCLIP audio tower, CLIP visual and text, C3D and the
     GraphDef executor (a small graph written with the port's proto
     writers) on the card against the same module on the CPU at the
     published shapes (relative L2), each one's device ms per batch of
     EVAL_BATCH clips or images (CUDA-graph replays), rate and peak memory,
     and the torch resize on the card against the CPU (at most 1 in uint8);
     11.2 the sampling CLI with --save_type npz --run_eval --ref_path
     (LAUNCH_SCRIPT_ARGS at batch 2, 4 clips, phase 10.3's NFE cut,
     EVAL_NUM_11 clips per side): the npz's keys, shapes and dtypes, finite
     metrics on the fallback route, the stage times and K1-K3's launches;
     11.3 scripts/eval.py (I3D and full-AudioCLIP checkpoints, --compute_is:
     protocol "reference"), image_eval.py (--clip_checkpoint) and
     video_is.py (C3D at the published widths) on random-weight checkpoints
     in the original key layouts: finite metrics, wall seconds, peak memory.
  12. the batch-8 path (the benchmark's base-dpm20-b8 cell): 12.1 K1-K3
     at the base MM-UNet's shapes at batch 8 (N = 128 at T = 1024 / 256 /
     64, N = 8192 / 2048 / 512 at T = 16, N = 8 at T = 400; the banded
     shapes at N = 8, shifts 0, the middle and the last of the span)
     against their plain versions, each timed with its bound (K1 beside
     SDPA's forward); 12.2 one evaluation of the flagship base MM-UNet at
     batch 8 against eight batch-1 evaluations of its rows (random
     non-zero weights, one timestep per row, a fixed shift), in bf16 and
     in fp32, with K1-K3 launched.
  13. the GroupNorm + FiLM + SiLU kernel (ops/group_norm.py): 13.1 one
     evaluation of each benchmark sampling model (the flagship SR U-Net on 16
     frames at 256^2, the base MM-UNet at batch 8, SDXL base's U-Net at 8
     rows of 128^2 latents) under inference_mode, every ResBlock, out-head
     and SpatialTransformer norm on the fused route (the attention norms
     counted apart), SDXL's K1 and K8 launches once a transformer block
     (70), its norm kernel's 46, and a train-style forward and backward on
     the autograd route alone; the SR and SDXL norms on the kernel's
     channels-last mode (route "fused_cl"), the base model's on the
     channels-first one; the image U-Nets' ResBlocks with their conv biases
     folded (ops/group_norm.BIAS_FOLDS: 42 / 42 / 20 an SR evaluation, 17 /
     17 / 11 an SDXL one) and their residual passes on the kernel; 13.2
     the kernel at each shape 13.1 recorded, in the layout recorded and with
     the input term recorded, against its plain version, timed beside its
     4-byte and 6-byte bounds, its two-read mode, the channels-first mode
     on the same shape, the plain version and the eager chain, and both
     modes' names in a profiler trace classified "group norm" by
     benchmark/trace.py; 13.3 cuDNN's layout transposes (nchwToNhwc,
     nhwcToNchw) counted, with their device seconds, in one traced SR
     evaluation; 13.4 the residual + bias kernel (ops/residual.py) at each
     ResBlock output 13.1 recorded against its plain version (the same
     bits), timed beside its 6-byte bound and the two eager adds it
     replaces, its name classified "elementwise".  Alone:
     ``python3 -c "import chip_smoke as cs; cs.toolchain(); cs.build();
     cs.group_norm_kernel()"``.

Standard output ends with phase 13's JSON record (the routes, the largest
error and the per-evaluation sums), then three lines: the kernels' JSON record
(launches on the main paths -- K1-K3 in phase 5's sampling run, K4-K7 in
phase 6's training run, K8 and S1-S4 in phase 7.2's entry-point run, where a
graph replay re-runs captured launches without counting them -- and the
per-call numbers of phases 3, 3b and 7.1 summed over each kernel's main-path
or hot shapes; K1-K7 carry ``a2v_launches``, their launches in phase 8.3's
a2v run (K1's include the SR stage's), and K4-K7 ``a2v_ms`` and
``a2v_bound_ms``, phase 8.2's per-call numbers summed over the sampler's
batch-1 shapes; K1, K4 and K5 carry ``sr_train_launches``,
``single_video_train_launches`` and ``single_audio_train_launches``, their
launches in phases 9.2 and 9.3's training runs, and ``sr_train_ms`` /
``audio_train_ms`` with their ``*_bound_ms``, phase 3b's per-call numbers
summed over the SR and audio training shapes; K1-K3 carry
``eval_cli_launches``, their launches in phase 11.2's sampling run with the
evaluation, and ``b8_ms``, ``b8_bound_ms`` and ``b8_library_ms`` (K1's
SDPA; null for K2/K3), phase 12.1's per-call numbers summed over the
batch-8 shapes), the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import tempfile
import time

from mm_diffusion_tpu_torch.tools.ab_self_attention import (
    BANDED_SHAPES, FLASH_SHAPES, SELF_SHAPES, TRAIN_BANDED_SHAPES, TRAIN_SELF_SHAPES,
)

REPO = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()  # the script's own clock, printed with each phase

# Each kernel is held to its plain version by the limit its ops module
# states (FORWARD_TOL, LSE_TOL, BACKWARD_TOL and VARIANT_TOL in
# block_attention.py, which fused_attention.py shares; GEMM_TOL in
# gemm_conv.py), here and in the card tests alike.
# bf16 model on the card vs fp32 on the CPU, relative L2 over the output.
MODEL_REL_L2_TOL = 5e-2
BANDED_SHIFTS = 3  # shifts per banded shape: 0, the middle and the last of the span

# Main-path shapes of the SR U-Net's and the single-modal audio U-Net's
# training steps at batch 4 (phase 3b's extra backward cases, checked and
# timed with their bounds, not in the sums): the SR U-Net's attention at
# 64x64 / 32x32 / 16x16 of its 256x256 input (ds 8/16/32, head dim 64, the
# per-head qkv order), and the audio stream's self-attention at 25600 / 4^k
# samples (128 channels, mult 1,2,3,4, 4 heads: head dims 64, 96, 128).
SR_TRAIN_SELF_SHAPES = [  # (label, N, T, C, heads, layout)
    ("sr ds8", 4, 1024, 384, 6, "per_head"),
    ("sr ds16", 4, 256, 768, 12, "per_head"),
    ("sr ds32", 4, 64, 768, 12, "per_head"),
]
AUDIO_TRAIN_SELF_SHAPES = [  # (label, N, T, C, heads, layout)
    ("audio ds2", 4, 6400, 256, 4, "thirds"),
    ("audio ds4", 4, 1600, 384, 4, "thirds"),
    ("audio ds8", 4, 400, 512, 4, "thirds"),
]
# Extra self-attention cases of phases 3 and 3b (checked and timed, not in
# the sums): ragged T with N >= 2, whose rows past T are the next sequence's;
# T = 16 with an N that leaves the last packed tile partial; head dims 32
# and 48, which run on the kernels built for 32 and 64; head dims 12, 36
# (zero-padded to 16 and 40), 136 and 200 (the flash kernels, K8).
SELF_EXTRA_SHAPES = [  # (label, N, T, C, heads, layout)
    ("ragged N=3 T=400", 3, 400, 512, 4, "thirds"),
    ("ragged N=5 T=100", 5, 100, 256, 4, "per_head"),
    ("packed N=1023 T=16", 1023, 16, 256, 4, "thirds"),
    ("head dim 32", 16, 256, 128, 4, "thirds"),
    ("head dim 48", 16, 256, 192, 4, "per_head"),
    ("head dim 12", 16, 100, 48, 4, "thirds"),
    ("head dim 36", 16, 256, 144, 4, "per_head"),
    ("head dim 136", 4, 256, 544, 4, "thirds"),
    ("head dim 200", 4, 100, 400, 2, "per_head"),
]
# Extra banded cases of phases 3 and 3b (batch 1 and 2; checked and timed,
# not in the sums): head dims 12, 36, 136 and 200, as above.
BANDED_EXTRA_SHAPES = [  # (label, F, Tq, Tk, C, heads, lw)
    ("head dim 12", 16, 64, 25, 48, 4, 8),
    ("head dim 36", 16, 100, 256, 144, 4, 1),
    ("head dim 136", 16, 64, 25, 272, 2, 4),
    ("head dim 200", 16, 25, 64, 400, 2, 16),
]
KERNEL_SOURCE = {
    "self_attention": "mm_diffusion_tpu_torch/ops/csrc/self_attention.cu",
    "banded_attention": "mm_diffusion_tpu_torch/ops/csrc/banded_attention.cu",
    "self_attention_bwd": "mm_diffusion_tpu_torch/ops/csrc/self_attention_bwd.cu",
    "banded_attention_bwd": "mm_diffusion_tpu_torch/ops/csrc/banded_attention_bwd.cu",
}
REPLACES = {  # the Pallas kernel bodies in the JAX package
    "self_attention": "mm_diffusion_tpu/ops/block_attention.py:165",  # K1
    "banded_attention[lw>1]": "mm_diffusion_tpu/ops/block_attention.py:609",  # K2
    "banded_attention[lw=1]": "mm_diffusion_tpu/ops/block_attention.py:534",  # K3
    "self_attention_bwd[T<=512]": "mm_diffusion_tpu/ops/block_attention.py:195",  # K4
    "self_attention_bwd[T>512]": "mm_diffusion_tpu/ops/block_attention.py:264",  # K5
    "banded_attention_bwd[lw=1]": "mm_diffusion_tpu/ops/block_attention.py:792",  # K6
    "banded_attention_bwd[lw>1]": "mm_diffusion_tpu/ops/block_attention.py:877",  # K7
}

# Phase 7: K8 and the A/B tools' kernels (S1-S4); FLASH_SHAPES are K8's hot
# shapes.
# K8 at head dims 32 and 256, and 12 and 36 on zero-padded copies (checked
# and timed, not in the sums).
FLASH_EXTRA_SHAPES = [
    ("self d=32", 128, 4, 1024, 1024, 32, "bhtd"),
    ("video->audio d=256", 32, 4, 1024, 400, 256, "bthd"),
    ("self d=12", 16, 4, 256, 256, 12, "bhtd"),
    ("audio->video d=36", 16, 4, 100, 256, 36, "bthd"),
]
CONV_CHECK_IMAGES = 2  # S4: the fp32 plain version is compared on 2 of the 16 images
REPLACES.update({
    "flash_mha_fwd": "mm_diffusion_tpu/ops/fused_attention.py:69 "
                     "(jax/experimental/pallas/ops/tpu/flash_attention.py:758)",  # K8
    "flash_mha_bwd": "mm_diffusion_tpu/ops/fused_attention.py:69 "
                     "(jax/experimental/pallas/ops/tpu/flash_attention.py:1121,1456)",  # K8
    "self_attention_variant[rows]": "tools/bench_attn_variants.py:36",  # S1
    "self_attention_variant[nomax]": "tools/bench_attn_variants2.py:40",  # S2
    "self_attention_variant[noexp]": "tools/bench_attn_variants2.py:40",  # S2
    "skip_gemm": "tools/bench_skip_conv.py:39",  # S3
    "conv3x3_chw": "tools/conv_chw_spike.py:69",  # S4
    "conv3x3_chw[halo]": "tools/conv_chw_spike.py:69",  # S4's input copy (its haloed concat)
    "gemm_blocks": "tools/conv_chw_spike.py:217",  # S4 core
})
KERNEL_SOURCE.update({
    "flash_mha_fwd": "mm_diffusion_tpu_torch/ops/csrc/flash_mha.cu",
    "flash_mha_bwd": "mm_diffusion_tpu_torch/ops/csrc/flash_mha.cu",
    "self_attention_variant": "mm_diffusion_tpu_torch/ops/csrc/self_attention.cu",
    "skip_gemm": "mm_diffusion_tpu_torch/ops/csrc/skip_gemm.cu",
    "conv3x3_chw": "mm_diffusion_tpu_torch/ops/csrc/conv3x3_chw.cu",
    "gemm_blocks": "mm_diffusion_tpu_torch/ops/csrc/skip_gemm.cu",
})
# Device time of a call: TIME_CALLS calls captured in one CUDA graph, the
# graph replayed TIME_REPLAYS times (utils/timing.py::device_ms).
TIME_CALLS, TIME_REPLAYS = 5, 4

# The card's peaks for the bound (H100 SXM data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
TRAIN_STEPS = 10  # train CLI steps in phase 6 (median taken after two warm-up steps)
# Phase 6.1, bf16 on the card vs fp32 on the CPU, same weights and draws:
# the relative L2 of the flattened gradient (H100 reading 1.315e-2, the
# same in two runs) and the relative gap of the loss (reading 5.2e-4).
# Each limit leaves a margin of about 4x (gradient) and 20x (loss) over
# its reading: enough for bf16 rounding, not for a wrong gradient path.
GRAD_REL_L2_TOL = 5e-2
LOSS_REL_TOL = 1e-2


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str) -> None:
    print(f"\n== {name} (at {time.perf_counter() - START:.0f} s)", flush=True)


def time_ms(fn) -> float:
    """Device ms per call: TIME_CALLS calls captured in one CUDA graph,
    replayed TIME_REPLAYS times between CUDA events (utils/timing.py)."""
    from mm_diffusion_tpu_torch.utils.timing import device_ms

    return device_ms(fn, calls=TIME_CALLS, replays=TIME_REPLAYS)


def bound_ms(flops: float, nbytes: float):
    """(least ms the card could take, "operations" or "bytes"): the larger
    of the bf16 tensor-core time and the device-memory time."""
    ops, mem = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES_PER_S * 1e3
    return max(ops, mem), "operations" if ops >= mem else "bytes"


def self_attention_work(n, t, c, h, backward=False, lse=True):
    """(FLOPs, bytes) of packed self-attention, bf16 in and out, fp32 lse
    (none without ``lse``: the K1 variants): the forward's two [T, T]
    products, or the backward's five (S, dP, dV, dQ, dK), each input read
    once and each output written once."""
    d = c // h
    rows, lse = n * t, n * h * t * 4 * lse
    if not backward:
        return 4 * n * h * t * t * d, rows * (3 * c + c) * 2 + lse
    return 10 * n * h * t * t * d, rows * (3 * c + c + c + 3 * c) * 2 + lse


def banded_work(n, f, tq, tk, c, h, lw, backward=False):
    """(FLOPs, bytes) of banded attention: q lanes of q_src and k|v lanes of
    kv_src read once (a kv frame is read once however many windows hold
    it), out (and dout) C lanes, lse; the backward writes both packed
    gradients whole (3C lanes, the zeros included)."""
    d = c // h
    keys = lw * tk
    lse = n * f * h * tq * 4
    reads = (n * f * tq * c + n * f * tk * 2 * c) * 2 + lse
    if not backward:
        return 4 * n * f * h * tq * keys * d, reads + n * f * tq * c * 2
    writes = n * f * (tq + tk) * 3 * c * 2
    return 10 * n * f * h * tq * keys * d, reads + 2 * n * f * tq * c * 2 + writes


def packed_views(layout, num_heads):
    """``qkv [N, T, 3C] -> (q, k, v)`` as strided ``[N, H, T, d]`` views."""
    from mm_diffusion_tpu_torch.ops import block_attention as ba

    return lambda x: ba.packed_head_views(x, num_heads, layout)


def library_attention_ms(views, leaves, dout=None):
    """The yardstick: ``scaled_dot_product_attention`` on ``views(*leaves)``
    (q, k, v as ``[N, H, T, d]``), device time (CUDA graph replays).
    Without ``dout``, the forward's ms; with it (``[N, H, Tq, d]``),
    ``(backward ms, forward+backward ms)``: the backward alone is one
    ``autograd.grad`` into ``leaves`` of a forward recorded on the capture
    stream, replayed in the graph -- the function the backward kernels
    compute.  Timed here only; the port never calls it."""
    import torch
    import torch.nn.functional as F

    from mm_diffusion_tpu_torch.utils.timing import on_capture_stream

    def fwd(*xs):
        return F.scaled_dot_product_attention(*views(*xs))

    if dout is None:
        with torch.no_grad():
            return time_ms(lambda: fwd(*leaves))
    xs = [x.detach().requires_grad_() for x in leaves]
    with on_capture_stream():
        out = fwd(*xs)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, xs, dout, retain_graph=True))
    return bwd_ms, time_ms(lambda: torch.autograd.grad(fwd(*xs), xs, dout))


def gathered_window(q_src, kv_src, dout, shift, lw, h, c):
    """The banded attention's window gathered for SDPA, outside any timing:
    ``([q, k, v], dout)`` as contiguous ``[N*F, H, T, d]`` tensors, k and v
    over the lw * Tk keys of each query frame's window."""
    from mm_diffusion_tpu_torch.ops import block_attention as ba

    n, f, tq, _ = q_src.shape
    *qkv, _ = ba.gathered_window_views(q_src, kv_src, shift, lw, h)
    g = dout.reshape(n * f, tq, h, c // h).transpose(1, 2)
    return [x.contiguous() for x in qkv], g.contiguous()


def toolchain() -> str:
    import torch

    from mm_diffusion_tpu_torch.ops import cuda_build
    from mm_diffusion_tpu_torch.utils.timing import nvidia_smi_line

    phase("1. toolchain")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvcc: {cuda_build.find_nvcc()}")
    print(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    print(f"nvidia-smi: {smi}")
    print("TF32: matmul off, cudnn off")
    try:  # the datasets' decoder
        import cv2

        print(f"OpenCV: {cv2.__version__}")
    except ImportError:
        print("OpenCV: not installed")
    return smi


def ptxas_table(log: str):
    """[(kernel, registers, spill stores, spill loads)] from nvcc's
    ``-Xptxas -v`` output; kernels named ``name<template ints, type>``."""
    import re

    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN6mmdiff\d+([a-z0-9_]+)(\w*)'", line)
        if m:
            tmpl = m.group(2) if m.group(2).startswith("I") else ""
            kind = "bf16" if "bfloat16" in tmpl else ("f32" if re.search(r"E(f|S\d_)", tmpl) else "")
            args = re.findall(r"Li(\d+)E", tmpl) + ([kind] if kind else [])
            name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


def build() -> None:
    from mm_diffusion_tpu_torch.ops import cuda_build

    phase("2. build kernels")
    t0 = time.perf_counter()
    built = cuda_build.load()
    print(f"library: {built.path}")
    print(f"nvcc compile {built.build_seconds:.2f} s, load total {time.perf_counter() - t0:.2f} s")
    table = ptxas_table(built.log)
    print(f"ptxas per kernel ({len(table)}): registers, spill stores / loads (bytes); "
          "self_attention_sm90_kernel<head dim, warpgroups, mode>: mode 0 K1, 1 rows (S1; at "
          "T <= 32 self_attention_rows_sm90_kernel), 2 nomax, 3 noexp (S2)")
    for name, regs, st, ld in table:
        flag = " (Hopper design)" if "sm90" in name else ""
        print(f"  {name:48s} {regs:4d} regs  spill {st}/{ld}{flag}")


def head_dim_route(d):
    """The route head dim ``d`` takes through the attention wrappers:
    "kernel", "pad" (a zero-padded copy on the same kernel) or "flash" (the
    K8 kernels, d above 128)."""
    from mm_diffusion_tpu_torch.ops import block_attention as ba

    dp = ba.padded_head_dim(d)
    return "flash" if dp > ba.HEAD_DIMS[-1] else ("pad" if dp != d else "kernel")


def routed_call(name, d, call):
    """Run ``call`` once with every launch counter at 0 and check that the
    kernel of head dim ``d``'s route ran: the wrapper's own kernel (padded
    or not), or K8's.  Returns ``(call's result, a note of what ran)``."""
    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.ops import fused_attention as fa

    ba.reset_launch_counts()
    fa.reset_launch_counts()
    result = call()
    route, routes = head_dim_route(d), dict(ba.HEAD_DIM_ROUTES)
    flash = fa.LAUNCHES["flash_mha_bwd" if name.endswith("_bwd") else "flash_mha_fwd"]
    own = ba.LAUNCHES[name]
    ran = (flash == 1 and own == 0) if route == "flash" else (own == 1 and flash == 0)
    padded = routes.get(f"{name}:pad", 0) == (d % 8 != 0)
    check(ran and padded, f"{name} d={d}: route {route}, launches {name} {own} / K8 {flash}, {routes}")
    return result, f"route {route}: launches {name} {own}, K8 {flash}, {routes}"


def kernel_parity():
    """Phase 3; returns {kernel name: per-call numbers summed over shapes}."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    phase(f"3. kernels vs plain versions (bf16; out {ba.FORWARD_TOL}, lse {ba.LSE_TOL})")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    summary = {}
    record = recorder(summary)

    for label, n, t, c, h, layout in SELF_SHAPES + SELF_EXTRA_SHAPES:
        main = (label, n, t, c, h, layout) in SELF_SHAPES
        d = c // h
        qkv = torch.randn((n, t, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
        (out, lse), ran = routed_call("self_attention", d, lambda: ba.self_attention_cuda(qkv, h, layout))
        err, lse_err, ok = self_forward_check(qkv, h, layout, out, lse)
        check(ok, f"self_attention {label}: err {err}, lse {lse_err}")
        ms = time_ms(lambda: ba.self_attention_cuda(qkv, h, layout))
        plain_ms = time_ms(lambda: ba.self_attention_reference(qkv, h, layout))
        lib_ms = library_attention_ms(packed_views(layout, h), [qkv])
        bound = bound_ms(*self_attention_work(n, t, c, h))
        print(
            f"self_attention {label:18s} N={n:5d} T={t:5d} C={c:4d} H={h:2d} {layout:8s} "
            f"err={err:.3e} lse_err={lse_err:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"library (SDPA fwd)={lib_ms:.4f} ms bound={bound[0]:.4f} ms ({bound[1]})"
            + ("" if main else f" [extra case, not summed; {ran}]")
        )
        if main:
            record("self_attention", max(err, lse_err), ms, plain_ms, bound, lib_ms)

    for label, f, tq, tk, c, h, lw in BANDED_SHAPES + BANDED_EXTRA_SHAPES:
        main = (label, f, tq, tk, c, h, lw) in BANDED_SHAPES
        d = c // h
        q_src = torch.randn((1, f, tq, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
        kv_src = torch.randn((1, f, tk, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
        span = f - lw
        shifts = sorted({0, span // 2, span})[:BANDED_SHIFTS]
        name = "banded_attention[lw=1]" if lw == 1 else "banded_attention[lw>1]"
        worst = 0.0
        for s in shifts:
            (out, lse), ran = routed_call(
                "banded_attention", d, lambda: ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c)
            )
            err, lse_err, ok = banded_forward_check(q_src, kv_src, s, lw, h, c, out, lse)
            check(ok, f"banded {label} shift {s}: err {err}, lse {lse_err}")
            worst = max(worst, err, lse_err)
        s = shifts[-1]
        ms = time_ms(lambda: ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c))
        plain_ms = time_ms(lambda: ba.banded_cross_attention_reference(q_src, kv_src, s, lw, h, c))
        bound = bound_ms(*banded_work(1, f, tq, tk, c, h, lw))
        window, _ = gathered_window(q_src, kv_src, q_src[..., :c], s, lw, h, c)
        sdpa_ms = library_attention_ms(lambda *xs: xs, window)
        del window
        print(
            f"banded_attention {label:20s} F={f} Tq={tq:5d} Tk={tk:5d} C={c} H={h} lw={lw:2d} "
            f"shifts={shifts} err={worst:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"bound={bound[0]:.4f} ms ({bound[1]}); yardstick, not the same function: "
            f"library (SDPA fwd, gathered window)={sdpa_ms:.4f} ms"
            + ("" if main else f" [extra case, not summed; {ran}]")
        )
        if main:
            record(name, worst, ms, plain_ms, bound, None)
    return summary


def self_forward_check(qkv, h, layout, out, lse):
    """(max |out error|, max |lse error|, both within their limits) of the
    self-attention kernel's ``out`` and ``lse`` against the plain version
    and the logsumexp of the scaled logits."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    ref = ba.self_attention_reference(qkv, h, layout)
    q, k, _ = ba.split_packed_qkv(qkv.float(), h, layout)
    lse_ref = torch.logsumexp(torch.einsum("nqhd,nkhd->nhqk", q, k) / q.shape[-1] ** 0.5, dim=-1)
    (err, ok), (lse_err, lse_ok) = ba.FORWARD_TOL.check(out, ref), ba.LSE_TOL.check(lse, lse_ref)
    return err, lse_err, ok and lse_ok


def banded_forward_check(q_src, kv_src, s, lw, h, c, out, lse):
    """The same for the banded kernel: ``lse`` [N, F, H, Tq] is the
    logsumexp over the lw * Tk keys of the joint window."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    n, f, tq, _ = q_src.shape
    tk, d = kv_src.shape[2], c // h
    ref = ba.banded_cross_attention_reference(q_src, kv_src, s, lw, h, c)
    idx = ba.window_frame_indices(f, lw, s, q_src.device)
    q = q_src[..., :c].float().reshape(n, f, tq, h, d)
    k = kv_src[..., c : 2 * c].float()[:, idx].reshape(n, f, lw * tk, h, d)
    lse_ref = torch.logsumexp(torch.einsum("nfqhd,nfkhd->nfhqk", q, k) / d**0.5, dim=-1)
    (err, ok), (lse_err, lse_ok) = ba.FORWARD_TOL.check(out, ref), ba.LSE_TOL.check(lse, lse_ref)
    return err, lse_err, ok and lse_ok


def recorder(summary):
    """``record(name, err, ms, plain_ms, (bound_ms, bound_by), library_ms)``
    into ``summary``: the worst error, per-call times summed over the
    shapes, the limiter of the largest bound share."""

    def record(name, err, ms, plain_ms, bound, lib_ms):
        s = summary.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "by": {"bytes": 0.0, "operations": 0.0}, "library_ms": 0.0,
        })
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["bound_ms"] += bound[0]
        s["by"][bound[1]] += bound[0]
        s["library_ms"] = None if lib_ms is None or s["library_ms"] is None else s["library_ms"] + lib_ms

    return record


def backward_parity(forward_summary):
    """Phase 3b: the backward kernels at the training step's shapes, after
    the forward kernels whose out and lse they take, held to the forward
    limits there too (their errors go into ``forward_summary``)."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    phase(f"3b. backward kernels vs plain backwards (bf16, {ba.BACKWARD_TOL})")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    summary = {}
    record = recorder(summary)

    def worst_fwd(name, *errs):
        forward_summary[name]["max_abs_err"] = max(forward_summary[name]["max_abs_err"], *errs)

    extra = [(label, n * (4 if t > 16 else 1), t, c, h, layout)
             for label, n, t, c, h, layout in SELF_EXTRA_SHAPES]
    for label, n, t, c, h, layout in TRAIN_SELF_SHAPES + extra:
        main = (label, n, t, c, h, layout) in TRAIN_SELF_SHAPES
        qkv = torch.randn((n, t, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
        dout = torch.randn((n, t, c), generator=g, device=dev, dtype=torch.bfloat16)
        out, lse = ba.self_attention_cuda(qkv, h, layout)
        fwd_err, lse_err, fwd_ok = self_forward_check(qkv, h, layout, out, lse)
        check(fwd_ok, f"self_attention {label} (training shape): err {fwd_err}, lse {lse_err}")
        if main:
            worst_fwd("self_attention", fwd_err, lse_err)
        dqkv, ran = routed_call("self_attention_bwd", c // h,
                                lambda: ba.self_attention_bwd_cuda(qkv, out, lse, dout, h, layout))
        check(torch.equal(dqkv, ba.self_attention_bwd_cuda(qkv, out, lse, dout, h, layout)),
              f"self_attention_bwd {label}: two runs differ")
        ref = ba.self_attention_backward_reference(qkv, dout, h, layout)
        err, ok = ba.BACKWARD_TOL.check(dqkv, ref)
        check(ok, f"self_attention_bwd {label}: err {err}")
        ms = time_ms(lambda: ba.self_attention_bwd_cuda(qkv, out, lse, dout, h, layout))
        scale = ref.float().abs().max().item()
        del ref
        plain_ms = time_ms(lambda: ba.self_attention_backward_reference(qkv, dout, h, layout))
        g_heads = dout.view(n, t, h, c // h).transpose(1, 2)
        lib_ms, lib_fwd_bwd_ms = library_attention_ms(packed_views(layout, h), [qkv], g_heads)
        bound = bound_ms(*self_attention_work(n, t, c, h, backward=True))
        print(
            f"self_attention_bwd {label:18s} N={n:5d} T={t:5d} C={c} H={h} {layout:8s} "
            f"forward err={fwd_err:.3e} lse_err={lse_err:.3e}; err={err:.3e} "
            f"(max|plain| {scale:.3e}) kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"library bwd={lib_ms:.4f} ms (fwd+bwd {lib_fwd_bwd_ms:.4f} ms) "
            f"bound={bound[0]:.4f} ms ({bound[1]})" + ("" if main else f" [extra case, not summed; {ran}]")
        )
        name = "self_attention_bwd[T>512]" if t >= ba.K5_MIN_T else "self_attention_bwd[T<=512]"
        if main:
            record(name, err, ms, plain_ms, bound, lib_ms)

    fwd_sums = {}
    for label, n, f, tq, tk, c, h, lw in TRAIN_BANDED_SHAPES:
        q_src = torch.randn((n, f, tq, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
        kv_src = torch.randn((n, f, tk, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
        dout = torch.randn((n, f, tq, c), generator=g, device=dev, dtype=torch.bfloat16)
        span = f - lw
        shifts = sorted({0, span // 2, span})
        worst = fwd_worst = 0.0
        for s in shifts:
            out, lse = ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c)
            fwd_err, lse_err, fwd_ok = banded_forward_check(q_src, kv_src, s, lw, h, c, out, lse)
            check(fwd_ok, f"banded {label} shift {s} (training shape): err {fwd_err}, lse {lse_err}")
            fwd_worst = max(fwd_worst, fwd_err, lse_err)
            worst_fwd("banded_attention[lw=1]" if lw == 1 else "banded_attention[lw>1]",
                      fwd_err, lse_err)
            got = ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, s, lw, h, c)
            ref = ba.banded_attention_backward_reference(q_src, kv_src, dout, s, lw, h, c)
            for name_, a, b in zip(("dq_src", "dkv_src"), got, ref):
                err, ok = ba.BACKWARD_TOL.check(a, b)
                check(ok, f"banded_attention_bwd {label} shift {s} {name_}: err {err}")
                worst = max(worst, err)
            check(not got[0][..., c:].any() and not got[1][..., :c].any(),
                  f"banded_attention_bwd {label} shift {s}: non-zero lanes outside q / k|v")
            check(all(torch.equal(a, b) for a, b in zip(
                got, ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, s, lw, h, c))),
                f"banded_attention_bwd {label} shift {s}: two runs differ")
            del got, ref
        fwd_ms = time_ms(lambda: ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c))
        kind = "banded_attention[lw=1]" if lw == 1 else "banded_attention[lw>1]"
        fwd_sums[kind] = fwd_sums.get(kind, 0.0) + fwd_ms
        print(f"banded_attention {label:20s} N={n} F={f} Tq={tq:5d} Tk={tk:5d} lw={lw:2d} (training "
              f"shape, shift {s}): kernel={fwd_ms:.4f} ms")
        ms = time_ms(lambda: ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, s, lw, h, c))
        plain_ms = time_ms(
            lambda: ba.banded_attention_backward_reference(q_src, kv_src, dout, s, lw, h, c)
        )
        sdpa_ms, sdpa_fwd_bwd_ms = library_attention_ms(
            lambda *xs: xs, *gathered_window(q_src, kv_src, dout, s, lw, h, c)
        )
        bound = bound_ms(*banded_work(n, f, tq, tk, c, h, lw, backward=True))
        print(
            f"banded_attention_bwd {label:20s} N={n} F={f} Tq={tq:5d} Tk={tk:5d} C={c} H={h} "
            f"lw={lw:2d} shifts={shifts} forward err={fwd_worst:.3e}; err={worst:.3e} kernel={ms:.4f} ms "
            f"plain={plain_ms:.4f} ms bound={bound[0]:.4f} ms ({bound[1]}); yardstick, not the same "
            f"function: SDPA bwd on the gathered window {sdpa_ms:.4f} ms (fwd+bwd {sdpa_fwd_bwd_ms:.4f} ms)"
        )
        name = "banded_attention_bwd[lw=1]" if lw == 1 else "banded_attention_bwd[lw>1]"
        record(name, worst, ms, plain_ms, bound, None)
    for kind, ms in fwd_sums.items():
        print(f"{kind} at the training shapes, summed: {ms:.4f} ms")
    banded_head_dims(g)
    return summary


def banded_head_dims(g) -> None:
    """Phase 3b's banded head-dim cases (batch 2): the forward and backward
    through their routes against the plain versions, the last shift of the
    span."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    for label, f, tq, tk, c, h, lw in BANDED_EXTRA_SHAPES:
        n, d, s = 2, c // h, f - lw
        make = lambda *shape: torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)  # noqa: E731
        q_src, kv_src, dout = make(n, f, tq, 3 * c), make(n, f, tk, 3 * c), make(n, f, tq, c)
        (out, lse), ran_fwd = routed_call(
            "banded_attention", d, lambda: ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c))
        fwd_err, lse_err, fwd_ok = banded_forward_check(q_src, kv_src, s, lw, h, c, out, lse)
        check(fwd_ok, f"banded {label} (batch 2): err {fwd_err}, lse {lse_err}")
        got, ran = routed_call("banded_attention_bwd", d, lambda: ba.banded_attention_bwd_cuda(
            q_src, kv_src, out, lse, dout, s, lw, h, c))
        ref = ba.banded_attention_backward_reference(q_src, kv_src, dout, s, lw, h, c)
        errs = [ba.BACKWARD_TOL.check(a, b) for a, b in zip(got, ref)]
        check(all(ok for _, ok in errs), f"banded_attention_bwd {label}: err {errs}")
        check(all(torch.equal(a, b) for a, b in zip(got, ba.banded_attention_bwd_cuda(
            q_src, kv_src, out, lse, dout, s, lw, h, c))), f"banded_attention_bwd {label}: two runs differ")
        ms = time_ms(lambda: ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, s, lw, h, c))
        print(f"banded_attention_bwd {label:20s} N={n} F={f} Tq={tq:5d} Tk={tk:5d} C={c} H={h} lw={lw:2d} "
              f"shift={s} forward err={max(fwd_err, lse_err):.3e}; err={max(e for e, _ in errs):.3e} "
              f"kernel={ms:.4f} ms [extra case, not summed; forward {ran_fwd}; backward {ran}]")


def slice_attention_cases(forward_summary, backward_summary):
    """Phase 3b, continued: the self-attention forward (K1) and backward
    (K4/K5) at the SR U-Net's and the single-modal audio U-Net's training
    shapes (SR_TRAIN_SELF_SHAPES, AUDIO_TRAIN_SELF_SHAPES), each held to its
    plain version (the forward's out and lse too), the backward also
    bitwise over two runs; timed with the plain version, the library call
    and the bound.  Errors go into the kernels' summaries; returns {kernel:
    {"sr_train_ms", "sr_train_bound_ms", "audio_train_ms",
    "audio_train_bound_ms"}} summed over each kernel's shapes."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    phase(f"3b. (continued) K1 and K4/K5 at the SR U-Net's (per-head qkv) and the single-modal audio "
          f"U-Net's training shapes, batch 4 (out {ba.FORWARD_TOL}, lse {ba.LSE_TOL}, backward "
          f"{ba.BACKWARD_TOL})")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    sums = {}

    def add(name, key, ms, bound):
        d = sums.setdefault(name, {})
        d[f"{key}_ms"] = d.get(f"{key}_ms", 0.0) + ms
        d[f"{key}_bound_ms"] = d.get(f"{key}_bound_ms", 0.0) + bound[0]

    for key, shapes in (("sr_train", SR_TRAIN_SELF_SHAPES), ("audio_train", AUDIO_TRAIN_SELF_SHAPES)):
        for label, n, t, c, h, layout in shapes:
            qkv = torch.randn((n, t, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
            dout = torch.randn((n, t, c), generator=g, device=dev, dtype=torch.bfloat16)
            (out, lse), ran = routed_call("self_attention", c // h,
                                          lambda: ba.self_attention_cuda(qkv, h, layout))
            fwd_err, lse_err, ok = self_forward_check(qkv, h, layout, out, lse)
            check(ok, f"self_attention {label}: err {fwd_err}, lse {lse_err}")
            fwd_ms = time_ms(lambda: ba.self_attention_cuda(qkv, h, layout))
            fwd_plain_ms = time_ms(lambda: ba.self_attention_reference(qkv, h, layout))
            fwd_lib_ms = library_attention_ms(packed_views(layout, h), [qkv])
            fwd_bound = bound_ms(*self_attention_work(n, t, c, h))
            print(f"self_attention {label:11s} N={n} T={t:5d} C={c} H={h:2d} {layout:8s} err={fwd_err:.3e} "
                  f"lse_err={lse_err:.3e} kernel={fwd_ms:.4f} ms plain={fwd_plain_ms:.4f} ms library "
                  f"(SDPA fwd)={fwd_lib_ms:.4f} ms bound={fwd_bound[0]:.4f} ms ({fwd_bound[1]}) [{ran}]")
            dqkv, ran = routed_call("self_attention_bwd", c // h,
                                    lambda: ba.self_attention_bwd_cuda(qkv, out, lse, dout, h, layout))
            check(torch.equal(dqkv, ba.self_attention_bwd_cuda(qkv, out, lse, dout, h, layout)),
                  f"self_attention_bwd {label}: two runs differ")
            ref = ba.self_attention_backward_reference(qkv, dout, h, layout)
            err, ok = ba.BACKWARD_TOL.check(dqkv, ref)
            check(ok, f"self_attention_bwd {label}: err {err}")
            scale = ref.float().abs().max().item()
            del ref, dqkv
            ms = time_ms(lambda: ba.self_attention_bwd_cuda(qkv, out, lse, dout, h, layout))
            plain_ms = time_ms(lambda: ba.self_attention_backward_reference(qkv, dout, h, layout))
            g_heads = dout.view(n, t, h, c // h).transpose(1, 2)
            lib_ms, lib_fwd_bwd_ms = library_attention_ms(packed_views(layout, h), [qkv], g_heads)
            bound = bound_ms(*self_attention_work(n, t, c, h, backward=True))
            name = bwd_kernel_name("self", t)
            print(f"self_attention_bwd {label:11s} N={n} T={t:5d} C={c} H={h:2d} {layout:8s} err={err:.3e} "
                  f"(max|plain| {scale:.3e}) kernel={ms:.4f} ms plain={plain_ms:.4f} ms library bwd="
                  f"{lib_ms:.4f} ms (fwd+bwd {lib_fwd_bwd_ms:.4f} ms) bound={bound[0]:.4f} ms ({bound[1]}) "
                  f"[{name}; {ran}]")
            forward_summary["self_attention"]["max_abs_err"] = max(
                forward_summary["self_attention"]["max_abs_err"], fwd_err, lse_err)
            backward_summary[name]["max_abs_err"] = max(backward_summary[name]["max_abs_err"], err)
            add("self_attention", key, fwd_ms, fwd_bound)
            add(name, key, ms, bound)
            del qkv, dout, out, lse
            torch.cuda.empty_cache()
    for name, v in sums.items():
        print(f"{name} summed: " + ", ".join(f"{k} {x:.4f}" for k, x in v.items()))
    return sums


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


def flagship_configs():
    """``(base MM-UNet config, SR U-Net config)`` of the sampling CLI's
    LAUNCH_SCRIPT_ARGS, the flagship flags that users run."""
    from mm_diffusion_tpu_torch import configs
    from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr as cli

    args = vars(cli.create_argparser().parse_args(cli.LAUNCH_SCRIPT_ARGS))
    return configs.create_model_config(**args), configs.create_image_sr_config(**args)


def flagship(tmp: str):
    """Phase 5; returns the launch counts of the main path's run."""
    import numpy as np
    import torch

    from mm_diffusion_tpu_torch.models.image_unet import ImageSuperResModel
    from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr as cli
    from mm_diffusion_tpu_torch.weights import randomize_

    phase("5. flagship CLI: scripts/multimodal_sample_sr.py, 20-NFE DPM-Solver + ddim25 SR")
    flagship_args = cli.LAUNCH_SCRIPT_ARGS
    base_cfg, sr_cfg = flagship_configs()
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
    return {k: v for k, v in ba.kernel_launches().items() if "_bwd" not in k}


TRAIN_FLAGS = (  # the flagship training config (batch 4, remat, bf16), synthetic data
    "--video_size 16,3,64,64 --audio_size 1,25600 --num_channels 128 --num_res_blocks 2 "
    "--num_head_channels 64 --cross_attention_resolutions 2,4,8 --cross_attention_windows 1,4,8 "
    "--cross_attention_shift True --video_attention_resolutions 2,4,8 "
    "--audio_attention_resolutions -1 --use_scale_shift_norm True --resblock_updown True "
    "--use_fp16 True --use_checkpoint True --diffusion_steps 1000 --noise_schedule linear "
    "--lr 1e-4 --ema_rate 0.9999 --batch_size 4 --data_dir synthetic"
).split()


def gradient_parity() -> None:
    """Phase 6.1: one loss and gradient, card vs CPU, same weights and draws."""
    import torch

    from mm_diffusion_tpu_torch import configs
    from mm_diffusion_tpu_torch.data.synthetic import load_synthetic_data
    from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
    from mm_diffusion_tpu_torch.train.state import mm_model_fn
    from mm_diffusion_tpu_torch.weights import randomize_

    phase("6.1 one loss and gradient: card (bf16, kernels, remat) vs CPU (fp32, plain versions)")
    torch.set_num_threads(os.cpu_count() or 1)
    dev = torch.device("cuda")
    flags = dict(
        num_channels=128, num_res_blocks=1, num_head_channels=64, resblock_updown=True,
        cross_attention_resolutions="2,4,8", cross_attention_windows="1,4,8",
        video_attention_resolutions="2,4,8", audio_attention_resolutions="-1",
    )
    cpu_model = randomize_(MultimodalUNet(configs.create_model_config(**flags)), seed=31).train()
    gpu_model = MultimodalUNet(configs.create_model_config(**flags, use_fp16=True, use_checkpoint=True))
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(dev).train()
    diffusion = configs.create_gaussian_diffusion(steps=1000)
    cfg = cpu_model.cfg
    batch = {k: torch.from_numpy(v) for k, v in next(
        load_synthetic_data(1, video_size=cfg.video_size, audio_size=cfg.audio_size, seed=3)).items()}
    rng = torch.Generator().manual_seed(4)
    noise = {k: torch.randn(v.shape, generator=rng) for k, v in batch.items()}
    t = torch.tensor([321])

    def loss_and_grad(model, device):
        on = lambda x: {k: v.to(device) for k, v in x.items()}  # noqa: E731
        terms = diffusion.to(device).training_losses(
            mm_model_fn(model, shift=5), on(batch), t.to(device), noise=on(noise)
        )
        loss = terms["loss"].mean()
        loss.backward()
        grad = torch.cat([p.grad.reshape(-1).double().cpu() for p in model.parameters()])
        return loss.item(), grad

    t0 = time.perf_counter()
    ref_loss, ref_grad = loss_and_grad(cpu_model, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    from mm_diffusion_tpu_torch.ops import block_attention as ba

    ba.reset_launch_counts()
    loss, grad = loss_and_grad(gpu_model, dev)
    torch.cuda.synchronize()
    counts = dict(ba.LAUNCHES)
    e = rel_l2(grad, ref_grad)
    loss_gap = abs(loss - ref_loss) / abs(ref_loss)
    print(f"loss card {loss:.6f} CPU {ref_loss:.6f}, relative gap {loss_gap:.3e} (tolerance "
          f"{LOSS_REL_TOL}); gradient ({grad.numel()} values) rel L2 {e:.3e} (tolerance "
          f"{GRAD_REL_L2_TOL}); CPU loss+backward {cpu_s:.1f} s; launches {counts}")
    check(loss_gap <= LOSS_REL_TOL, "loss card vs CPU")
    check(e <= GRAD_REL_L2_TOL, "gradient card vs CPU")
    check(counts["self_attention_bwd"] > 0 and counts["banded_attention_bwd"] > 0,
          "the gradient did not go through the backward kernels")


def training(tmp: str):
    """Phase 6.2-6.3; returns the launch counts of the main path's run."""
    import gc
    import statistics

    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.scripts import multimodal_train as cli

    phase(f"6.2 train CLI: scripts/multimodal_train.py, flagship training config, {TRAIN_STEPS} steps")
    out_dir = os.path.join(tmp, "train")
    argv = TRAIN_FLAGS + [
        "--output_dir", out_dir, "--device", "cuda", "--log_interval", "1",
        "--save_interval", "1000000", "--max_steps", str(TRAIN_STEPS),
    ]
    print("argv:", " ".join(argv))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ba.reset_launch_counts()
    t0 = time.perf_counter()
    loop = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ba.LAUNCHES)
    self_bwd, banded_bwd = dict(ba.SELF_BWD_LENGTHS), dict(ba.BANDED_BWD_WINDOWS)
    banded_fwd = dict(ba.BANDED_WINDOWS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rows = loop.history
    for r in rows:
        print(f"step {int(r['step']):3d} loss {r['loss']:.5f} grad_norm {r['grad_norm']:.4e} "
              f"step_ms {r['step_ms']:.1f}")
    check(len(rows) == TRAIN_STEPS and loop.state.step == TRAIN_STEPS, "train CLI step count")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows),
          "non-finite loss or gradient norm")
    median_ms = statistics.median(r["step_ms"] for r in rows[2:])
    print(f"median step {median_ms:.1f} ms over steps 3-{TRAIN_STEPS} (batch 4); "
          f"peak device memory {peak_gib:.2f} GiB (max_memory_allocated); CLI wall {wall:.1f} s")
    print(f"launches over the run: {launches}; banded forward by window {banded_fwd}; "
          f"self backward by T {self_bwd}; banded backward by window {banded_bwd}")
    counts = ba.kernel_launches()
    for name, n in counts.items():
        check(n > 0, f"{name} never launched in the training run")
    del loop
    gc.collect()
    torch.cuda.empty_cache()

    phase("6.3 resume from the checkpoint for one more step")
    argv[argv.index("--max_steps") + 1] = str(TRAIN_STEPS + 1)
    loop = cli.main(argv)
    r = loop.history[-1]
    print(f"resumed from step {loop.resumed_from}; step {int(r['step'])} loss {r['loss']:.5f} "
          f"grad_norm {r['grad_norm']:.4e}")
    check(loop.resumed_from == TRAIN_STEPS, f"resumed from {loop.resumed_from}")
    check(loop.state.step == TRAIN_STEPS + 1 and len(loop.history) == 1, "the step counter did not continue")
    check(math.isfinite(r["loss"]), "non-finite loss after the resume")
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def flash_work(b, h, tq, tk, d, backward=False):
    """(FLOPs, bytes) of flash MHA, bf16 in and out, fp32 lse: the
    forward's two [Tq, Tk] products reading q, k, v and writing out; the
    backward's five reading q, k, v, out, dout and lse and writing dq, dk,
    dv."""
    q, kv, lse = b * h * tq * d * 2, b * h * tk * d * 2, b * h * tq * 4
    if not backward:
        return 4 * b * h * tq * tk * d, 2 * q + 2 * kv + lse
    return 10 * b * h * tq * tk * d, 3 * q + 2 * kv + lse + q + 2 * kv


def gemm_work(m, n, k, a_bytes, b_bytes):
    """(FLOPs, bytes) of an [M, K] x [K, N] product with a bf16 result."""
    return 2 * m * n * k, a_bytes + b_bytes + m * n * 2


def flash_parity(record):
    """Phase 7.1 (K8): the flash MHA kernels against their plain versions,
    both layouts, Tq != Tk with ragged ends.  Where Tk is ragged, the lse
    limit must also reject a planted fault: the logsumexp that a kernel
    would give if it let the zero keys that pad Tk to 128 into the softmax."""
    import torch

    from mm_diffusion_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    for label, b, h, tq, tk, d, layout in FLASH_SHAPES + FLASH_EXTRA_SHAPES:
        main = (label, b, h, tq, tk, d, layout) in FLASH_SHAPES
        rec = record if main else (lambda *args: None)
        def make(t):
            shape = (b, h, t, d) if layout == "bhtd" else (b, t, h, d)
            x = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
            return x if layout == "bhtd" else x.transpose(1, 2)  # [B, H, T, D] views

        q, k, v, dout = make(tq), make(tk), make(tk), make(tq)
        bthd = lambda *xs: [x.transpose(1, 2) for x in xs]  # noqa: E731
        design = fa.forward_design(d, q.dtype)[0]
        fa.reset_launch_counts()
        out, lse = fa.flash_mha_fwd_cuda(q, k, v)
        check(fa.FORWARD_DESIGNS == {design: 1}, f"flash_mha_fwd {label}: {dict(fa.FORWARD_DESIGNS)}, not {design}")
        ref = fa.mha_reference(*bthd(q, k, v)).transpose(1, 2)
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / d**0.5
        lse_ref = torch.logsumexp(logits, -1)
        (err, ok), (lse_err, lse_ok) = fa.FORWARD_TOL.check(out, ref), fa.LSE_TOL.check(lse, lse_ref)
        check(ok and lse_ok, f"flash_mha_fwd {label}: err {err}, lse {lse_err}")
        del ref, logits
        # Planted faults: the logsumexp a kernel would give if it let the
        # zero keys that pad Tk to a 128-key (the TPU path) or a 64-key (this
        # kernel's tile) multiple into the softmax.
        for pad in sorted({-tk % 128, -tk % 64} - {0}, reverse=True):
            fault_err, fault_ok = fa.LSE_TOL.check(lse, torch.logaddexp(lse_ref, lse_ref.new_tensor(math.log(pad))))
            print(f"flash_mha_fwd {label}: lse err {lse_err:.3e} ({fa.LSE_TOL}); planted fault, "
                  f"{pad} zero keys in the softmax: lse err {fault_err:.3e}, rejected {not fault_ok}")
            check(not fault_ok, f"flash_mha_fwd {label}: the lse limit lets {pad} stray keys pass")
        fwd = dict(
            ms=time_ms(lambda: fa.flash_mha_fwd_cuda(q, k, v)),
            plain=time_ms(lambda: fa.mha_reference(*bthd(q, k, v))),
            lib=library_attention_ms(lambda *xs: xs, [q, k, v]),
            bound=bound_ms(*flash_work(b, h, tq, tk, d)),
        )
        rec("flash_mha_fwd", max(err, lse_err), fwd["ms"], fwd["plain"], fwd["bound"], fwd["lib"])

        bdesign = fa.backward_design(d, q.dtype)[0]
        fa.reset_launch_counts()
        grads = fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout)
        check(fa.BACKWARD_DESIGNS == {bdesign: 1}, f"flash_mha_bwd {label}: {dict(fa.BACKWARD_DESIGNS)}, not {bdesign}")
        refs = fa.mha_backward_reference(*bthd(q, k, v, dout))
        bwd_err = 0.0
        for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
            e, ok = fa.BACKWARD_TOL.check(a, r.transpose(1, 2))
            check(ok, f"flash_mha_bwd {label} {name}: err {e}")
            bwd_err = max(bwd_err, e)
        # The Hopper backward bitwise equal over two runs.
        if bdesign == "sm90":
            again = fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout)
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"flash_mha_bwd {label}: two runs of the Hopper backward differ")
            del again
        del grads, refs
        bwd = dict(
            ms=time_ms(lambda: fa.flash_mha_bwd_cuda(q, k, v, out, lse, dout)),
            plain=time_ms(lambda: fa.mha_backward_reference(*bthd(q, k, v, dout))),
            bound=bound_ms(*flash_work(b, h, tq, tk, d, backward=True)),
        )
        bwd["lib"], lib_fwd_bwd = library_attention_ms(lambda *xs: xs, [q, k, v], dout)
        rec("flash_mha_bwd", bwd_err, bwd["ms"], bwd["plain"], bwd["bound"], bwd["lib"])
        for name, r, e, dsg in (("fwd", fwd, max(err, lse_err), design), ("bwd", bwd, bwd_err, bdesign)):
            print(f"flash_mha_{name} {label:13s} {layout} B={b} H={h} Tq={tq:5d} Tk={tk:5d} D={d} "
                  f"err={e:.3e} kernel={r['ms']:.4f} ms ({dsg}) plain={r['plain']:.4f} ms "
                  f"library={r['lib']:.4f} ms bound={r['bound'][0]:.4f} ms ({r['bound'][1]})"
                  + (f" (library fwd+bwd {lib_fwd_bwd:.4f} ms)" if name == "bwd" else "")
                  + ("" if main else " [extra case, not summed]"))


# The variants at head dims 12 and 36 (a zero-padded copy) and 136 and 200
# (the kernels built at 192 and 256), checked and timed, not in the sums.
# (label, N, T, C, heads).
VARIANT_EXTRA_CASES = [
    ("head dim 12", 1024, 16, 48, 4),
    ("head dim 36", 16, 256, 144, 4),
    ("head dim 136", 256, 25, 272, 2),
    ("head dim 200", 16, 1024, 400, 2),
]


def variant_parity(record):
    """Phase 7.1 (S1, S2): the K1 variants that are kernels of their own
    (rows, nomax, noexp), each the Hopper design, against their plain
    versions at the JAX tools' cases (rows: S1's four; nomax, noexp: S2's three), and
    at VARIANT_EXTRA_CASES' head dims through their routes, with the
    counters showing the route and the kernel.  noexp's limit must also
    reject two planted faults: the plain output with each sequence's keys
    and values taken from its neighbour, and without the 1/sqrt(d) scale."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.tools.bench_attn_variants import CASES

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    for variant, cases in (("rows", CASES), ("nomax", CASES[:3]), ("noexp", CASES[:3])):
        name = f"self_attention_variant[{variant}]"
        for label, n, t, c, h in cases + VARIANT_EXTRA_CASES:
            main = (label, n, t, c, h) in cases
            d = c // h
            qkv = torch.randn((n, t, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
            tol = ba.VARIANT_TOL[variant]
            ba.reset_launch_counts()
            out = ba.self_attention_variant_cuda(qkv, h, variant)
            dp = ba.padded_head_dim(d)
            routes = {k: v for k, v in {"self_attention_variant:pad": int(dp != d),
                                        "self_attention_variant:wide": int(dp > 128)}.items() if v}
            check(dict(ba.VARIANT_LAUNCHES) == {variant: 1} and dict(ba.HEAD_DIM_ROUTES) == routes
                  and ba.LAUNCHES["self_attention"] == 0,
                  f"{name} {label}: launches {dict(ba.VARIANT_LAUNCHES)}, routes {dict(ba.HEAD_DIM_ROUTES)}")
            ref = ba.self_attention_variant_reference(qkv, h, variant)
            err, ok = tol.check(out, ref)
            check(ok, f"{name} {label}: err {err}")
            if variant == "noexp" and main:
                mixed = torch.cat([qkv[..., :c], qkv.roll(1, dims=0)[..., c:]], dim=-1)
                faults = {
                    "keys of the neighbouring sequence": ba.self_attention_variant_reference(mixed, h, variant),
                    "no 1/sqrt(d) scale": ref * d ** 0.5,
                }
                readings = {k: tol.check(out, f) for k, f in faults.items()}
                print(f"{name} {label}: err {err:.3e}, max|plain| {ref.float().abs().max().item():.3e} "
                      f"({tol}); planted faults: "
                      + ", ".join(f"{k} err {e:.3e} rejected {not o}" for k, (e, o) in readings.items()))
                check(not any(o for _, o in readings.values()), f"{name} {label}: a planted fault passes")
            ms = time_ms(lambda: ba.self_attention_variant_cuda(qkv, h, variant))
            del out, ref
            plain_ms = time_ms(lambda: ba.self_attention_variant_reference(qkv, h, variant))
            lib_ms = library_attention_ms(packed_views("thirds", h), [qkv])
            bound = bound_ms(*self_attention_work(n, t, c, h, lse=False))
            print(f"{name:30s} {label:13s} N={n:5d} T={t:5d} C={c} H={h:2d} err={err:.3e} "
                  f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms library (SDPA fwd)={lib_ms:.4f} ms "
                  f"bound={bound[0]:.4f} ms ({bound[1]})"
                  + ("" if main else f" [extra case, route {routes or 'kernel'}, not summed]"))
            if main:
                record(name, err, ms, plain_ms, bound, lib_ms)
            del qkv


def gemm_conv_parity(record):
    """Phase 7.1 (S3, S4): the two-part GEMM, the direct 3x3 conv and the
    GEMM core against their plain versions at the JAX tools' shapes."""
    import torch
    import torch.nn.functional as F

    from mm_diffusion_tpu_torch.ops import gemm_conv as gc
    from mm_diffusion_tpu_torch.tools import bench_skip_conv, conv_chw_spike

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16

    b, h, w, c, co = bench_skip_conv.SHAPE
    x1 = torch.randn((b, h, w, c), generator=g, device=dev, dtype=bf)
    x2 = torch.randn((b, h, w, c), generator=g, device=dev, dtype=bf)
    wt = torch.randn((2 * c, co), generator=g, device=dev) * 0.05
    plain = gc.skip_gemm_reference(x1, x2, wt)
    err, ok = gc.GEMM_TOL.check(gc.skip_gemm_cuda(x1, x2, wt), plain)
    check(ok, f"skip_gemm: err {err}")
    del plain
    wb = wt.to(bf)
    ms = time_ms(lambda: gc.skip_gemm_cuda(x1, x2, wt))
    plain_ms = time_ms(lambda: gc.skip_gemm_reference(x1, x2, wt))
    split_ms = time_ms(lambda: x1 @ wb[:c] + x2 @ wb[c:])
    concat_ms = time_ms(lambda: torch.cat([x1, x2], dim=-1) @ wb)
    m = b * h * w
    bound = bound_ms(*gemm_work(m, co, 2 * c, 2 * m * c * 2, wt.numel() * 4))
    print(f"skip_gemm B={b} {h}x{w} C={c}+{c} -> {co}: err={err:.3e} "
          f"kernel={ms:.4f} ms tiles {gc.gemm_tiles(m, co)} "
          f"plain={plain_ms:.4f} ms bound={bound[0]:.4f} ms ({bound[1]}); no single library "
          f"call: split (two matmuls summed) {split_ms:.4f} ms, concat + matmul {concat_ms:.4f} ms")
    record("skip_gemm", err, ms, plain_ms, bound, None)
    del x1, x2

    b, ci, co, h, w = conv_chw_spike.BENCH_SHAPE
    x = torch.randn((b, ci, h, w), generator=g, device=dev, dtype=bf)
    wt = (torch.randn((co, ci, 3, 3), generator=g, device=dev) * 0.05).to(bf)
    n = CONV_CHECK_IMAGES
    # The conv's input copy, channels-last with a zero ring: exact.
    xh = gc.channels_last_halo_cuda(x)
    check(torch.equal(xh, gc.channels_last_halo(x)), "conv3x3_chw[halo]: the copy differs from its plain version")
    halo = dict(ms=time_ms(lambda: gc.channels_last_halo_cuda(x)), plain=time_ms(lambda: gc.channels_last_halo(x)),
                bound=bound_ms(0, (x.numel() + xh.numel()) * 2))
    print(f"conv3x3_chw[halo] B={b} Ci={ci} {h}x{w} -> {tuple(xh.shape)}: exact, kernel={halo['ms']:.4f} ms "
          f"plain (F.pad of the permuted view)={halo['plain']:.4f} ms bound={halo['bound'][0]:.4f} ms "
          f"({halo['bound'][1]})")
    record("conv3x3_chw[halo]", 0.0, halo["ms"], halo["plain"], halo["bound"], None)
    del xh
    plain = gc.conv3x3_chw_reference(x[:n], wt)
    err, ok = gc.GEMM_TOL.check(gc.conv3x3_chw_cuda(x[:n], wt), plain)
    check(ok, f"conv3x3_chw: err {err}")
    del plain
    ms = time_ms(lambda: gc.conv3x3_chw_cuda(x, wt))
    plain_ms = time_ms(lambda: gc.conv3x3_chw_reference(x, wt))
    lib_ms = time_ms(lambda: F.conv2d(x, wt, padding=1))
    bound = bound_ms(*gemm_work(co, b * h * w, 9 * ci, x.numel() * 2, wt.numel() * 2))
    print(f"conv3x3_chw B={b} Ci={ci} Co={co} {h}x{w}: err={err:.3e} (on {n} "
          f"images) kernel={ms:.4f} ms (the input copy included) plain={plain_ms:.4f} ms "
          f"library (F.conv2d, cuDNN)={lib_ms:.4f} ms bound={bound[0]:.4f} ms ({bound[1]})")
    record("conv3x3_chw", err, ms, plain_ms, bound, lib_ms)
    del x

    co, k = conv_chw_spike.GEMM_CO, conv_chw_spike.GEMM_K
    for npx, nblk in conv_chw_spike.GEMM_CASES:
        a = (torch.randn((co, k), generator=g, device=dev) * 0.05).to(bf)
        bb = torch.randn((nblk, k, npx), generator=g, device=dev, dtype=bf)
        plain = gc.gemm_blocks_reference(a, bb)
        err, ok = gc.GEMM_TOL.check(gc.gemm_blocks_cuda(a, bb), plain)
        check(ok, f"gemm_blocks npx={npx} nblk={nblk}: err {err}")
        del plain
        ms = time_ms(lambda: gc.gemm_blocks_cuda(a, bb))
        plain_ms = time_ms(lambda: gc.gemm_blocks_reference(a, bb))
        lib_ms = time_ms(lambda: torch.matmul(a, bb))
        bound = bound_ms(*gemm_work(co, npx * nblk, k, a.numel() * 2, bb.numel() * 2))
        print(f"gemm_blocks [{co}x{k}] x [{nblk}x{k}x{npx}]: err={err:.3e} "
              f"kernel={ms:.4f} ms tiles {gc.gemm_tiles(co, npx, nblk)} "
              f"plain={plain_ms:.4f} ms library (torch.matmul)={lib_ms:.4f} ms "
              f"bound={bound[0]:.4f} ms ({bound[1]})")
        record("gemm_blocks", err, ms, plain_ms, bound, lib_ms)
        del bb


def spike_parity():
    """Phase 7.1; returns {kernel name: per-call numbers summed over shapes}."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.ops import gemm_conv as gc

    phase(f"7.1 flash MHA (K8) and spike kernels (S1-S4) vs plain versions (bf16; out "
          f"{ba.FORWARD_TOL}, lse {ba.LSE_TOL}, backward and noexp {ba.BACKWARD_TOL}, "
          f"GEMM/conv {gc.GEMM_TOL})")
    summary = {}
    record = recorder(summary)
    flash_parity(record)
    variant_parity(record)
    gemm_conv_parity(record)
    torch.cuda.empty_cache()
    return summary


def entry_points():
    """Phase 7.2: the slice's entry points -- the fused_attention API
    (forward and backward through autograd, each API at each of phase
    7.1's hot shapes) and each A/B tool once with few iterations; returns
    the launch counts of that run."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.ops import fused_attention as fa
    from mm_diffusion_tpu_torch.ops import gemm_conv as gc
    from mm_diffusion_tpu_torch.tools import bench_attn_variants, bench_skip_conv, conv_chw_spike

    phase("7.2 entry points: ops/fused_attention.py (flash_mha, flash_mha_bhtd) and the A/B tools")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    for counts in (ba, fa, gc):
        counts.reset_launch_counts()
    for api in (fa.flash_mha, fa.flash_mha_bhtd):
        for label, b, h, tq, tk, d, _ in FLASH_SHAPES:
            shape = (lambda t: (b, t, h, d)) if api is fa.flash_mha else (lambda t: (b, h, t, d))
            leaves = [torch.randn(shape(t), generator=g, device=dev, dtype=torch.bfloat16).requires_grad_()
                      for t in (tq, tk, tk)]
            dout = torch.randn(shape(tq), generator=g, device=dev, dtype=torch.bfloat16)
            out = api(*leaves)
            out.backward(dout)
            as_bthd = (lambda x: x) if api is fa.flash_mha else (lambda x: x.transpose(1, 2))
            plain = [as_bthd(x.detach()) for x in leaves]
            err, ok = fa.FORWARD_TOL.check(as_bthd(out.detach()), fa.mha_reference(*plain))
            refs = fa.mha_backward_reference(*plain, as_bthd(dout))
            errs = [fa.BACKWARD_TOL.check(as_bthd(x.grad), r) for x, r in zip(leaves, refs)]
            print(f"{api.__name__} {label:13s} {tuple(out.shape)} Tq={tq} Tk={tk}: out err {err:.3e}; "
                  f"dq/dk/dv err {', '.join(f'{e:.3e}' for e, _ in errs)}")
            check(ok and all(o for _, o in errs), f"{api.__name__} {label}: output or gradients off")
            del leaves, dout, out, plain, refs
    few = ["--calls", "2", "--replays", "1"]
    bench_attn_variants.main(few)
    bench_skip_conv.main(few)
    for mode in ("check", "bench", "gemm"):
        conv_chw_spike.main([mode] + few)
    torch.cuda.synchronize()
    designs = {"flash_mha_fwd": dict(fa.FORWARD_DESIGNS), "flash_mha_bwd": dict(fa.BACKWARD_DESIGNS),
               "conv3x3_chw routes": dict(gc.CONV_ROUTES)}
    print(f"designs over the entry points' run: {designs}")
    check(fa.FORWARD_DESIGNS == {"sm90": fa.LAUNCHES["flash_mha_fwd"]},
          f"the flash MHA API did not run the Hopper forward alone: {designs}")
    check(fa.BACKWARD_DESIGNS == {"sm90": fa.LAUNCHES["flash_mha_bwd"]},
          f"the flash MHA API did not run the Hopper backward alone: {designs}")
    counts = {
        "flash_mha_fwd": fa.LAUNCHES["flash_mha_fwd"],
        "flash_mha_bwd": fa.LAUNCHES["flash_mha_bwd"],
        **{f"self_attention_variant[{v}]": ba.VARIANT_LAUNCHES[v] for v in ("rows", "nomax", "noexp")},
        **gc.LAUNCHES,
        "conv3x3_chw[halo]": gc.HELPER_LAUNCHES["channels_last_halo"],
    }
    print(f"launches over the entry points' run: {counts} (K1 via the stock-kernel variants: "
          f"{ba.LAUNCHES['self_attention']})")
    for name, n in counts.items():
        check(n > 0, f"{name} never launched through its entry point")
    return counts

# Phase 8: zero-shot conditional sampling at the flagship base config of
# scripts/multimodal_sample_sr.py's LAUNCH_SCRIPT_ARGS, the reference's
# audio->video settings (gradient method, classifier scale 3.0, ddim25 SR of
# all 16 frames).  The one cut: 25 respaced steps, where the reference runs
# 1000.
COND_STEPS = 25
COND_SCALE = 3.0
# Phase 8.1, one gradient-method step, bf16 on the card vs fp32 on the CPU,
# same weights, inputs, noise and shift: the relative gap of the consistency
# loss (H100 reading 1.712e-4) and the relative L2 of the gradient with
# respect to the video (reading 6.622e-2; it crosses the whole MM-UNet and
# the RS-MMA coupling in bf16, where 6.1's parameter gradient crosses the
# net once).  Each limit is about 4x its first reading.
COND_LOSS_REL_TOL = 7e-4
COND_GRAD_REL_L2_TOL = 0.25
COND_STEP_REPEATS = 5  # gradient steps timed on the card in 8.1 (median)
COND_SHIFT = 5  # 8.1's RS-MMA shift at every shifting site, as phase 6.1's


def conditional_flags():
    """The model and SR flags of LAUNCH_SCRIPT_ARGS (its sampler flags are
    the unconditional CLI's), the reference's a2v settings and the cut."""
    from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr as cli

    argv, drop = [], {"--sample_fn", "--sample_steps"}
    args = iter(cli.LAUNCH_SCRIPT_ARGS)
    for flag in args:
        value = next(args)
        if flag not in drop:
            argv += [flag, value]
    return argv + ["--classifier_scale", str(COND_SCALE), "--timestep_respacing", str(COND_STEPS)]


def bwd_kernel_name(kind, key):
    """The JSON name of a backward launch: self by sequence length (K4 /
    K5), banded by window (K6 / K7)."""
    from mm_diffusion_tpu_torch.ops import block_attention as ba

    if kind == "self":
        return "self_attention_bwd[T>512]" if key >= ba.K5_MIN_T else "self_attention_bwd[T<=512]"
    return "banded_attention_bwd[lw=1]" if key == 1 else "banded_attention_bwd[lw>1]"


def conditional_gradient_parity():
    """Phase 8.1: one gradient-method step (samplers/ancestral.py::
    conditional_gradient_step), card vs CPU, then its time on the card."""
    import statistics

    import torch

    from mm_diffusion_tpu_torch import configs
    from mm_diffusion_tpu_torch.data.synthetic import load_synthetic_data
    from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.samplers import conditional_gradient_step
    from mm_diffusion_tpu_torch.scripts import audio2video_sample_sr as cli
    from mm_diffusion_tpu_torch.weights import randomize_

    phase(f"8.1 one gradient-method step (a2v, scale {COND_SCALE}): card (bf16, kernels) vs CPU "
          "(fp32, plain versions)")
    torch.set_num_threads(os.cpu_count() or 1)
    dev = torch.device("cuda")
    args = cli.create_argparser().parse_args(conditional_flags())
    kwargs = {**vars(args), "use_fp16": False}
    cpu_model, diffusion = configs.create_model_and_diffusion(**kwargs)
    randomize_(cpu_model, seed=41).eval().requires_grad_(False)
    gpu_model = MultimodalUNet(configs.create_model_config(**{**kwargs, "use_fp16": True}))
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to(dev).eval().requires_grad_(False)
    cfg = cpu_model.cfg
    cond = torch.from_numpy(next(load_synthetic_data(
        1, video_size=cfg.video_size, audio_size=cfg.audio_size, seed=3))["audio"])
    rng = torch.Generator().manual_seed(4)
    f, c, h, w = cfg.video_size
    x_T = {"video": torch.randn((1, f, h, w, c), generator=rng),
           "audio": torch.randn((1, cfg.audio_size[1], 1), generator=rng)}
    noise = {k: torch.randn(v.shape, generator=rng) for k, v in x_T.items()}
    i = COND_STEPS // 2
    t = torch.tensor([i])

    def step(model, device):
        on = lambda x: {k: v.to(device) for k, v in x.items()}  # noqa: E731
        d = diffusion.to(device)
        tt = t.to(device)
        x = {**on(x_T), "audio": d.q_sample(cond.to(device), tt, x_T["audio"].to(device))}

        def model_fn(xx, t_model):
            v, a = model(xx["video"], xx["audio"], t_model, shift=COND_SHIFT)
            return {"video": v, "audio": a}

        with torch.no_grad():
            return conditional_gradient_step(d, model_fn, x, tt, cond.to(device), "audio",
                                             x_T["audio"].to(device), noise=on(noise))

    t0 = time.perf_counter()
    ref_loss, ref_grad, _ = step(cpu_model, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ba.reset_launch_counts()
    loss, grad, _ = step(gpu_model, dev)
    torch.cuda.synchronize()
    counts, self_t, banded_w = dict(ba.LAUNCHES), dict(ba.SELF_BWD_LENGTHS), dict(ba.BANDED_BWD_WINDOWS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    e = rel_l2(grad.cpu(), ref_grad)
    gap = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    print(f"step i={i} of {COND_STEPS}: loss card {loss.item():.6e} CPU {ref_loss.item():.6e}, relative "
          f"gap {gap:.3e} (tolerance {COND_LOSS_REL_TOL}); gradient w.r.t. the video ({grad.numel()} "
          f"values, max |CPU| {ref_grad.abs().max().item():.3e}) rel L2 {e:.3e} (tolerance "
          f"{COND_GRAD_REL_L2_TOL}); CPU step {cpu_s:.1f} s; peak device memory {peak_gib:.2f} GiB")
    print(f"launches in the card's step: {counts}; self backward by T {self_t}; banded backward by "
          f"window {banded_w}")
    check(gap <= COND_LOSS_REL_TOL, "consistency loss card vs CPU")
    check(e <= COND_GRAD_REL_L2_TOL, "video gradient card vs CPU")
    bwd = {}
    for kind, table in (("self", self_t), ("banded", banded_w)):
        for key, n in table.items():
            bwd[bwd_kernel_name(kind, key)] = bwd.get(bwd_kernel_name(kind, key), 0) + n
    for name in ("self_attention_bwd[T<=512]", "self_attention_bwd[T>512]",
                 "banded_attention_bwd[lw=1]", "banded_attention_bwd[lw>1]"):
        check(bwd.get(name, 0) > 0, f"{name} not launched by the gradient step")
    times = []
    for _ in range(COND_STEP_REPEATS):
        t0 = time.perf_counter()
        step(gpu_model, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"gradient step on the card: median {statistics.median(times):.2f} ms over {COND_STEP_REPEATS} "
          f"(host wall to a synchronisation; {', '.join(f'{x:.2f}' for x in times)})")
    del cpu_model, gpu_model


def sampler_backward_parity():
    """Phase 8.2: the backward kernels (K4-K7) at the sampler's batch-1
    shapes (phase 3's MM-UNet shapes, banded shifts 0, the middle and the
    last), each against its plain backward; returns {kernel: {"ms",
    "bound_ms"} summed over the shapes}."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    phase(f"8.2 backward kernels at the sampler's batch-1 shapes vs plain backwards (bf16, {ba.BACKWARD_TOL})")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    make = lambda *shape: torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)  # noqa: E731
    sums = {}

    def add(name, ms, bound):
        s = sums.setdefault(name, {"ms": 0.0, "bound_ms": 0.0})
        s["ms"] += ms
        s["bound_ms"] += bound[0]

    for label, n, t, c, h, layout in SELF_SHAPES:
        if not label.startswith("mm "):
            continue  # the SR U-Net is not differentiated
        qkv, dout = make(n, t, 3 * c), make(n, t, c)
        out, lse = ba.self_attention_cuda(qkv, h, layout)
        dqkv = ba.self_attention_bwd_cuda(qkv, out, lse, dout, h, layout)
        err, ok = ba.BACKWARD_TOL.check(dqkv, ba.self_attention_backward_reference(qkv, dout, h, layout))
        check(ok, f"self_attention_bwd {label} (batch 1): err {err}")
        ms = time_ms(lambda: ba.self_attention_bwd_cuda(qkv, out, lse, dout, h, layout))
        bound = bound_ms(*self_attention_work(n, t, c, h, backward=True))
        print(f"self_attention_bwd {label:18s} N={n:5d} T={t:5d} C={c} H={h} {layout:8s} err={err:.3e} "
              f"kernel={ms:.4f} ms bound={bound[0]:.4f} ms ({bound[1]})")
        add(bwd_kernel_name("self", t), ms, bound)
    for label, f, tq, tk, c, h, lw in BANDED_SHAPES:
        q_src, kv_src, dout = make(1, f, tq, 3 * c), make(1, f, tk, 3 * c), make(1, f, tq, c)
        span, err = f - lw, 0.0
        for s in sorted({0, span // 2, span}):
            out, lse = ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c)
            got = ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, s, lw, h, c)
            ref = ba.banded_attention_backward_reference(q_src, kv_src, dout, s, lw, h, c)
            errs = [ba.BACKWARD_TOL.check(a, b) for a, b in zip(got, ref)]
            err = max(err, *(e for e, _ in errs))
            check(all(ok for _, ok in errs), f"banded_attention_bwd {label} shift {s} (batch 1): err {errs}")
        ms = time_ms(lambda: ba.banded_attention_bwd_cuda(q_src, kv_src, out, lse, dout, s, lw, h, c))
        bound = bound_ms(*banded_work(1, f, tq, tk, c, h, lw, backward=True))
        print(f"banded_attention_bwd {label:20s} N=1 F={f} Tq={tq:5d} Tk={tk:5d} C={c} H={h} lw={lw:2d} "
              f"shifts {sorted({0, span // 2, span})} err={err:.3e} kernel={ms:.4f} ms (shift {s}) "
              f"bound={bound[0]:.4f} ms ({bound[1]})")
        add(bwd_kernel_name("banded", lw), ms, bound)
    for name, v in sums.items():
        print(f"{name} at the sampler's batch-1 shapes, summed: {v['ms']:.4f} ms, bound {v['bound_ms']:.4f} ms")
    return sums


def conditional_clis(tmp: str):
    """Phase 8.3-8.4: both conditional CLIs end to end with random non-zero
    weights saved to .pt files; returns the a2v run's launches per kernel."""
    import statistics

    import numpy as np
    import torch

    from mm_diffusion_tpu_torch import configs
    from mm_diffusion_tpu_torch.models.image_unet import ImageSuperResModel
    from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.scripts import audio2video_sample_sr as a2v
    from mm_diffusion_tpu_torch.scripts import video2audio_sample as v2a
    from mm_diffusion_tpu_torch.weights import randomize_

    flags = conditional_flags()
    args = a2v.create_argparser().parse_args(flags)
    base_pt, sr_pt = os.path.join(tmp, "cond_base.pt"), os.path.join(tmp, "cond_sr.pt")
    torch.save(randomize_(MultimodalUNet(configs.create_model_config(**vars(args))), seed=23).state_dict(),
               base_pt)
    torch.save(randomize_(ImageSuperResModel(configs.create_image_sr_config(**vars(args))), seed=24)
               .state_dict(), sr_pt)
    common = flags + ["--multimodal_model_path", base_pt, "--device", "cuda", "--sample_num", "1"]

    def run(cli, name, argv):
        argv = argv + ["--output_dir", os.path.join(tmp, name)]
        print("argv:", " ".join(argv))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ba.reset_launch_counts()
        t0 = time.perf_counter()
        result = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {
            "self_attention": ba.LAUNCHES["self_attention"],
            "banded_attention[lw=1]": ba.BANDED_WINDOWS.get(1, 0),
            "banded_attention[lw>1]": sum(v for k, v in ba.BANDED_WINDOWS.items() if k > 1),
        }
        for kind, table in (("self", ba.SELF_BWD_LENGTHS), ("banded", ba.BANDED_BWD_WINDOWS)):
            for key, n in table.items():
                counts[bwd_kernel_name(kind, key)] = counts.get(bwd_kernel_name(kind, key), 0) + n
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        timing = result["timings"][0]
        samples = result["samples"]
        for key, arr in samples.items():
            check(bool(np.isfinite(arr).all()), f"{name} {key} has non-finite values")
            print(f"{key}: shape {arr.shape}, finite, mean {arr.mean():.4f}, std {arr.std():.4f}")
        check(result["paths"] and all(os.path.exists(p) for p in result["paths"]), f"{name}: files missing")
        step_ms = statistics.median(timing["step_s"]) * 1e3
        print(f"outputs written: {result['paths']}")
        print(f"{name}: {len(timing['step_s'])} steps, median step {step_ms:.2f} ms; base stage "
              f"{timing['base_s']:.3f} s" + (f", SR stage {timing['sr_s']:.3f} s" if "sr_s" in timing else "")
              + f"; peak device memory {peak_gib:.2f} GiB (max_memory_allocated); CLI wall {wall:.1f} s")
        print(f"{name} launches over the run: {counts}; per step: "
              f"{ {k: v / COND_STEPS for k, v in counts.items() if k.startswith(('self', 'banded'))} }")
        return samples, timing, counts, step_ms

    phase(f"8.3 a2v CLI: scripts/audio2video_sample_sr.py, gradient method (scale {COND_SCALE}), "
          f"{COND_STEPS} steps (the reference: 1000), ddim25 SR of all 16 frames")
    samples, timing, counts, step_ms = run(a2v, "a2v", common + ["--sr_model_path", sr_pt])
    for key, shape in (("video", (1, 16, 64, 64, 3)), ("audio", (1, 25600, 1)),
                       ("sr_video", (1, 16, 256, 256, 3))):
        check(samples[key].shape == shape, f"a2v {key} shape {samples[key].shape} != {shape}")
    for name, n in counts.items():
        check(n > 0, f"{name} never launched in the a2v run")
    check(len(counts) == 7, f"a2v run launched {sorted(counts)}, not K1-K7")
    print(f"projected 1000-step a2v clip: {step_ms * 1000 / 1e3:.1f} s base (1000 x the median step) "
          f"+ {timing['sr_s']:.3f} s SR")

    phase(f"8.4 v2a CLI: scripts/video2audio_sample.py, replacement method, {COND_STEPS} steps")
    v2a_samples, _, v2a_counts, _ = run(v2a, "v2a", common + ["--classifier_scale", "0.0"])
    check(v2a_samples["audio"].shape == (1, 25600, 1), f"v2a audio shape {v2a_samples['audio'].shape}")
    check(not any("_bwd" in k for k in v2a_counts), f"the replacement method ran a backward: {v2a_counts}")
    return counts


# Phase 9: SR U-Net training and single-modal training at full width.  The
# SR flags are those of scripts/multimodal_sample_sr.py's LAUNCH_SCRIPT_ARGS
# (192 channels, attention at ds 32/16/8, head channels 64, resblock_updown,
# learned sigma, 256 <- 64); the single-modal flags 128 channels, 4 heads,
# attention at ds 2/4/8 (scripts/single_modal_train.py's defaults).  Cut:
# SR_TRAIN_STEPS steps (+1 resumed), SINGLE_TRAIN_STEPS per modality.
SR_FLAGS = (
    "--large_size 256 --small_size 64 --sr_num_channels 192 --sr_attention_resolutions 32,16,8 "
    "--sr_num_head_channels 64 --sr_resblock_updown True --sr_learn_sigma True --use_fp16 True"
).split()
SR_TRAIN_STEPS = 10
SR_NO_REMAT_STEPS = 3  # the same flags without use_checkpoint, for its peak memory
SINGLE_FLAGS = ("--num_channels 128 --num_heads 4 --attention_resolutions 2,4,8 "
                "--use_checkpoint True --batch_size 4").split()
SINGLE_SIZES = {"video": ["--video_size", "16,3,64,64"], "audio": ["--audio_size", "1,25600"]}
SINGLE_TRAIN_STEPS = 6


def self_kernel_counts():
    """K1 / K4 / K5 launches since the counters were last set to 0."""
    from mm_diffusion_tpu_torch.ops import block_attention as ba

    counts = {"self_attention": ba.LAUNCHES["self_attention"]}
    for t, n in ba.SELF_BWD_LENGTHS.items():
        counts[bwd_kernel_name("self", t)] = counts.get(bwd_kernel_name("self", t), 0) + n
    return counts


def card_vs_cpu_gradient(label, cpu_model, gpu_model, diffusion, adapter, batch, noise, t):
    """One loss and parameter gradient of ``diffusion.training_losses`` on
    the CPU (fp32, plain versions) and on the card (bf16, kernels, remat),
    same weights and draws; checks both against LOSS_REL_TOL /
    GRAD_REL_L2_TOL and returns the card's backward lengths by T."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    def loss_and_grad(model, device):
        on = {k: v.to(device) for k, v in batch.items()}
        x_start, model_fn = adapter(model, on)
        terms = diffusion.to(device).training_losses(model_fn, x_start, t.to(device), noise=noise.to(device))
        loss = terms["loss"].mean()
        loss.backward()
        grad = torch.cat([p.grad.reshape(-1).double().cpu() for p in model.parameters()])
        return loss.item(), grad

    t0 = time.perf_counter()
    ref_loss, ref_grad = loss_and_grad(cpu_model, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    ba.reset_launch_counts()
    loss, grad = loss_and_grad(gpu_model, torch.device("cuda"))
    torch.cuda.synchronize()
    counts, lengths = self_kernel_counts(), dict(ba.SELF_BWD_LENGTHS)
    e = rel_l2(grad, ref_grad)
    gap = abs(loss - ref_loss) / abs(ref_loss)
    print(f"{label}: loss card {loss:.6f} CPU {ref_loss:.6f}, relative gap {gap:.3e} (tolerance "
          f"{LOSS_REL_TOL}); gradient ({grad.numel()} values) rel L2 {e:.3e} (tolerance "
          f"{GRAD_REL_L2_TOL}); CPU loss+backward {cpu_s:.1f} s; launches {counts}; backward by T {lengths}")
    check(gap <= LOSS_REL_TOL, f"{label}: loss card vs CPU")
    check(e <= GRAD_REL_L2_TOL, f"{label}: gradient card vs CPU")
    return lengths


def sr_gradient_parity() -> None:
    """Phase 9.1: one SR U-Net loss and gradient, card vs CPU."""
    import torch

    from mm_diffusion_tpu_torch import configs
    from mm_diffusion_tpu_torch.models.image_unet import ImageSuperResModel
    from mm_diffusion_tpu_torch.scripts import image_sr_train as cli
    from mm_diffusion_tpu_torch.train import ImageSRTask
    from mm_diffusion_tpu_torch.weights import randomize_

    phase("9.1 SR U-Net, one loss and gradient at batch 1: card (bf16, kernels, use_checkpoint) vs CPU "
          "(fp32, plain versions)")
    torch.set_num_threads(os.cpu_count() or 1)
    args = vars(cli.create_argparser().parse_args(SR_FLAGS))
    cpu_model = randomize_(ImageSuperResModel(configs.create_image_sr_config(
        **{**args, "use_fp16": False})), seed=51).train()
    gpu_model = ImageSuperResModel(configs.create_image_sr_config(**{**args, "use_checkpoint": True}))
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to("cuda").train()
    diffusion = configs.create_gaussian_diffusion(steps=1000, learn_sigma=True)
    batch = {k: torch.from_numpy(v) for k, v in next(cli.synthetic_sr_data(1, 256, 64, seed=3)).items()}
    noise = torch.randn(batch["high_res"].shape, generator=torch.Generator().manual_seed(4))
    lengths = card_vs_cpu_gradient("SR U-Net", cpu_model, gpu_model, diffusion, ImageSRTask().adapter(None),
                                   batch, noise, torch.tensor([321]))
    check(set(lengths) == {1024, 256, 64}, f"the SR backward went through K4/K5 at T {sorted(lengths)}")
    del cpu_model, gpu_model


def train_cli_run(cli, argv, steps):
    """Run a train CLI for ``steps`` steps with the counters at 0; returns
    (loop, K1/K4/K5 launches, peak GiB, median step ms after two)."""
    import statistics

    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    argv = argv + ["--device", "cuda", "--log_interval", "1", "--max_steps", str(steps)]
    print("argv:", " ".join(argv))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ba.reset_launch_counts()
    t0 = time.perf_counter()
    loop = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = self_kernel_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rows = loop.history
    for r in rows:
        print(f"step {int(r['step']):3d} loss {r['loss']:.5f} grad_norm {r['grad_norm']:.4e} "
              f"step_ms {r['step_ms']:.1f}")
    check(len(rows) == steps and loop.state.step == steps, "train CLI step count")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows),
          "non-finite loss or gradient norm")
    median_ms = statistics.median(r["step_ms"] for r in rows[2:])
    print(f"median step {median_ms:.1f} ms over steps 3-{steps}; peak device memory {peak_gib:.2f} GiB "
          f"(max_memory_allocated); CLI wall {wall:.1f} s; launches {counts}; self backward by T "
          f"{dict(ba.SELF_BWD_LENGTHS)}")
    return loop, counts, peak_gib, median_ms


def sr_training(tmp: str):
    """Phase 9.2: scripts/image_sr_train.py at the SR flags, batch 4,
    use_checkpoint, synthetic data: SR_TRAIN_STEPS steps with a checkpoint
    and a preview at the last, a resume for one step, and the same flags
    without use_checkpoint for its peak memory; returns the first run's
    K1/K4/K5 launches."""
    import gc

    import torch

    from mm_diffusion_tpu_torch.scripts import image_sr_train as cli

    phase(f"9.2 SR train CLI: scripts/image_sr_train.py, batch 4, use_checkpoint, {SR_TRAIN_STEPS} steps")
    out_dir = os.path.join(tmp, "sr_train")
    common = SR_FLAGS + ["--batch_size", "4"]
    argv = common + ["--use_checkpoint", "True", "--output_dir", out_dir, "--save_interval", str(SR_TRAIN_STEPS)]
    loop, counts, peak, _ = train_cli_run(cli, argv, SR_TRAIN_STEPS)
    for name in ("self_attention", "self_attention_bwd[T<=512]", "self_attention_bwd[T>512]"):
        check(counts.get(name, 0) > 0, f"{name} never launched in the SR training run")
    previews = sorted(os.listdir(os.path.join(out_dir, "previews")))
    check(len(previews) == 1 and previews[0].startswith(f"step_{SR_TRAIN_STEPS:06d}"),
          f"SR preview files {previews}")
    print(f"preview: {previews[0]}; checkpoints: {sorted(os.listdir(os.path.join(out_dir, 'checkpoints')))}")
    del loop
    gc.collect()

    loop = cli.main(argv + ["--device", "cuda", "--log_interval", "1", "--max_steps", str(SR_TRAIN_STEPS + 1)])
    r = loop.history[-1]
    print(f"resumed from step {loop.resumed_from}; step {int(r['step'])} loss {r['loss']:.5f}")
    check(loop.resumed_from == SR_TRAIN_STEPS and loop.state.step == SR_TRAIN_STEPS + 1, "SR resume")
    check(math.isfinite(r["loss"]), "non-finite loss after the resume")
    del loop
    gc.collect()

    no_remat = common + ["--output_dir", os.path.join(tmp, "sr_train_no_remat"), "--save_interval", "1000000"]
    loop, _, peak_no_remat, _ = train_cli_run(cli, no_remat, SR_NO_REMAT_STEPS)
    check(not loop.model.cfg.use_checkpoint, "the no-remat run has use_checkpoint set")
    print(f"peak device memory: {peak:.2f} GiB with use_checkpoint, {peak_no_remat:.2f} GiB without")
    check(peak < peak_no_remat, "use_checkpoint did not lower the SR training's peak memory")
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def single_audio_gradient_parity() -> None:
    """Phase 9.3 (first part): one loss and gradient of the single-modal
    audio U-Net, card vs CPU."""
    import torch

    from mm_diffusion_tpu_torch import configs
    from mm_diffusion_tpu_torch.data.synthetic import load_synthetic_data
    from mm_diffusion_tpu_torch.models.single_unet import SingleModalUNet
    from mm_diffusion_tpu_torch.scripts import single_modal_train as cli
    from mm_diffusion_tpu_torch.train import SingleModalTask
    from mm_diffusion_tpu_torch.weights import randomize_

    phase("9.3 single-modal audio U-Net, one loss and gradient at batch 1: card (bf16, kernels, "
          "use_checkpoint) vs CPU (fp32, plain versions)")
    torch.set_num_threads(os.cpu_count() or 1)
    args = cli.create_argparser().parse_args(SINGLE_FLAGS + SINGLE_SIZES["audio"] + ["--modality", "audio"])
    flags = {k: getattr(args, k) for k in cli.single_model_defaults()}
    cpu_model = randomize_(SingleModalUNet(cli.create_single_config(
        **{**flags, "use_checkpoint": False}, dtype="float32")), seed=61).train()
    gpu_model = SingleModalUNet(cli.create_single_config(**flags))
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to("cuda").train()
    cfg = cpu_model.cfg
    audio = next(load_synthetic_data(1, video_size=cfg.video_size, audio_size=cfg.audio_size, seed=3))["audio"]
    batch = {"x": torch.from_numpy(audio)}
    noise = torch.randn(batch["x"].shape, generator=torch.Generator().manual_seed(4))
    lengths = card_vs_cpu_gradient("single-modal audio U-Net", cpu_model, gpu_model,
                                   configs.create_gaussian_diffusion(steps=1000),
                                   SingleModalTask().adapter(None), batch, noise, torch.tensor([321]))
    check(set(lengths) == {6400, 1600, 400}, f"the audio backward went through K4/K5 at T {sorted(lengths)}")
    del cpu_model, gpu_model


def single_training(tmp: str):
    """Phase 9.3: scripts/single_modal_train.py for video (16x64x64) and
    audio (25600 samples), batch 4, use_checkpoint; returns {modality:
    K1/K4/K5 launches}."""
    import gc

    import torch

    from mm_diffusion_tpu_torch.scripts import single_modal_train as cli

    launches = {}
    for modality in ("video", "audio"):
        phase(f"9.3 single-modal train CLI: scripts/single_modal_train.py --modality {modality}, batch 4, "
              f"use_checkpoint, {SINGLE_TRAIN_STEPS} steps")
        argv = SINGLE_FLAGS + SINGLE_SIZES[modality] + [
            "--modality", modality, "--output_dir", os.path.join(tmp, f"single_{modality}"),
            "--save_interval", "1000000"]
        loop, counts, _, _ = train_cli_run(cli, argv, SINGLE_TRAIN_STEPS)
        for name in ("self_attention", "self_attention_bwd[T<=512]", "self_attention_bwd[T>512]"):
            check(counts.get(name, 0) > 0, f"{name} never launched in the {modality} training run")
        launches[modality] = counts
        del loop
        gc.collect()
        torch.cuda.empty_cache()
    return launches

# Phase 10: multi-GPU training and sampling (parallel/) on the one card.
# NCCL refuses two ranks on one device, so 10.1 and 10.2 run two ranks on
# gloo over CUDA tensors (the worker joins torchrun's group on gloo itself):
# the flagship training config (TRAIN_FLAGS: remat, bf16) at full width,
# 2 ranks x batch 2 with injected timesteps and noise, held to the one-rank
# batch-4 step on the same card at phase 6.1's limits.  10.3 runs the
# train CLI through torchrun on NCCL (one rank) with a resume, and the
# sampling CLI with --n_sample_data 2 on two gloo ranks.  Cuts: PARALLEL_STEPS
# timed steps per rank; 10.3's sampler at SAMPLE_STEPS_10 / SR_STEPS_10,
# and ddpm (per-step noise at both stages) on DDPM_RESPACING_10 steps.
PARALLEL_T = (50, 321, 600, 999)  # the global batch's timesteps
PARALLEL_SHIFT = 5  # the RS-MMA shift at every shifting site, as phase 6.1's
PARALLEL_STEPS = 3  # steps timed per rank after the checked one
PARALLEL_WORLD = 2
TORCHRUN_TRAIN_STEPS = 5  # the median of steps 3-5 is printed
SAMPLE_STEPS_10, SR_STEPS_10 = 10, 5
DDPM_RESPACING_10 = ("--sample_fn", "ddpm", "--timestep_respacing", "4", "--sr_sample_fn", "ddpm",
                     "--sr_timestep_respacing", "3")
# The collectives' share of a step is taken by difference: DDP's step
# without its gradient all-reduce (no_sync) against the step; FSDP2's step
# against that same step without collectives.  torch.profiler cannot give
# it: gloo runs its collectives on threads of its own, and their events
# read 0-1.2 ms a step on the H100 (torch 2.11).


def parallel_step_run(mode: str, work: str):
    """One rank's run of phases 10.1 (``mode`` "ddp") / 10.2 ("fsdp"), or
    the one-rank batch-4 reference ("one", no process group): the checked
    step with injected draws, then PARALLEL_STEPS timed steps (under DDP
    also PARALLEL_STEPS without the gradient all-reduce).  Writes
    ``<work>/<mode>_rank<r>.pt``."""
    import statistics

    import torch

    from mm_diffusion_tpu_torch import configs
    from mm_diffusion_tpu_torch.configs import args_to_dict
    from mm_diffusion_tpu_torch.data.synthetic import load_synthetic_data
    from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.parallel import ParallelModel, make_mesh, process_data_shard, rank_rows, setup_dist
    from mm_diffusion_tpu_torch.parallel.mesh import full_tensor, local
    from mm_diffusion_tpu_torch.scripts import multimodal_train
    from mm_diffusion_tpu_torch.train import create_train_state, make_optimizer, make_train_step
    from mm_diffusion_tpu_torch.weights import randomize_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = setup_dist("cuda") if mode != "one" else torch.device("cuda")
    rank, world = process_data_shard()
    mesh = None if mode == "one" else make_mesh(n_fsdp=world if mode == "fsdp" else 1, device_type="cuda")
    args = multimodal_train.create_argparser().parse_args(TRAIN_FLAGS)
    cfg = configs.create_model_config(**args_to_dict(args, configs.model_and_diffusion_defaults()))
    model = randomize_(MultimodalUNet(cfg), seed=71).to(device).train()
    parallel = ParallelModel(model, mesh)
    state = create_train_state(model, make_optimizer(model, args.lr), (0.9999,), parallel=parallel)
    diffusion = configs.create_gaussian_diffusion(steps=1000).to(device)
    step = make_train_step(diffusion, shift=PARALLEL_SHIFT)
    rows = len(PARALLEL_T)
    batch = {k: torch.from_numpy(v) for k, v in next(
        load_synthetic_data(rows, video_size=cfg.video_size, audio_size=cfg.audio_size, seed=3)).items()}
    rng = torch.Generator().manual_seed(4)
    noise = {k: torch.randn(v.shape, generator=rng).to(device) for k, v in batch.items()}
    local_batch = {k: rank_rows(v, rank, world).to(device) for k, v in batch.items()}
    t = torch.tensor(PARALLEL_T)

    torch.cuda.reset_peak_memory_stats()
    ba.reset_launch_counts()
    metrics = step(state, local_batch, t=t, noise=noise)
    torch.cuda.synchronize()
    counts = ba.kernel_launches()
    grad = torch.cat([full_tensor(p.grad).reshape(-1).float().cpu() for p in model.parameters()])
    opt_state = [v for st in state.optimizer.opt.state.values() for v in st.values() if v.dim() > 0]
    held = list(model.parameters()) + opt_state + list(state.ema["0.9999"].values())
    state_bytes = sum(local(x).numel() * x.element_size() for x in held)
    ms = []
    for _ in range(PARALLEL_STEPS):
        t0 = time.perf_counter()
        step(state, local_batch, t=t, noise=noise)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    nosync_ms = None
    if parallel.kind == "ddp":  # the same steps without the gradient all-reduce (DDP's no_sync)
        nosync = []
        for _ in range(PARALLEL_STEPS):
            t0 = time.perf_counter()
            with parallel.module.no_sync():
                step(state, local_batch, t=t, noise=noise)
            torch.cuda.synchronize()
            nosync.append(1e3 * (time.perf_counter() - t0))
        nosync_ms = statistics.median(nosync)
    out = {
        "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), "counts": counts,
        "nosync_ms": nosync_ms,
        "kind": parallel.kind, "step_ms": statistics.median(ms), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "state_bytes": state_bytes, "grad": grad if rank == 0 else None,
    }
    torch.save(out, os.path.join(work, f"{mode}_rank{rank}.pt"))
    return out


def run_command(cmd, timeout=600, label=""):
    """Run ``cmd`` from the checkout; fail the phase on a non-zero exit (its
    output's end printed), kill it at ``timeout``."""
    import subprocess

    print("command:", " ".join(cmd))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(out[-6000:])
    check(proc.returncode == 0, f"{label} exited {proc.returncode}")
    return out, wall


def torchrun(nproc: int, *args):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
            *args]


def parallel_training(tmp: str):
    """Phases 10.1 and 10.2; returns {mode: [per-rank outputs]}."""
    import gc

    import torch

    work = os.path.join(tmp, "parallel")
    os.makedirs(work, exist_ok=True)
    ref = parallel_step_run("one", work)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"one rank, batch 4: loss {ref['loss']:.6f} grad_norm {ref['grad_norm']:.6e} step "
          f"{ref['step_ms']:.1f} ms, peak {ref['peak_gib']:.2f} GiB, parameter + optimizer + EMA "
          f"{ref['state_bytes'] / 2**30:.3f} GiB; launches {ref['counts']}")
    results = {}
    for mode, label in (("ddp", "10.1 DDP"), ("fsdp", "10.2 FSDP2 (--n_fsdp 2)")):
        phase(f"{label} on the card: {PARALLEL_WORLD} ranks x batch 2 on gloo over CUDA tensors, the flagship "
              f"train config (remat, bf16) vs the one-rank batch-4 step")
        _, wall = run_command(
            torchrun(PARALLEL_WORLD, os.path.abspath(__file__), "--parallel-worker", mode, work), label=label)
        outs = [torch.load(os.path.join(work, f"{mode}_rank{r}.pt"), weights_only=False)
                for r in range(PARALLEL_WORLD)]
        for r, o in enumerate(outs):
            loss_gap = abs(o["loss"] - ref["loss"]) / abs(ref["loss"])
            norm_gap = abs(o["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
            if o["nosync_ms"] is not None:
                print(f"rank {r}: {o['nosync_ms']:.1f} ms per step without the gradient all-reduce (no_sync): "
                      f"the all-reduce takes {1 - o['nosync_ms'] / o['step_ms']:.3f} of the step")
            print(f"rank {r} ({o['kind']}): loss {o['loss']:.6f} (gap {loss_gap:.3e}), grad_norm "
                  f"{o['grad_norm']:.6e} (gap {norm_gap:.3e}); step {o['step_ms']:.1f} ms (median of "
                  f"{PARALLEL_STEPS}); peak {o['peak_gib']:.2f} GiB; parameter + optimizer + EMA "
                  f"{o['state_bytes'] / 2**30:.3f} GiB; "
                  f"launches {o['counts']}")
            check(o["kind"] == mode, f"rank {r} ran {o['kind']}, not {mode}")
            check(loss_gap <= LOSS_REL_TOL, f"{label} rank {r}: loss vs one rank")
            check(norm_gap <= LOSS_REL_TOL, f"{label} rank {r}: gradient norm vs one rank")
            for name, n in o["counts"].items():
                check(n > 0, f"{label} rank {r}: {name} never launched")
        e = rel_l2(outs[0]["grad"].double(), ref["grad"].double())
        print(f"gradient ({ref['grad'].numel()} values) rel L2 vs one rank {e:.3e} (tolerance "
              f"{GRAD_REL_L2_TOL}); launch wall {wall:.1f} s")
        check(e <= GRAD_REL_L2_TOL, f"{label}: gradient vs one rank")
        results[mode] = outs
    ddp_bytes = results["ddp"][0]["state_bytes"]
    for r, o in enumerate(results["fsdp"]):
        share = o["state_bytes"] / ddp_bytes
        nosync = results["ddp"][r]["nosync_ms"]
        print(f"FSDP2 rank {r}: parameter + optimizer + EMA {o['state_bytes'] / 2**30:.3f} GiB, "
              f"{share:.3f} of DDP's {ddp_bytes / 2**30:.3f} GiB; against DDP's step without collectives "
              f"({nosync:.1f} ms) the all-gathers and reduce-scatters take {1 - nosync / o['step_ms']:.3f} "
              f"of the step")
        check(share < 0.6, f"FSDP2 rank {r} holds {share:.3f} of DDP's state, not about half")
    return results


def parallel_sample_rows(argv):
    """The two ranks' rows of 10.3's sampling, computed in this process
    rank by rank (batch 1 each, as the ranks run them)."""
    import numpy as np
    import torch

    from mm_diffusion_tpu_torch.sampling import sample_base_and_sr
    from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr as cli

    args = cli.create_argparser().parse_args(argv)
    rows = []
    for r in range(PARALLEL_WORLD):
        base, sr, gen, step_gen, f, size = cli.build_pipeline(args, torch.device("cuda"))
        out = sample_base_and_sr(base, sr, args.batch_size, size, f, generator=gen, rank=r,
                                 world=PARALLEL_WORLD, step_generator=step_gen)
        rows.append({k: v.float().cpu().numpy() for k, v in out.items()})
        del base, sr
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


def parallel_clis(tmp: str):
    """Phase 10.3: the train CLI through torchrun on NCCL (one rank), a
    resume, and the sampling CLI with --n_sample_data 2 on two gloo ranks
    against the one-rank run."""
    import json as json_
    import statistics

    import numpy as np
    import torch

    from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr as cli

    phase(f"10.3 CLIs through torchrun: multimodal_train.py (1 rank, NCCL), {TORCHRUN_TRAIN_STEPS} steps and a "
          f"resume; multimodal_sample_sr.py --n_sample_data {PARALLEL_WORLD} on {PARALLEL_WORLD} gloo ranks")
    out_dir = os.path.join(tmp, "torchrun_train")
    train = ["-m", "mm_diffusion_tpu_torch.scripts.multimodal_train", *TRAIN_FLAGS, "--output_dir", out_dir,
             "--device", "cuda", "--log_interval", "1", "--save_interval", "1000000"]
    for steps in (TORCHRUN_TRAIN_STEPS, TORCHRUN_TRAIN_STEPS + 1):
        out, wall = run_command(torchrun(1, *train, "--max_steps", str(steps)), label="torchrun train CLI")
        print(f"torchrun train CLI to step {steps}: wall {wall:.1f} s; "
              f"{[line for line in out.splitlines() if 'training on' in line or 'resuming' in line]}")
    rows = [json_.loads(line) for line in open(os.path.join(out_dir, "progress.jsonl"))]
    for r in rows:
        print(f"step {int(r['step'])} loss {r['loss']:.5f} grad_norm {r['grad_norm']:.4e} step_ms {r['step_ms']:.1f}")
    print(f"median step {statistics.median(r['step_ms'] for r in rows[2:TORCHRUN_TRAIN_STEPS]):.1f} ms over "
          f"steps 3-{TORCHRUN_TRAIN_STEPS} (one rank on NCCL, batch 4)")
    check([int(r["step"]) for r in rows] == list(range(1, TORCHRUN_TRAIN_STEPS + 2)), "torchrun train steps")
    check(all(math.isfinite(r["loss"]) for r in rows), "non-finite loss in the torchrun train run")
    ckpts = sorted(os.listdir(os.path.join(out_dir, "checkpoints")))
    check(ckpts == [f"step_{s:08d}.pt" for s in (TORCHRUN_TRAIN_STEPS, TORCHRUN_TRAIN_STEPS + 1)],
          f"checkpoints {ckpts}")

    solver = cli.LAUNCH_SCRIPT_ARGS + [
        "--sample_steps", str(SAMPLE_STEPS_10), "--sr_sample_steps", str(SR_STEPS_10),
        "--batch_size", str(PARALLEL_WORLD), "--sample_num", str(PARALLEL_WORLD), "--device", "cuda"]
    for name, argv in (("dpm_solver + ddim", solver), ("ddpm", solver + list(DDPM_RESPACING_10))):
        one_run = cli.main(argv + ["--output_dir", os.path.join(tmp, "sample_one")])
        one = one_run["samples"]
        rows_ref = parallel_sample_rows(argv)
        work = os.path.join(tmp, "sample_ranks")
        os.makedirs(work, exist_ok=True)
        _, wall = run_command(
            torchrun(PARALLEL_WORLD, os.path.abspath(__file__), "--parallel-worker", "sample", work,
                     *argv, "--n_sample_data", str(PARALLEL_WORLD), "--output_dir", work),
            label=f"torchrun sampling CLI ({name})")
        ranks = torch.load(os.path.join(work, "sample_rank0.pt"), weights_only=False)
        names = lambda paths: sorted(os.path.basename(p) for p in paths)  # noqa: E731
        check(names(ranks["paths"]) == names(one_run["paths"]) != [],
              f"{name}: the two-rank run wrote {names(ranks['paths'])}, the one-rank run {names(one_run['paths'])}")
        for k, v in one.items():
            spread = float(np.abs(rows_ref[k] - v).max())
            gap = float(np.abs(ranks["samples"][k] - v).max())
            same = float(np.abs(ranks["samples"][k] - rows_ref[k]).max())
            print(f"{name}: {k} {v.shape}: two ranks vs one rank max |diff| {gap:.3e}; the one-rank spread (the "
                  f"ranks' rows at batch 1 in one process vs batch 2) {spread:.3e}; two ranks vs those rows "
                  f"{same:.3e}")
            check(ranks["samples"][k].shape == v.shape and bool(np.isfinite(ranks["samples"][k]).all()),
                  f"{name}: {k}: shape or non-finite values")
            check(gap <= spread + 1e-3, f"{name}: {k}: two ranks differ from one rank by more than its spread")
            check(same <= 1e-3, f"{name}: {k}: two ranks differ from their rows computed in one process")
        print(f"{name}: two-rank sampling wall {wall:.1f} s; files {names(ranks['paths'])}")


def parallel_worker(mode: str, work: str, argv) -> None:
    """A rank of 10.1/10.2 (``ddp`` / ``fsdp``) or of 10.3's sampling run
    (``sample``), under torchrun.  NCCL refuses two ranks on one card, so
    the worker joins torchrun's group on gloo and puts its rank on the one
    card before the port's code runs (``setup_dist`` then finds the group
    and joins nothing; the device mesh keeps the card set here)."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="env://")
    torch.cuda.set_device(0)
    try:
        if mode in ("ddp", "fsdp"):
            parallel_step_run(mode, work)
            return
        from mm_diffusion_tpu_torch.parallel import process_data_shard
        from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr as cli

        result = cli.main(argv)
        rank, _ = process_data_shard()
        torch.save({"samples": result["samples"], "paths": result["paths"]},
                   os.path.join(work, f"sample_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()



# Phase 11: evaluation (evaluation/, the eval CLIs, --save_type npz and
# --run_eval) at the published architectures with seeded random weights.
# 11.1 holds each network on the card (fp32, TF32 off) against the same
# module on the CPU; 11.2 runs the sampling CLI with the evaluation; 11.3
# the eval CLIs on random-weight checkpoints in the original key layouts.
# Cuts: 11.2's sampler as phase 10.3's (10 NFE, ddim5), and EVAL_NUM_11
# clips per side where the CLIs evaluate 2048 (the loader repeats the 4
# sampled clips; 2048 would spend minutes in host-side numpy).
EVAL_REL_L2_TOL = 1e-4
EVAL_BATCH = 8  # clips (images for the image networks) per timed batch
EVAL_NUM_11 = 16
EVAL_SAMPLE_ARGS = ["--batch_size", "2", "--sample_num", "4", "--sample_steps", str(SAMPLE_STEPS_10),
                    "--sr_sample_steps", str(SR_STEPS_10), "--device", "cuda"]
# the weights' scale: N(0, gain / fan_in).  He's 2 where the signal would
# fade through depth; smaller where a larger one drives the sigmoid gates
# and the attention pools' softmax into saturation, where fp32's rounding
# on two devices decides the output
EVAL_GAINS = {"i3d": 2.0, "audio": 0.5, "clip_visual": 1.0, "clip_text": 1.0}


def eval_random_(model, seed: int, gain: float):
    """Seeded random weights for an evaluation network: weights ~ N(0,
    gain / fan_in), norm scales ~ 1 + N(0, 0.1^2), biases ~ N(0, 0.1^2),
    BN running means ~ N(0, 0.1^2) and variances ~ U(0.5, 1); the FBSP
    filterbank's spline order ~ U(0, 0.5), bandwidth ~ U(0.1, 1), centres
    kept (the trained tower's ranges)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if name == "fbsp.fc":
                continue
            if name == "fbsp.m":
                p.copy_(torch.rand(p.shape, generator=g) * 0.5)
            elif name == "fbsp.fb":
                p.copy_(torch.rand(p.shape, generator=g) * 0.9 + 0.1)
            elif p.dim() > 1:
                p.copy_(noise * math.sqrt(gain / p[0].numel()))
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) * 0.5 + 0.5)
    return model.eval()


def c3d_published_params(seed: int):
    """Random C3D weights at the published widths, in chainer's layout."""
    import numpy as np

    rng = np.random.default_rng(seed)
    convs = {"conv1a": (3, 64), "conv2a": (64, 128), "conv3a": (128, 256), "conv3b": (256, 256),
             "conv4a": (256, 512), "conv4b": (512, 512), "conv5a": (512, 512), "conv5b": (512, 512)}
    params = {}
    for name, (cin, cout) in convs.items():
        params[name] = {"W": (rng.standard_normal((cout, cin, 3, 3, 3), np.float32) * math.sqrt(2 / (27 * cin))),
                        "b": rng.standard_normal(cout, np.float32) * 0.1}
    for name, (cin, cout) in {"fc6": (8192, 4096), "fc7": (4096, 4096), "fc8": (4096, 101)}.items():
        params[name] = {"W": rng.standard_normal((cout, cin), np.float32) * math.sqrt(2 / cin),
                        "b": rng.standard_normal(cout, np.float32) * 0.1}
    return params


def eval_graph_bytes(seed: int) -> bytes:
    """A small frozen GraphDef, written with the port's proto writers
    (evaluation/tf_bundle.py): Conv2D (SAME, stride 2), BiasAdd, Relu,
    AvgPool SAME, MaxPool SAME, ResizeBilinear, Reshape (a -1 target),
    MatMul, Softmax.  Feed ``x:0`` [N, 37, 45, 3], fetch ``out:0``
    [N, 10]."""
    import numpy as np

    from mm_diffusion_tpu_torch.evaluation.tf_bundle import _proto_field_bytes, _proto_field_varint

    rng = np.random.default_rng(seed)
    fb, fv = _proto_field_bytes, _proto_field_varint

    def tensor(arr):
        dtype = {np.dtype("float32"): 1, np.dtype("int32"): 3}[arr.dtype]
        shape = b"".join(fb(2, fv(1, d)) for d in arr.shape)
        return fb(8, fv(1, dtype) + fb(2, shape) + fb(4, arr.tobytes()))

    def ints(values):
        return fb(1, b"".join(fv(3, v) for v in values))

    def node(name, op, inputs=(), **attrs):
        out = fb(1, name.encode()) + fb(2, op.encode()) + b"".join(fb(3, i.encode()) for i in inputs)
        for key, value in attrs.items():
            out += fb(5, fb(1, key.encode()) + fb(2, value))
        return fb(1, out)

    f32 = fv(6, 1)
    pool = dict(ksize=ints([1, 3, 3, 1]), padding=fb(2, b"SAME"), T=f32)
    nodes = [
        node("x", "Placeholder", dtype=f32),
        node("w1", "Const", value=tensor((rng.standard_normal((3, 3, 3, 16)) * 0.3).astype(np.float32)), dtype=f32),
        node("conv", "Conv2D", ("x", "w1"), strides=ints([1, 2, 2, 1]), padding=fb(2, b"SAME"), T=f32),
        node("b1", "Const", value=tensor(rng.standard_normal(16).astype(np.float32)), dtype=f32),
        node("bias", "BiasAdd", ("conv", "b1"), T=f32),
        node("relu", "Relu", ("bias",), T=f32),
        node("avg", "AvgPool", ("relu",), strides=ints([1, 1, 1, 1]), **pool),
        node("max", "MaxPool", ("avg",), strides=ints([1, 2, 2, 1]), **pool),
        node("size", "Const", value=tensor(np.array([12, 12], np.int32)), dtype=fv(6, 3)),
        node("resize", "ResizeBilinear", ("max", "size"), T=f32, align_corners=fv(5, 0)),
        node("shape", "Const", value=tensor(np.array([-1, 12 * 12 * 16], np.int32)), dtype=fv(6, 3)),
        node("flat", "Reshape", ("resize", "shape"), T=f32),
        node("w2", "Const", value=tensor((rng.standard_normal((12 * 12 * 16, 10)) * 0.02).astype(np.float32)),
             dtype=f32),
        node("mm", "MatMul", ("flat", "w2"), T=f32),
        node("out", "Softmax", ("mm",), T=f32),
    ]
    return b"".join(nodes)


def eval_network_cases():
    """(name, module, checked input, timed input of EVAL_BATCH clips or
    images) for each evaluation network, at the published shapes, CPU
    tensors."""
    import numpy as np
    import torch

    from mm_diffusion_tpu_torch.evaluation import audioclip, c3d, clip_model, graphdef, i3d

    g = torch.Generator().manual_seed(5)

    class GraphNet:  # the executor behind the modules' interface: .to(device), call
        def __init__(self, blob, device="cpu"):
            self.blob, self.executor = blob, graphdef.GraphDefExecutor(blob, device=device)

        def to(self, device):
            return GraphNet(self.blob, device)

        def __call__(self, x):
            return self.executor.run(["out:0"], {"x:0": x})[0]

        def checked(self, x):
            return self.executor.run(["out:0", "mm:0"], {"x:0": x})

    tokens = torch.randint(1, 49407, (EVAL_BATCH, 77), generator=g)
    tokens[:, 20] = 49407  # the end-of-text token, the highest id
    return [
        ("i3d", eval_random_(i3d.InceptionI3d(), 61, EVAL_GAINS["i3d"]),
         torch.rand((2, 16, 224, 224, 3), generator=g) * 2 - 1,
         torch.rand((EVAL_BATCH, 16, 224, 224, 3), generator=g) * 2 - 1),
        ("audioclip_audio", eval_random_(audioclip.ESResNeXtFBSP(), 62, EVAL_GAINS["audio"]),
         torch.rand((2, 1, 70560), generator=g) * 2 - 1, torch.rand((EVAL_BATCH, 1, 70560), generator=g) * 2 - 1),
        ("clip_visual", eval_random_(clip_model.CLIPVisualResNet(), 63, EVAL_GAINS["clip_visual"]),
         torch.randn((16, 224, 224, 3), generator=g), torch.randn((EVAL_BATCH * 16, 224, 224, 3), generator=g)),
        ("clip_text", eval_random_(clip_model.CLIPTextEncoder(), 64, EVAL_GAINS["clip_text"]), tokens[:2], tokens),
        ("c3d", c3d.C3D(c3d_published_params(65)), torch.randn((2, 16, 112, 112, 3), generator=g) * 50,
         torch.randn((EVAL_BATCH, 16, 112, 112, 3), generator=g) * 50),
        ("graphdef", GraphNet(eval_graph_bytes(6)), torch.from_numpy(np.random.default_rng(7).uniform(0, 255, (2, 37, 45, 3)).astype(
            np.float32)), torch.rand((EVAL_BATCH, 37, 45, 3), generator=g) * 255),
    ]


def eval_networks():
    """Phase 11.1; returns {network: (ms per batch, peak GiB)}."""
    import gc

    import numpy as np
    import torch

    from mm_diffusion_tpu_torch.evaluation.common import fp32_precision
    from mm_diffusion_tpu_torch.evaluation.resize import resize_uint8

    phase(f"11.1 evaluation networks on the card (fp32, TF32 off) vs the same modules on the CPU, at the "
          f"published shapes (rel L2 {EVAL_REL_L2_TOL}); device ms per batch of {EVAL_BATCH}")
    torch.set_num_threads(os.cpu_count() or 1)
    dev = torch.device("cuda")
    out = {}
    def checked(name, module, x):
        """The outputs held card vs CPU: C3D's and the graph's logits beside
        their softmax, which random weights saturate."""
        if name == "graphdef":
            return [y.cpu() for y in module.checked(x)]
        if name != "c3d":
            return [module(x).cpu()]
        logits = []
        hook = module.fc8.register_forward_hook(lambda mod, i, o: logits.append(o.cpu()))
        out = module(x).cpu()
        hook.remove()
        return [out, logits[0]]

    for name, module, x, timed in eval_network_cases():
        with fp32_precision():
            t0 = time.perf_counter()
            refs = checked(name, module, x)
            cpu_s = time.perf_counter() - t0
            gpu = module.to(dev)
            gots = checked(name, gpu, x.to(dev))
            ref, got = refs[0], gots[0]
            e = max(rel_l2(g, r) for g, r in zip(gots, refs))
            timed = timed.to(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            gpu(timed)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            ms = time_ms(lambda: gpu(timed))
        per = "images" if name in ("clip_visual", "graphdef") else "clips"
        rate = EVAL_BATCH * 1e3 / ms
        print(f"{name}: input {tuple(x.shape)} -> {tuple(ref.shape)}, rel L2 card vs CPU {e:.3e}"
              f"{' (the larger of the output and the logits)' if len(refs) > 1 else ''}, finite "
              f"{bool(torch.isfinite(got).all())}; batch of {EVAL_BATCH} {per} {tuple(timed.shape)}: {ms:.3f} ms "
              f"({rate:.1f} {per}/s), peak {peak:.2f} GiB over the inputs; CPU forward {cpu_s:.1f} s")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output on the card")
        check(e <= EVAL_REL_L2_TOL, f"{name}: card vs CPU rel L2 {e:.3e}")
        out[name] = (ms, peak)
        del module, gpu, timed
        gc.collect()
        torch.cuda.empty_cache()
    rng = np.random.RandomState(8)
    for (h, w), size, mode in (((64, 64), 224, "bilinear"), ((256, 256), 224, "bilinear"),
                               ((64, 64), 224, "bicubic"), ((256, 256), 224, "bicubic"),
                               ((64, 64), 128, "bicubic"), ((256, 256), 128, "bicubic")):
        frames = torch.from_numpy(rng.randint(0, 256, (16, h, w, 3)).astype(np.uint8))
        diff = (resize_uint8(frames.to(dev), size, size, mode).cpu().int()
                - resize_uint8(frames, size, size, mode).int()).abs()
        print(f"resize {mode} {h}->{size}: card vs CPU max |diff| {int(diff.max())} in uint8, share "
              f"{float((diff > 0).float().mean()):.2e}")
        check(int(diff.max()) <= 1, f"resize {mode} {h}->{size}: card vs CPU differ by more than 1")
    return out


def write_av_npz(path, seed, n=4):
    """A synthetic "real" AV batch at the sampler's output sizes: moving
    smooth patterns in uint8 and 1.6 s of 16 kHz tones with noise."""
    import numpy as np

    from mm_diffusion_tpu_torch.evaluation.npz_batch import save_av_npz_batch

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:256, :256] / 256.0
    t = np.arange(16)[:, None, None]
    videos = np.stack([
        np.stack([127 + 120 * np.sin(2 * np.pi * (rng.uniform(1, 4) * xx + rng.uniform(1, 4) * yy + 0.1 * t + c))
                  for c in range(3)], -1) for _ in range(n)]).astype(np.uint8)
    s = np.arange(25600) / 16000.0
    audio = np.stack([0.5 * np.sin(2 * np.pi * rng.uniform(200, 2000) * s) + 0.05 * rng.standard_normal(25600)
                      for _ in range(n)]).astype(np.float32)
    return save_av_npz_batch(path, videos, audio, 10, 16000)


def eval_sampling_cli(tmp: str):
    """Phase 11.2: the sampling CLI with --save_type npz --run_eval;
    returns (the npz it wrote, the real npz, K1-K3's launches)."""
    import functools

    import numpy as np
    import torch

    from mm_diffusion_tpu_torch.evaluation import eval_multimodal
    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.scripts import multimodal_sample_sr as cli

    phase(f"11.2 sampling CLI with the evaluation: multimodal_sample_sr.py --save_type npz --run_eval, "
          f"LAUNCH_SCRIPT_ARGS at batch 2, 4 clips, {SAMPLE_STEPS_10} NFE, ddim{SR_STEPS_10} SR; "
          f"eval on {EVAL_NUM_11} clips per side")
    real = write_av_npz(os.path.join(tmp, "real"), 9)
    argv = cli.LAUNCH_SCRIPT_ARGS + EVAL_SAMPLE_ARGS + [
        "--save_type", "npz", "--run_eval", "True", "--ref_path", real, "--output_dir", os.path.join(tmp, "eval")]
    print("argv:", " ".join(argv))
    evals = []

    def timed_eval(*args, **kw):
        t0 = time.perf_counter()
        metrics = functools.partial(eval_multimodal, eval_num=EVAL_NUM_11)(*args, **kw)
        evals.append(time.perf_counter() - t0)
        return metrics

    cli.eval_multimodal, orig = timed_eval, cli.eval_multimodal
    ba.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        result = cli.main(argv)
    finally:
        cli.eval_multimodal = orig
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in ba.kernel_launches().items() if "_bwd" not in k}
    (path,) = result["paths"]
    with np.load(path) as z:
        layout = {k: (str(z[k].dtype), z[k].shape) for k in z.files}
    want = {"arr_0": ("uint8", (4, 16, 256, 256, 3)), "audio": ("float32", (4, 25600, 1)),
            "video_fps": ("float32", ()), "audio_fps": ("int32", ()),
            "video_base": ("float32", (4, 16, 64, 64, 3))}
    metrics = result["metrics"]
    print(f"npz {os.path.basename(path)}: {layout}")
    print(f"metrics: {metrics}")
    print(f"stage wall times per batch: {result['timings']}; evaluation {evals[0]:.1f} s; CLI total {wall:.1f} s; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
    check(layout == want, f"npz layout {layout}")
    check(metrics["protocol"] == "fallback", f"protocol {metrics['protocol']}")
    check(all(math.isfinite(metrics[k]) for k in ("fvd", "kvd", "fad")), "non-finite metrics")
    for name, n in counts.items():
        check(n > 0, f"{name} never launched in the sampling run")
    return path, real, counts


def eval_clis(tmp: str, sample: str, real: str):
    """Phase 11.3: scripts/eval.py, image_eval.py and video_is.py on
    random-weight checkpoints in the original key layouts."""
    import contextlib
    import io

    import numpy as np
    import torch

    from mm_diffusion_tpu_torch.evaluation import audioclip, clip_model, i3d
    from mm_diffusion_tpu_torch.scripts import eval as eval_cli
    from mm_diffusion_tpu_torch.scripts import image_eval as image_eval_cli
    from mm_diffusion_tpu_torch.scripts import video_is as video_is_cli

    phase("11.3 eval CLIs on random-weight checkpoints: eval.py (I3D + full AudioCLIP, --compute_is), "
          "image_eval.py (--clip_checkpoint), video_is.py (C3D)")
    ck = {k: os.path.join(tmp, f) for k, f in (("i3d", "i3d.pt"), ("audioclip", "audioclip.pt"),
                                                ("c3d", "c3d.npz"), ("mean", "mean2.npz"))}
    torch.save(eval_random_(i3d.InceptionI3d(), 71, EVAL_GAINS["i3d"]).state_dict(), ck["i3d"])
    tower = eval_random_(audioclip.ESResNeXtFBSP(), 72, EVAL_GAINS["audio"])
    visual = eval_random_(clip_model.CLIPVisualResNet(), 73, EVAL_GAINS["clip_visual"])
    torch.save({**{f"audio.{k}": v for k, v in tower.state_dict().items()},
                **{f"visual.{k}": v for k, v in visual.state_dict().items()},
                "logit_scale_ai": torch.tensor(math.log(100.0))}, ck["audioclip"])
    np.savez(ck["c3d"], **{f"{n}/{k}": v for n, p in c3d_published_params(74).items() for k, v in p.items()})
    np.savez(ck["mean"], mean=np.random.default_rng(75).uniform(0, 255, (3, 16, 128, 171)).astype(np.float32))
    runs = [
        ("eval.py", eval_cli.main, ["--ref_dir", real, "--fake_dir", sample, "--i3d_checkpoint", ck["i3d"],
                                    "--audioclip_checkpoint", ck["audioclip"], "--compute_is",
                                    "--sample_num", str(EVAL_NUM_11)],
         ("fvd", "kvd", "fad", "av_clip_score_fake", "av_clip_score_real", "video_is")),
        ("image_eval.py", image_eval_cli.main, [real, sample, "--clip_checkpoint", ck["audioclip"]],
         ("fid", "kid", "precision", "recall")),
        ("video_is.py", video_is_cli.main, [sample, "--c3d_npz", ck["c3d"], "--mean", ck["mean"]], ("video_is",)),
    ]
    out = {}
    for name, main, argv, keys in runs:
        argv = argv + ["--output_dir", os.path.join(tmp, name), "--device", "cuda"]
        print(f"{name} argv: {' '.join(argv)}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            metrics = main(argv)
        if name == "eval.py":
            check(metrics["protocol"] == "reference", f"eval.py protocol {metrics['protocol']}")
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{name}: {metrics}; wall {wall:.1f} s, peak {peak:.2f} GiB")
        check(all(k in metrics and math.isfinite(metrics[k]) for k in keys), f"{name}: metrics {metrics}")
        out[name] = (wall, peak)
    return out


# Phase 12: the batch-8 path (the benchmark's base-dpm20-b8 cell): 12.1
# K1-K3 at the base MM-UNet's shapes at batch 8 (the sampler's N times 8;
# the SR U-Net's shapes do not depend on the batch), 12.2 one batch-8
# evaluation against eight batch-1 evaluations of its rows.
B8 = 8
B8_SELF_SHAPES = [(label, n * B8, t, c, h, layout) for label, n, t, c, h, layout in SELF_SHAPES
                  if label.startswith("mm ")]
B8_BANDED_SHAPES = [(label, B8, f, tq, tk, c, h, lw) for label, f, tq, tk, c, h, lw in BANDED_SHAPES]
# 12.2: the RS-MMA shift at every shifting site (the last of the window-8
# span, where its window wraps) and each row's timestep.
B8_SHIFT = 8
B8_TIMESTEPS = (0, 130, 260, 390, 520, 650, 780, 999)
# 12.2's limits: max over rows and both outputs of the relative L2 between
# the batch-8 and the batch-1 evaluation on the card.  H100 readings:
# bf16 1.260e-2 (the same in two runs), fp32 with TF32 off 3.265e-4.  The
# two evaluations first part at the first ResBlock's conv (bf16, 1.4e-4)
# or the time embedding's linear (fp32, 1.2e-7), where cuDNN and cuBLAS
# choose their kernels by the batch, and the random-weight network grows
# that gap layer by layer to its output.  Each limit leaves 3-4x over its
# reading; a row or offset fault of a kernel at a large N moves a row by O(1).
B8_ROW_REL_L2_TOL = {"bfloat16": 5e-2, "float32": 1e-3}


def batch8_kernels(summary):
    """Phase 12.1: K1-K3 at the batch-8 shapes against their plain versions
    (FORWARD_TOL / LSE_TOL; the banded shifts 0, the middle and the last of
    the span), each shape timed with its bound and, for K1, SDPA's forward.
    Errors go into ``summary``; returns {kernel: {"b8_ms", "b8_bound_ms",
    "b8_library_ms"}} summed over the kernel's shapes."""
    import torch

    from mm_diffusion_tpu_torch.ops import block_attention as ba

    phase(f"12.1 K1-K3 at the batch-{B8} shapes vs plain versions (bf16; out {ba.FORWARD_TOL}, "
          f"lse {ba.LSE_TOL})")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    sums = {}

    def add(name, err, ms, bound, lib_ms):
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], err)
        d = sums.setdefault(name, {"b8_ms": 0.0, "b8_bound_ms": 0.0, "b8_library_ms": 0.0})
        d["b8_ms"] += ms
        d["b8_bound_ms"] += bound[0]
        d["b8_library_ms"] = None if lib_ms is None else d["b8_library_ms"] + lib_ms

    for label, n, t, c, h, layout in B8_SELF_SHAPES:
        qkv = torch.randn((n, t, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
        (out, lse), ran = routed_call("self_attention", c // h, lambda: ba.self_attention_cuda(qkv, h, layout))
        err, lse_err, ok = self_forward_check(qkv, h, layout, out, lse)
        check(ok, f"self_attention {label} batch {B8}: err {err}, lse {lse_err}")
        ms = time_ms(lambda: ba.self_attention_cuda(qkv, h, layout))
        lib_ms = library_attention_ms(packed_views(layout, h), [qkv])
        bound = bound_ms(*self_attention_work(n, t, c, h))
        print(f"self_attention {label:18s} N={n:5d} T={t:5d} C={c:4d} H={h} err={err:.3e} lse_err={lse_err:.3e} "
              f"kernel={ms:.4f} ms library (SDPA fwd)={lib_ms:.4f} ms bound={bound[0]:.4f} ms ({bound[1]}) "
              f"[{ran}]")
        add("self_attention", max(err, lse_err), ms, bound, lib_ms)
        del qkv, out, lse
        torch.cuda.empty_cache()

    for label, n, f, tq, tk, c, h, lw in B8_BANDED_SHAPES:
        q_src = torch.randn((n, f, tq, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
        kv_src = torch.randn((n, f, tk, 3 * c), generator=g, device=dev, dtype=torch.bfloat16)
        shifts = sorted({0, (f - lw) // 2, f - lw})
        worst = 0.0
        for s in shifts:
            (out, lse), ran = routed_call(
                "banded_attention", c // h, lambda: ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c))
            err, lse_err, ok = banded_forward_check(q_src, kv_src, s, lw, h, c, out, lse)
            check(ok, f"banded {label} batch {B8} shift {s}: err {err}, lse {lse_err}")
            worst = max(worst, err, lse_err)
        s = shifts[-1]
        ms = time_ms(lambda: ba.banded_attention_cuda(q_src, kv_src, s, lw, h, c))
        bound = bound_ms(*banded_work(n, f, tq, tk, c, h, lw))
        print(f"banded_attention {label:20s} N={n} F={f} Tq={tq:5d} Tk={tk:5d} C={c} H={h} lw={lw:2d} "
              f"shifts={shifts} err={worst:.3e} kernel={ms:.4f} ms bound={bound[0]:.4f} ms ({bound[1]})")
        add("banded_attention[lw=1]" if lw == 1 else "banded_attention[lw>1]", worst, ms, bound, None)
    for name, v in sums.items():
        print(f"{name} at batch {B8}, summed: {v}")
    return sums


@contextlib.contextmanager
def row0_outputs(model):
    """Record row 0 of every submodule's tensor output, in call order, into
    the last dict of the yielded list (the caller appends a fresh dict to
    start another pass); the hooks go on exit."""
    import torch

    seen = [{}]

    def hook(name):
        def record(module, args, out):
            if torch.is_tensor(out):
                seen[-1].setdefault(name, out[:1].float().clone())
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def batch8_eval():
    """Phase 12.2: the flagship base MM-UNet (random non-zero weights) on
    the card at batch 8 against eight batch-1 evaluations of the same rows:
    the same weights, inputs, timesteps and shift; in bf16 (the sampling
    path) and in fp32 (TF32 off), whose gap is rounding alone."""
    import dataclasses

    import torch

    from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.weights import randomize_

    phase(f"12.2 the base MM-UNet: one batch-{B8} evaluation vs {B8} batch-1 evaluations of its rows "
          f"(on the card, shift {B8_SHIFT}; max row rel L2 {B8_ROW_REL_L2_TOL})")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(42)
    base, _ = flagship_configs()
    f, c, h, w = base.video_size
    video = torch.randn((B8, f, h, w, c), generator=g).to(dev)
    audio = torch.randn((B8, base.audio_size[1], base.audio_size[0]), generator=g).to(dev)
    t = torch.tensor(B8_TIMESTEPS, device=dev)
    for dtype, tol in B8_ROW_REL_L2_TOL.items():
        model = randomize_(MultimodalUNet(dataclasses.replace(base, dtype=dtype)), seed=41)
        model.to(dev).eval()
        one = lambda i: model(video[i : i + 1], audio[i : i + 1], t[i : i + 1], shift=B8_SHIFT)  # noqa: E731
        with torch.inference_mode(), row0_outputs(model) as seen:
            ba.reset_launch_counts()
            v8, a8 = model(video, audio, t, shift=B8_SHIFT)
            torch.cuda.synchronize()
            launches = {k: v for k, v in ba.kernel_launches().items() if "_bwd" not in k}
            seen.append({})
            rows = [one(0)]
        with torch.inference_mode():
            rows += [one(i) for i in range(1, B8)]
        parting = [(name, rel_l2(x, seen[1][name])) for name, x in seen[0].items()]
        first = next(((n, e) for n, e in parting if e > 0), None)
        print(f"{dtype}: row 0's module outputs, batch {B8} vs batch 1: the first to differ (call order) "
              f"{first}, the last {parting[-1]}")
        errs = {key: [rel_l2(full[i : i + 1].float().cpu(), one[k].float().cpu()) for i, one in enumerate(rows)]
                for k, (key, full) in enumerate((("video", v8), ("audio", a8)))}
        worst = max(max(e) for e in errs.values())
        for key, e in errs.items():
            print(f"{dtype} {key}: per-row rel L2 batch {B8} vs batch 1: " + " ".join(f"{x:.3e}" for x in e))
        print(f"{dtype}: max {worst:.3e} (tolerance {tol}); launches of the batch-{B8} evaluation {launches}")
        check(all(torch.isfinite(x).all() for x in (v8, a8)), f"{dtype}: non-finite batch-{B8} output")
        check(worst <= tol, f"{dtype}: batch-{B8} evaluation vs batch 1: {worst}")
        for name, n in launches.items():
            check(n > 0, f"{dtype}: {name} never launched in the batch-{B8} evaluation")
        del model, v8, a8, rows
        torch.cuda.empty_cache()


# Phase 13: the GroupNorm + FiLM + SiLU kernel (ops/group_norm.py) at every
# shape of one sampling evaluation of the benchmark's sampling
# configurations (the flagship's: the SR U-Net on one clip's 16 frames at 256^2,
# the base MM-UNet at batch 8; SDXL base's U-Net at 8 rows of 128^2
# latents, whose transformer norms run with eps 1e-6 and the SiLU off),
# against its plain version at GN_TOL (one bf16 step:
# both round an fp32 value once, the sums taken in another order).
GN_SR_FRAMES = 16
GN_SHIFT = 3  # the RS-MMA shift of 13.1's base evaluation
SDXL_CONTEXT_TOKENS, SDXL_POOLED = 77, 1280  # 13.1's SDXL text context and pooled embedding


def group_norm_sites():
    """Phase 13.1: one evaluation of each sampling model on the card under
    ``inference_mode`` with the kernel's wrapper recording its calls: every
    ResBlock, out-head and SpatialTransformer norm took the fused route (the
    attention blocks' norms stay on GroupNorm32, counted by forward hooks),
    and a train-style forward and backward took none.  The models: the SR
    U-Net, the base MM-UNet at batch 8, and Stable Diffusion XL base's
    U-Net in one 8-row evaluation of the benchmark's text-to-image cell,
    where K1 runs once and K8 once a transformer block.  The image U-Nets'
    ResBlocks fold their conv biases (BIAS_FOLDS) and end on the residual
    kernel.  Every launch counter is reset just before each evaluation.
    Returns ({model: Counter of (shape, groups, FiLM dtype, silu, eps,
    layout, input term)}, {model: route and launch counts}, {model: Counter
    of residual shapes})."""
    import collections
    import dataclasses

    import torch

    from benchmark.weights import load_seeded_
    from mm_diffusion_tpu_torch import configs
    from mm_diffusion_tpu_torch.models.attention import RSMMACrossAttention, TokenSelfAttention
    from mm_diffusion_tpu_torch.models.image_unet import ImageResBlock, ImageSuperResModel, ImageUNet, sdxl_vector
    from mm_diffusion_tpu_torch.models.transformer import BasicTransformerBlock, SpatialTransformer
    from mm_diffusion_tpu_torch.ops import block_attention as ba
    from mm_diffusion_tpu_torch.ops import fused_attention as fa
    from mm_diffusion_tpu_torch.models.layers import GroupNorm32
    from mm_diffusion_tpu_torch.models.mm_unet import MultimodalUNet
    from mm_diffusion_tpu_torch.ops import group_norm as gn
    from mm_diffusion_tpu_torch.ops import residual
    from mm_diffusion_tpu_torch.weights import randomize_

    phase("13.1 GroupNorm + FiLM + SiLU: the routes of one sampling evaluation of each benchmark model, "
          "and of one train-style forward and backward")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(13)
    base, sr = flagship_configs()
    f, c, h, w = base.video_size
    sdxl = configs.create_text2img_config(**configs.sdxl_base_flags())

    def sdxl_model():
        with torch.device(dev):
            return load_seeded_(ImageUNet(sdxl), 45)

    cases = {
        "sr": (lambda: randomize_(ImageSuperResModel(sr), seed=43), lambda m: m(
            torch.randn((GN_SR_FRAMES, sr.image_size, sr.image_size, 3), generator=g).to(dev),
            torch.full((GN_SR_FRAMES,), 500, device=dev),
            torch.rand((GN_SR_FRAMES, sr.image_size // 4, sr.image_size // 4, 3), generator=g).to(dev) * 2 - 1)),
        "base": (lambda: randomize_(MultimodalUNet(base), seed=43), lambda m: m(
            torch.randn((B8, f, h, w, c), generator=g).to(dev),
            torch.randn((B8, base.audio_size[1], base.audio_size[0]), generator=g).to(dev),
            torch.tensor(B8_TIMESTEPS, device=dev), shift=GN_SHIFT)),
        "sdxl": (sdxl_model, lambda m: m(
            torch.randn((B8, sdxl.image_size, sdxl.image_size, sdxl.in_channels), generator=g).to(dev),
            torch.tensor(B8_TIMESTEPS, device=dev),
            context=torch.randn((B8, SDXL_CONTEXT_TOKENS, sdxl.context_dim), generator=g).to(dev),
            y=sdxl_vector(torch.randn((B8, SDXL_POOLED), generator=g)).to(dev))),
    }
    real, real_residual = gn.group_norm_silu_cuda, residual.residual_bias_cuda
    sites, routes, residual_sites = {}, {}, {}
    for name, (build, run) in cases.items():
        model = build().to(dev).eval()
        seen, seen_residual = collections.Counter(), collections.Counter()

        def recording(x, weight, bias, groups, eps=1e-5, film=None, silu=True, in_bias=None, _seen=seen):
            term = None if in_bias is None else ("channel" if in_bias.dim() == 1 else "sample")
            _seen[(tuple(x.shape), groups, None if film is None else str(film[0].dtype).split(".")[-1],
                   silu, eps, "cl" if gn.channels_last(x) else "cf", term)] += 1
            return real(x, weight, bias, groups, eps, film, silu, in_bias)

        def recording_residual(skip, h, bias, _seen=seen_residual):
            _seen[tuple(h.shape)] += 1
            return real_residual(skip, h, bias)

        in_attention = {id(m) for blk in model.modules() if isinstance(blk, (TokenSelfAttention, RSMMACrossAttention))
                        for m in blk.modules() if isinstance(m, GroupNorm32)}
        module_calls = collections.Counter()
        hooks = [m.register_forward_hook(lambda mod, a, o, _k=id(m) in in_attention, _n=n:
                                         module_calls.update(["attention" if _k else _n]))
                 for n, m in model.named_modules() if isinstance(m, GroupNorm32)]
        for counts in (gn, ba, fa, residual):
            counts.reset_launch_counts()
        gn.group_norm_silu_cuda, residual.residual_bias_cuda = recording, recording_residual
        try:
            with torch.inference_mode():
                outs = run(model)
                torch.cuda.synchronize()
        finally:
            gn.group_norm_silu_cuda, residual.residual_bias_cuda = real, real_residual
            for hd in hooks:
                hd.remove()
        outs = outs if isinstance(outs, tuple) else (outs,)
        check(all(torch.isfinite(o).all() for o in outs), f"{name}: non-finite output")
        attn = module_calls.pop("attention", 0)
        others = dict(module_calls)
        launches = {"self_attention": ba.LAUNCHES["self_attention"], "flash_mha_fwd": fa.LAUNCHES["flash_mha_fwd"],
                    "flash_mha_designs": dict(fa.FORWARD_DESIGNS), "head_dim_routes": dict(ba.HEAD_DIM_ROUTES)}
        folds = dict(gn.BIAS_FOLDS)
        routes[name] = dict(gn.ROUTES, attention_norms_on_group_norm32=attn, launches=launches, bias_folds=folds,
                            residual_routes=dict(residual.ROUTES))
        print(f"{name}: norm calls of one evaluation: {dict(gn.ROUTES)} through group_norm_silu, {attn} "
              f"attention norms on GroupNorm32; {len(seen)} distinct shapes, kernel launches by mode "
              f"{dict(gn.LAUNCHES)}; attention launches {launches}; bias folds {folds}, residual routes "
              f"{dict(residual.ROUTES)}, launches {dict(residual.LAUNCHES)}")
        if name != "base":  # the image U-Net: every ResBlock folds its conv biases
            blocks = [m for m in model.modules() if isinstance(m, ImageResBlock)]
            skips = sum(not isinstance(b.skip_connection, torch.nn.Identity) for b in blocks)
            check(folds == {"norm": len(blocks), "residual": len(blocks), "skip": skips}
                  and (len(blocks), skips) == {"sr": (42, 20), "sdxl": (17, 11)}[name]
                  and dict(residual.ROUTES) == {"kernel": len(blocks)}
                  and residual.LAUNCHES["residual_bias"] == len(blocks),
                  f"{name}: {len(blocks)} ResBlocks, {skips} skip convs; bias folds {folds}, residual routes "
                  f"{dict(residual.ROUTES)}")
        else:
            check(not folds and not residual.ROUTES, f"base: bias folds {folds}, residual routes {dict(residual.ROUTES)}")
        if name == "sdxl":
            # K1 and K8 once a transformer block; the norm twice a ResBlock,
            # once a SpatialTransformer and once in the out head.
            blocks = sum(isinstance(m, BasicTransformerBlock) for m in model.modules())
            norms = (2 * sum(isinstance(m, ImageResBlock) for m in model.modules()) + 1
                     + sum(isinstance(m, SpatialTransformer) for m in model.modules()))
            check(blocks == 70 and launches["self_attention"] == blocks and launches["flash_mha_fwd"] == blocks
                  and launches["flash_mha_designs"] == {"sm90": blocks} and not launches["head_dim_routes"],
                  f"sdxl: {blocks} transformer blocks, attention launches {launches}")
            check(gn.LAUNCHES["group_norm_silu_cl"] == norms == 46,
                  f"sdxl: {norms} norms, {dict(gn.LAUNCHES)} kernel launches")
            check(any(not silu and eps == 1e-6 for (_, _, _, silu, eps, _, _) in seen),
                  "sdxl: no transformer norm seen")
        # The image U-Net (sr, sdxl) holds its activations channels-last, the MM-UNet channels-first.
        route, mode = ("fused", "group_norm_silu") if name == "base" else ("fused_cl", "group_norm_silu_cl")
        check(set(gn.ROUTES) == {route} and gn.ROUTES[route] == sum(seen.values()) == gn.LAUNCHES[mode]
              and sum(gn.LAUNCHES.values()) == gn.LAUNCHES[mode], f"{name}: routes {dict(gn.ROUTES)}, "
              f"launches {dict(gn.LAUNCHES)}")
        check(not others, f"{name}: norms outside the attention blocks ran as modules: {others}")
        sites[name] = seen
        residual_sites[name] = seen_residual
        del model, outs
        torch.cuda.empty_cache()

    # Training: grad on, parameters require grad -> every norm on the autograd route.
    small = dataclasses.replace(base, use_checkpoint=True)
    model = randomize_(MultimodalUNet(small), seed=44).to(dev).train()
    gn.reset_launch_counts()
    v, a = model(torch.randn((1, f, h, w, c), generator=g).to(dev),
                 torch.randn((1, base.audio_size[1], base.audio_size[0]), generator=g).to(dev),
                 torch.tensor([500], device=dev), shift=GN_SHIFT)
    (v.float().square().mean() + a.float().square().mean()).backward()
    torch.cuda.synchronize()
    print(f"train-style forward and backward (batch 1, remat): routes {dict(gn.ROUTES)}, kernel launches "
          f"{dict(gn.LAUNCHES)}")
    check(set(gn.ROUTES) == {"autograd"} and not any(gn.LAUNCHES.values()),
          f"training took the kernel: {dict(gn.ROUTES)}")
    routes["train"] = dict(gn.ROUTES)
    del model, v, a
    torch.cuda.empty_cache()
    return sites, routes, residual_sites


def group_norm_kernel():
    """Phase 13: 13.1's routes, then 13.2: the kernel at each recorded shape
    and layout against its plain version (GN_TOL), its device ms beside the
    bounds (4 bytes an element: read once, written once; 6: read twice),
    its two-read mode's, the channels-first mode's on a contiguous copy of
    the same input (for the channels-last shapes), the plain version's and
    the eager chain's (GroupNorm32 then SiLU: the library ms), both modes'
    names in a profiler trace in the benchmark's "group norm" kind, and
    13.3's transposes.  Returns the record printed as JSON."""
    import torch
    import torch.nn.functional as F

    from benchmark.trace import kind_of
    from mm_diffusion_tpu_torch.models.layers import GroupNorm32
    from mm_diffusion_tpu_torch.ops import group_norm as gn

    sites, routes, residual_sites = group_norm_sites()
    phase(f"13.2 GroupNorm + FiLM + SiLU kernel vs plain version at 13.1's shapes, layouts and input terms "
          f"(bf16; {gn.GN_TOL})")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    record = {"routes": routes, "max_abs_err": 0.0}
    for name, seen in sites.items():
        tot = dict(ms=0.0, two_read_ms=0.0, channels_first_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bound6_ms=0.0)
        for (shape, groups, film_dtype, silu, eps, layout, term), calls in sorted(
                seen.items(), key=lambda kv: (-math.prod(kv[0][0]), str(kv[0]))):
            n, c = shape[:2]
            x = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
            if layout == "cl":
                x = x.movedim(1, -1).contiguous().movedim(-1, 1)
            check(gn.channels_last(x) == (layout == "cl"), f"{shape}: layout {layout} not rebuilt")
            norm = GroupNorm32(c, eps=eps).to(dev).requires_grad_(False)
            check(norm.num_groups == groups, f"{shape}: {norm.num_groups} groups, the model had {groups}")
            with torch.no_grad():
                norm.weight.copy_(1 + 0.1 * torch.randn(c, generator=g, device=dev))
                norm.bias.copy_(0.1 * torch.randn(c, generator=g, device=dev))
            film = None
            if film_dtype is not None:
                emb = (0.3 * torch.randn((n, 2 * c), generator=g, device=dev)).to(getattr(torch, film_dtype))
                film = tuple(emb.chunk(2, dim=-1))
            # The term as the ResBlock passes it: the first conv's bias, fp32 [C], or with the time embedding, [N, C].
            t = None if term is None else 0.5 * torch.randn((c,) if term == "channel" else (n, c), generator=g,
                                                            device=dev)
            args = (x, norm.weight, norm.bias, groups, norm.eps, film, silu, t)
            cf_args = (x.contiguous(),) + args[1:]
            plain = gn.group_norm_silu_reference(*args)
            out = gn.group_norm_silu_cuda(*args)
            check(gn.channels_last(out) == (layout == "cl"), f"{shape}: the output left the input's layout")
            err, ok = gn.GN_TOL.check(out, plain)
            err2, ok2 = gn.GN_TOL.check(gn._group_norm_silu_two_read_cuda(*args), plain)
            check(ok and ok2, f"group_norm_silu {shape} {layout} groups {groups} film {film_dtype} eps {eps} "
                              f"term {term}: err {err} (two-read {err2})")
            del plain, out
            ms = time_ms(lambda: gn.group_norm_silu_cuda(*args))
            two_ms = time_ms(lambda: gn._group_norm_silu_two_read_cuda(*args))
            cf_ms = time_ms(lambda: gn.group_norm_silu_cuda(*cf_args)) if layout == "cl" else ms
            plain_ms = time_ms(lambda: gn.group_norm_silu_reference(*args))
            # The eager chain: the term's broadcast add (the bias add the fold removed), GroupNorm32, the SiLU.
            tv = None if t is None else t.to(x.dtype).reshape((t.shape[0] if t.dim() == 2 else 1, c)
                                                              + (1,) * (x.dim() - 2))
            act = F.silu if silu else (lambda y: y)
            lib_ms = time_ms(lambda: act(norm(x if tv is None else x + tv, film=film)))
            extra = 8 * c + (4 * n * c if film is not None else 0) + (4 * t.numel() if t is not None else 0)
            bound = bound_ms(0, 4 * x.numel() + extra)
            bound6 = bound_ms(0, 6 * x.numel() + extra)
            print(f"{name} {shape} {layout} groups {groups} film {film_dtype} silu {silu} eps {eps} term {term} "
                  f"x{calls}: "
                  f"err={max(err, err2):.3e} "
                  f"kernel={ms:.4f} ms two-read={two_ms:.4f} ms channels-first={cf_ms:.4f} ms "
                  f"plain={plain_ms:.4f} ms library (GroupNorm32 + SiLU, eager)={lib_ms:.4f} ms "
                  f"bound={bound[0]:.4f} ms ({100 * bound[0] / ms:.1f}% of it) 6-byte bound={bound6[0]:.4f} ms")
            record["max_abs_err"] = max(record["max_abs_err"], err, err2)
            for key, val in (("ms", ms), ("two_read_ms", two_ms), ("channels_first_ms", cf_ms),
                             ("plain_ms", plain_ms), ("library_ms", lib_ms), ("bound_ms", bound[0]),
                             ("bound6_ms", bound6[0])):
                tot[key] += calls * val
            del x, args, cf_args
        print(f"{name}: one evaluation's norms: kernel {tot['ms']:.3f} ms, two-read {tot['two_read_ms']:.3f} ms, "
              f"channels-first {tot['channels_first_ms']:.3f} ms, eager chain {tot['library_ms']:.3f} ms, "
              f"bound {tot['bound_ms']:.3f} ms (6-byte {tot['bound6_ms']:.3f} ms)")
        record[name] = tot
        torch.cuda.empty_cache()

    (shape, groups, *_), _ = max(sites["sr"].items(), key=lambda kv: math.prod(kv[0][0]))
    x = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    norm = GroupNorm32(shape[1]).to(dev).requires_grad_(False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        gn.group_norm_silu_cuda(x, norm.weight, norm.bias, groups)
        gn.group_norm_silu_cuda(x.contiguous(memory_format=torch.channels_last), norm.weight, norm.bias, groups)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if "group_norm_silu" in e.name}
    print(f"profiled kernel names: {sorted(names)} -> kinds {sorted({kind_of(n) for n in names})}")
    check(len(names) == 2 and all(kind_of(n) == "group norm" for n in names)
          and any(f"{gn.KERNEL_NAME}<" in n for n in names) and any(gn.CL_KERNEL_NAME in n for n in names),
          f"kernel names in the trace: {names}")
    record["sr_transposes"] = sr_layout_transposes()
    record["residual"] = residual_kernel(residual_sites)
    return record


def residual_kernel(sites):
    """Phase 13.4: the residual + bias kernel at each ResBlock output shape
    of 13.1's SR and SDXL evaluations against its plain version (the same
    fp32 adds and one rounding: the same bits), timed beside its bound (6
    bytes an element) and the two eager adds it replaces (the second conv's
    broadcast bias add, then the residual add); its name in a profiler trace
    classified "elementwise".  Returns {model: summed ms of one evaluation}."""
    import torch

    from benchmark.trace import kind_of
    from mm_diffusion_tpu_torch.ops import group_norm as gn
    from mm_diffusion_tpu_torch.ops import residual

    phase("13.4 residual + bias kernel vs plain version at 13.1's ResBlock outputs (bf16, channels-last)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    record = {}
    for name, seen in sites.items():
        tot = dict(ms=0.0, eager_ms=0.0, bound_ms=0.0)
        for shape, calls in sorted(seen.items(), key=lambda kv: -math.prod(kv[0])):
            skip, h = (torch.randn(shape, generator=g, device=dev).bfloat16().contiguous(
                memory_format=torch.channels_last) for _ in range(2))
            b = 0.1 * torch.randn(shape[1], generator=g, device=dev)
            plain = residual.residual_bias_reference(skip, h, b)
            out = residual.residual_bias_cuda(skip, h.clone(memory_format=torch.channels_last), b)
            check(gn.channels_last(out) and torch.equal(out, plain),
                  f"residual_bias {shape}: not the plain version's bits")
            ms = time_ms(lambda: residual.residual_bias_cuda(skip, h, b))  # accumulates into h, as timed
            b16 = b.bfloat16().reshape(1, -1, 1, 1)
            eager_ms = time_ms(lambda: skip + (h + b16))
            bound = bound_ms(0, 6 * h.numel() + 4 * shape[1])[0]
            print(f"{name} {shape} x{calls}: kernel={ms:.4f} ms eager bias + residual adds={eager_ms:.4f} ms "
                  f"bound={bound:.4f} ms ({100 * bound / ms:.1f}% of it)")
            for key, val in (("ms", ms), ("eager_ms", eager_ms), ("bound_ms", bound)):
                tot[key] += calls * val
            del skip, h, plain, out
        print(f"{name}: one evaluation's residual passes: kernel {tot['ms']:.3f} ms, eager adds "
              f"{tot['eager_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms")
        record[name] = tot
        torch.cuda.empty_cache()
    x = torch.randn((2, 64, 8, 8), device=dev).bfloat16().contiguous(memory_format=torch.channels_last)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        residual.residual_bias_cuda(x, x.clone(memory_format=torch.channels_last), torch.zeros(64, device=dev))
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if "residual_bias" in e.name}
    print(f"profiled kernel names: {sorted(names)} -> kinds {sorted({kind_of(n) for n in names})}")
    check(len(names) == 1 and all(residual.KERNEL_NAME in n and kind_of(n) == "elementwise" for n in names),
          f"residual kernel names in the trace: {names}")
    return record


def sr_layout_transposes():
    """Phase 13.3: one SR evaluation (the flagship SR U-Net, 16 frames at 256^2,
    bf16, inference_mode) under the profiler after a warm-up one: cuDNN's
    layout transposes (kernels named nchwToNhwc / nhwcToNchw), counted, with
    their device seconds, beside the evaluation's busy kernel seconds.
    Returns {kernel: [launches, seconds]} with "all kernels"."""
    import collections

    import torch

    from mm_diffusion_tpu_torch.models.image_unet import ImageSuperResModel
    from mm_diffusion_tpu_torch.weights import randomize_

    phase("13.3 cuDNN layout transposes in one traced SR evaluation (16 frames at 256^2)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(15)
    _, sr = flagship_configs()
    model = randomize_(ImageSuperResModel(sr), seed=43).to(dev).eval()
    x = torch.randn((GN_SR_FRAMES, sr.image_size, sr.image_size, 3), generator=g).to(dev)
    ts = torch.full((GN_SR_FRAMES,), 500, device=dev)
    low = torch.rand((GN_SR_FRAMES, sr.image_size // 4, sr.image_size // 4, 3), generator=g).to(dev) * 2 - 1
    with torch.inference_mode():
        model(x, ts, low)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            model(x, ts, low)
            torch.cuda.synchronize()
    counts = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()  # the kernel's own interval
        for key in ("nchwToNhwc", "nhwcToNchw"):
            if key in e.name:
                counts[key][0] += 1
                counts[key][1] += us / 1e6
        counts["all kernels"][0] += 1
        counts["all kernels"][1] += us / 1e6
    print("one SR evaluation: " + ", ".join(f"{k} {n} launches {sec:.6f} s" for k, (n, sec) in counts.items()))
    del model
    torch.cuda.empty_cache()
    return dict(counts)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # one rank of phase 10, started by the script itself through torchrun
    parser.add_argument("--parallel-worker", nargs=2, metavar=("MODE", "DIR"), help=argparse.SUPPRESS)
    opts, rest = parser.parse_known_args()
    if rest and not opts.parallel_worker:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
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
    if opts.parallel_worker:
        parallel_worker(*opts.parallel_worker, rest)
        return 0
    try:
        smi = toolchain()
        build()
        summary = kernel_parity()
        summary.update(backward_parity(summary))
        slice_cases = slice_attention_cases(summary, summary)
        model_parity()
        with tempfile.TemporaryDirectory() as tmp:
            launches = flagship(tmp)
            gradient_parity()
            launches.update({k: v for k, v in training(tmp).items() if "_bwd" in k})
        summary.update(spike_parity())
        launches.update(entry_points())
        conditional_gradient_parity()
        sampler_bwd = sampler_backward_parity()
        with tempfile.TemporaryDirectory() as tmp:
            a2v_launches = conditional_clis(tmp)
        sr_gradient_parity()
        single_audio_gradient_parity()
        with tempfile.TemporaryDirectory() as tmp:
            sr_launches = sr_training(tmp)
            single_launches = single_training(tmp)
        with tempfile.TemporaryDirectory() as tmp:
            parallel_training(tmp)
            parallel_clis(tmp)
        eval_networks()
        with tempfile.TemporaryDirectory() as tmp:
            sample_npz, real_npz, eval_launches = eval_sampling_cli(tmp)
            eval_clis(tmp, sample_npz, real_npz)
        b8_cases = batch8_kernels(summary)
        batch8_eval()
        gn_record = group_norm_kernel()
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
            "bound_ms": summary[name]["bound_ms"],
            "bound_by": max(summary[name]["by"], key=summary[name]["by"].get),
            "library_ms": summary[name]["library_ms"],
            **({"a2v_launches": a2v_launches[name]} if name in a2v_launches else {}),
            **({"eval_cli_launches": eval_launches[name]} if name in eval_launches else {}),
            **({f"a2v_{k}": v for k, v in sampler_bwd[name].items()} if name in sampler_bwd else {}),
            **({"sr_train_launches": sr_launches[name],
                "single_video_train_launches": single_launches["video"][name],
                "single_audio_train_launches": single_launches["audio"][name]} if name in sr_launches else {}),
            **slice_cases.get(name, {}),
            **b8_cases.get(name, {}),
        }
        for name in REPLACES
    ]
    print(json.dumps({"group_norm_silu": gn_record}))
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
