"""The traced run's readings: a ``torch.profiler`` window over a few steady
calls, reduced to the device's busy time (the union of its kernel
intervals), the time of each kernel kind, the longest idle gaps named by
what the host was doing, and the kernels that took the most time.

The kinds are a frozen copy of ``mm_diffusion_tpu_torch/scripts/
profile_flagship.py``'s ``KINDS`` (first match wins, on the lower-cased
kernel name), so that a later change to the port cannot move what a
per-layer metric counts."""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

WINDOW_LABEL = "benchmark.traced_window"

KINDS = (
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
ATTENTION_KINDS = ("attention (hand CUDA)", "attention backward (hand CUDA)")
MEMORY_PASS_KINDS = ("group norm", "copies / layout", "elementwise")
OPTIMIZER_KIND = "optimizer / EMA"
TOP = 10  # entries of each breakdown list
NAME_CHARS = 160  # a kernel or host op name is cut to this length in the breakdown


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


@dataclasses.dataclass
class Trace:
    """One traced window: times in microseconds."""

    window_us: float
    busy_us: float  # union of the device operations' intervals
    kernel_us: float  # their summed durations
    by_kind: Dict[str, float]
    top_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def breakdown(self) -> dict:
        return {"device_ops": [[n, us / 1e6] for n, us in self.top_ops],
                "idle_gaps": [[n, us / 1e6] for n, us in self.idle_gaps]}


def _union(intervals: List[Tuple[float, float]]):
    """Merged, sorted intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_op_at(cpu_ops, t: float) -> str:
    """The innermost host op running at ``t`` (the latest-starting one
    whose interval holds it)."""
    best, best_start = "host idle", float("-inf")
    for name, s, e in cpu_ops:
        if s <= t <= e and s > best_start:
            best, best_start = name, s
    return best


def reduce_events(events) -> Trace:
    """A :class:`Trace` from the profiler's raw (kineto) events of one
    window: each has ``name()``, ``device_type()``, ``start_ns()``,
    ``end_ns()`` and ``is_user_annotation()``."""
    window = None
    kernels, cpu_ops = [], []
    for e in events:
        name, span = e.name(), (e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append((name, *span))
        elif name == WINDOW_LABEL:
            window = span
        else:
            cpu_ops.append((name, *span))
    if window is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW_LABEL!r} range")
    w0, w1 = window
    kernels = [(n, max(s, w0), min(e, w1)) for n, s, e in kernels if e > w0 and s < w1]
    merged = _union([(s, e) for _, s, e in kernels])
    by_kind, by_name = collections.Counter(), collections.Counter()
    for n, s, e in kernels:
        by_kind[kind_of(n)] += e - s
        by_name[n[:NAME_CHARS]] += e - s
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    idle = [(_host_op_at(cpu_ops, s + length / 2)[:NAME_CHARS], length) for length, s in gaps]
    return Trace(
        window_us=w1 - w0,
        busy_us=sum(e - s for s, e in merged),
        kernel_us=sum(e - s for _, s, e in kernels),
        by_kind=dict(by_kind),
        top_ops=by_name.most_common(TOP),
        idle_gaps=idle,
    )


def trace_calls(fn: Callable[[], None], calls: int, sync: Callable[[], None]) -> Trace:
    """Profile ``calls`` calls of ``fn`` (each ends with the device synchronised)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW_LABEL):
            for _ in range(calls):
                fn()
            sync()
    return reduce_events(prof.profiler.kineto_results.events())
