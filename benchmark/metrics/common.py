"""Arithmetic the per-layer readers share.  A reader takes the run's
``Record`` (``benchmark/run.py``) and returns the metric's value, or None
where the run has nothing to read; no share of a peak or a roofline is
ever given as 0 for want of a reading."""

from __future__ import annotations

from typing import Optional

from benchmark.trace import ATTENTION_KINDS, MEMORY_PASS_KINDS, OPTIMIZER_KIND
from benchmark.work import PEAK_BF16_FLOPS


def mfu(record) -> Optional[float]:
    """Model FLOPs of the window's finished units over its seconds at the
    card's bf16 peak, in %."""
    if not record.units:
        return None
    return 100.0 * record.units * record.flops_per_unit / record.window_s / PEAK_BF16_FLOPS


def mem_pass_share(record) -> Optional[float]:
    """GroupNorm, elementwise and copy / layout kernels' share of the
    traced kernel time, in %."""
    tr = record.trace
    if tr is None or not tr.kernel_us:
        return None
    return 100.0 * sum(tr.by_kind.get(k, 0.0) for k in MEMORY_PASS_KINDS) / tr.kernel_us


def attn_roofline(record) -> Optional[float]:
    """The least seconds of the traced units' attention work over the
    attention kernels' traced seconds, in %."""
    tr = record.trace
    if tr is None:
        return None
    kernel_us = sum(tr.by_kind.get(k, 0.0) for k in ATTENTION_KINDS)
    if not kernel_us or not record.traced_units:
        return None
    return 100.0 * record.traced_units * record.attn_bound_s_per_unit / (kernel_us / 1e6)


def device_idle(record) -> Optional[float]:
    """Share of the traced window with no device operation running, in %:
    the union of the device's operations against the window's length, both
    from the one profiler window.  The profiler's own host work is inside
    that window, so where the host paces the device this reads higher than
    the untraced window would."""
    tr = record.trace
    if tr is None or not tr.window_us:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)


def optimizer_ms(record) -> Optional[float]:
    """Device ms per traced step of the optimizer / EMA kernels."""
    tr = record.trace
    if tr is None or not record.traced_units or not tr.by_kind.get(OPTIMIZER_KIND):
        return None
    return tr.by_kind[OPTIMIZER_KIND] / 1e3 / record.traced_units


def sampler_glue_share(record) -> Optional[float]:
    """Share of the window outside the model's calls, in %."""
    if record.span_s is None:
        return None
    return 100.0 * (1.0 - record.span_s / record.window_s)
