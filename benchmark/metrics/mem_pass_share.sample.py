"""GroupNorm, elementwise and copy kernels' share of the sampling trace's kernel time."""

from benchmark.metrics.common import mem_pass_share as read  # noqa: F401
