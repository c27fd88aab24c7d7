"""Device ms a step of the optimizer and EMA kernels (multi-tensor AdamW, EMA, norms)."""

from benchmark.metrics.common import optimizer_ms as read  # noqa: F401
