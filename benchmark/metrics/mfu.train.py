"""The training window's model FLOPs (three forwards a step) at the card's bf16 peak."""

from benchmark.metrics.common import mfu as read  # noqa: F401
