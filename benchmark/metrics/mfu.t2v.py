"""The text-to-video window's model FLOPs at the card's bf16 peak."""

from benchmark.metrics.common import mfu as read  # noqa: F401
