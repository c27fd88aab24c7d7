"""Roofline share of the attention kernels (K1-K3) in the sampling trace."""

from benchmark.metrics.common import attn_roofline as read  # noqa: F401
