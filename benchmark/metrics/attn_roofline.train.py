"""Roofline share of the attention kernels (K1-K7, forward and backward) in the training trace."""

from benchmark.metrics.common import attn_roofline as read  # noqa: F401
