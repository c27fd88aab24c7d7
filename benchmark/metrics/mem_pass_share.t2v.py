"""Elementwise and copy kernels' share of the text-to-video trace's kernel
time: the LayerNorms, the modulation, the q / k RMSNorms and rotations, the
GELUs, the gated residual adds and the weight casts."""

from benchmark.metrics.common import mem_pass_share as read  # noqa: F401
