"""Roofline share of the self-attention kernel (K1) in the text-to-video
trace: the self-attention sites' least time (T = 32,760, head dim 128) over
the traced time of kind "attention (hand CUDA)".  K8's ``flash_mha_*``
kernels (the cross-attention) fall under "other" in ``trace.py``'s kinds,
so the cross sites are left out of both sides."""

from benchmark.metrics.common import attn_roofline as read  # noqa: F401
