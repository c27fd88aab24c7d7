"""Share of the sampling window outside the model's evaluations (the samplers' own arithmetic and host work)."""

from benchmark.metrics.common import sampler_glue_share as read  # noqa: F401
