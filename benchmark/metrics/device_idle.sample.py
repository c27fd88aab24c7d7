"""Share of the sampling trace with the device idle."""

from benchmark.metrics.common import device_idle as read  # noqa: F401
