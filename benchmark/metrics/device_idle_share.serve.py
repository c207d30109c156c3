"""``device_idle_share`` in the served cells, where it moves the served
tail."""

from benchmark.metrics.device_idle_share import read  # noqa: F401
