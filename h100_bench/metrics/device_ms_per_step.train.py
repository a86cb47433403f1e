"""device_ms_per_step.train: the union of the kernel launches' intervals in
the traced window over the train steps completed, ms."""

from h100_bench.lib.readers import device_ms_per_step as read  # noqa: F401
