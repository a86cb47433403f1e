"""device_idle.train: the share of the window with no work on the device, %."""

from h100_bench.lib.readers import device_idle as read  # noqa: F401
