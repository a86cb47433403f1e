"""mfu.pairs: the frozen count of the work completed over the window times the peak, %."""

from h100_bench.lib.readers import mfu as read  # noqa: F401
