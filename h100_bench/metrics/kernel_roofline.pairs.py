"""kernel_roofline.pairs: the work's least time on the chip over the kernels' time
(their launches' union, copies left out), %."""

from h100_bench.lib.readers import kernel_roofline as read  # noqa: F401
