"""host_ms_per_chunk.pairs: the host's time in each ``MomentLocalizer.dispatch``
call (featurization, stacking, copies, launches), the benchmark's spans'
total over their count, ms."""

from h100_bench.lib.readers import span_ms_per_call


def read(record):
    return span_ms_per_call(record, "dispatch")
