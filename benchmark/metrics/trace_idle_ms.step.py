"""trace_idle_ms.step: device idle ms a step inside the union of the
program's ``pota.trace.chunk`` spans (forward and recompute): the host's
pace through the trace's glue, under the profiler."""
from harness.spans import chunk_idle_ms


def read(rec):
    return chunk_idle_ms(rec, "step")
