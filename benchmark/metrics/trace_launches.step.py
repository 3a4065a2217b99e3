"""trace_launches.step: kernels a step launched inside the differentiable
trace's checkpointed chunks (the program's ``pota.trace.chunk`` spans: the
forward's 32 chunks and the backward's recompute of each), the trace's
torch glue around K1."""
from harness.spans import chunk_launches


def read(rec):
    return chunk_launches(rec, "step")
