"""frame_p95_ms: the 95th percentile of every frame of the window, each
timed from its start to its synchronise."""
from harness.readers import p95_unit_ms


def read(rec):
    return p95_unit_ms(rec, "frame")
