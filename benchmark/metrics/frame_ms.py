"""frame_ms: the whole measured window over the frames completed in it."""
from harness.readers import mean_unit_ms


def read(rec):
    return mean_unit_ms(rec, "frame")
