"""launches.step: kernels the device ran a step, in the traced stretch
(the host issues each: the entry's launch count)."""
from harness.readers import launches


def read(rec):
    return launches(rec, "step")
