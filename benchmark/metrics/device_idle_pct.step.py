"""device_idle_pct.step: the share of the traced window in which no device
operation (kernel, copy, set) ran."""
from harness.readers import idle_pct


def read(rec):
    return idle_pct(rec, "step")
