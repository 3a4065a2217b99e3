"""host_reads.step: the program's reads of device data to the host a step
(its ``host_reads`` counter: each waits for the device to drain the
work queued before it)."""
from harness.spans import per_unit


def read(rec):
    return per_unit(rec, "step", ("host_reads",))
