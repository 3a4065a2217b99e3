"""host_reads.frame: the program's reads of device data to the host a frame
(its ``host_reads`` counter: each waits for the device to drain the
work queued before it)."""
from harness.spans import per_unit


def read(rec):
    return per_unit(rec, "frame", ("host_reads",))
