"""merge_link_pct.step: the collectives against the link's roofline: the
least time rank 0's bytes sent a step (``roofline/merge.py``) take at one
card's NVLink peak, over the device time of the collectives' kernels
(NCCL's) a step, in %."""
from harness.spec import roofline_count

# NVLink 4 of one H100 SXM, one direction (18 links of 25 GB/s)
LINK_BYTES_PER_S = 450e9


def read(rec):
    t = rec.trace
    if t is None or rec.world is None or not t.units:
        return None
    seconds, n = t.kernel_time("nccl")
    counted = roofline_count(rec.base, "merge")(rec.world)
    if n == 0 or seconds <= 0 or counted is None:
        return None
    return 100.0 * counted[1] / LINK_BYTES_PER_S / (seconds / t.units)
