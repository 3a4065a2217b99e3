"""k6_roofline_pct.step: K6 (po_backward_kernel) against its roofline: the
least time the published peaks allow for its work (roofline/po_backward.py)
over its device time a launch."""
from harness.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "step", "po_backward", "po_backward_kernel")
