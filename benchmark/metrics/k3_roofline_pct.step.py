"""k3_roofline_pct.step: K3 (po_splat_kernel) against its roofline: the least
time the published peaks allow for its work (roofline/po_splat.py) over
its device time a launch."""
from harness.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "step", "po_splat", "po_splat_kernel")
