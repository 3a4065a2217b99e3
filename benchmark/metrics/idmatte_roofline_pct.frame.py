"""idmatte_roofline_pct.frame: the id-matte stage against its memory
roofline: the least time its bytes (``roofline/idmatte.py``) take at the
published HBM peak, over the device time a frame launched inside the
id-matte spans (``idmatte_busy_ms.frame``), in %."""
import os

from harness.readers import HBM_BYTES_PER_S
from harness.spec import load_module, roofline_count

busy = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "idmatte_busy_ms.frame.py"),
                   "bench_metrics_idmatte_busy_of_roofline")


def read(rec):
    ms = busy.read(rec)
    if not ms or rec.world is None:
        return None
    _, n_bytes = roofline_count(rec.base, "idmatte")(rec.world)
    return 100.0 * n_bytes / HBM_BYTES_PER_S / (ms * 1e-3)
