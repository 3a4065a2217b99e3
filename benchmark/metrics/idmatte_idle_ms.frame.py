"""idmatte_idle_ms.frame: device idle ms a frame inside the program's
id-matte spans (``pota.splat.idmatte``, ``pota.resolve.crypto``): the
host's pace through ``crypto_topk``'s boolean indexes, each a read of a
count to the host."""
import os

from harness.spans import idle_inside
from harness.spec import load_module

busy = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "idmatte_busy_ms.frame.py"),
                   "bench_metrics_idmatte_busy_of_idle")


def read(rec):
    found = busy.stage(rec)
    if found is None:
        return None
    t, union = found
    return idle_inside(t, union) / t.units * 1e3
