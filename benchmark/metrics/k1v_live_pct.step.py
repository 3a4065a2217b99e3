"""k1v_live_pct.step: K1v's candidates that carry a cotangent over all its
candidates (the program's ``k1v.live``, counted by the kernel's own
live-candidate queue, and ``k1v.candidates``), in %."""
from harness.spans import share_pct


def read(rec):
    return share_pct(rec, "step", "k1v.live", "k1v.candidates")
