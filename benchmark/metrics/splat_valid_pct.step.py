"""splat_valid_pct.step: the issued queue slots whose splat landed (in the
region, not vignetted, not occluded) over the issued slots (the program's
``splat.valid_splats`` and ``splat.issued_slots`` counters), in %."""
from harness.spans import share_pct


def read(rec):
    return share_pct(rec, "step", "splat.valid_splats", "splat.issued_slots")
