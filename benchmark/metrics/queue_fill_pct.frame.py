"""queue_fill_pct.frame: the splat queue's slots issued to sources over its
size S (the program's ``splat.issued_slots`` and ``splat.queue_slots``
counters), in %."""
from harness.spans import share_pct


def read(rec):
    return share_pct(rec, "frame", "splat.issued_slots", "splat.queue_slots")
