"""merge_bytes.step: the bytes rank 0 sends in collectives a sharded step
(the program's ``merge.bytes`` counter: the merge's all-to-all and
all-reduces, its backward's all-gather, the loss's and gradients'
all-reduces); None where the program does not count them."""
from harness.spans import counters


def read(rec):
    c = counters(rec)
    if not c or "merge.bytes" not in c or not rec.trace.units:
        return None
    return c["merge.bytes"] / rec.trace.units
