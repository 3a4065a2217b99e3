"""merge_busy_ms.step: device ms a sharded step on rank 0 of the operations
launched inside the program's merge and gradient spans (``pota.merge`` and
its stages, ``pota.merge.vjp``, ``pota.shard.grads``), with the collectives'
own kernels (NCCL's, whose launches the trace may not tie to a range)."""
from harness.spans import has_spans, launched_inside, span_union

SPANS = ("pota.merge", "pota.shard.grads")


def read(rec):
    t = rec.trace
    if t is None or not t.units or not has_spans(t):
        return None
    union = span_union(t, lambda n: n.startswith(SPANS))
    if not union:
        return None
    ops = launched_inside(t, union)
    ops += [d for d in t.device if d[3] is None and "nccl" in d[0].lower()]
    return sum(d[2] for d in ops) * 1e-3 / t.units
