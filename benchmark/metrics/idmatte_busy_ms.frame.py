"""idmatte_busy_ms.frame: device ms a frame of the operations launched inside
the program's id-matte spans: ``pota.splat.idmatte`` (``splat_frame``'s
``id_matte_records`` and ``crypto_topk``) and ``pota.resolve.crypto``
(``resolve_crypto``)."""
from harness.spans import has_spans, launched_inside, span_union

SPANS = ("pota.splat.idmatte", "pota.resolve.crypto")


def stage(rec):
    """(the traced stretch, the union of the id-matte spans), or None where
    the run was not traced as frames or holds no such span."""
    t = rec.trace
    if rec.kind != "frame" or t is None or not t.units or not has_spans(t):
        return None
    union = span_union(t, lambda n: n in SPANS)
    return (t, union) if union else None


def read(rec):
    found = stage(rec)
    if found is None:
        return None
    t, union = found
    return sum(d[2] for d in launched_inside(t, union)) * 1e-3 / t.units
