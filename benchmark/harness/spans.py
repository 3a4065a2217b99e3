"""What the program's own spans and counters say about a traced stretch.

The program (``pota_tpu_torch``) names its layers by ``record_function``
ranges whose names start with ``pota.`` (its ``utils/trace.py::span``) and
counts work in ``utils/trace.py::COUNTERS`` while a profiler records.  The
span readers work on the stretch's :class:`harness.trace.Summary`; the
counter readers import the program's counters through
:data:`harness.world.PROGRAM`.  A program without them (a commit before
they existed) gives no span and no counter module: every reader here then
returns None, and its metric is left out of the result line.
"""
from __future__ import annotations

import bisect
import importlib

from . import world as wd
from .trace import BACKWARD, _union

PREFIX = "pota."
CHUNK = "pota.trace.chunk"


def has_spans(t) -> bool:
    """Whether the stretch holds any of the program's spans."""
    return any(n.startswith(PREFIX) for n, _, _ in t.ranges)


def span_union(t, match) -> list:
    """The union of the ranges whose name ``match(name)`` accepts, as
    sorted disjoint [start, end] intervals (us)."""
    return _union((a, b) for n, a, b in t.ranges if match(n))


def _inside(t: float, union: list, starts: list) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= union[i][1]


def launched_inside(t, union: list, kernels_only: bool = False) -> list:
    """The device operations (kernels alone with ``kernels_only``) whose
    launch time lies in ``union``."""
    starts = [a for a, _ in union]
    ops = t.kernels() if kernels_only else t.device
    return [d for d in ops if d[3] is not None and _inside(d[3], union,
                                                          starts)]


def idle_inside(t, union: list) -> float:
    """Seconds of the window inside ``union`` in which no device operation
    ran."""
    w0, w1 = t.window
    busy = t.busy_intervals()
    starts = [x for x, _ in busy]
    total = 0.0
    for a, b in union:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        total += b - a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            x, y = busy[i]
            total -= max(0.0, min(b, y) - max(a, x))
            i += 1
    return total * 1e-6


def _traced(rec, kind: str) -> bool:
    return (rec.kind == kind and rec.trace is not None and rec.trace.units
            and has_spans(rec.trace))


def chunk_launches(rec, kind: str):
    """Kernels a unit launched inside the trace's checkpointed chunks
    (``pota.trace.chunk``: the forward and the backward's recompute)."""
    if not _traced(rec, kind):
        return None
    t = rec.trace
    union = span_union(t, lambda n: n == CHUNK)
    if not union:
        return None
    return len(launched_inside(t, union, kernels_only=True)) / t.units


def chunk_idle_ms(rec, kind: str):
    """Device idle ms a unit inside the union of the trace's chunks."""
    if not _traced(rec, kind):
        return None
    t = rec.trace
    union = span_union(t, lambda n: n == CHUNK)
    if not union:
        return None
    return idle_inside(t, union) / t.units * 1e3


def backward_glue_ms(rec, kind: str):
    """Device ms a unit of the operations launched inside
    ``loss.backward`` and outside every span of the program: autograd's
    own nodes (the shade's and the trace's glue VJPs, ``IndexBackward0``)."""
    if not _traced(rec, kind):
        return None
    t = rec.trace
    back = span_union(t, lambda n: n == BACKWARD)
    if not back:
        return None
    ours = span_union(t, lambda n: n.startswith(PREFIX))
    starts = [a for a, _ in ours]
    glue = [d for d in launched_inside(t, back)
            if not _inside(d[3], ours, starts)]
    return sum(d[2] for d in glue) * 1e-3 / t.units


def counters(rec):
    """The program's counters over the traced stretch (name -> total), or
    None where the run was not traced or the program has no counters."""
    if rec.trace is None:
        return None
    try:
        mod = importlib.import_module(f"{wd.PROGRAM}.utils.trace")
    except ModuleNotFoundError:
        return None
    return mod.snapshot()


def per_unit(rec, kind: str, names):
    """The sum of the counters ``names`` (a prefix ending in ``.`` takes
    every counter under it) over the traced units; 0 where the program
    counted none of them."""
    c = counters(rec) if rec.kind == kind else None
    if c is None or not rec.trace.units:
        return None
    total = sum(v for k, v in c.items() if any(
        k == n or (n.endswith(".") and k.startswith(n)) for n in names))
    return total / rec.trace.units


def share_pct(rec, kind: str, part: str, whole: str):
    """100 times counter ``part`` over counter ``whole``, both summed over
    the traced units; None where ``whole`` was not counted."""
    c = counters(rec) if rec.kind == kind else None
    if c is None or not c.get(whole):
        return None
    return 100.0 * c.get(part, 0) / c[whole]
