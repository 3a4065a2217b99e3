"""What decides ``correct``: the program's answers against the plain
reference's, number by number, each beside its limit.

What is compared, and how, is the cell's kind of unit's
(``kinds/<kind>.py``: ``reference`` and ``numbers``); the limits are the
cell's (``checks/<workload>.json``).
"""
from __future__ import annotations

import math

from . import world as wd


def norm_gap(got: list, ref: list) -> float:
    """The worst leaf's gap of norms: |‖got‖ - ‖ref‖| over the larger of
    the reference leaf's norm and the median leaf's (leaves whose
    reference norm is under a thousandth of the median's are left out)."""
    ng = [float(t.double().norm()) for t in got]
    nr = [float(t.double().norm()) for t in ref]
    if not all(math.isfinite(v) for v in ng):
        return math.inf
    med = sorted(nr)[len(nr) // 2] if len(nr) % 2 else \
        0.5 * sum(sorted(nr)[len(nr) // 2 - 1:len(nr) // 2 + 1])
    keep = [i for i, v in enumerate(nr) if v >= 1e-3 * med]
    return max(abs(ng[i] - nr[i]) / max(nr[i], med, 1e-300) for i in keep)


def reference_answer(cell, device, seed: int, got: dict,
                     control: bool = False) -> dict:
    """The reference's answer to what ``got`` recorded, in the same form.
    ``control`` runs the reference with bfloat16 at its kernels'
    boundaries (``reference.ops.rounded``)."""
    import reference.ops as rops

    w = wd.build(wd.REFERENCE, cell.config, cell.traffic, device,
                 ops=rops.rounded() if control else None)
    return cell.kind.reference(w, cell.traffic, seed, got)


def numbers(cell, got: dict, ref: dict) -> dict:
    return cell.kind.numbers(got, ref)


def judged(values: dict, limits: dict) -> dict:
    """Each number with its limit; a number missing a limit, not finite or
    above it fails."""
    return {k: {"value": v, "limit": limits.get(k),
                "ok": (k in limits and math.isfinite(v)
                       and v <= limits[k])}
            for k, v in values.items()}
