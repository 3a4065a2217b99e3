"""The arithmetic the metric readers share (``metrics/<name>.py`` each
call one of these with its own arguments)."""
from __future__ import annotations

import math
import statistics

from .spec import roofline_count

# published peaks of one NVIDIA H100 SXM (data sheet, dense): float32
# outside the tensor cores, and HBM3
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def mean_unit_ms(rec, kind: str):
    """The window over the units completed in it, ms."""
    if rec.kind != kind or rec.trace is not None or not rec.units:
        return None
    return rec.window_s / rec.units * 1e3


def p95_unit_ms(rec, kind: str):
    """The 95th percentile of every unit of the window (each timed from
    its start to its synchronise), ms."""
    if rec.kind != kind or rec.trace is not None or not rec.unit_s:
        return None
    if len(rec.unit_s) == 1:
        return rec.unit_s[0] * 1e3
    return statistics.quantiles(rec.unit_s, n=20,
                                method="inclusive")[18] * 1e3


def launches(rec, kind: str):
    """Kernels the device ran a unit, in the traced stretch."""
    if rec.kind != kind or rec.trace is None or not rec.trace.units:
        return None
    return len(rec.trace.kernels()) / rec.trace.units


def idle_pct(rec, kind: str):
    """The share of the traced window in which no device operation ran."""
    if rec.kind != kind or rec.trace is None:
        return None
    t = rec.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def busy_ms(rec, kind: str, ranges: tuple):
    """Device ms a unit of the operations launched inside the ranges named
    ``ranges`` (the harness's wrappers of the program's functions)."""
    if rec.kind != kind or rec.trace is None or not rec.trace.units:
        return None
    t = rec.trace
    total = sum(t.busy_in(r) for r in ranges)
    return total / t.units * 1e3 if total > 0 else None


def roofline_pct(rec, kind: str, kernel: str, name_part: str):
    """The least time the published peaks allow for one launch of
    ``kernel`` (``roofline/<kernel>.py``'s operations and bytes, counted
    on the program's world) over the kernel's mean device time a launch,
    in %; None where the stretch ran no such kernel."""
    if rec.kind != kind or rec.trace is None or rec.world is None:
        return None
    seconds, n = rec.trace.kernel_time(name_part)
    if n == 0 or seconds <= 0:
        return None
    flops, n_bytes = roofline_count(rec.base, kernel)(rec.world)
    least = max(flops / F32_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
    return 100.0 * least / (seconds / n)


def positive(v):
    return v if v is not None and math.isfinite(v) and v > 0 else None
