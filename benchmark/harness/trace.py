"""The traced stretch: ranges set from outside the program, and the
reduction of a ``torch.profiler`` trace to device busy time, idle time,
kernel times and launches.

The ranges are ``record_function`` wrappers the harness sets on module
globals of the program, the (module, function) pairs that the cell's
per-layer metrics list as ``RANGES`` (``metrics/<name>.py``), so a kernel
is charged to the functions whose range holds its launch, as
``scripts/profile_torch_frame.py`` does; the harness adds ``bench.window``
around the stretch, ``bench.unit`` around each unit and ``loss.backward``
around a fit step's backward.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import tempfile

WINDOW, UNIT, BACKWARD = "bench.window", "bench.unit", "loss.backward"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def annotated(pkg: str, functions):
    """While open, each (module, function) of ``functions`` of ``pkg``
    runs inside a ``record_function`` range named after the function."""
    import torch

    originals = []
    try:
        for mod_name, fn_name in functions:
            mod = importlib.import_module(f"{pkg}.{mod_name}")
            fn = getattr(mod, fn_name)
            originals.append((mod, fn_name, fn))

            def wrapped(*a, _fn=fn, _name=fn_name, **k):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **k)

            setattr(mod, fn_name, functools.wraps(fn)(wrapped))
        yield
    finally:
        for mod, fn_name, fn in originals:
            setattr(mod, fn_name, fn)


def chrome_events(prof) -> list:
    """The profiler's events as the Chrome trace lists them; the file is
    written under the temporary directory and removed at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Summary:
    """A traced stretch reduced from Chrome trace events (times in us).

    ``window`` is the ``bench.window`` range; ``device`` the device
    operations (kernels, copies, sets) as (name, start, duration, launch
    time or None); ``ranges`` the ``record_function`` ranges as (name,
    start, end)."""

    def __init__(self, events: list):
        self.ranges = [(e["name"], float(e["ts"]),
                        float(e["ts"]) + float(e.get("dur", 0.0)))
                       for e in events if e.get("cat") == "user_annotation"]
        windows = [r for r in self.ranges if r[0] == WINDOW]
        if not windows:
            raise ValueError(f"the trace holds no {WINDOW!r} range")
        self.window = windows[0][1:]
        launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
                  if e.get("cat") == "cuda_runtime"
                  and "correlation" in e.get("args", {})}
        self.device = []
        for e in events:
            if e.get("cat") in DEVICE_CATS:
                corr = e.get("args", {}).get("correlation")
                self.device.append((e["name"], float(e["ts"]),
                                    float(e.get("dur", 0.0)),
                                    launch.get(corr)))
        self.units = sum(1 for r in self.ranges if r[0] == UNIT)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list:
        w0, w1 = self.window
        return _union((max(s, w0), min(s + d, w1)) for _, s, d, _ in
                      self.device if s + d > w0 and s < w1)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernels(self, part: str = "") -> list:
        """The kernels (not copies) whose name holds ``part``."""
        return [d for d in self.device if part in d[0]
                and not d[0].startswith(("Memcpy", "Memset"))]

    def busy_in(self, name: str) -> float:
        """Device seconds of the operations launched inside any range
        named ``name``."""
        spans = [(a, b) for n, a, b in self.ranges if n == name]
        return sum(d for _, _, d, t in self.device
                   if t is not None and any(a <= t <= b for a, b in spans)
                   ) * 1e-6

    def kernel_time(self, part: str) -> tuple:
        """(device seconds, launches) of the kernels whose name holds
        ``part``."""
        ks = self.kernels(part)
        return sum(d for _, _, d, _ in ks) * 1e-6, len(ks)

    def innermost(self, t: float) -> str:
        inside = [r for r in self.ranges if r[1] <= t < r[2]
                  and r[0] not in (WINDOW,)]
        return (min(inside, key=lambda r: r[2] - r[1])[0] if inside
                else "(no range open)")

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (summed by name), and
        the idle gaps of the window summed by the innermost range the host
        had open where each began; seconds, at most ``top`` each."""
        ops = {}
        for name, _, d, _ in self.device:
            ops[name] = ops.get(name, 0.0) + d * 1e-6
        gaps, prev = {}, self.window[0]
        for a, b in self.busy_intervals() + [[self.window[1]] * 2]:
            if a > prev:
                key = self.innermost(prev)
                gaps[key] = gaps.get(key, 0.0) + (a - prev) * 1e-6
            prev = max(prev, b)
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v] for k, v in order(ops)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}
