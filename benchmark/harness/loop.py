"""The one driver every cell runs: set-up, the measured window (or the
traced stretch), the metrics' record.

What a unit of work is comes from the traffic's ``kind``
(``kinds/<kind>.py``: a frame, a fit step); the traffic file gives its
parameters and how many units a traced stretch holds.  The loop is
closed: the next unit starts when the last has synchronised.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import random
import sys
import time

import torch

from . import trace
from . import world as wd


@dataclasses.dataclass
class Record:
    """What the metric readers read (``metrics/<name>.py``)."""
    kind: str                      # the traffic's kind of unit
    units: int = 0                 # units measured or traced
    unit_s: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0          # the host clock over the window
    setup_s: float = 0.0
    peak_bytes: int = 0            # allocated, over the window
    trace: trace.Summary | None = None
    launches: dict = dataclasses.field(default_factory=dict)  # a unit
    world: wd.World | None = None  # the program's, until released
    base: str = ""


def _launch_counter():
    return importlib.import_module(f"{wd.PROGRAM}.ops._build").LAUNCHES


def route_ok(delta: dict, route: dict) -> bool:
    """The unit launched each kernel of ``route`` as often as it says, and
    no other kernel."""
    return all(delta.get(k, 0) == route.get(k, 0)
               for k in set(delta) | set(route))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device, reset: bool = False) -> int:
    if torch.device(device).type != "cuda":
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return int(torch.cuda.max_memory_allocated(device))


class Run:
    """One run of a cell: ``Run(cell, seed, device).go(seconds, traced,
    t0)`` returns the metrics' record; :meth:`release` frees the program's
    state and returns what the check reads."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.t = cell.traffic
        self.kind = cell.kind
        self.route = cell.check["route"]
        self.attempted = self.failed = 0
        # draws the window's unit the check compares (reservoir)
        self.pick = random.Random(self.seed)
        self.rec = None

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        t = [time.perf_counter()]
        self.w = wd.build(wd.PROGRAM, self.cell.config, self.t, self.device)
        _sync(self.device)
        t.append(time.perf_counter())
        self.state, self.next_index = self.kind.setup(self.w, self.t,
                                                      self.seed)
        _sync(self.device)
        t.append(time.perf_counter())
        self.setup_phases = [b - a for a, b in zip(t, t[1:])]

    # -------------------------------------------------------------- units
    def unit(self) -> None:
        """One unit, synchronised, its route and answer seen."""
        launches = _launch_counter()
        before = dict(launches)
        k = self.next_index
        self.next_index += 1
        seed = wd.unit_seed(self.seed, k)
        with torch.profiler.record_function(trace.UNIT):
            out = self.kind.unit(self.w, self.state, seed)
            _sync(self.device)
        keep = self.pick.random() * (self.attempted + 1) < 1.0
        ok = self.kind.done(self.state, out, seed, k, keep)
        delta = {n: launches[n] - before[n] for n in launches
                 if launches[n] != before[n]}
        self.last_launches = delta
        self.attempted += 1
        if not ok or not route_ok(delta, self.route):
            self.failed += 1

    # ------------------------------------------------------------- window
    def go(self, seconds: float, traced: bool, t0: float) -> Record:
        rec = self.rec = Record(kind=self.t["kind"], base=self.cell.base)
        self.setup_start = time.perf_counter()
        self.setup()
        setup_peak = _peak(self.device)
        _peak(self.device, reset=True)
        start = time.perf_counter()
        rec.setup_s = start - t0
        print(f"set-up: {self.setup_start - t0:.3f} s to the harness, then "
              f"the world {self.setup_phases[0]:.3f} s, the warm-up "
              f"{self.setup_phases[1]:.3f} s", file=sys.stderr, flush=True)
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with trace.annotated(wd.PROGRAM, self.cell.ranges()), \
                    torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(trace.WINDOW):
                    for _ in range(int(self.t["trace_units"])):
                        self.unit()
            end = time.perf_counter()
            rec.trace = trace.Summary(trace.chrome_events(prof))
            del prof
        else:
            while True:
                a = time.perf_counter()
                self.unit()
                end = time.perf_counter()
                rec.unit_s.append(end - a)
                if end - start >= seconds:
                    break
        rec.units = self.attempted
        rec.window_s = end - start
        rec.launches = self.last_launches
        rec.peak_bytes = _peak(self.device)
        rec.world = self.w
        self.memory_peak = max(setup_peak, rec.peak_bytes)
        return rec

    def release(self) -> dict:
        """Free the program's state; return what the check reads."""
        got = self.state["got"]
        self.w = self.state = None
        if self.rec is not None:
            self.rec.world = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return got
