"""Spans and counters of the port, on the profiler's clock.

:class:`span` marks a layer of the program: while a ``torch.profiler``
records, it opens a ``torch.profiler.record_function`` range named
``pota.<layer>``, so the range shares Kineto's clock with every kernel and
copy the layer launches, on the main thread and on the autograd engine's
device thread alike, and nests inside its caller's range.  When no profiler
records, it costs one check (``torch.autograd._profiler_enabled()``).

:data:`COUNTERS` holds counts made where the work happens, and only while a
profiler records, so that their totals cover exactly a traced stretch
(:func:`count`, :func:`snapshot`, :func:`reset`).  A count taken from a
device value keeps a one-element device tensor (a device-to-device copy of
the value, never a view that would hold a frame's buffers alive) and is
added up only by :func:`snapshot`, after the stretch has synchronised:
counting launches no kernel and reads nothing from the device.

``ops/_build.LAUNCHES`` is not one of these counters: it counts every
launch, traced or not, since a run's route check reads it.
"""
from __future__ import annotations

import functools

import torch

# name -> [(value, most, of)]: a Python number or a one-element device
# tensor, the most it counts for (None: all of it), and the size whose rest
# it counts (None: the value itself)
COUNTERS: dict = {}


def recording() -> bool:
    """Whether a ``torch.profiler`` records on this thread."""
    return torch.autograd._profiler_enabled()


class span:
    """``with span("pota.splat"):`` or ``@span("pota.k3")``: a
    ``record_function`` range named ``name`` while a profiler records,
    nothing otherwise."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()

    def __exit__(self, *exc):
        if self._range is not None:
            rng, self._range = self._range, None
            rng.__exit__(*exc)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        # the function itself, not a wrapper set around it from outside
        # (whose ``__wrapped__`` the benchmark's ranges leave behind)
        del spanned.__wrapped__
        return spanned


def count(name: str, n=1, most: int | None = None,
          of: int | None = None) -> None:
    """Add ``n`` to counter ``name`` while a profiler records.  ``n`` is a
    Python number or a one-element tensor; a device tensor is kept as a
    one-element device-to-device copy of the same dtype (a copy, not a
    kernel), read at :func:`snapshot`.  ``most`` caps this count when it
    is read (the value of a tail that can pass a fixed size); with ``of``
    the count is what ``n`` (so capped) leaves of ``of``."""
    if not torch.autograd._profiler_enabled():
        return
    if isinstance(n, torch.Tensor):
        kept = torch.empty((1,), dtype=n.dtype, device=n.device)
        kept.copy_(n.reshape(1))
        n = kept
    COUNTERS.setdefault(name, []).append((n, most, of))


def host_read(t: torch.Tensor, n: int = 1) -> None:
    """Count ``n`` reads of ``t``'s data to the host (``host_reads``),
    where ``t`` is not on the CPU: each waits for the device to finish the
    work queued before it."""
    if t.device.type != "cpu":
        count("host_reads", n)


def host_write(device, n: int = 1) -> None:
    """Count ``n`` blocking copies of host data to ``device``
    (``host_writes``), where ``device`` is not the CPU: ``torch.tensor(data,
    device=...)`` copies from pageable memory and then waits for the
    stream, as a read does."""
    if torch.device(device).type != "cpu":
        count("host_writes", n)


def snapshot() -> dict:
    """Each counter's total (int or float), the device values read now:
    call it after the traced stretch has synchronised."""
    out = {}
    for name, entries in COUNTERS.items():
        total = 0
        for v, most, of in entries:
            v = v.item() if isinstance(v, torch.Tensor) else v
            v = v if most is None else min(v, most)
            total += v if of is None else of - v
        out[name] = total
    return out


def reset() -> None:
    """Forget every count (tests; a tool tracing twice in one process)."""
    COUNTERS.clear()
