"""The child processes of a run whose unit spans several devices: ranks
1..n-1 of a ``torch.distributed`` group whose rank 0 is the run's own
process.

A rank is a Python process running a kind's file as a script
(``kinds/<kind>.py``), started by :class:`Ranks`: it reads one JSON line
from its standard input (what it is to build and how it joins the group),
then one command a line (``step <seed>``, ``stop``) until ``stop`` or the
end of its input.  Its standard output goes to the run's standard error,
so that the run's last line of standard output stays its result.

Nothing outlives the run and nothing hangs it:

- rank 0 watches its ranks (a thread); a rank that ends before it is told
  to stop ends the run at once (``os._exit``): a rank blocked in a
  collective would otherwise wait for the group's timeout;
- each rank ends itself when rank 0's process is gone (a thread watching
  its parent) or its input closes;
- the ranks are stopped when their :class:`Ranks` is freed or the run's
  process exits.

A fault planted under rank 0 (``faults/<name>.py``) is planted under every
rank when its ``planted()`` runs inside :func:`everywhere`: the ranks
started inside it plant it too (:func:`planted_here`).
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import weakref

# the faults a rank plants (names under ``faults/``, comma-separated)
FAULTS = "POTA_BENCH_RANK_FAULTS"
POLL_S = 0.5
# how long stopped ranks may take to end before they are killed
STOP_S = 20.0


@contextlib.contextmanager
def everywhere(name: str):
    """While open, ranks started from this process plant the fault
    ``name`` too."""
    old = os.environ.get(FAULTS)
    os.environ[FAULTS] = ",".join(filter(None, [old, name]))
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(FAULTS, None)
        else:
            os.environ[FAULTS] = old


def planted_here(base: str) -> contextlib.ExitStack:
    """In a rank: the faults its environment names, planted (an open
    ``ExitStack``)."""
    from .spec import load_fault

    stack = contextlib.ExitStack()
    for name in filter(None, os.environ.get(FAULTS, "").split(",")):
        stack.enter_context(load_fault(name, base).planted())
    return stack


def free_port() -> int:
    """A TCP port of this host that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stop(procs: list, state: dict, wait_s: float, after=None) -> None:
    """Tell each rank to stop, give them ``wait_s`` seconds, then kill
    what is left; then ``after()``."""
    state["stopping"] = True
    for p in procs:
        with contextlib.suppress(OSError, ValueError):
            p.stdin.write("stop\n")
            p.stdin.flush()
            p.stdin.close()
    end = time.monotonic() + wait_s
    for p in procs:
        with contextlib.suppress(subprocess.TimeoutExpired):
            p.wait(max(end - time.monotonic(), 0.0))
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if after is not None:
        after()


def _die(code: int, message: str) -> None:
    print(message, file=sys.stderr, flush=True)
    os._exit(code)


def _watch(procs: list, state: dict, on_death) -> None:
    while not state["stopping"]:
        for r, p in enumerate(procs, 1):
            code = p.poll()
            if code is not None and not state["stopping"]:
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                on_death(r, code)
                return
        time.sleep(POLL_S)


def _stderr():
    """Where a rank's standard output goes: the run's standard error."""
    try:
        return sys.stderr.fileno()
    except (AttributeError, OSError, ValueError):
        return None


class Ranks:
    """Ranks 1..n-1, each ``python3 <script>`` handed ``start`` (a JSON
    object) plus its own ``rank``.  ``on_death(rank, code)`` runs when a
    rank ends unasked (default: the run ends, exit code 1); ``after_stop()``
    once the ranks have stopped."""

    def __init__(self, script: str, n: int, start: dict, on_death=None,
                 after_stop=None):
        self.procs = []
        self.state = {"stopping": False}
        for r in range(1, n):
            p = subprocess.Popen([sys.executable, script],
                                 stdin=subprocess.PIPE, stdout=_stderr(),
                                 text=True)
            p.stdin.write(json.dumps({**start, "rank": r}) + "\n")
            p.stdin.flush()
            self.procs.append(p)
        # the watcher and the finalizer hold the processes, not this object
        self._finalizer = weakref.finalize(self, _stop, self.procs,
                                           self.state, STOP_S, after_stop)
        on_death = on_death or (lambda r, code: _die(
            1, f"rank {r} ended with exit code {code} during the run"))
        threading.Thread(target=_watch, args=(self.procs, self.state,
                                              on_death), daemon=True).start()

    def send(self, line: str) -> None:
        """One command to every rank."""
        for p in self.procs:
            p.stdin.write(line + "\n")
            p.stdin.flush()

    def stop(self) -> None:
        """Stop the ranks (also when this object is freed)."""
        self._finalizer()


def watch_parent() -> None:
    """In a rank: end this process when the process that started it is
    gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(POLL_S)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
