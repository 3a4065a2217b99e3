"""rank_dropped: one rank's band left out of the merge: the program's
ordered sum of the row bands (``parallel/sharded.py::_rank_sum``) skips the
last rank's, on every rank."""
import contextlib
import importlib

from harness import ranks
from harness import world as wd

KINDS = ("sharded_step",)


@contextlib.contextmanager
def planted():
    sh = importlib.import_module(f"{wd.PROGRAM}.parallel.sharded")
    rank_sum = sh._rank_sum
    sh._rank_sum = lambda parts: rank_sum(parts[:-1])
    try:
        with ranks.everywhere("rank_dropped"):
            yield
    finally:
        sh._rank_sum = rank_sum
