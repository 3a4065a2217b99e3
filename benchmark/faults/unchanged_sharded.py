"""unchanged_sharded: the fault ``unchanged`` (``faults/unchanged.py``:
no descent) planted under every rank of a sharded step."""
import contextlib

from harness import ranks
from harness.spec import HERE, load_fault

KINDS = ("sharded_step",)


@contextlib.contextmanager
def planted():
    with load_fault("unchanged", HERE).planted(), \
            ranks.everywhere("unchanged_sharded"):
        yield
