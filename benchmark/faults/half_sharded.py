"""half_sharded: the fault ``half`` (``faults/half.py``) planted under
every rank of a sharded step."""
import contextlib

from harness import ranks
from harness.spec import HERE, load_fault

KINDS = ("sharded_step",)


@contextlib.contextmanager
def planted():
    with load_fault("half", HERE).planted(), \
            ranks.everywhere("half_sharded"):
        yield
