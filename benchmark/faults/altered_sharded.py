"""altered_sharded: the fault ``altered`` (``faults/altered.py``) planted under
every rank of a sharded step."""
import contextlib

from harness import ranks
from harness.spec import HERE, load_fault

KINDS = ("sharded_step",)


@contextlib.contextmanager
def planted():
    with load_fault("altered", HERE).planted(), \
            ranks.everywhere("altered_sharded"):
        yield
