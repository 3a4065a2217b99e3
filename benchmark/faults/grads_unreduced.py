"""grads_unreduced: each rank descends on its own share's gradient: the
program's sum all-reduces of the gradients (``parallel/sharded.py::
_all_reduce`` of a tensor with a dimension; the loss, a scalar, is still
summed) left out, on every rank."""
import contextlib
import importlib

import torch.distributed as dist

from harness import ranks
from harness import world as wd

KINDS = ("sharded_step",)


@contextlib.contextmanager
def planted():
    sh = importlib.import_module(f"{wd.PROGRAM}.parallel.sharded")
    all_reduce = sh._all_reduce

    def some(x, mesh, op=dist.ReduceOp.SUM):
        if op == dist.ReduceOp.SUM and x.dim() > 0:
            return None
        return all_reduce(x, mesh, op)

    sh._all_reduce = some
    try:
        with ranks.everywhere("grads_unreduced"):
            yield
    finally:
        sh._all_reduce = all_reduce
