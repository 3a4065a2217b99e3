"""stale: the fit's folded tables kept from before the first descent: the
program's fold cache (``ops/po_kernels._fold_cache``) is pinned for the
lens at its first update, so later steps trace and splat with the first
step's tables, as a fold cache keyed on too little would.

No limit is held against it (``CAUGHT``): the fit traffic's 1e-9 descent
moves 119 of the 1,120 coefficients a step (the rest round back), which
flips a few splat decisions, so stale tables move the second step's loss
by 0.2-2.5% only, under the ``loss_gap`` limit that the control sets, and
leave the first step's numbers as they are.  ``calibrate.py --faults stale`` reads
it; on the CPU it changes nothing (the plain differentiable trace folds no
tables)."""
import contextlib
import importlib

from harness import world as wd

KINDS = ("step",)
CAUGHT = False


@contextlib.contextmanager
def planted():
    po = importlib.import_module(f"{wd.PROGRAM}.ops.po_kernels")
    fold_cache, descend = po._fold_cache, wd.descend
    pinned = {}

    def cache(lens):
        hit = pinned.get(id(lens))
        return fold_cache(lens) if hit is None else hit

    def pin_then_descend(w, step):
        if w.pkg == wd.PROGRAM and id(w.lens) not in pinned:
            pinned[id(w.lens)] = fold_cache(w.lens)
        descend(w, step)

    po._fold_cache, wd.descend = cache, pin_then_descend
    try:
        yield
    finally:
        po._fold_cache, wd.descend = fold_cache, descend
