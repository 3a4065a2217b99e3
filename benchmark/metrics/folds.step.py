"""folds.step: misses of the lens's fold cache a step (the program's
``folds.*`` counters: the basis check, K1's, K3's and K1v's tables, the
unfold); a sound fit refolds after every descent, a stale cache folds
nothing."""
from harness.spans import per_unit


def read(rec):
    return per_unit(rec, "step", ("folds.",))
