"""Operations of the PO backward solve that K3 and K6 run per queue slot,
counted from what the fit's own terms need (not from the kernels' basis).

The solve (``lt_sample_aperture``) finds the sensor point and direction
(x, y, dx, dy) whose ray passes the aperture point and reaches the target,
by Newton iterations on six rows of the fit at the frame's wavelength: the
aperture polynomial's two (apx, apy) and the outer pupil's four (o0..o3).
With one wavelength a frame, terms that differ only in their wavelength
power fold into one monomial of (x, y, dx, dy), so the work is set by the
distinct monomials with a nonzero coefficient in each row.

Per iteration and slot this counts, as float32 operations (a fused
multiply-add is two):

- one multiply per monomial whose value some row or some partial needs;
- one multiply-add per nonzero (row, monomial) coefficient, for the rows'
  values;
- one multiply-add per nonzero (row, unknown, monomial) term of the 6 x 4
  Jacobian (the partial of a monomial of exponent e_v > 0 along v);
- 60 for the residual and the 4 x 4 elimination and back-substitution
  (46 + 14), nothing for the charts' conversions;

then the final evaluation of the four rows the splat reads (o0, o1, the
transmission, apx): a multiply per monomial they need and a multiply-add
per nonzero coefficient.  Everything else (the aperture draw, the pixel
map, the occlusion probe) is left out, so the count errs low.
"""
from __future__ import annotations

import numpy as np

NEWTON_ROWS = ("apx", "apy", "o0", "o1", "o2", "o3")
FINAL_ROWS = ("o0", "o1", "trans", "apx")
SOLVE_FLOPS = 60


def row_monomials(fit_path: str) -> dict:
    """Per row, the set of (a, b, c, d) monomials with a nonzero folded
    coefficient, from the fit's file."""
    with np.load(fit_path, allow_pickle=False) as z:
        parts = (("ap", ("apx", "apy")),
                 ("pt", ("o0", "o1", "o2", "o3", "trans")))
        rows = {}
        for poly, names in parts:
            exps = z[f"{poly}_exponents"][:, :4]
            coeffs = z[f"{poly}_coeffs"]
            for r, name in enumerate(names):
                rows[name] = {tuple(int(v) for v in e)
                              for e, c in zip(exps, coeffs[r]) if c != 0.0}
    return rows


def solve_flops(fit_path: str, iterations: int) -> float:
    """float32 operations of one slot's solve (see the module's text)."""
    rows = row_monomials(fit_path)
    need, fma = set(), 0
    for r in NEWTON_ROWS:
        need |= rows[r]
        fma += len(rows[r])
        for m in rows[r]:
            for v in range(4):
                if m[v] > 0:
                    fma += 1
                    need.add(tuple(e - (k == v) for k, e in enumerate(m)))
    per_iter = len(need) + 2 * fma + SOLVE_FLOPS
    final = set().union(*(rows[r] for r in FINAL_ROWS))
    final_fma = sum(len(rows[r]) for r in FINAL_ROWS)
    return float(iterations * per_iter + len(final) + 2 * final_fma)


def queue_slots(w) -> int:
    """Slots of the frame's splat queue on the world ``w``:
    ``splat_queue_mult`` a sample."""
    rc = w.rc
    return (w.cfg.splat_queue_mult * rc.xres_region * rc.yres_region
            * rc.spp)
