"""Loading a committed lens fit (a frozen copy of the port's loader; the
fitting itself is not copied: the benchmark renders committed fits)."""
from __future__ import annotations

import os

import numpy as np

from .. import resolve_device
from .polynomial import LENS_CONSTANTS, PolyFunction, PolyLens

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG_DIR)), "data",
                        "lenses")


def _fit_path(directory: str, name: str, degree: int) -> str:
    return os.path.join(directory, f"{name}__deg{degree}.npz")


def poly_lens_from_numpy(pt: dict, ap: dict, constants: dict,
                         device=None) -> PolyLens:
    """Build the port's lens from numpy arrays.

    ``pt`` and ``ap`` each hold ``exponents`` [T, 5], ``coeffs`` [O, T],
    ``in_scale`` [5] and ``in_shift`` [5] (a JAX ``PolyFunction``'s fields as
    numpy); ``constants`` holds the scalar fields of :data:`LENS_CONSTANTS`
    plus optional ``name``, ``outer_chart`` and ``inner_chart``.  The lens
    is built on ``device`` (default: the card).
    """
    def mk(f):
        return PolyFunction(
            exponents=np.array(f["exponents"], np.int64),
            coeffs=np.array(f["coeffs"], np.float32),
            in_scale=np.array(f["in_scale"], np.float32),
            in_shift=np.array(f["in_shift"], np.float32),
        )

    extra = {k: constants[k] for k in ("name", "outer_chart", "inner_chart")
             if k in constants}
    lens = PolyLens(mk(pt), mk(ap),
                    **{k: float(constants[k]) for k in LENS_CONSTANTS},
                    **extra)
    return lens.to(resolve_device(device))


def load_poly_lens(name: str, degree: int = 5, path: str | None = None,
                   device=None) -> PolyLens | None:
    """Load a fit (the committed npz format) onto ``device`` (default: the
    card) from ``path``, by default ``data/lenses/<name>__deg<degree>.npz``,
    or None when the file does not exist."""
    device = resolve_device(device)
    path = path or _fit_path(LENS_DIR, name, degree)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        c = z["constants"]
        cond = {"in_scale": z["in_scale"], "in_shift": z["in_shift"]}
        constants = dict(zip(LENS_CONSTANTS, (float(v) for v in c)))
        constants["name"] = str(z["name"])
        # fits saved before the cylinder charts carry no charts: sphere
        if "charts" in z.files:
            constants["outer_chart"] = str(z["charts"][0])
            constants["inner_chart"] = str(z["charts"][1])
        return poly_lens_from_numpy(
            {"exponents": z["pt_exponents"], "coeffs": z["pt_coeffs"], **cond},
            {"exponents": z["ap_exponents"], "coeffs": z["ap_coeffs"], **cond},
            constants, device=device,
        )
