"""A frame: ``render_frame`` under ``no_grad``, then ``resolve_aovs``
(:func:`harness.world.frame`), one after another, each with a new sample
seed.

Set-up renders :data:`WARMUP` frames on seeds no window frame has.  The
check compares one frame of the window, drawn from the seed: the resolved
beauty by its relative L1 gap (``rgba_l1``) and the closest-depth AOV
planes by the share of pixels where any of them differs by more than
:data:`AOV_TOL` of the plane's scale (``aov_off``).
"""
from __future__ import annotations

import math

import torch

from harness import world as wd

WARMUP = 2
AOV_TOL = 1e-3


def setup(w: wd.World, traffic: dict, seed: int) -> tuple:
    """Warm every shape the window uses; (state, first window index)."""
    for i in range(WARMUP):
        wd.frame(w, wd.unit_seed(seed, -2 - i))
    return {"got": {}}, 0


def unit(w: wd.World, state: dict, seed: int):
    """One frame's resolved planes (not yet synchronised)."""
    return wd.frame(w, seed)


def done(state: dict, out, seed: int, index: int, keep: bool) -> bool:
    """Keep the frame for the check where the draw picked it."""
    if keep:
        state["got"] = {"planes": out, "seed": seed, "index": index}
    return True


def reference(w: wd.World, traffic: dict, seed: int, got: dict) -> dict:
    """The frame of the same sample seed."""
    return {"planes": wd.frame(w, got["seed"])}


def _finite(t) -> bool:
    return bool(torch.isfinite(t).all())


def numbers(got: dict, ref: dict) -> dict:
    """``rgba_l1`` and ``aov_off`` of the program's resolved planes
    against the reference's (dicts of [H, W, 4] under ``planes``)."""
    got, ref = got["planes"], ref["planes"]
    if not all(_finite(v) for v in got.values()):
        return {"rgba_l1": math.inf, "aov_off": math.inf}
    g, r = got["RGBA"].double(), ref["RGBA"].double()
    rgba = float((g - r).abs().sum() / r.abs().sum().clamp(min=1e-30))
    off = None
    for name, rv in ref.items():
        if name == "RGBA":
            continue
        rv = rv.double()
        scale = max(float(rv.abs().max()), 1.0)
        bad = ((got[name].double() - rv).abs().amax(-1) > AOV_TOL * scale)
        off = bad if off is None else off | bad
    share = 0.0 if off is None else float(off.double().mean())
    return {"rgba_l1": rgba, "aov_off": share}
