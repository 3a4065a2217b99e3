"""A step of a lens fit: the differentiable frame, the L2 loss toward a
plate, ``loss.backward()``, the descent (:func:`harness.world.step`).

Set-up renders the plate with the committed fit, perturbs the fit by the
traffic's ``perturbation`` along a draw from the seed, and drives it
through :data:`SETUP_STEPS` steps by the window's own step; the window
continues from that state.  The check compares the first
:data:`REF_STEPS` of those steps, which the reference follows from the
same perturbation: the first step's rendered beauty by its relative L1
gap (``image_l1``, as a frame's ``rgba_l1``), each step's loss
(``loss_gap``), the first gradient's norm by the worst leaf (``grad_gap``)
and the norm of the coefficients' change over the first
:data:`CHANGE_STEPS` steps by the worst leaf (``change_gap``), each gap
against the reference's norm of that leaf or of the median leaf, whichever
is larger.
"""
from __future__ import annotations

import math

import torch

from harness import world as wd
from harness.check import norm_gap

SETUP_STEPS = 3
# a 4K step of the plain reference takes ~20 s: it follows two of three
REF_STEPS = 2
CHANGE_STEPS = 1


def make_noise(coeffs, seed: int, device) -> tuple:
    """The coefficients' perturbation draw, from the seed: one standard
    normal tensor per leaf, made on ``device``."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    return tuple(torch.randn(c.shape, generator=g, device=device,
                             dtype=torch.float32) for c in coeffs)


def fit_steps(w: wd.World, target, seed: int, noise: tuple, n: int,
              traffic: dict) -> dict:
    """Perturb ``w``'s fit by the benchmark's ``noise`` and drive it through
    its first ``n`` steps: the losses, the first step's beauty (on the
    host, so that it holds no device memory), the first gradient, the
    coefficients before and after every step (``cs``)."""
    wd.perturb(w, noise, traffic["perturbation"])
    out = {"losses": [], "c0": [c.detach().clone() for c in w.coeffs],
           "cs": []}
    for k in range(n):
        loss, img = wd.step(w, target, wd.unit_seed(seed, k),
                            traffic["descent_step"])
        out["losses"].append(float(loss))
        if k == 0:
            out["image"] = img.cpu()
            out["grad"] = [c.grad.detach().clone() for c in w.coeffs]
        out["cs"].append([c.detach().clone() for c in w.coeffs])
    return out


def setup(w: wd.World, traffic: dict, seed: int) -> tuple:
    """The plate and the first steps; (state, first window index)."""
    target = wd.plate(w, wd.unit_seed(seed, -1))
    noise = make_noise(w.coeffs, seed, w.m.device)
    got = fit_steps(w, target, seed, noise, SETUP_STEPS, traffic)
    got["noise"] = noise
    return {"got": got, "target": target, "traffic": traffic}, SETUP_STEPS


def unit(w: wd.World, state: dict, seed: int):
    """One step; its loss (a device scalar)."""
    return wd.step(w, state["target"], seed,
                   state["traffic"]["descent_step"])[0]


def done(state: dict, out, seed: int, index: int, keep: bool) -> bool:
    """A step whose loss is not finite failed."""
    return math.isfinite(float(out))


def reference(w: wd.World, traffic: dict, seed: int, got: dict) -> dict:
    """The reference's plate and first steps from the same perturbation."""
    target = wd.plate(w, wd.unit_seed(seed, -1))
    return fit_steps(w, target, seed, got["noise"], REF_STEPS, traffic)


def numbers(got: dict, ref: dict) -> dict:
    """``image_l1``, ``loss_gap``, ``grad_gap`` and ``change_gap`` of the
    program's first steps against the reference's."""
    g, r = got["image"], ref["image"]
    image_l1 = (float((g - r).abs().sum(dtype=torch.float64)
                      / r.abs().sum(dtype=torch.float64).clamp(min=1e-30))
                if bool(torch.isfinite(g).all()) else math.inf)
    n = len(ref["losses"])
    lg = [abs(a - b) / max(abs(b), 1e-300)
          for a, b in zip(got["losses"][:n], ref["losses"])]
    loss_gap = max(lg) if all(math.isfinite(v) for v in lg) else math.inf
    change = lambda d: [c.double() - c0.double() for c, c0 in
                        zip(d["cs"][CHANGE_STEPS - 1], d["c0"])]
    return {"image_l1": image_l1, "loss_gap": loss_gap,
            "grad_gap": norm_gap(got["grad"], ref["grad"]),
            "change_gap": norm_gap(change(got), change(ref))}
