"""A configuration built into one side's objects, and the units of work.

The program (``pota_tpu_torch``) and the reference (the frozen plain copy
under ``benchmark/reference/``) have the same module layout, so one builder
serves both: :func:`build` imports the side's own modules by name and
builds its own configuration classes, scene, fit, camera state and camera
matrices from the configuration file.  What the benchmark makes itself (the
seeds, the coefficients' perturbation) it hands to both sides alike.
"""
from __future__ import annotations

import dataclasses
import importlib
import os

import torch

from .spec import ROOT
from .trace import BACKWARD

PROGRAM = "pota_tpu_torch"
REFERENCE = "reference"
MASK32 = 0xFFFFFFFF


def unit_seed(seed: int, index: int) -> int:
    """The sample seed of frame or step ``index`` of a run seeded ``seed``
    (a 32-bit word; the plate takes index -1)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (index + 2) * 0xBF58476D1CE4E5B9)
    x &= (1 << 64) - 1
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (x ^ (x >> 29)) & MASK32


@dataclasses.dataclass
class World:
    """One side's objects for a configuration and a traffic mix."""
    pkg: str
    cfg: object
    rc: object
    scene: object
    lens: object
    state: object
    m: torch.Tensor
    m_end: torch.Tensor | None
    renderer: object
    splat: object
    ops: object = None
    fit: str = ""          # the fit's file, for the roofline counts

    @property
    def coeffs(self):
        return (self.lens.pt.coeffs, self.lens.ap.coeffs)


def lens_path(config: dict) -> str:
    lens = config["lens"]
    return os.path.join(ROOT, "data", "lenses",
                        f"{lens['name']}__deg{lens['degree']}.npz")


def build(pkg: str, config: dict, traffic: dict, device, ops=None) -> World:
    """``pkg``'s objects for ``config`` under ``traffic`` on ``device``:
    the camera and render settings, the scene, the committed fit, the PO
    camera state set up on the unperturbed fit, the camera matrix and,
    where the traffic trucks the camera, the shutter's end matrix."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    cfgmod = mod("config")
    renderer = mod("render.renderer")
    cam = dict(config["camera"])
    cam["camera_type"] = cfgmod.CameraType[cam["camera_type"]]
    cfg = cfgmod.CameraConfig(**cam)
    rc = cfgmod.RenderConfig(**config["render"])
    sc = config["scene"]
    scene = getattr(mod("render.scene"), sc["name"])(**sc["args"],
                                                     device=device)
    lens = mod("optics.fit").load_poly_lens(
        config["lens"]["name"], config["lens"]["degree"],
        path=lens_path(config), device=device)
    state = mod("optics.focus").setup_po_camera(lens, cfg, scene=scene)
    eye, target = config["camera_pose"]
    m = renderer.look_at(eye, target, device=device)
    truck = float(traffic.get("truck", 0.0))
    m_end = None
    if truck:
        m_end = renderer.look_at([eye[0] + truck, *eye[1:]],
                                 [target[0] + truck, *target[1:]],
                                 device=device)
    return World(pkg, cfg, rc, scene, lens, state, m, m_end, renderer,
                 mod("render.splat"), ops, fit=lens_path(config))


def frame(w: World, seed: int) -> dict:
    """One frame: ``render_frame`` under ``no_grad``, then
    ``resolve_aovs``; the resolved planes."""
    with torch.no_grad():
        _, fb = w.renderer.render_frame(
            w.cfg, w.rc, w.scene, w.m, seed=seed, po_lens=w.lens,
            po_state=w.state, cam_to_world_end=w.m_end, ops=w.ops)
        return w.splat.resolve_aovs(w.rc, fb)


def plate(w: World, seed: int) -> torch.Tensor:
    """The fit's target: the resolved beauty of a frame."""
    with torch.no_grad():
        img, _ = w.renderer.render_frame(
            w.cfg, w.rc, w.scene, w.m, seed=seed, po_lens=w.lens,
            po_state=w.state, cam_to_world_end=w.m_end, ops=w.ops)
    return img


def perturb(w: World, noise: tuple, scale: float) -> None:
    """Move the fit's coefficients by ``scale`` of their own size along
    ``noise`` (the benchmark's draw, one tensor per leaf), then let them
    carry gradients."""
    with torch.no_grad():
        for c, z in zip(w.coeffs, noise):
            c.mul_(1.0 + scale * z.to(c.device, c.dtype))
    for c in w.coeffs:
        c.requires_grad_(True)


def descend(w: World, step: float) -> None:
    """Move ``w``'s fit coefficients ``step`` of their joint norm along
    minus their joint gradient (the fit's optimizer; no host read)."""
    coeffs = w.coeffs
    with torch.no_grad():
        gn = torch.sqrt(sum((c.grad.double() ** 2).sum() for c in coeffs))
        cn = torch.sqrt(sum((c.double() ** 2).sum() for c in coeffs))
        for c in coeffs:
            c.sub_((c.grad.double() * (step * cn / gn)).float())


def step(w: World, target: torch.Tensor, seed: int, descent: float):
    """One step of the lens fit: the differentiable frame, JAX's
    ``train_step_sharded`` L2 loss toward ``target``, ``loss.backward()``
    into the coefficients' ``grad``, the descent.  Returns the loss
    (a device scalar) and the rendered beauty the loss read."""
    for c in w.coeffs:
        c.grad = None
    img, _ = w.renderer.render_frame(
        w.cfg, w.rc, w.scene, w.m, seed=seed, po_lens=w.lens,
        po_state=w.state, cam_to_world_end=w.m_end, differentiable=True,
        ops=w.ops)
    loss = ((img - target) ** 2).mean()
    with torch.profiler.record_function(BACKWARD):
        loss.backward()
    descend(w, descent)
    return loss.detach(), img.detach()
