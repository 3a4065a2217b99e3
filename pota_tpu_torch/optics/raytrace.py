"""Sequential lens-element ray tracer, the ground-truth optic (port of
:mod:`pota_tpu.optics.raytrace`).

The reference fits polynomials to a per-element trace whose code lives in
the sibling repo ``polynomial-optics`` and survives in-tree only as the
deprecated ray-traced camera (zpelgrims/pota
``src/deprecated/lentil_raytraced.cpp``).  This module traces batches of
rays through an element stack with a Python loop over the surfaces, in the
lens tensors' dtype (float32, as JAX's x64-off trace) on their device.

Conventions
-----------
*  Lens space: sensor plane at z = 0, +z toward the scene.  Rays are the
   5-D light field [x, y, dx, dy, lambda]: position mm on the sensor plane,
   direction as slopes (dz = 1 before normalizing), wavelength in um (the
   reference's chart, src/lentil.h:1252-1256).
*  Prescriptions are stored scene->sensor: rows of [radius, thickness, ior,
   abbe, housing_radius] (+ an optional cylinder flag).  ``radius`` is
   signed with the center of curvature toward the image for positive
   values; 0 means planar.  ``ior`` / ``abbe`` describe the medium behind
   the surface (toward the image); the aperture stop is a planar row with
   ior 1.
*  The trace runs the reverse direction (sensor -> scene), the direction
   the polynomial functions pt_evaluate / pt_sample_aperture model.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from . import geometry as geo

# Fraunhofer lines (um) used for the Abbe -> Cauchy conversion
_LAMBDA_D = 0.5876
_LAMBDA_F = 0.4861
_LAMBDA_C = 0.6563


@dataclasses.dataclass(frozen=True)
class LensSystem:
    """Preprocessed element stack in sensor->scene order.

    Tensors (all [K], K = number of surfaces, ordered rear -> front):
      vertex_z:    surface vertex position (mm, sensor at z = 0)
      radius:      signed curvature radius in the reversed frame (center
                   at vertex_z + radius); 0 => planar
      housing:     housing (clear semi-aperture) radius
      cauchy_a/b:  Cauchy coefficients of the media before (``_in``) and
                   after (``_out``) crossing the surface in sensor->scene
                   travel
      is_aperture: 1.0 at the iris plane
    Plus python metadata: the constants of the reference's lens headers,
    the pupil charts ("sphere" / "cyl-x" / "cyl-y"), the iris row
    ``aperture_index`` and the per-surface cylinder flags ``cyl_axes`` (0
    sphere or plane, 1 curvature in x, 2 curvature in y; empty when all
    are spherical), which the trace branches on per surface."""

    vertex_z: torch.Tensor
    radius: torch.Tensor
    housing: torch.Tensor
    cauchy_a_in: torch.Tensor
    cauchy_b_in: torch.Tensor
    cauchy_a_out: torch.Tensor
    cauchy_b_out: torch.Tensor
    is_aperture: torch.Tensor
    lens_length: float          # front vertex - rear vertex (mm)
    back_focal_length: float    # rear vertex z (sensor at focus for inf)
    efl: float                  # effective focal length (mm)
    aperture_z: float           # z of the iris plane
    aperture_housing_radius: float
    inner_pupil_radius: float   # housing of the rear surface
    outer_pupil_radius: float   # housing of the front surface
    inner_pupil_curvature_radius: float
    outer_pupil_curvature_radius: float
    fov: float                  # full field of view (radians), efl + sensor
    aperture_index: int = -1
    name: str = "unnamed"
    outer_chart: str = "sphere"
    inner_chart: str = "sphere"
    cyl_axes: tuple = ()

    ARRAY_FIELDS = (
        "vertex_z", "radius", "housing", "cauchy_a_in", "cauchy_b_in",
        "cauchy_a_out", "cauchy_b_out", "is_aperture",
    )

    @property
    def device(self) -> torch.device:
        return self.vertex_z.device

    def to(self, device=None, dtype=None) -> "LensSystem":
        """A copy with the tensors on ``device`` and/or in ``dtype``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device=device, dtype=dtype)
            for f in self.ARRAY_FIELDS})


def _cauchy_from_nd_abbe(nd: float, abbe: float):
    """Convert (n_d, V_d) to Cauchy A + B / lambda^2 (lambda in um)."""
    if nd <= 1.0 + 1e-6:
        return 1.0, 0.0
    if abbe <= 0.0:
        return nd, 0.0
    b = (nd - 1.0) / (abbe * (1.0 / _LAMBDA_F**2 - 1.0 / _LAMBDA_C**2))
    a = nd - b / _LAMBDA_D**2
    return a, b


def _paraxial_bfl_efl(rows: np.ndarray) -> tuple[float, float]:
    """Paraxial BFL and EFL of a scene->sensor prescription (numpy float64):
    a y-u trace of a parallel marginal ray at the d-line."""
    y = 1.0
    u = 0.0
    n = 1.0
    for i, row in enumerate(rows):
        radius, thickness, ior = row[0], row[1], row[2]
        cyl = int(row[5]) if len(row) > 5 else 0
        n2 = ior if ior > 0 else 1.0
        # cylinder surfaces with curvature in x are flat in the y-z paraxial
        # plane this trace runs in (anamorphic attachments are near-afocal
        # in x, so the y-plane focus places the sensor for both axes)
        if radius != 0.0 and cyl != 1:
            power = (n2 - n) / radius
            u = (n * u - y * power) / n2
        n = n2
        if i < len(rows) - 1:
            y = y + u * thickness
    bfl = -y / u if u != 0 else np.inf
    efl = -1.0 / u if u != 0 else np.inf
    return float(bfl), float(efl)


def build_lens_system(rows, name: str = "unnamed",
                      sensor_width: float = 36.0,
                      outer_chart: str = "sphere",
                      inner_chart: str = "sphere",
                      device=None) -> LensSystem:
    """Preprocess a scene->sensor prescription into a :class:`LensSystem`
    of float32 tensors on ``device`` (default: the card).

    ``rows``: [radius, thickness, ior, abbe, housing_radius] (+ an optional
    6th column: cylinder flag, 0 sphere, 1 curvature in x / axis along y, 2
    curvature in y), scene->sensor; the thickness of the last row is
    ignored (the sensor sits at the paraxial focus, BFL behind the rear
    vertex).  The aperture stop is the row with radius 0 and ior 1.  The
    preprocessing is numpy float64, as in JAX."""
    device = resolve_device(device)
    rows = np.asarray(rows, np.float64)
    if rows.shape[1] > 5:
        cyl_std = rows[:, 5].astype(int)
    else:
        cyl_std = np.zeros(len(rows), int)
    n_surf = len(rows)
    bfl, efl = _paraxial_bfl_efl(rows)
    if not (np.isfinite(bfl) and bfl > 0):
        raise ValueError(f"{name}: bad BFL {bfl}")

    # vertex positions scene->sensor in the standard frame, front at 0
    z_std = np.concatenate([[0.0], np.cumsum(rows[:-1, 1])])
    lens_length = float(z_std[-1] - z_std[0])
    # reversed frame: sensor at 0, +z toward the scene, rear vertex at bfl
    vertex_z = bfl + (z_std[-1] - z_std)
    order = np.arange(n_surf)[::-1]                # rear -> front
    vertex_z = vertex_z[order]
    radius_rev = -rows[order, 0]                   # sign flip when reversed

    # crossing std-surface i sensor->scene goes from the medium behind it
    # (medium(i)) to the one in front (medium(i-1); air for i = 0)
    cauchy = np.array([_cauchy_from_nd_abbe(r[2], r[3]) for r in rows])
    a_behind = np.concatenate([cauchy[:, 0], [1.0]])
    b_behind = np.concatenate([cauchy[:, 1], [0.0]])
    a_in = np.array([a_behind[i] for i in range(n_surf)])
    b_in = np.array([b_behind[i] for i in range(n_surf)])
    a_out = np.array([a_behind[i - 1] if i > 0 else 1.0
                      for i in range(n_surf)])
    b_out = np.array([b_behind[i - 1] if i > 0 else 0.0
                      for i in range(n_surf)])
    a_in, b_in, a_out, b_out = (
        a_in[order], b_in[order], a_out[order], b_out[order])

    is_ap = ((rows[:, 0] == 0.0) & (np.abs(rows[:, 2] - 1.0) < 1e-9))[order]
    if not is_ap.any():
        raise ValueError(f"{name}: prescription has no aperture row")
    ap_idx_rev = int(np.argmax(is_ap))

    fov = 2.0 * np.arctan((sensor_width * 0.5) / efl)

    # cylindrical front / rear surfaces force the matching pupil chart (the
    # reference's per-lens lens_outer/inner_pupil_geometry dispatch):
    # curvature in x = cylinder axis along y = "cyl-y"
    cyl_rev = tuple(int(v) for v in cyl_std[order])
    chart_of = {0: "sphere", 1: "cyl-y", 2: "cyl-x"}
    if outer_chart == "sphere" and cyl_rev[-1]:
        outer_chart = chart_of[cyl_rev[-1]]
    if inner_chart == "sphere" and cyl_rev[0]:
        inner_chart = chart_of[cyl_rev[0]]
    if not any(cyl_rev):
        cyl_rev = ()

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    housing = rows[order, 4]
    return LensSystem(
        vertex_z=t(vertex_z), radius=t(radius_rev), housing=t(housing),
        cauchy_a_in=t(a_in), cauchy_b_in=t(b_in),
        cauchy_a_out=t(a_out), cauchy_b_out=t(b_out),
        is_aperture=t(is_ap),
        lens_length=lens_length,
        back_focal_length=float(bfl),
        efl=float(efl),
        aperture_z=float(vertex_z[ap_idx_rev]),
        aperture_housing_radius=float(housing[ap_idx_rev]),
        inner_pupil_radius=float(housing[0]),
        outer_pupil_radius=float(housing[-1]),
        inner_pupil_curvature_radius=float(-radius_rev[0]),
        outer_pupil_curvature_radius=float(-radius_rev[-1]),
        fov=float(fov),
        aperture_index=ap_idx_rev,
        name=name,
        outer_chart=outer_chart,
        inner_chart=inner_chart,
        cyl_axes=cyl_rev,
    )


# ---------------------------------------------------------------- tracing ----


def _ior(a, b, lam):
    return a + b / (lam * lam)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, -1, keepdim=True))


def _intersect_surface(pos, direction, vertex_z, radius, cyl: int = 0):
    """Intersect rays with a spherical, cylindrical or planar surface.

    ``vertex_z`` and ``radius`` are 0-d tensors; ``cyl`` (python int): 0
    sphere, 1 cylinder with curvature in x (axis along y, the
    horizontal-squeeze anamorphic element), 2 curvature in y.  Picks the
    root on the vertex side: the hit whose z offset from the center has the
    sign of (vertex - center) = -radius.  Both the planar and the curved
    branch stay finite (the curved normal divides by a radius floored away
    from 0), so a gradient through the select takes no NaN.
    Returns (t, hit, normal, ok), the normal oriented against the ray."""
    planar = radius == 0.0
    t_plane = (vertex_z - pos[..., 2]) / direction[..., 2]

    center_z = vertex_z + radius
    zero = torch.zeros_like(pos[..., 0])
    if cyl == 0:
        center = torch.stack(
            [zero, zero, torch.broadcast_to(center_z, zero.shape)], -1)
        oc = pos - center
        a = torch.ones_like(zero)
        b = torch.sum(oc * direction, -1)
        c = torch.sum(oc * oc, -1) - radius * radius
    else:
        # a 2-D circle in the curved plane; the axis coordinate free-rides
        u = pos[..., 0] if cyl == 1 else pos[..., 1]
        du = direction[..., 0] if cyl == 1 else direction[..., 1]
        w = pos[..., 2] - center_z
        dw = direction[..., 2]
        a = du * du + dw * dw
        b = u * du + w * dw
        c = u * u + w * w - radius * radius
    a_safe = torch.where(torch.abs(a) < 1e-12, 1e-12, a)
    disc = b * b - a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / a_safe
    t1 = (-b + sq) / a_safe
    # hit z relative to the center must have the sign of -radius
    z0 = pos[..., 2] + t0 * direction[..., 2] - center_z
    pick0 = torch.sign(z0) == torch.sign(-radius)
    t_curved = torch.where(pick0, t0, t1)
    t = torch.where(planar, t_plane, t_curved)
    ok = torch.where(planar, t_plane > 0, ok & (t_curved > 0))

    hit = pos + t[..., None] * direction
    r_safe = torch.where(planar, 1.0, radius)
    if cyl == 0:
        n_curved = (hit - center) / r_safe
    elif cyl == 1:
        n_curved = torch.stack(
            [hit[..., 0] / r_safe, zero, (hit[..., 2] - center_z) / r_safe],
            -1)
    else:
        n_curved = torch.stack(
            [zero, hit[..., 1] / r_safe, (hit[..., 2] - center_z) / r_safe],
            -1)
    n_plane = torch.tensor([0.0, 0.0, -1.0], dtype=hit.dtype,
                           device=hit.device).expand(hit.shape)
    normal = torch.where(planar, n_plane, n_curved)
    # orient the normal against the direction of travel
    flip = torch.sum(normal * direction, -1, keepdim=True) > 0
    normal = torch.where(flip, -normal, normal)
    return t, hit, normal, ok


def _refract(direction, normal, eta):
    """Snell refraction (vector form); returns (new_dir, total internal
    reflection)."""
    cos_i = -torch.sum(direction * normal, -1)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    refr = eta[..., None] * direction + (eta * cos_i - cos_t)[..., None] * normal
    refr = refr / torch.clamp(_norm(refr), min=1e-12)
    return refr, tir


def _fresnel_unpolarized(cos_i, cos_t, n1, n2):
    rs = (n1 * cos_i - n2 * cos_t) / torch.clamp(n1 * cos_i + n2 * cos_t,
                                                 min=1e-12)
    rp = (n1 * cos_t - n2 * cos_i) / torch.clamp(n1 * cos_t + n2 * cos_i,
                                                 min=1e-12)
    return 1.0 - 0.5 * (rs * rs + rp * rp)


def trace_sensor_to_scene(lens: LensSystem, sensor_lf, aperture_radius=None):
    """Trace 5-D sensor light-field rays through the element stack.

    Args:
      sensor_lf: [..., 5] = [x, y, dx, dy, lambda_um] at the (unshifted)
        sensor plane z = 0, on the lens's device.
      aperture_radius: iris radius (mm); default the housing radius (wide
        open).

    Returns a dict: ``out_pos``, ``out_dir`` [..., 3] (the exit ray at the
    front surface, lens space), ``transmittance`` [...] (Fresnel product, 0
    where clipped, totally reflected or missed), ``aperture_xy`` [..., 2]
    (the hit on the iris plane) and ``valid`` [...] bool."""
    x, y, dx, dy, lam = (sensor_lf[..., i] for i in range(5))
    pos = torch.stack([x, y, torch.zeros_like(x)], -1)
    direction = torch.stack([dx, dy, torch.ones_like(dx)], -1)
    direction = direction / _norm(direction)

    ap_r = (lens.aperture_housing_radius if aperture_radius is None
            else aperture_radius)

    trans = torch.ones_like(x)
    valid = torch.ones_like(x, dtype=torch.bool)
    ap_xy = torch.zeros_like(pos[..., :2])

    for k in range(lens.vertex_z.shape[0]):
        cyl = lens.cyl_axes[k] if lens.cyl_axes else 0
        t, hit, normal, ok = _intersect_surface(
            pos, direction, lens.vertex_z[k], lens.radius[k], cyl)
        r2 = hit[..., 0] ** 2 + hit[..., 1] ** 2
        inside = r2 <= lens.housing[k] ** 2
        if k == lens.aperture_index:
            ap_xy = hit[..., :2]
            inside = r2 <= ap_r ** 2
            new_dir = direction
            f = torch.ones_like(x)
        else:
            n1 = _ior(lens.cauchy_a_in[k], lens.cauchy_b_in[k], lam)
            n2 = _ior(lens.cauchy_a_out[k], lens.cauchy_b_out[k], lam)
            eta = n1 / n2
            cos_i = -torch.sum(direction * normal, -1)
            new_dir, tir = _refract(direction, normal, eta)
            cos_t = -torch.sum(new_dir * normal, -1)
            f = _fresnel_unpolarized(cos_i, torch.abs(cos_t), n1, n2)
            ok = ok & ~tir
        valid = valid & ok & inside
        trans = trans * torch.where(valid, f, 0.0)
        pos = hit
        direction = new_dir

    return {
        "out_pos": pos,
        "out_dir": direction,
        "transmittance": torch.where(valid, trans, 0.0),
        "aperture_xy": ap_xy,
        "valid": valid,
    }


def trace_to_chart(lens: LensSystem, sensor_lf, aperture_radius=None):
    """Trace and return the exit ray in the outer-pupil chart: the
    reference's pt_evaluate output (src/lentil.h:1252-1266, sphereToCs /
    cylinderToCs at :387-389), [x, y, dx, dy] on the sphere (or cylinder,
    ``lens.outer_chart``) of radius ``outer_pupil_curvature_radius`` with
    its vertex at the front surface.

    Returns (chart [..., 4], transmittance [...], aperture_xy [..., 2],
    valid [...])."""
    res = trace_sensor_to_scene(lens, sensor_lf, aperture_radius)
    pos = res["out_pos"] - torch.stack(
        [torch.zeros_like(lens.vertex_z[-1]), torch.zeros_like(
            lens.vertex_z[-1]), lens.vertex_z[-1]])
    R = lens.outer_pupil_curvature_radius
    d = res["out_dir"]
    if lens.outer_chart != "sphere":
        # a cylinder chart parametrizes points on the cylinder of radius R
        # (axis at z = -R): slide the exit ray onto it first (the chart
        # stores a ray line, so sliding along the ray is exact)
        cyl_y = lens.outer_chart == "cyl-y"
        u = pos[..., 0] if cyl_y else pos[..., 1]
        du = d[..., 0] if cyl_y else d[..., 1]
        w = pos[..., 2] + R
        dw = d[..., 2]
        a = du * du + dw * dw
        b = u * du + w * dw
        c = u * u + w * w - R * R
        sq = torch.sqrt(torch.clamp(b * b - a * c, min=0.0))
        a_safe = torch.where(torch.abs(a) < 1e-12, 1e-12, a)
        t0 = (-b - sq) / a_safe
        t1 = (-b + sq) / a_safe
        # the nearest intersection along the ray (smallest |t|)
        t = torch.where(torch.abs(t0) <= torch.abs(t1), t0, t1)
        pos = pos + t[..., None] * d
    pos2, dir2 = geo.cs_to_chart(pos, d, -R, R, lens.outer_chart)
    out = torch.cat([pos2, dir2], -1)
    return out, res["transmittance"], res["aperture_xy"], res["valid"]
