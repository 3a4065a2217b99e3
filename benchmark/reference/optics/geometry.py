"""Pupil chart transforms (port of :mod:`pota_tpu.optics.geometry`): rays
crossing a pupil are stored as ``[x, y, dx, dy]`` on a plane, sphere or
cylinder chart (ref ``src/lens.h:75-221``).  Lens-space mm; inputs are
batched ``(..., 2)`` / ``(..., 3)``."""
from __future__ import annotations

import torch


def safe_sqrt(x, eps=1e-20):
    """sqrt that is exactly 0 (value and tangent) at and below ``eps``."""
    return torch.where(x > eps, torch.sqrt(torch.clamp(x, min=eps)), 0.0)


def _normalize(v, eps=1e-12):
    n2 = torch.sum(v * v, -1, keepdim=True)
    return v / torch.sqrt(torch.clamp(n2, min=eps * eps))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def plane_to_cs(pos2, dir2, plane_z):
    """Two-plane chart -> 3D ray; ``dir2`` is the slope (dz = 1 before
    normalizing)."""
    z = torch.as_tensor(plane_z, dtype=pos2.dtype, device=pos2.device)
    outpos = torch.stack(
        [pos2[..., 0], pos2[..., 1], torch.broadcast_to(z, pos2[..., 0].shape)],
        -1)
    outdir = torch.stack(
        [dir2[..., 0], dir2[..., 1], torch.ones_like(dir2[..., 0])], -1)
    return outpos, _normalize(outdir)


def cs_to_plane(pos3, dir3, plane_z):
    """3D ray -> two-plane chart at ``z = plane_z`` (ref src/lens.h:87-97)."""
    t = (plane_z - pos3[..., 2]) / dir3[..., 2]
    out_x = pos3[..., 0] + t * dir3[..., 0]
    out_y = pos3[..., 1] + t * dir3[..., 1]
    abs_dz = torch.abs(dir3[..., 2])
    return (torch.stack([out_x, out_y], -1),
            torch.stack([dir3[..., 0] / abs_dz, dir3[..., 1] / abs_dz], -1))


def _sphere_tangent_frame(normal):
    """Tangent and bitangent of a pupil-sphere normal (ref
    src/lens.h:113-116)."""
    ex = _normalize(torch.stack(
        [normal[..., 2], torch.zeros_like(normal[..., 2]), -normal[..., 0]],
        -1))
    return ex, _cross(normal, ex)


def sphere_to_cs(pos2, dir2, center, sphere_rad):
    """Sphere chart -> 3D ray (ref src/lens.h:99-125)."""
    r2 = pos2[..., 0] ** 2 + pos2[..., 1] ** 2
    nz = safe_sqrt(sphere_rad ** 2 - r2) / abs(sphere_rad)
    normal = torch.stack(
        [pos2[..., 0] / sphere_rad, pos2[..., 1] / sphere_rad, nz], -1)
    d2 = dir2[..., 0] ** 2 + dir2[..., 1] ** 2
    tz = safe_sqrt(1.0 - d2)
    temp = torch.stack([dir2[..., 0], dir2[..., 1], tz], -1)
    ex, ey = _sphere_tangent_frame(normal)
    outdir = (temp[..., 0:1] * ex + temp[..., 1:2] * ey
              + temp[..., 2:3] * normal)
    outpos = torch.stack(
        [pos2[..., 0], pos2[..., 1], normal[..., 2] * sphere_rad + center],
        -1)
    return outpos, outdir


def cylinder_to_cs(pos2, dir2, center, radius, cyl_y: bool):
    """Cylinder chart -> 3D ray (ref src/lens.h:188-221)."""
    zeros = torch.zeros_like(pos2[..., 0])
    if cyl_y:
        nz = safe_sqrt(radius ** 2 - pos2[..., 0] ** 2) / abs(radius)
        normal = torch.stack([pos2[..., 0] / radius, zeros, nz], -1)
    else:
        nz = safe_sqrt(radius ** 2 - pos2[..., 1] ** 2) / abs(radius)
        normal = torch.stack([zeros, pos2[..., 1] / radius, nz], -1)
    d2 = dir2[..., 0] ** 2 + dir2[..., 1] ** 2
    tz = safe_sqrt(1.0 - d2)
    temp = torch.stack([dir2[..., 0], dir2[..., 1], tz], -1)
    ex = _normalize(torch.stack([normal[..., 2], zeros, -normal[..., 0]], -1))
    ey = _normalize(_cross(normal, ex))
    outdir = (temp[..., 0:1] * ex + temp[..., 1:2] * ey
              + temp[..., 2:3] * normal)
    outpos = torch.stack(
        [pos2[..., 0], pos2[..., 1], normal[..., 2] * radius + center], -1)
    return outpos, outdir


def cs_to_sphere(pos3, dir3, center, sphere_rad):
    """3D ray -> sphere chart (ref src/lens.h:127-153); ``pos3`` lies on the
    sphere."""
    normal = torch.stack(
        [pos3[..., 0] / sphere_rad, pos3[..., 1] / sphere_rad,
         torch.abs((pos3[..., 2] - center) / sphere_rad)], -1)
    temp = _normalize(dir3)
    ex, ey = _sphere_tangent_frame(normal)
    return (torch.stack([pos3[..., 0], pos3[..., 1]], -1),
            torch.stack([torch.sum(temp * ex, -1),
                         torch.sum(temp * ey, -1)], -1))


def cs_to_cylinder(pos3, dir3, center, radius, cyl_y: bool):
    """3D ray -> cylinder chart (ref src/lens.h:156-185).  The tangent ``ex``
    is normalized (the reference leaves it unnormalized, src/lens.h:171), as
    in JAX, so the chart round-trips with :func:`cylinder_to_cs`."""
    zeros = torch.zeros_like(pos3[..., 0])
    nz = torch.abs((pos3[..., 2] - center) / radius)
    if cyl_y:
        normal = torch.stack([pos3[..., 0] / radius, zeros, nz], -1)
    else:
        normal = torch.stack([zeros, pos3[..., 1] / radius, nz], -1)
    temp = _normalize(dir3)
    ex = _normalize(torch.stack([normal[..., 2], zeros, -normal[..., 0]], -1))
    ey = _normalize(_cross(normal, ex))
    return (torch.stack([pos3[..., 0], pos3[..., 1]], -1),
            torch.stack([torch.sum(temp * ex, -1),
                         torch.sum(temp * ey, -1)], -1))


CHARTS = ("sphere", "cyl-x", "cyl-y")


def chart_to_cs(pos2, dir2, center, radius, chart: str = "sphere"):
    """Pupil chart -> 3D ray, dispatched by the lens's pupil geometry."""
    if chart == "sphere":
        return sphere_to_cs(pos2, dir2, center, radius)
    if chart == "cyl-x":
        return cylinder_to_cs(pos2, dir2, center, radius, cyl_y=False)
    if chart == "cyl-y":
        return cylinder_to_cs(pos2, dir2, center, radius, cyl_y=True)
    raise ValueError(f"unknown pupil chart {chart!r}")


def cs_to_chart(pos3, dir3, center, radius, chart: str = "sphere"):
    """3D ray -> pupil chart (the inverse of :func:`chart_to_cs`)."""
    if chart == "sphere":
        return cs_to_sphere(pos3, dir3, center, radius)
    if chart == "cyl-x":
        return cs_to_cylinder(pos3, dir3, center, radius, cyl_y=False)
    if chart == "cyl-y":
        return cs_to_cylinder(pos3, dir3, center, radius, cyl_y=True)
    raise ValueError(f"unknown pupil chart {chart!r}")


def line_plane_intersection_y0(origin, direction):
    """Intersection of a ray with the plane y = 0 (ref src/lens.h:412-419)."""
    d = _normalize(direction)
    plane_n = torch.tensor([0.0, 1.0, 0.0], device=origin.device)
    coord = _normalize(torch.tensor([100.0, 0.0, 100.0], device=origin.device))
    num = torch.sum(coord * plane_n) - torch.sum(plane_n * origin, -1)
    den = torch.sum(plane_n * d, -1)
    t = num / den
    return origin + d * t[..., None]
