"""Pupil chart transforms (port of the parts of
:mod:`pota_tpu.optics.geometry` the PO render uses).  Lens-space mm; inputs
are batched ``(..., 2)`` / ``(..., 3)``."""
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


def sphere_to_cs(pos2, dir2, center, sphere_rad):
    """Sphere chart -> 3D ray (ref src/lens.h:99-125)."""
    r2 = pos2[..., 0] ** 2 + pos2[..., 1] ** 2
    nz = safe_sqrt(sphere_rad ** 2 - r2) / abs(sphere_rad)
    normal = torch.stack(
        [pos2[..., 0] / sphere_rad, pos2[..., 1] / sphere_rad, nz], -1)
    d2 = dir2[..., 0] ** 2 + dir2[..., 1] ** 2
    tz = safe_sqrt(1.0 - d2)
    temp = torch.stack([dir2[..., 0], dir2[..., 1], tz], -1)
    ex = _normalize(torch.stack(
        [normal[..., 2], torch.zeros_like(normal[..., 2]), -normal[..., 0]],
        -1))
    ey = _cross(normal, ex)
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


def line_plane_intersection_y0(origin, direction):
    """Intersection of a ray with the plane y = 0 (ref src/lens.h:412-419)."""
    d = _normalize(direction)
    plane_n = torch.tensor([0.0, 1.0, 0.0], device=origin.device)
    coord = _normalize(torch.tensor([100.0, 0.0, 100.0], device=origin.device))
    num = torch.sum(coord * plane_n) - torch.sum(plane_n * origin, -1)
    den = torch.sum(plane_n * d, -1)
    t = num / den
    return origin + d * t[..., None]
