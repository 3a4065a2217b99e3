"""Empirical aberration helpers of the extended thin lens (port of
:mod:`pota_tpu.optics.aberrations`, ref ``src/lens.h:519-582``): optical
vignetting, barrel distortion and its closed-form inverse, and the coma
perturbation."""
from __future__ import annotations

import math

import torch


def _norm(v, keepdim=True):
    return torch.sqrt(torch.sum(v * v, -1, keepdim=keepdim))


def _normalize(v, eps=1e-12):
    return v / torch.clamp(_norm(v), min=eps)


def optical_vignetting_square(origin, direction, aperture_radius,
                              ov_radius, ov_distance, square_bias):
    """Cat-eye gate through a virtual second aperture at ``ov_distance``
    (ref src/lens.h:529-538): True where the ray passes the superellipse of
    radius ``aperture_radius * ov_radius``."""
    t = torch.abs(ov_distance / direction[..., 2])
    p = direction * t[..., None] - origin
    power = 1.0 + square_bias
    radius = aperture_radius * ov_radius
    dist = torch.abs(p[..., 0]) ** power + torch.abs(p[..., 1]) ** power
    return dist <= radius ** power


def barrel_distortion(uv, distortion):
    """Quadratic barrel distortion of screen coords (ref src/lens.h:545-548)."""
    return uv * (1.0 + torch.sum(uv * uv, -1, keepdim=True) * distortion)


def inverse_barrel_distortion(uv, distortion):
    """Closed-form (Cardano) inverse of :func:`barrel_distortion`
    (ref src/lens.h:550-559)."""
    b = distortion
    l_safe = torch.clamp(_norm(uv), min=1e-12)
    x0 = (9.0 * b * b * l_safe
          + math.sqrt(3.0) * torch.sqrt(27.0 * b ** 4 * l_safe ** 2
                                        + 4.0 * b ** 3)) ** (1.0 / 3.0)
    x = (x0 / (2.0 ** (1.0 / 3.0) * 3.0 ** (2.0 / 3.0) * b)
         - (2.0 / 3.0) ** (1.0 / 3.0) / x0)
    return uv * (x / l_safe)


def coma_multiplier(sensor_width, focal_length, dir_from_center, unit_disk):
    """Field times aperture-distance factor of the coma rotation
    (ref src/lens.h:563-571)."""
    like = dir_from_center
    maximal = torch.tensor([sensor_width * 0.5, sensor_width * 0.5,
                            -focal_length], dtype=like.dtype,
                           device=like.device)
    maximal = maximal / _norm(maximal)
    axis_z = torch.tensor([0.0, 0.0, -1.0], dtype=like.dtype,
                          device=like.device)
    maximal_proj = torch.sum(maximal * axis_z)
    current_proj = torch.sum(dir_from_center * axis_z, -1)
    projection_perc = ((current_proj - maximal_proj) / (1.0 - maximal_proj)
                       - 0.5) * 2.0
    dist_from_sensor_center = 1.0 - projection_perc
    dist_from_aperture = _norm(unit_disk, keepdim=False)
    return dist_from_sensor_center * dist_from_aperture


def _rotation_matrix(axis, angle):
    """Rodrigues axis-angle rotation matrices, batched over leading dims."""
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = torch.cos(angle)
    s = torch.sin(angle)
    one_c = 1.0 - c
    row0 = torch.stack([c + x * x * one_c, x * y * one_c - z * s,
                        x * z * one_c + y * s], -1)
    row1 = torch.stack([y * x * one_c + z * s, c + y * y * one_c,
                        y * z * one_c - x * s], -1)
    row2 = torch.stack([z * x * one_c - y * s, z * y * one_c + x * s,
                        c + z * z * one_c], -1)
    return torch.stack([row0, row1, row2], -2)


def coma_perturb(dir_from_lens, ray_to_perturb, abb_coma, reverse: bool):
    """Rotate a ray about the axis orthogonal to its direction and -z by
    ``abb_coma * 2.3456`` degrees, negated for the backward path
    (ref src/lens.h:575-582)."""
    minus_z = torch.tensor([0.0, 0.0, -1.0], dtype=dir_from_lens.dtype,
                           device=dir_from_lens.device)
    axis = _normalize(torch.cross(
        dir_from_lens, minus_z.expand_as(dir_from_lens), dim=-1))
    angle = torch.as_tensor(abb_coma * 2.3456 * math.pi / 180.0,
                            dtype=dir_from_lens.dtype,
                            device=dir_from_lens.device)
    if reverse:
        angle = -angle
    rot = _rotation_matrix(axis, angle.expand(axis[..., 0].shape))
    return torch.einsum("...ij,...j->...i", rot, ray_to_perturb)
