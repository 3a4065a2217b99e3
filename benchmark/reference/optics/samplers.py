"""Aperture samplers (port of :mod:`pota_tpu.optics.samplers`): uniforms in
[0, 1) -> points on the unit aperture."""
from __future__ import annotations

import math

import torch


def _f32(v, like):
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def bias(value, b):
    """Schlick bias curve, value ** (log(b) / log(0.5)) (Arnold's AiBias)."""
    b = _f32(b, value)
    return torch.pow(value, torch.log(b) / torch.log(_f32(0.5, value)))


def concentric_polar(r1, r2):
    """Shirley's concentric map in polar form: (radius, angle) and the
    square point (a, b) of the two uniforms."""
    a = 2.0 * r1 - 1.0
    b2 = 2.0 * r2 - 1.0
    use_a = (a * a) > (b2 * b2)
    safe_a = torch.where(a == 0.0, 1.0, a)
    safe_b = torch.where(b2 == 0.0, 1.0, b2)
    r = torch.where(use_a, a, b2)
    phi = torch.where(
        use_a,
        (math.pi / 4.0) * (b2 / safe_a),
        (math.pi / 2.0) - (math.pi / 4.0) * (a / safe_b),
    )
    return r, phi, a, b2


def concentric_disk_sample(r1, r2):
    """Shirley concentric square -> disk map (ref src/lens.h:309-333)."""
    r, phi, a, b2 = concentric_polar(r1, r2)
    both_zero = (a == 0.0) & (b2 == 0.0)
    x = torch.where(both_zero, 0.0, r * torch.cos(phi))
    y = torch.where(both_zero, 0.0, r * torch.sin(phi))
    return torch.stack([x, y], -1)


def concentric_disk_sample_aberrated(r1, r2, abb_spherical, circle_to_square):
    """Concentric disk sample with spherical-aberration bias and squircle
    lerp (ref src/lens.h:477-514)."""
    r, phi, a, b2 = concentric_polar(r1, r2)
    if abb_spherical != 0.5:
        r = bias(torch.abs(r), abb_spherical) * torch.sign(r)
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    if circle_to_square > 0.0:
        x = x + circle_to_square * (a - x)
        y = y + circle_to_square * (b2 - y)
    both_zero = (a == 0.0) & (b2 == 0.0)
    x = torch.where(both_zero, 0.0, x)
    y = torch.where(both_zero, 0.0, y)
    return torch.stack([x, y], -1)


def triangular_aperture_sample(r1, r2, radius, blades: int):
    """n-bladed polygonal aperture as a fan of triangles
    (ref src/lentil.h:964-982)."""
    tri = torch.floor(r1 * blades)
    r1s = r1 * blades - tri
    a = torch.sqrt(r1s)
    b = (1.0 - r2) * a
    c = r2 * a
    ang1 = 2.0 * math.pi / blades * (tri + 1.0)
    ang2 = 2.0 * math.pi / blades * tri
    x = radius * (b * torch.cos(ang1) + c * torch.cos(ang2))
    y = radius * (b * torch.sin(ang1) + c * torch.sin(ang2))
    return torch.stack([x, y], -1)


def lerp_squircle_mapping(amount):
    """Empirical squircle exponent of the optical-vignetting gate
    (ref src/lens.h:541-543)."""
    amount = torch.as_tensor(amount, dtype=torch.float32)
    return 1.0 + torch.log(1.0 + amount) * torch.exp(amount * 3.0)
