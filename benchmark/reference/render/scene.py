"""Analytic sphere scene: the forward pass's shading source and the backward
splat's occlusion oracle (port of :mod:`pota_tpu.render.scene`)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..optics.geometry import safe_sqrt

INF = 1e30


@dataclasses.dataclass
class SphereScene:
    centers: torch.Tensor       # [S, 3] world space
    radii: torch.Tensor         # [S]
    emission: torch.Tensor      # [S, 3]
    albedo: torch.Tensor        # [S, 3]
    sky_color: torch.Tensor     # [3]
    light_dir: torch.Tensor     # [3] direction toward the light
    light_color: torch.Tensor   # [3]
    transmission: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.centers.device

    @property
    def n_objects(self) -> int:
        return int(self.centers.shape[0])

    def intersect(self, origins, dirs, t_min=1e-3):
        """Nearest hit. Returns (t [N], idx [N], hit [N])."""
        oc = origins[:, None, :] - self.centers[None, :, :]      # [N, S, 3]
        b = torch.sum(oc * dirs[:, None, :], -1)                  # [N, S]
        c = torch.sum(oc * oc, -1) - self.radii[None, :] ** 2
        disc = b * b - c
        sq = safe_sqrt(disc)
        t0 = -b - sq
        t1 = -b + sq
        t = torch.where(t0 > t_min, t0, t1)
        valid = (disc > 0.0) & (t > t_min)
        t = torch.where(valid, t, INF)
        idx = torch.argmin(t, -1)
        tbest = torch.gather(t, 1, idx[:, None])[:, 0]
        return tbest, idx, tbest < INF

    def occluded(self, p_from, p_to, t_min=1e-3):
        """Segment occlusion probe between two world points -> bool [N]."""
        seg = p_to - p_from
        dist = torch.sqrt(torch.clamp(torch.sum(seg * seg, -1), min=1e-24))
        d = seg / dist[..., None]
        t, _, hit = self.intersect(p_from, d, t_min)
        return hit & (t < dist - t_min)

    def shade(self, origins, dirs):
        """Shade primary rays: emission + lambert direct light + sky.
        Returns rgba [N, 4], z [N] (distance along the ray, 1e30 on a miss),
        P [N, 3], hit [N] and obj_id [N]; with ``transmission`` also the
        transmitted radiance [N, 3] and the id-matte's coverage layers
        ``crypto_ids`` / ``crypto_weights`` [N, 2]."""
        t, idx, hit = self.intersect(origins, dirs)
        # the sphere rows gather by index_select: its gradient sums the
        # samples' rows by sphere with index_add_, where the gradient of
        # table[idx] sorts the indices and walks each sphere's run in one
        # warp (0.63 s of a 1M-sample step on an H100)
        p = origins + dirs * t[:, None]
        n = ((p - self.centers.index_select(0, idx))
             / self.radii.index_select(0, idx)[:, None])
        ndotl = torch.clamp(torch.sum(n * self.light_dir[None, :], -1),
                            min=0.0)
        shadow_hit = self._occluded_dir(p + n * 1e-3, self.light_dir)
        direct = (self.albedo.index_select(0, idx)
                  * self.light_color[None, :]
                  * torch.where(shadow_hit, 0.0, ndotl)[:, None])
        rgb = torch.where(hit[:, None],
                          self.emission.index_select(0, idx) + direct,
                          self.sky_color[None, :])
        obj_id = torch.where(hit, idx, -1).to(torch.int32)
        out = {}
        if self.transmission is not None:
            # thin glass: continue the ray from the exit point and tint what
            # lies behind (one bounce; the reference takes Arnold's
            # transmission AOV, src/lentil_filter.cpp:152-159)
            t_exit = t + 2.0 * torch.abs(torch.sum(
                (self.centers.index_select(0, idx) - p) * dirs, -1))
            _, idx2, hit2 = self.intersect(
                origins + dirs * (t_exit + 1e-3)[:, None], dirs)
            behind = torch.where(hit2[:, None],
                                 self.emission.index_select(0, idx2),
                                 self.sky_color[None, :])
            tint = self.transmission.index_select(0, idx)
            transmitted = torch.where(hit[:, None], tint * behind, 0.0)
            rgb = rgb + transmitted
            out["transmission"] = transmitted
            # opacity-weighted coverage layers (src/lentil.h:780-811): the
            # front surface takes its opacity, the leftover goes to the hit
            # behind, or to the front surface when nothing is behind
            grey = (tint[:, 0] + tint[:, 1] + tint[:, 2]) / 3.0
            opacity_front = torch.clamp(1.0 - grey, 0.0, 1.0)
            out["crypto_ids"] = torch.stack(
                [obj_id, torch.where(hit2, idx2, idx).to(torch.int32)], -1)
            out["crypto_weights"] = torch.stack(
                [torch.where(hit, opacity_front, 0.0),
                 torch.where(hit, 1.0 - opacity_front, 0.0)], -1)
        alpha = torch.where(hit, 1.0, 0.0)
        return {
            "rgba": torch.cat([rgb, alpha[:, None]], -1),
            "z": torch.where(hit, t, INF),
            "P": torch.where(hit[:, None], p, 0.0),
            "hit": hit,
            "obj_id": obj_id,
            **out,
        }

    def _occluded_dir(self, origins, direction):
        _, _, hit = self.intersect(origins, direction[None, :].expand_as(origins))
        return hit


def sphere_scene_from_numpy(centers, radii, emission, albedo, sky_color,
                            light_dir, light_color, transmission=None,
                            device=None) -> SphereScene:
    """A :class:`SphereScene` from numpy arrays (a JAX ``SphereScene``'s
    fields as numpy), on ``device`` (default: the card)."""
    device = resolve_device(device)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return SphereScene(
        centers=f(centers), radii=f(radii), emission=f(emission),
        albedo=f(albedo), sky_color=f(sky_color), light_dir=f(light_dir),
        light_color=f(light_color),
        transmission=None if transmission is None else f(transmission),
    )


def lightgrid_scene(n: int = 5, spacing: float = 12.0, radius: float = 0.35,
                    z: float = -220.0, intensity: float = 30.0,
                    sky: float = 0.0, device=None) -> SphereScene:
    """Grid of small bright emissive spheres (the reference's bokeh
    acceptance scene)."""
    xs = (np.arange(n) - (n - 1) / 2.0) * spacing
    cx, cy = np.meshgrid(xs, xs)
    centers = np.stack([cx.ravel(), cy.ravel(), np.full(n * n, z)], -1)
    s = n * n
    rng = np.random.default_rng(7)
    colors = 0.5 + 0.5 * rng.uniform(size=(s, 3)).astype(np.float32)
    return sphere_scene_from_numpy(
        centers=centers, radii=np.full((s,), radius),
        emission=colors * np.float32(intensity), albedo=np.zeros((s, 3)),
        sky_color=np.full((3,), sky), light_dir=[0.0, 1.0, 0.0],
        light_color=np.zeros(3), device=device,
    )


def teapot_scene(device=None) -> SphereScene:
    """Five diffuse spheres at staggered depths plus three bright
    out-of-focus emitters."""
    centers, radii, emission, albedo = [], [], [], []
    for i, (x, zdepth) in enumerate(
        [(-30, -120), (-15, -160), (0, -200), (15, -260), (30, -330)]
    ):
        centers.append([x, -5.0, zdepth])
        radii.append(10.0)
        emission.append([0.0, 0.0, 0.0])
        albedo.append([0.4 + 0.1 * (i % 3), 0.5, 0.7 - 0.1 * (i % 2)])
    for x, y, zdepth, c in [
        (-25, 18, -300, [40.0, 30.0, 8.0]),
        (0, 22, -350, [10.0, 35.0, 45.0]),
        (28, 16, -280, [45.0, 12.0, 30.0]),
    ]:
        centers.append([x, y, zdepth])
        radii.append(0.6)
        emission.append(c)
        albedo.append([0.0, 0.0, 0.0])
    light_dir = (np.asarray([0.3, 0.8, 0.52], np.float32)
                 / np.float32(np.linalg.norm([0.3, 0.8, 0.52])))
    return sphere_scene_from_numpy(
        centers=centers, radii=radii, emission=emission, albedo=albedo,
        sky_color=[0.02, 0.02, 0.03], light_dir=light_dir,
        light_color=[1.2, 1.1, 1.0], device=device,
    )
