"""Extended thin-lens camera with empirical aberrations (port of
:mod:`pota_tpu.optics.thinlens`, ref ``src/lentil.h:431-569`` and
``:665-692``).

The reference's vignetting-retry loop becomes K = ``vignetting_retries + 1``
candidate aperture samples per ray and a first-success select, as in JAX.
All functions are batched over rays (leading dimension N).
"""
from __future__ import annotations

import torch

from ..config import CameraConfig, CameraType

from ..utils import rng as prng
from . import aberrations, samplers


def _norm(v):
    return torch.sqrt(torch.sum(v * v, -1, keepdim=True))


def sample_aperture(cfg: CameraConfig, r1, r2, bokeh_cdf=None):
    """The configured aperture sampler -> unit-disk points [..., 2]
    (ref src/lentil.h:460-473): image bokeh (alias sampler), the aberrated
    concentric disk, or the blade fan."""
    if cfg.bokeh_enable_image and bokeh_cdf is not None:
        from ..render.bokeh_image import bokeh_sample_alias
        return bokeh_sample_alias(bokeh_cdf, r1, r2)
    if cfg.aperture_blades < 2:
        return samplers.concentric_disk_sample_aberrated(
            r1, r2, cfg.effective_abb_spherical,
            cfg.effective_circle_to_square)
    return samplers.triangular_aperture_sample(r1, r2, 1.0,
                                               cfg.aperture_blades)


def trace_fw_thinlens(cfg: CameraConfig, sx, sy, r1, r2, retry_key=None,
                      deriv_ray: bool = False, bokeh_cdf=None):
    """Forward thin-lens trace, batched over rays [N].

    ``sx, sy`` are screen coords, ``r1, r2`` the primary lens uniforms and
    ``retry_key`` the per-ray uint32 key of the retry draws (int64 words;
    not needed for ``deriv_ray``, which never retries).  Returns (origin
    [N, 3], direction [N, 3], weight [N], tries [N]) in camera space
    (looking down -z), scaled to scene units."""
    n_tries = 1 if deriv_ray else cfg.vignetting_retries + 1
    dev, dtype = sx.device, sx.dtype

    s = torch.stack([sx, sy], -1)
    if cfg.abb_distortion > 0.0:
        s = aberrations.barrel_distortion(s, cfg.abb_distortion)
    hsw = cfg.sensor_width * 0.5
    p = torch.stack([s[..., 0] * hsw, s[..., 1] * hsw,
                     torch.full_like(sx, -cfg.effective_focal_length)], -1)
    dir_from_center = p / _norm(p)

    if cfg.enable_dof:
        unit_disk = sample_aperture(
            cfg, *prng.retry_uniforms(r1, r2, retry_key, n_tries), bokeh_cdf)
    else:
        unit_disk = torch.zeros(sx.shape + (n_tries, 2), dtype=dtype,
                                device=dev)
    unit_disk = torch.stack(
        [unit_disk[..., 0] * cfg.effective_anamorphic, unit_disk[..., 1]], -1)

    lens = torch.cat([unit_disk * cfg.thinlens_aperture_radius,
                      torch.zeros_like(unit_disk[..., :1])], -1)  # [N, K, 3]
    dfc = dir_from_center[:, None, :]
    intersection = torch.abs(cfg.focus_distance / dfc[..., 2])
    focus_point = dfc * intersection[..., None]
    dir_from_lens = focus_point - lens
    dir_from_lens = dir_from_lens / _norm(dir_from_lens)

    if cfg.abb_coma != 0.0:
        coma_mult = cfg.abb_coma * aberrations.coma_multiplier(
            cfg.sensor_width, cfg.effective_focal_length, dfc, unit_disk)
        dir_from_lens = aberrations.coma_perturb(
            dir_from_lens, dir_from_lens, coma_mult, reverse=False)

    # vignetting gate (skipped for derivative rays, ref src/lentil.h:494)
    if cfg.optical_vignetting_distance > 0.0 and not deriv_ray:
        ok = aberrations.optical_vignetting_square(
            lens, dir_from_lens, cfg.thinlens_aperture_radius,
            cfg.optical_vignetting_radius, cfg.optical_vignetting_distance,
            samplers.lerp_squircle_mapping(cfg.effective_circle_to_square))
    else:
        ok = torch.ones(lens.shape[:-1], dtype=torch.bool, device=dev)

    # first-success select over the K candidates
    first = torch.argmax(ok.to(torch.int32), -1)
    any_ok = ok.any(-1)
    idx = first[:, None, None].expand(-1, 1, 3)
    origin = torch.gather(lens, 1, idx)[:, 0]
    direction = torch.gather(dir_from_lens, 1, idx)[:, 0]

    scale = cfg.unit_scale_thinlens
    origin = origin * scale
    direction = direction * scale
    direction = direction / _norm(direction)

    weight = torch.where(any_ok, 1.0, 0.0).to(dtype)
    tries = torch.where(any_ok, first, n_tries).to(torch.int32)
    return origin, direction, weight, tries


def image_dist(focal_length, z):
    """Thin-lens image distance for an object at (negative) depth z."""
    return (-focal_length * z) / (-focal_length + z)


def image_dist_focusdist(cfg: CameraConfig, shift=0.0):
    """Image distance of the focus plane (ref src/lentil.h:665-671)."""
    fd = cfg.focus_distance + shift
    return ((-cfg.effective_focal_length * -fd)
            / (-cfg.effective_focal_length + -fd))


def coc_thinlens(cfg: CameraConfig, camera_space_z, aperture_radius=None,
                 focus_distance=None):
    """Circle-of-confusion diameter in screen units (ref src/lentil.h:674-692).

    PO cameras pass their calibrated ``aperture_radius`` (mm) and x10
    ``focus_distance``, exactly as the reference reconciles the two setups.
    """
    if cfg.camera_type == CameraType.POLYNOMIAL_OPTICS:
        if aperture_radius is None or focus_distance is None:
            raise ValueError("PO coc needs aperture_radius and focus_distance")
        focus_distance = focus_distance / 10.0
    else:
        aperture_radius = cfg.thinlens_aperture_radius * 10.0
        focus_distance = cfg.focus_distance

    f = cfg.effective_focal_length
    image_dist_samplepos = (-f * camera_space_z) / (-f + camera_space_z)
    image_dist_fd = (-f * -focus_distance) / (-f + -focus_distance)
    return torch.abs(
        (aperture_radius * (image_dist_samplepos - image_dist_fd))
        / image_dist_samplepos
    )
