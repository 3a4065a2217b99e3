"""Thin-lens helpers the PO splat gates use (port of
``pota_tpu.optics.thinlens.image_dist_focusdist`` / ``coc_thinlens``).  The
thin-lens camera itself is not ported yet."""
from __future__ import annotations

import torch

from pota_tpu.config import CameraConfig, CameraType


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
