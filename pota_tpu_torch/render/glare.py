"""FFT glare imager: aperture-diffraction bloom (port of
:mod:`pota_tpu.render.glare`).

The reference ships only a sketch of this imager
(``src/deprecated/lentil_glare_imager.cpp``: "calculate obstacle picture
(fft(aperture*obstacle))").  The far-field diffraction pattern of the iris
is ``|FFT2(aperture transmission)|^2`` (an n-blade iris draws the 2n-spike
starburst); glare thresholds the frame's highlights, convolves them with
that PSF (a padded, linear FFT convolution) and adds the result back scaled
by ``intensity``; chromatic streaking scales the PSF per channel with
wavelength.  Everything is tensor work and differentiable.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


def aperture_mask(size: int = 256, blades: int = 0, radius: float = 0.9,
                  device=None) -> torch.Tensor:
    """Aperture transmission mask [size, size] in {0, 1}, on ``device``
    (default: the card).  ``blades < 3`` gives a circular iris, otherwise a
    regular ``blades``-gon (the samplers' iris, ref src/lentil.h:964-982)."""
    y, x = np.mgrid[0:size, 0:size]
    cx = (size - 1) / 2.0
    u = (x - cx) / (size / 2.0)
    v = (y - cx) / (size / 2.0)
    r = np.sqrt(u * u + v * v)
    if blades < 3:
        mask = r <= radius
    else:
        # distance to the polygon's edge in this direction (apothem form)
        seg = np.pi / blades
        local = np.mod(np.arctan2(v, u) + seg, 2 * seg) - seg
        mask = r <= radius * np.cos(seg) / np.maximum(np.cos(local), 1e-6)
    return torch.as_tensor(mask.astype(np.float32),
                           device=resolve_device(device))


def diffraction_psf(mask: torch.Tensor, out_size: int | None = None,
                    chroma: float = 0.0) -> torch.Tensor:
    """Far-field diffraction PSF of an aperture mask -> [H, W, 3], each
    channel of unit energy.  ``chroma`` in [0, 1] scales the channels'
    spread (red wider than blue: the diffraction angle grows with the
    wavelength; lambda_R / lambda_G ~ 1.18, lambda_B / lambda_G ~ 0.85 at
    full chroma)."""
    n = mask.shape[0]
    psf = torch.abs(torch.fft.fftshift(torch.fft.fft2(mask))) ** 2
    size = out_size or n
    scales = 1.0 + chroma * torch.tensor([0.18, 0.0, -0.15],
                                         device=mask.device)
    grid = torch.arange(size, dtype=torch.float32, device=mask.device)
    yy, xx = grid[:, None].expand(size, size), grid[None, :].expand(size,
                                                                    size)
    c = (size - 1) / 2.0
    chans = []
    for s in scales:
        # sample the PSF at coordinates shrunk by the channel's scale
        sy = (yy - c) / s + (n - 1) / 2.0
        sx = (xx - c) / s + (n - 1) / 2.0
        iy = torch.clamp(torch.round(sy).to(torch.int64), 0, n - 1)
        ix = torch.clamp(torch.round(sx).to(torch.int64), 0, n - 1)
        inside = (sy >= 0) & (sy <= n - 1) & (sx >= 0) & (sx <= n - 1)
        ch = torch.where(inside, psf[iy, ix], 0.0)
        chans.append(ch / torch.clamp(ch.sum(), min=1e-20))
    return torch.stack(chans, -1)


def apply_glare(image: torch.Tensor, psf: torch.Tensor,
                threshold: float = 1.0,
                intensity: float = 0.1) -> torch.Tensor:
    """Add aperture-diffraction glare to a frame [H, W, 3 or 4] with a PSF
    [h, w, 3] of unit energy per channel.  Highlights above ``threshold``
    are convolved with the PSF (zero-padded, so linear, not circular) and
    added back scaled by ``intensity``; the source keeps ``1 - intensity``
    of its energy above the threshold, so glare moves energy and creates
    none."""
    rgb = image[..., :3]
    h, w = rgb.shape[:2]
    ph, pw = psf.shape[:2]
    hi = torch.clamp(rgb - threshold, min=0.0)
    fh, fw = h + ph - 1, w + pw - 1
    img_f = torch.fft.rfft2(hi, s=(fh, fw), dim=(0, 1))
    psf_f = torch.fft.rfft2(psf, s=(fh, fw), dim=(0, 1))
    conv = torch.fft.irfft2(img_f * psf_f, s=(fh, fw), dim=(0, 1))
    oy, ox = ph // 2, pw // 2
    glare = torch.clamp(conv[oy:oy + h, ox:ox + w], min=0.0)
    out_rgb = rgb - intensity * hi + intensity * glare
    if image.shape[-1] == 4:
        return torch.cat([out_rgb, image[..., 3:4]], -1)
    return out_rgb


def resolve_with_glare(image: torch.Tensor, blades: int = 0,
                       threshold: float = 1.0, intensity: float = 0.1,
                       chroma: float = 0.0,
                       psf_size: int = 128) -> torch.Tensor:
    """One-call imager: the iris PSF, built on the image's device, applied
    to a frame."""
    mask = aperture_mask(psf_size, blades, device=image.device)
    psf = diffraction_psf(mask, chroma=chroma)
    return apply_glare(image, psf, threshold=threshold, intensity=intensity)
