"""Image-based bokeh aperture sampling (port of
:mod:`pota_tpu.render.bokeh_image`, ref ``src/imagebokeh.h:30-413``).

The tables are built on the host with numpy exactly as the JAX package
builds them (a row CDF over descending-sorted rows, per-row column CDFs
over descending-sorted columns, and a Walker alias table over the pixel
multinomial), then held as tensors on the render's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device


@dataclasses.dataclass
class BokehImage:
    """CDF and alias tables of a square aperture image."""

    cdf_row: torch.Tensor      # [Y] f32, cumulative over sorted row sums
    row_indices: torch.Tensor  # [Y] int64, descending-sort indirection
    cdf_col: torch.Tensor      # [Y, X] f32, per-row cumulative over sorted cols
    col_indices: torch.Tensor  # [Y, X] int64, per-row sort indirection
    alias_prob: torch.Tensor   # [Y*X] f32, Walker acceptance thresholds
    alias_idx: torch.Tensor    # [Y*X] int64, Walker alias partners
    resolution: int = 0


def bokeh_image_from_numpy(cdf_row, row_indices, cdf_col, col_indices,
                           alias_prob, alias_idx, resolution: int,
                           device=None) -> BokehImage:
    """A :class:`BokehImage` from the six tables as numpy arrays (for
    example the JAX package's, through ``np.asarray``), on ``device``
    (default: the card)."""
    device = resolve_device(device)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return BokehImage(f(cdf_row), i(row_indices), f(cdf_col), i(col_indices),
                      f(alias_prob), i(alias_idx), int(resolution))


def build_bokeh_cdf(pixels: np.ndarray, device=None) -> BokehImage:
    """Build the sampler tables from an [H, W, C>=1] float image
    (imageData::bokehProbability, ref src/imagebokeh.h:143-338):
    luminance 0.3/0.59/0.11, normalized; row-sum CDF over descending-sorted
    rows; per-row column CDFs over descending-sorted columns.  The tables
    go to ``device`` (default: the card)."""
    device = resolve_device(device)
    pixels = np.asarray(pixels, np.float64)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    h, w = pixels.shape[:2]
    if h != w:
        raise ValueError("bokeh image must be square "
                         "(ref src/imagebokeh.h:97-101)")
    c = pixels.shape[2]
    o1 = 1 if c >= 2 else 0
    o2 = 2 if c >= 3 else o1
    lum = (pixels[..., 0] * 0.3 + pixels[..., o1] * 0.59
           + pixels[..., o2] * 0.11)
    total = lum.sum()
    if not total > 0:
        raise ValueError("bokeh image is black")
    norm = lum / total

    row_sums = norm.sum(axis=1)
    row_indices = np.argsort(-row_sums, kind="stable")
    cdf_row = np.cumsum(row_sums[row_indices])

    safe_rows = np.where(row_sums > 0, row_sums, 1.0)[:, None]
    per_row = np.where(norm > 0, norm / safe_rows, 0.0)
    col_indices = np.argsort(-per_row, axis=1, kind="stable")
    sorted_cols = np.take_along_axis(per_row, col_indices, axis=1)
    cdf_col = np.cumsum(sorted_cols, axis=1)

    alias_prob, alias_idx = _build_alias(norm.ravel())
    return bokeh_image_from_numpy(cdf_row, row_indices, cdf_col, col_indices,
                                  alias_prob, alias_idx, w, device=device)


def _build_alias(p: np.ndarray):
    """Walker alias table over the pixel multinomial ``p`` (sums to 1): the
    same distribution as the sorted-CDF inversion, sampled in O(1)."""
    k = p.size
    scaled = p * k
    alias = np.zeros(k, np.int64)
    prob = np.ones(k, np.float64)
    small = [i for i in range(k) if scaled[i] < 1.0]
    large = [i for i in range(k) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    return prob, alias


def load_bokeh_image(path: str, device=None) -> BokehImage:
    """Load an aperture image (png/jpg through PIL, or EXR) and build its
    tables on ``device`` (default: the card)."""
    device = resolve_device(device)
    if path.lower().endswith(".exr"):
        from ..io.exr import read_exr

        planes = read_exr(path)
        keys = [k for k in ("R", "G", "B") if k in planes]
        img = np.stack([planes[k] for k in keys], -1)
    else:
        from PIL import Image

        img = np.asarray(Image.open(path), np.float32) / 255.0
    return build_bokeh_cdf(img, device=device)


def _pixel_to_unit(res: int, row, col):
    """Pixel (row, col) -> [-1, 1]^2 aperture point with the reference's
    row/column flip (ref src/imagebokeh.h:395-410)."""
    half = (res - 1) // 2
    recalc_row = row.to(torch.float32) - half
    recalc_col = col.to(torch.float32) - half
    return torch.stack([recalc_col / res * 2.0, -recalc_row / res * 2.0], -1)


def bokeh_sample_alias(bi: BokehImage, r1, r2):
    """Alias-method inversion: two uniforms -> point in [-1, 1]^2, the
    sampler of the thin-lens retries and of the backward splat queue."""
    res = bi.resolution
    k = res * res
    j = torch.clamp((r1 * k).to(torch.int64), 0, k - 1)
    keep = r2 < bi.alias_prob[j]
    choice = torch.where(keep, j, bi.alias_idx[j])
    return _pixel_to_unit(res, choice // res, choice % res)


def bokeh_sample(bi: BokehImage, r_row, r_col):
    """Invert the CDFs with two binary searches per sample
    (imageData::bokehSample, ref src/imagebokeh.h:341-412): two uniforms ->
    point in [-1, 1]^2."""
    res = bi.resolution
    shape = r_col.shape
    r = torch.clamp(torch.searchsorted(bi.cdf_row, r_row.contiguous(),
                                       right=True), 0, res - 1)
    actual_row = bi.row_indices[r].reshape(-1)
    c_rel = torch.searchsorted(bi.cdf_col[actual_row],
                               r_col.reshape(-1, 1).contiguous(), right=True)
    c_rel = torch.clamp(c_rel[:, 0], 0, res - 1)
    actual_col = bi.col_indices[actual_row, c_rel]

    recalc_row = (actual_row - (res - 1) // 2).reshape(shape)
    recalc_col = (actual_col - (res - 1) // 2).reshape(shape)
    flipped_row = recalc_col.to(torch.float32)
    flipped_col = -recalc_row.to(torch.float32)
    return torch.stack([flipped_row / res * 2.0, flipped_col / res * 2.0], -1)
