"""End-to-end render pipeline: camera rays -> shading -> splat -> resolve
(port of :mod:`pota_tpu.render.renderer`).

The device is the scene's: every tensor of a render is made there.  A
configuration object of another package raises ``TypeError``
(:func:`check_supported`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..config import (
    CameraConfig,
    CameraType,
    RenderConfig,
    require_port_configs,
)
from ..optics import thinlens
from ..utils.trace import span
from . import sampling


def check_supported(cfg: CameraConfig, rc: RenderConfig, po_lens=None):
    """Raise ``TypeError`` unless ``cfg`` and ``rc`` are the port's config
    classes.  A PO frame whose lens lies on the card raises ``ValueError``
    for a fit outside the degree-5 basis of the card's PO kernels
    (:func:`pota_tpu_torch.ops.po_kernels.check_basis`), before any kernel
    runs; on the CPU such a fit renders."""
    require_port_configs(cfg, rc)
    if (cfg.camera_type == CameraType.POLYNOMIAL_OPTICS
            and po_lens is not None and po_lens.device.type == "cuda"):
        from ..ops.po_kernels import check_basis

        check_basis(po_lens)


def _unit(d):
    return d / torch.sqrt(torch.clamp(torch.sum(d * d, -1, keepdim=True),
                                      min=1e-24))


def _transform_rays(cam_to_world, origins, dirs):
    """Apply a 4x4 camera -> world transform to ray origins/directions."""
    rot = cam_to_world[:3, :3]
    trans = cam_to_world[:3, 3]
    return origins @ rot.T + trans, _unit(dirs @ rot.T)


def interp_camera_matrix(m0, m1, t):
    """Per-sample camera matrix over the shutter: the linear blend of the
    two key matrices (ref src/lentil_filter.cpp:141-150).  ``t`` [N] in
    [0, 1] -> [N, 4, 4]."""
    t = t[:, None, None]
    return m0[None] * (1.0 - t) + m1[None] * t


def _transform_rays_mb(m_per_sample, origins, dirs):
    """Per-sample camera -> world ray transform ([N, 4, 4] matrices)."""
    rot = m_per_sample[:, :3, :3]
    trans = m_per_sample[:, :3, 3]
    o = torch.einsum("nij,nj->ni", rot, origins) + trans
    return o, _unit(torch.einsum("nij,nj->ni", rot, dirs))


@span("pota.trace")
def trace_camera_rays(cfg: CameraConfig, samples: dict, po_lens=None,
                      po_state=None, ops=None, bokeh_cdf=None,
                      differentiable: bool = False):
    """Camera-space rays for a sample stream, by camera model;
    ``differentiable`` takes the PO camera's differentiable route."""
    if cfg.camera_type == CameraType.THIN_LENS:
        origin, direction, weight, _tries = thinlens.trace_fw_thinlens(
            cfg, samples["sx"], samples["sy"], samples["r1"], samples["r2"],
            retry_key=samples["key"], bokeh_cdf=bokeh_cdf)
    else:
        if po_lens is None or po_state is None:
            raise ValueError(
                "the polynomial camera needs po_lens and po_state")
        from ..models.po_camera import trace_fw_po

        origin, direction, weight, _tries = trace_fw_po(
            cfg, po_lens, samples["sx"], samples["sy"], samples["r1"],
            samples["r2"], samples["key"], po_state, ops=ops,
            bokeh_cdf=bokeh_cdf, differentiable=differentiable)
    return origin, direction, weight * cfg.exposure


def trace_camera_rays_with_derivs(cfg: CameraConfig, rc: RenderConfig,
                                  samples: dict, po_lens=None,
                                  po_state=None, bokeh_cdf=None, ops=None):
    """Primary rays and their ray differentials (the reference's
    camera_create_ray, ``src/lentil_camera.cpp:96-119``; JAX's
    ``pota_tpu/render/renderer.py:80-137``).

    The primary rays come from :func:`trace_camera_rays` (K1 for the PO
    lens).  The differentials are the derivative of the deriv-ray path
    (one aperture candidate on the primary's (r1, r2), no retries) along
    one pixel's screen step, (2/xres, 0) and (0, 2/yres), so the outputs
    are dO/dpixel and dD/dpixel; the reference finite-differences two extra
    rays, this is exact.  A PO camera with depth of field takes K1j
    (``ops.po_forward_jvp``, once for both axes:
    :func:`~pota_tpu_torch.models.po_camera.trace_fw_po_jvp`) on the card;
    on the CPU, without depth of field and for the thin lens, one
    ``torch.func.jvp`` per axis over ``trace_fw_po(deriv_ray=True)`` (the
    term trace, ``_ApertureSolve.jvp``) or
    ``trace_fw_thinlens(deriv_ray=True)``, as JAX's ``jax.jvp``.  On the
    CPU the term trace keeps JAX's rounding, to which the CPU tests hold
    the deriv ray.

    Returns (origin, direction, weight, {"dOdx", "dOdy", "dDdx",
    "dDdy"}), each derivative [N, 3]."""
    origin, direction, weight = trace_camera_rays(
        cfg, samples, po_lens=po_lens, po_state=po_state, ops=ops,
        bokeh_cdf=bokeh_cdf)
    r1, r2 = samples["r1"], samples["r2"]
    sx, sy = samples["sx"], samples["sy"]
    zeros = torch.zeros_like(sx)
    steps = ((torch.full_like(sx, 2.0 / rc.xres), zeros),
             (zeros, torch.full_like(sy, 2.0 / rc.yres)))
    po = cfg.camera_type != CameraType.THIN_LENS
    if po and cfg.enable_dof and sx.device.type == "cuda":
        from ..models.po_camera import trace_fw_po_jvp

        (dOdx, dDdx), (dOdy, dDdy) = trace_fw_po_jvp(
            cfg, po_lens, sx, sy, r1, r2, po_state, steps, ops=ops,
            bokeh_cdf=bokeh_cdf)
    else:
        def deriv_trace(sx, sy):
            if not po:
                o, d, _, _ = thinlens.trace_fw_thinlens(
                    cfg, sx, sy, r1, r2, deriv_ray=True, bokeh_cdf=bokeh_cdf)
            else:
                from ..models.po_camera import trace_fw_po

                o, d, _, _ = trace_fw_po(cfg, po_lens, sx, sy, r1, r2, None,
                                         po_state, ops=ops,
                                         bokeh_cdf=bokeh_cdf,
                                         deriv_ray=True)
            return o, d

        (dOdx, dDdx), (dOdy, dDdy) = (
            torch.func.jvp(deriv_trace, (sx, sy), t)[1] for t in steps)
    return origin, direction, weight, {
        "dOdx": dOdx, "dOdy": dOdy, "dDdx": dDdx, "dDdy": dDdy}


def camera_reverse_ray(cfg: CameraConfig, p_cam, po_lens=None):
    """Camera-space point -> screen coords by the pinhole field of view
    (the reference's camera_reverse_ray, ``src/lentil_camera.cpp:164-172``:
    ``Ps = Po.xy / max(|Po.z * tan_fov|, 1e-3)``).  The PO camera takes the
    fitted lens's field of view (ref ``src/lentil.h:1658``), the thin lens
    its sensor's (ref ``src/lentil.h:1666``)."""
    if cfg.camera_type == CameraType.POLYNOMIAL_OPTICS:
        if po_lens is None:
            raise ValueError("the polynomial camera needs po_lens")
        tan_fov = math.tan(po_lens.fov / 2.0)
    else:
        tan_fov = cfg.thinlens_tan_fov
    coeff = 1.0 / torch.clamp(torch.abs(p_cam[..., 2] * tan_fov), min=1e-3)
    return torch.stack([p_cam[..., 0] * coeff, p_cam[..., 1] * coeff], -1)


def trace_chunk_count(cfg: CameraConfig, n_samples: int) -> int:
    """The checkpointed chunks of a differentiable trace of ``n_samples``
    samples: ``cfg.trace_chunks`` where it divides them, else one."""
    tc = cfg.trace_chunks
    return tc if tc > 1 and n_samples % tc == 0 else 1


def _trace_chunked(cfg: CameraConfig, samples: dict, n_chunks: int,
                   **kw):
    """:func:`trace_camera_rays` over ``n_chunks`` equal sample chunks in
    turn, each under ``torch.utils.checkpoint`` (JAX's ``trace_chunks``,
    ``pota_tpu/render/renderer.py:171-190``): a backward pass recomputes a
    chunk's aperture solve and monomial tensors instead of keeping all of
    them.  The samples are drawn before chunking and the retry draws are
    counter-based, so a recompute repeats the forward bit for bit."""
    from torch.utils.checkpoint import checkpoint

    keys = ("sx", "sy", "r1", "r2", "key")

    def trace(*cols):
        # also around the chunk's recompute, inside the backward pass
        with span("pota.trace.chunk"):
            return trace_camera_rays(cfg, dict(zip(keys, cols)), **kw)

    parts = [checkpoint(trace, *cols, use_reentrant=False)
             for cols in zip(*(samples[k].chunk(n_chunks) for k in keys))]
    return tuple(torch.cat(p) for p in zip(*parts))


@span("pota.sample_stream")
def render_sample_stream(cfg: CameraConfig, rc: RenderConfig, scene,
                         cam_to_world, seed: int = 0, po_lens=None,
                         po_state=None, ops=None, bokeh_cdf=None,
                         cam_to_world_end=None,
                         differentiable: bool = False,
                         samples: dict | None = None) -> dict:
    """Trace + shade the whole frame (or ``samples``, a part of its sample
    stream); returns the per-sample AOV stream.
    With ``cam_to_world_end`` each sample's rays leave the camera matrix
    blended to its shutter ``time`` (motion blur).  ``differentiable``
    takes the differentiable forward trace, in checkpointed chunks
    (:func:`trace_chunk_count`, :func:`_trace_chunked`)."""
    require_port_configs(cfg, rc)
    if samples is None:
        samples = sampling.frame_samples(rc, seed, device=scene.device)
    trace_kw = dict(po_lens=po_lens, po_state=po_state, ops=ops,
                    bokeh_cdf=bokeh_cdf, differentiable=differentiable)
    tc = trace_chunk_count(cfg, samples["sx"].shape[0])
    if differentiable and tc > 1:
        origin_cs, dir_cs, weight = _trace_chunked(cfg, samples, tc,
                                                   **trace_kw)
    else:
        origin_cs, dir_cs, weight = trace_camera_rays(cfg, samples,
                                                      **trace_kw)
    if cam_to_world_end is not None:
        m = interp_camera_matrix(cam_to_world, cam_to_world_end,
                                 samples["time"])
        origin_ws, dir_ws = _transform_rays_mb(m, origin_cs, dir_cs)
    else:
        origin_ws, dir_ws = _transform_rays(cam_to_world, origin_cs, dir_cs)
    with span("pota.shade"):
        shaded = scene.shade(origin_ws, dir_ws)
    stream = {
        **samples,
        "rgba": shaded["rgba"] * weight[:, None],
        "z": shaded["z"],
        "P": shaded["P"],
        "raydir": dir_ws,
        "weight": weight,
        "hit": shaded["hit"],
        "obj_id": shaded["obj_id"],
    }
    # optional AOVs the scene may emit ride the stream, transmission in the
    # units of rgba (ref src/lentil_filter.cpp:152)
    if "transmission" in shaded:
        stream["transmission"] = shaded["transmission"] * weight[:, None]
    if "volume" in shaded:
        stream["volume"] = shaded["volume"]
    # the id-matte's opacity-weighted coverage layers
    if "crypto_ids" in shaded:
        stream["crypto_ids"] = shaded["crypto_ids"]
        stream["crypto_weights"] = shaded["crypto_weights"]
    return stream


def resolve_gaussian(rc: RenderConfig, stream: dict) -> torch.Tensor:
    """Cross-pixel gaussian filter over the filter footprint (the
    reference's passthrough filter, src/lentil.h:736-775)."""
    h, wres, spp = rc.yres_region, rc.xres_region, rc.spp
    ox = stream["ox"].reshape(h, wres, spp)
    oy = stream["oy"].reshape(h, wres, spp)
    rgba = stream["rgba"].reshape(h, wres, spp, 4)
    inv_w2 = (2.0 / rc.filter_width) ** 2
    reach = int(rc.filter_width / 2.0 + 0.5)

    num = torch.zeros((h, wres, 4), dtype=rgba.dtype, device=rgba.device)
    den = torch.zeros((h, wres), dtype=rgba.dtype, device=rgba.device)
    for dy in range(-reach, reach + 1):
        for dx in range(-reach, reach + 1):
            r = inv_w2 * ((ox - dx) ** 2 + (oy - dy) ** 2)
            w = torch.where(r > 1.0, 0.0, torch.exp(-2.0 * r))
            n = (rgba * w[..., None]).sum(2)
            d = w.sum(2)
            if dx or dy:
                n = torch.roll(n, (dy, dx), (0, 1))
                d = torch.roll(d, (dy, dx), (0, 1))
                if dy:
                    row = slice(0, 1) if dy > 0 else slice(h - 1, h)
                    n[row] = 0.0
                    d[row] = 0.0
                if dx:
                    col = slice(0, 1) if dx > 0 else slice(wres - 1, wres)
                    n[:, col] = 0.0
                    d[:, col] = 0.0
            num = num + n
            den = den + d
    return num / torch.clamp(den, min=1e-12)[..., None]


def render_frame_simple(cfg: CameraConfig, rc: RenderConfig, scene,
                        cam_to_world, seed: int = 0, po_lens=None,
                        po_state=None, bokeh_cdf=None):
    """Forward-only render (no redistribution): the sample stream resolved
    by the gaussian filter, [H, W, 4]."""
    check_supported(cfg, rc, po_lens=po_lens)
    with torch.no_grad():
        stream = render_sample_stream(
            cfg, rc, scene, cam_to_world.to(scene.device, torch.float32),
            seed, po_lens=po_lens, po_state=po_state, bokeh_cdf=bokeh_cdf)
        return resolve_gaussian(rc, stream)


@span("pota.frame")
def render_frame(cfg: CameraConfig, rc: RenderConfig, scene, cam_to_world,
                 seed: int = 0, po_lens=None, po_state=None, bokeh_cdf=None,
                 cam_to_world_end=None, differentiable: bool = False,
                 aovs=None, ops=None):
    """Full pipeline: forward trace + bidirectional redistribution +
    resolve.  Returns (resolved RGBA image [H, W, 4], framebuffer dict).

    ``bokeh_cdf`` is the image bokeh's
    :class:`~pota_tpu_torch.render.bokeh_image.BokehImage`, on the scene's
    device.  ``cam_to_world_end`` is the camera matrix at the end of the
    shutter (motion blur).  ``aovs`` lists the AOV planes (default
    :data:`~pota_tpu_torch.render.aov.DEFAULT_AOVS`).  ``ops`` is the
    kernel set the path calls (default :data:`pota_tpu_torch.ops.KERNELS`;
    :data:`~pota_tpu_torch.ops.PLAIN` runs the plain versions, for parity
    checks on the card).

    ``differentiable=True`` (JAX's ``render_frame(..., use_pallas=False,
    differentiable=True)``) records the frame for autograd, so that
    ``loss.backward()`` fills the ``grad`` of what requires it: the PO
    lens's coefficients, the scene's tensors and ``cam_to_world`` (and
    ``cam_to_world_end``).  The forward trace takes its differentiable
    route, the splat geometry (K3, K5, K6 or the decomposed projection,
    and the occlusion probe) runs without a gradient, and the value chain
    carries the gradient through K2 and K4 on every route and to every
    gaussian AOV (:func:`~pota_tpu_torch.render.splat.splat_frame`).
    Without it the frame runs under ``torch.no_grad()``."""
    from .splat import resolve_imager, splat_frame

    check_supported(cfg, rc, po_lens=po_lens)
    dev = scene.device
    cam_to_world = cam_to_world.to(dev, torch.float32)
    if cam_to_world_end is not None:
        cam_to_world_end = cam_to_world_end.to(dev, torch.float32)
    with torch.enable_grad() if differentiable else torch.no_grad():
        stream = render_sample_stream(cfg, rc, scene, cam_to_world, seed,
                                      po_lens=po_lens, po_state=po_state,
                                      ops=ops, bokeh_cdf=bokeh_cdf,
                                      cam_to_world_end=cam_to_world_end,
                                      differentiable=differentiable)
        if not rc.enable_redistribution:
            return resolve_gaussian(rc, stream), {}
        fb = splat_frame(cfg, rc, scene, stream, cam_to_world,
                         po_lens=po_lens, po_state=po_state, aovs=aovs,
                         bokeh_cdf=bokeh_cdf,
                         n_crypto_ids=(scene.n_objects if rc.enable_id_matte
                                       else 0),
                         cam_to_world_end=cam_to_world_end, ops=ops,
                         differentiable=differentiable)
        return resolve_imager(rc, fb), fb


def look_at(eye, target, up=(0.0, 1.0, 0.0), device=None) -> torch.Tensor:
    """Camera -> world matrix for a camera looking down -z, on ``device``
    (default: the card)."""
    device = resolve_device(device)
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = -fwd
    m[:3, 3] = eye
    return torch.as_tensor(m, device=device)
