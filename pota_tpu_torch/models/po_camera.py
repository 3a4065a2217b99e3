"""Polynomial-optics forward camera (port of
:mod:`pota_tpu.models.po_camera`).

The reference's vignetting-retry loop becomes K = ``vignetting_retries + 1``
candidate aperture samples per ray, traced by the PO forward kernel, then a
first-success select.  :func:`trace_fw_po` picks one route from the
configuration alone, on every device:

* depth of field on, no image bokeh, not the deriv ray: K1's select mode
  (``ops.po_kernels.po_forward_selected``: K1 draws each ray's candidates,
  selects the first that passes the pupil crops and hands back the ray), or
  ``ops.po_kernels.SelectFn`` when differentiable (K1v's select mode for the
  backward);
* the image bokeh: the CDF's candidates drawn in torch and handed to K1's
  candidate mode (``ops.po_kernels.po_forward``, or ``ForwardFn`` when
  differentiable), then selected in torch (:func:`select_rays`);
* the deriv ray, or no depth of field: the torch term trace.

The differentiable routes give the gradient JAX takes through its pure path
(``use_pallas=False``).  The device decides only inside the kernel wrappers
(the plain version on the CPU, the kernel on the card) and the autograd
functions, whose forward on the CPU traces the fit's term set (JAX's rounding,
to which the CPU tests hold it).  The ray differentials take K1j on the card
(:func:`trace_fw_po_jvp`: K1's function and its Jacobian in the sensor point,
one launch) and, on the CPU and without depth of field, the deriv ray's torch
trace (``trace_fw_po(deriv_ray=True)``, ``_ApertureSolve``), which
``torch.func.jvp`` differentiates.
"""
from __future__ import annotations

import torch

from ..config import CameraConfig

from ..ops.po_kernels import (
    ForwardFn,
    SelectFn,
    aperture_sample,
    candidate_rays,
    chart_rays,
    select_rays,
)
from ..optics.polynomial import (
    PolyLens,
    pt_evaluate,
    pt_sample_aperture,
)
from ..utils import rng as prng


def po_sample_aperture_disk(cfg: CameraConfig, r1, r2, bokeh_cdf=None):
    """PO aperture sampler: image bokeh (the CDF inversion), the plain
    concentric disk, or the blade fan (ref src/lentil.h:312-324).  The PO
    path takes no spherical-aberration bias or squircle: those are
    thin-lens controls."""
    if cfg.bokeh_enable_image and bokeh_cdf is not None:
        from ..render.bokeh_image import bokeh_sample
        return bokeh_sample(bokeh_cdf, r1, r2)
    return aperture_sample(r1, r2, cfg.aperture_blades)


def trace_fw_po(cfg: CameraConfig, lens: PolyLens, sx, sy, r1, r2,
                retry_key, po_state, newton_iterations: int = 3, ops=None,
                bokeh_cdf=None, differentiable: bool = False,
                deriv_ray: bool = False):
    """Forward PO trace, batched over rays [N].  ``bokeh_cdf`` is the image
    bokeh's :class:`~pota_tpu_torch.render.bokeh_image.BokehImage`.

    Returns (origin [N, 3], dir [N, 3], weight [N], tries [N]) scaled to
    scene units, camera looking down -z.  ``ops`` selects the kernel set
    (default: the kernel wrappers, :data:`pota_tpu_torch.ops.KERNELS`).
    With depth of field K1 draws the [N, K] candidates, selects each ray's
    and returns the rays (``ops.po_forward_selected``); the image bokeh's
    are drawn in torch from its CDF and handed to ``ops.po_forward``, and
    selected in torch (:func:`select_rays`).  ``differentiable`` traces
    the rays through :class:`~pota_tpu_torch.ops.po_kernels.SelectFn`
    (with the image bokeh ``ForwardFn``: K1 forward, K1v backward: JAX's
    gradient of its pure path, ``pota_tpu/models/po_camera.py:194-205``),
    so origin and direction carry gradients to the lens coefficients; the
    screen points take none.  ``deriv_ray``
    traces one candidate on (r1, r2), draws no retry uniforms
    (``retry_key`` may be None) and takes the torch trace
    (``pt_sample_aperture``, ``pt_evaluate``: the term trace, whatever the
    device and dtype), which ``torch.func.jvp`` differentiates (JAX's
    ``pota_tpu/models/po_camera.py:140-151``): the ray differentials' path
    on the CPU, and their float64 oracle; on the card they take
    :func:`trace_fw_po_jvp`.
    """
    if ops is None:
        from ..ops import KERNELS as ops
    aperture_radius = po_state.aperture_radius
    sensor_shift = po_state.sensor_shift
    n_tries = 1 if deriv_ray else cfg.vignetting_retries + 1
    n = sx.shape[0]
    hsw = cfg.sensor_width * 0.5
    image_bokeh = cfg.bokeh_enable_image and bokeh_cdf is not None
    if cfg.enable_dof and not image_bokeh and not deriv_ray:
        # K1 draws, traces and selects the candidates and hands back the
        # rays (its select mode)
        rays = (sx.contiguous(), sy.contiguous(), r1.contiguous(),
                r2.contiguous(),
                None if retry_key is None else retry_key.contiguous())
        draw = (n_tries, aperture_radius, cfg.aperture_blades)
        lam, scale = cfg.lambda_um, cfg.unit_scale_po
        if differentiable:
            return SelectFn.apply(*rays, lens.pt.coeffs, lens.ap.coeffs,
                                  lens, draw, lam, sensor_shift,
                                  newton_iterations, (hsw, scale), ops)
        return ops.po_forward_selected(lens, rays[0], rays[1], hsw,
                                       *rays[2:], *draw, lam, sensor_shift,
                                       scale, newton_iterations)
    x = sx * hsw
    y = sy * hsw

    if cfg.enable_dof:
        aperture = (po_sample_aperture_disk(
            cfg, *prng.retry_uniforms(r1, r2, retry_key, n_tries), bokeh_cdf)
            * aperture_radius)
    if cfg.enable_dof and deriv_ray:
        zero = torch.zeros((n, n_tries), dtype=x.dtype, device=x.device)
        sensor5 = pt_sample_aperture(
            lens, torch.stack([x[:, None] + zero, y[:, None] + zero, zero,
                               zero, zero + cfg.lambda_um], -1),
            aperture, iterations=newton_iterations)
        # move to the polynomial's sensor plane (ref src/lentil.h:349-350)
        dx, dy = sensor5[..., 2], sensor5[..., 3]
        xk = sensor5[..., 0] + dx * sensor_shift
        yk = sensor5[..., 1] + dy * sensor_shift
        out4, trans = pt_evaluate(
            lens, torch.stack([xk, yk, dx, dy, sensor5[..., 4]], -1))
    elif cfg.enable_dof:
        # the image bokeh: the CDF's candidates, drawn in torch, into K1's
        # candidate mode
        rays = candidate_rays(x, y, aperture)
        lam, its = cfg.lambda_um, newton_iterations
        if differentiable:
            out4, trans, dx, dy = ForwardFn.apply(
                *rays, lens.pt.coeffs, lens.ap.coeffs, lens, lam,
                sensor_shift, its, ops)
        else:
            out4, trans, dx, dy = ops.po_forward(lens, *rays, lam,
                                                 sensor_shift, its)
        out4 = out4.reshape(n, n_tries, 4)
        trans = trans.reshape(n, n_tries)
        dx = dx.reshape(n, n_tries)
        dy = dy.reshape(n, n_tries)
        xk = x[:, None] + dx * sensor_shift
        yk = y[:, None] + dy * sensor_shift
    else:
        # no depth of field: zero sensor directions, no aperture solve
        zero = torch.zeros((n, n_tries), dtype=x.dtype, device=x.device)
        dx = dy = zero
        xk = x[:, None] + zero
        yk = y[:, None] + zero
        out4, trans = pt_evaluate(
            lens, torch.stack([xk, yk, dx, dy, zero + cfg.lambda_um], -1))
    return select_rays(lens, out4, trans, torch.stack([xk, yk, dx, dy], -1),
                       cfg.unit_scale_po)


def trace_fw_po_jvp(cfg: CameraConfig, lens: PolyLens, sx, sy, r1, r2,
                    po_state, tangents, newton_iterations: int = 3, ops=None,
                    bokeh_cdf=None):
    """The deriv ray's differentials (one candidate on (r1, r2), no
    retries, depth of field on) by K1j: ``ops.po_forward_jvp`` once for
    K1's function and its Jacobian in the sensor point (x, y), JAX's
    ``custom_root`` tangent at the Newton's solution; then, per screen
    tangent ``(t_sx, t_sy)`` of ``tangents`` ([N] each), the chart's
    tangent ``J (t_sx, t_sy) hsw`` through
    :func:`~pota_tpu_torch.ops.po_kernels.chart_rays` by
    ``torch.func.jvp`` (the torch tail alone).  What ``torch.func.jvp`` of
    ``trace_fw_po(deriv_ray=True)`` computes, without its torch trace.
    Returns [(d origin [N, 3], d direction [N, 3])], one pair a tangent."""
    if ops is None:
        from ..ops import KERNELS as ops
    hsw = cfg.sensor_width * 0.5
    aperture = (po_sample_aperture_disk(cfg, r1[:, None], r2[:, None],
                                        bokeh_cdf)[:, 0]
                * po_state.aperture_radius)
    out4, _, _, _, jac = ops.po_forward_jvp(
        lens, (sx * hsw).contiguous(), (sy * hsw).contiguous(),
        aperture[:, 0].contiguous(), aperture[:, 1].contiguous(),
        cfg.lambda_um, po_state.sensor_shift, newton_iterations)
    out = []
    for t_sx, t_sy in tangents:
        t_out4 = (jac[..., 0] * (t_sx * hsw)[:, None]
                  + jac[..., 1] * (t_sy * hsw)[:, None])
        _, d = torch.func.jvp(lambda o: chart_rays(lens, o,
                                                   cfg.unit_scale_po),
                              (out4,), (t_out4,))
        out.append(d)
    return out
