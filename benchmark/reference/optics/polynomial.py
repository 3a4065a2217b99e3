"""Sparse polynomial light-field transforms (port of
:mod:`pota_tpu.optics.polynomial`).

A fitted lens is an ``nn.Module`` whose exponent, coefficient and input
conditioning tensors are buffers, so ``lens.to(device)`` moves the whole
fit; a gradient step sets ``requires_grad`` on the ``coeffs`` buffers.  The
Newton solvers take their Jacobians by forward mode (``torch.func.jvp``),
the counterpart of JAX's ``jax.linearize``; the ``where`` guards have zero
tangents on their clamped branches as in JAX.  :func:`pt_sample_aperture`
differentiates by the implicit function theorem, as JAX's
``lax.custom_root`` does (:class:`_ApertureSolve`);
:func:`lt_sample_aperture` gives forward values only (the decomposed
splat's solve, which no differentiable route of the port takes).

Inputs follow the reference chart: [x, y, dx, dy, lambda_um] in mm at the
unshifted sensor plane.
"""
from __future__ import annotations

import torch
from torch import nn

from . import geometry as geo


class PolyFunction(nn.Module):
    """One fitted polynomial map R^5 -> R^O with a shared sparse term set:
    ``exponents`` [T, 5], ``coeffs`` [O, T], conditioning
    ``(x - in_shift) * in_scale``."""

    def __init__(self, exponents, coeffs, in_scale, in_shift,
                 max_degree: int | None = None):
        super().__init__()
        exps = torch.as_tensor(exponents).to(torch.int64)
        self.register_buffer("exponents", exps)
        self.register_buffer(
            "coeffs", torch.as_tensor(coeffs).to(torch.float32))
        self.register_buffer(
            "in_scale", torch.as_tensor(in_scale).to(torch.float32))
        self.register_buffer(
            "in_shift", torch.as_tensor(in_shift).to(torch.float32))
        self.max_degree = (int(exps.max()) if max_degree is None
                           else int(max_degree))


def monomial_basis(exponents, x, max_degree: int):
    """Monomials [..., T] for conditioned inputs x [..., 5].

    Powers are built by repeated multiplication and the factors multiplied
    in variable order, as the JAX basis does (a factor of 1 for a zero
    exponent changes no bits)."""
    ones = torch.ones_like(x[..., 0])
    mono = None
    for v in range(5):
        powers = [ones, x[..., v]]
        for _ in range(2, max_degree + 1):
            powers.append(powers[-1] * x[..., v])
        table = torch.stack(powers, -1)                    # [..., D+1]
        f = table.index_select(-1, exponents[:, v])         # [..., T]
        mono = f if mono is None else mono * f
    return mono


def poly_eval(fn: PolyFunction, x5, coeffs=None):
    """Evaluate the sparse polynomial at ``x5`` [..., 5] -> [..., O], with
    ``coeffs`` [O, T] in place of ``fn.coeffs`` when given."""
    x = (x5 - fn.in_shift) * fn.in_scale
    mono = monomial_basis(fn.exponents, x, fn.max_degree)
    return mono @ (fn.coeffs if coeffs is None else coeffs).T


LENS_CONSTANTS = (
    "lens_length", "back_focal_length", "efl", "aperture_z",
    "aperture_housing_radius", "inner_pupil_radius", "outer_pupil_radius",
    "inner_pupil_curvature_radius", "outer_pupil_curvature_radius", "fov",
    "fstop", "aperture_radius_at_fstop",
)


class PolyLens(nn.Module):
    """A fitted lens: ``pt`` (sensor -> outer-pupil chart + transmittance)
    and ``ap`` (sensor -> iris plane) maps plus the scalar constants of the
    reference's generated headers (python floats)."""

    def __init__(self, pt: PolyFunction, ap: PolyFunction, *,
                 lens_length, back_focal_length, efl, aperture_z,
                 aperture_housing_radius, inner_pupil_radius,
                 outer_pupil_radius, inner_pupil_curvature_radius,
                 outer_pupil_curvature_radius, fov, fstop,
                 aperture_radius_at_fstop, name: str = "unnamed",
                 outer_chart: str = "sphere", inner_chart: str = "sphere"):
        super().__init__()
        self.pt = pt
        self.ap = ap
        self.lens_length = float(lens_length)
        self.back_focal_length = float(back_focal_length)
        self.efl = float(efl)
        self.aperture_z = float(aperture_z)
        self.aperture_housing_radius = float(aperture_housing_radius)
        self.inner_pupil_radius = float(inner_pupil_radius)
        self.outer_pupil_radius = float(outer_pupil_radius)
        self.inner_pupil_curvature_radius = float(inner_pupil_curvature_radius)
        self.outer_pupil_curvature_radius = float(outer_pupil_curvature_radius)
        self.fov = float(fov)
        self.fstop = float(fstop)
        self.aperture_radius_at_fstop = float(aperture_radius_at_fstop)
        self.name = str(name)
        for chart in (outer_chart, inner_chart):
            if chart not in geo.CHARTS:
                raise ValueError(f"unknown pupil chart {chart!r}")
        self.outer_chart = str(outer_chart)
        self.inner_chart = str(inner_chart)

    @property
    def device(self) -> torch.device:
        return self.pt.coeffs.device


# ------------------------------------------------------------------ pt_evaluate


def pt_evaluate(lens: PolyLens, sensor5):
    """Sensor light field -> (out4 chart, transmittance >= 0)."""
    out = poly_eval(lens.pt, sensor5)
    return out[..., :4], torch.clamp(out[..., 4], min=0.0)


def aperture_xy(lens: PolyLens, sensor5):
    """Sensor light field -> hit position on the iris plane [..., 2]."""
    return poly_eval(lens.ap, sensor5)


# ------------------------------------------------------------ Newton machinery


def _batched_jacobian(res_fn, s, n_unknowns: int):
    """Residual [..., n_res] and Jacobian [..., n_res, n_unknowns] by one
    forward-mode tangent per unknown."""
    cols = []
    r = None
    for i in range(n_unknowns):
        tangent = torch.zeros_like(s)
        tangent[..., i] = 1.0
        r, col = torch.func.jvp(res_fn, (s,), (tangent,))
        cols.append(col)
    return r, torch.stack(cols, -1)


def _solve2(a, b, c, d, r0, r1):
    """Closed-form 2x2 solve [[a, b], [c, d]] x = r."""
    det = a * d - b * c
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    return (d * r0 - b * r1) / det, (-c * r0 + a * r1) / det


def _solve4_blocked(jac, r):
    """Closed-form batched 4x4 solve by the Schur complement of the leading
    2x2 block."""
    a, b = jac[..., 0, 0], jac[..., 0, 1]
    c, d = jac[..., 1, 0], jac[..., 1, 1]
    B = jac[..., :2, 2:]
    C = jac[..., 2:, :2]
    D = jac[..., 2:, 2:]
    detA = a * d - b * c
    detA = torch.where(torch.abs(detA) < 1e-12, 1e-12, detA)
    inv = 1.0 / detA
    i00, i01 = d * inv, -b * inv
    i10, i11 = -c * inv, a * inv

    # A^{-1} B
    ab = [[i00 * B[..., 0, j] + i01 * B[..., 1, j] for j in range(2)],
          [i10 * B[..., 0, j] + i11 * B[..., 1, j] for j in range(2)]]
    # Schur complement S = D - C A^{-1} B
    S = [[D[..., i, j] - (C[..., i, 0] * ab[0][j] + C[..., i, 1] * ab[1][j])
          for j in range(2)] for i in range(2)]
    av0 = i00 * r[..., 0] + i01 * r[..., 1]
    av1 = i10 * r[..., 0] + i11 * r[..., 1]
    rh0 = r[..., 2] - (C[..., 0, 0] * av0 + C[..., 0, 1] * av1)
    rh1 = r[..., 3] - (C[..., 1, 0] * av0 + C[..., 1, 1] * av1)
    x2, x3 = _solve2(S[0][0], S[0][1], S[1][0], S[1][1], rh0, rh1)
    t0 = r[..., 0] - (B[..., 0, 0] * x2 + B[..., 0, 1] * x3)
    t1 = r[..., 1] - (B[..., 1, 0] * x2 + B[..., 1, 1] * x3)
    return torch.stack(
        [i00 * t0 + i01 * t1, i10 * t0 + i11 * t1, x2, x3], -1)


# ----------------------------------------------------------- pt_sample_aperture


def _ap_residual(fn: PolyFunction, coeffs, sensor5, ap_target):
    """The iris-hit residual of the sensor directions d [..., 2]: the
    aperture polynomial (``coeffs`` in place of ``fn.coeffs``) at (x, y,
    d, lambda) of ``sensor5``, less ``ap_target``."""
    x, y, lam = sensor5[..., 0], sensor5[..., 1], sensor5[..., 4]

    def residual(d):
        s = torch.stack([x, y, d[..., 0], d[..., 1], lam], -1)
        return poly_eval(fn, s, coeffs) - ap_target
    return residual


def aperture_solve_vjp(fn: PolyFunction, coeffs, sensor5, ap_target, d, g,
                       want) -> list:
    """The implicit-function VJP of the aperture solve at its solution
    ``d`` [..., 2] for the cotangent ``g`` [..., 2] (JAX's ``custom_root``
    rule): ``J^T l = g`` with J = dr/dd (:func:`_ap_residual`, the
    closed-form 2x2 solve and its determinant floor), then ``-(dr/dtheta)^T
    l`` for theta = (sensor5, ap_target, coeffs), by one
    ``torch.autograd.grad`` of the residual.  Returns the three cotangents,
    None where ``want`` (three bools) is false."""
    with torch.no_grad():
        _, jac = _batched_jacobian(
            _ap_residual(fn, coeffs, sensor5, ap_target), d, 2)
        # J^T l = g
        l0, l1 = _solve2(jac[..., 0, 0], jac[..., 1, 0], jac[..., 0, 1],
                         jac[..., 1, 1], g[..., 0], g[..., 1])
    if not any(want):
        return [None, None, None]
    with torch.enable_grad():
        theta = [t.detach().requires_grad_(bool(w))
                 for t, w in zip((sensor5, ap_target, coeffs), want)]
        r = _ap_residual(fn, theta[2], theta[0], theta[1])(d.detach())
        got = iter(torch.autograd.grad(
            r, [t for t, w in zip(theta, want) if w],
            grad_outputs=-torch.stack([l0, l1], -1)))
    return [next(got) if w else None for w in want]


class _ApertureSolve(torch.autograd.Function):
    """The sensor directions d [..., 2] solving the iris-hit residual
    (:func:`_ap_residual`) = 0, with implicit-function gradients (JAX's
    ``lax.custom_root`` with ``_linear_solve_from_fn``,
    ``pota_tpu/optics/polynomial.py:256-324``).

    Forward: the fixed-iteration 2x2 Newton from the straight line to the
    target, without a graph.  Backward: at the solution d*, solve the
    transposed system ``J^T l = g`` (J = dr/dd, the same closed-form 2x2
    solve and determinant floor) and return ``-(dr/dtheta)^T l`` for the
    inputs theta = (sensor5, ap_target, coeffs)
    (:func:`aperture_solve_vjp`).  Forward mode (``jvp``, for
    ``torch.func.jvp``): at d*, ``dd = -J^-1 (dr/dtheta . t)``, the
    residual's tangent by one ``torch.func.jvp`` and the same 2x2 solve, as
    JAX's ``jax.jvp`` through ``lax.custom_root`` gives it.  (The Newton's
    own Jacobians are forward-mode, so ``torch.autograd.forward_ad`` dual
    tensors, which torch does not nest, are refused.)  The coefficients come in as an
    argument, not read from ``fn`` (a buffer), so that they get their
    gradient; the start point gets none, as in JAX."""

    @staticmethod
    def forward(sensor5, ap_target, coeffs, fn, aperture_z, iterations):
        x, y = sensor5[..., 0], sensor5[..., 1]
        residual = _ap_residual(fn, coeffs, sensor5, ap_target)
        # init: straight line to the aperture point
        d = torch.stack([(ap_target[..., 0] - x) / aperture_z,
                         (ap_target[..., 1] - y) / aperture_z], -1)
        for _ in range(iterations):
            r, jac = _batched_jacobian(residual, d, 2)
            d0, d1 = _solve2(jac[..., 0, 0], jac[..., 0, 1], jac[..., 1, 0],
                             jac[..., 1, 1], r[..., 0], r[..., 1])
            d = d - torch.stack([d0, d1], -1)
        return d

    @staticmethod
    def setup_context(ctx, inputs, output):
        sensor5, ap_target, coeffs, fn, _, _ = inputs
        ctx.save_for_backward(sensor5, ap_target, coeffs, output)
        ctx.save_for_forward(sensor5, ap_target, coeffs, output)
        ctx.fn = fn

    @staticmethod
    def backward(ctx, g):
        sensor5, ap_target, coeffs, d = ctx.saved_tensors
        grads = aperture_solve_vjp(ctx.fn, coeffs, sensor5, ap_target, d, g,
                                   ctx.needs_input_grad[:3])
        return (*grads, None, None, None)

    @staticmethod
    def jvp(ctx, t_sensor5, t_ap_target, t_coeffs, *_):
        sensor5, ap_target, coeffs, d = ctx.saved_tensors
        fn = ctx.fn
        _, jac = _batched_jacobian(
            _ap_residual(fn, coeffs, sensor5, ap_target), d, 2)
        theta = (sensor5, ap_target, coeffs)
        tangents = tuple(torch.zeros_like(v) if t is None else t
                         for v, t in zip(theta, (t_sensor5, t_ap_target,
                                                 t_coeffs)))
        # the residual's tangent at d* with d held: dr/dtheta . t
        _, rt = torch.func.jvp(
            lambda s5, a, c: _ap_residual(fn, c, s5, a)(d), theta, tangents)
        # J dd = -rt
        d0, d1 = _solve2(jac[..., 0, 0], jac[..., 0, 1], jac[..., 1, 0],
                         jac[..., 1, 1], -rt[..., 0], -rt[..., 1])
        return torch.stack([d0, d1], -1)


def pt_sample_aperture(lens: PolyLens, sensor5, ap_target,
                       iterations: int = 3):
    """Solve the sensor directions (dx, dy) so the ray hits ``ap_target`` on
    the iris: a fixed-iteration 2x2 Newton on the aperture polynomial,
    differentiable by the implicit function theorem with respect to
    ``sensor5``, ``ap_target`` and ``lens.ap.coeffs``
    (:class:`_ApertureSolve`).  Returns the updated sensor light field."""
    d = _ApertureSolve.apply(sensor5, ap_target, lens.ap.coeffs, lens.ap,
                             lens.aperture_z, iterations)
    return torch.cat([sensor5[..., :2], d, sensor5[..., 4:5]], -1)


# ----------------------------------------------------------- lt_sample_aperture


def _chart_to_cs(lens: PolyLens, out4):
    R = lens.outer_pupil_curvature_radius
    return geo.chart_to_cs(out4[..., :2], out4[..., 2:4], -R, R,
                           lens.outer_chart)


def lt_sample_aperture(lens: PolyLens, scene_point, ap_point, lam,
                       iterations: int = 5):
    """Solve the sensor light field for a (scene point, aperture point) pair
    by a fixed-iteration 4x4 Newton over (x, y, dx, dy).

    ``scene_point`` [..., 3] is in lens space mm (+z toward the scene),
    ``ap_point`` [..., 2] the iris target (mm), ``lam`` the wavelength (um).
    The chief-ray guess floors |z| at 1e-6, as the backward kernels do
    (``po_pallas.py:387-391``); JAX's pure solver divides by z unguarded,
    which differs only for targets at |z| < 1e-6.  The solve runs in
    ``scene_point``'s dtype (float64 for a reference solve), ``lam``
    included.
    Returns (sensor5, out4, transmittance >= 0 cropped by the outer
    pupil)."""
    shape = scene_point.shape[:-1]
    lam_b = torch.as_tensor(lam, dtype=scene_point.dtype,
                            device=scene_point.device).expand(shape)
    ap_b = ap_point.expand(shape + (2,))
    front_z = lens.back_focal_length + lens.lens_length

    def residual(s4):
        s = torch.cat([s4, lam_b[..., None]], -1)
        ap = poly_eval(lens.ap, s) - ap_b
        out = poly_eval(lens.pt, s)
        pos, direction = _chart_to_cs(lens, out[..., :4])
        dz = torch.where(torch.abs(direction[..., 2]) < 1e-9, 1e-9,
                         direction[..., 2])
        t = (scene_point[..., 2] - (pos[..., 2] + front_z)) / dz
        hit_xy = pos[..., :2] + t[..., None] * direction[..., :2]
        return torch.cat([ap, hit_xy - scene_point[..., :2]], -1)

    # chief-ray estimate through the lens center
    pz = scene_point[..., 2]
    pz = torch.where(torch.abs(pz) < 1e-6, 1e-6, pz)
    x0 = -scene_point[..., 0] * lens.back_focal_length / pz
    y0 = -scene_point[..., 1] * lens.back_focal_length / pz
    s4 = torch.stack([x0, y0, (ap_b[..., 0] - x0) / lens.aperture_z,
                      (ap_b[..., 1] - y0) / lens.aperture_z], -1)
    for _ in range(iterations):
        r, jac = _batched_jacobian(residual, s4, 4)
        s4 = s4 - _solve4_blocked(jac, r)
    sensor5 = torch.cat([s4, lam_b[..., None]], -1)

    out4, trans = pt_evaluate(lens, sensor5)
    r2 = out4[..., 0] ** 2 + out4[..., 1] ** 2
    trans = torch.where(r2 > lens.outer_pupil_radius ** 2, 0.0, trans)
    return sensor5, out4, trans


def inner_pupil_ok(lens: PolyLens, sensor5):
    """Crop at the inward-facing pupil (ref src/lentil.h:369-374, 640-645)."""
    px = sensor5[..., 0] + sensor5[..., 2] * lens.back_focal_length
    py = sensor5[..., 1] + sensor5[..., 3] * lens.back_focal_length
    return px * px + py * py <= lens.inner_pupil_radius ** 2
