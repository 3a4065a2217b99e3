"""Polynomial fitting of lenses, and loading and saving fits (port of
:mod:`pota_tpu.optics.fit`).

The reference's offline codegen (the sibling repo ``polynomial-optics``,
which produced the per-lens ``pt_evaluate.h`` headers) becomes a fit: sample
the 5-D sensor light field, trace each ray through the element stack
(:func:`pota_tpu_torch.optics.raytrace.trace_to_chart`, float32 on the
device), and least-squares fit degree-truncated polynomials for the
outer-pupil chart, the transmittance and the sensor->iris map (float64 on
the device).  Inputs are conditioned to about [-1, 1] before the solve.

Fits are npz files in :mod:`pota_tpu.optics.fit`'s format, so either
package reads the other's.  The committed fits in ``data/lenses/`` are read
first; fits made here are cached under :data:`FIT_CACHE_DIR`
(``pota_tpu_torch/build/lens_fits/``), never in ``data/lenses/``.
"""
from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from .. import resolve_device
from .polynomial import LENS_CONSTANTS, PolyFunction, PolyLens
from .raytrace import LensSystem, trace_to_chart

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS_DIR = os.path.join(os.path.dirname(_PKG_DIR), "data", "lenses")
# where get_or_fit_lens writes the fits it makes (ignored by git)
FIT_CACHE_DIR = os.path.join(_PKG_DIR, "build", "lens_fits")


def monomial_exponents(degree: int, nvars: int = 5) -> np.ndarray:
    """All exponent tuples with total degree <= degree, ordered by degree
    and then lexicographically (int32 [T, nvars])."""
    exps = [e for e in itertools.product(range(degree + 1), repeat=nvars)
            if sum(e) <= degree]
    exps.sort(key=lambda e: (sum(e), e))
    return np.asarray(exps, np.int32)


def _design_matrix(x: torch.Tensor, exps: np.ndarray) -> torch.Tensor:
    """[N, 5] inputs, [T, 5] exponents -> [N, T] monomials in float64 on
    ``x``'s device."""
    x = x.to(torch.float64)
    max_deg = int(exps.max())
    powers = [torch.ones_like(x)]
    for _ in range(max_deg):
        powers.append(powers[-1] * x)
    powers = torch.stack(powers, -1)                       # [N, 5, D + 1]
    e = torch.as_tensor(exps, dtype=torch.int64, device=x.device)
    out = None
    for v in range(5):
        f = powers[:, v, :].index_select(1, e[:, v])       # [N, T]
        out = f if out is None else out * f
    return out


def sample_fit_domain(lens: LensSystem, n: int, seed: int = 0,
                      sensor_extent: float | None = None):
    """Draw training sensor light-field samples [n, 5] (numpy float32; the
    draws of JAX's ``sample_fit_domain``).  Returns (samples, sensor
    extent, direction extent)."""
    rng = np.random.default_rng(seed)
    r_sensor = sensor_extent or 25.0  # covers a 36 mm sensor's diagonal
    d_max = (lens.inner_pupil_radius + r_sensor) / lens.back_focal_length
    x = rng.uniform(-r_sensor, r_sensor, n)
    y = rng.uniform(-r_sensor, r_sensor, n)
    # aim the directions at the rear element's clear aperture (with a
    # margin): many more training rays pass than with blind slopes
    phi = rng.uniform(0.0, 2 * np.pi, n)
    rr = lens.inner_pupil_radius * 1.15 * np.sqrt(rng.uniform(0.0, 1.0, n))
    tx = rr * np.cos(phi)
    ty = rr * np.sin(phi)
    dx = (tx - x) / lens.back_focal_length
    dy = (ty - y) / lens.back_focal_length
    lam = rng.uniform(0.38, 0.78, n)
    return (np.stack([x, y, dx, dy, lam], -1).astype(np.float32), r_sensor,
            d_max)


def _condition(r_sensor: float, d_max: float):
    scale = np.array([1.0 / r_sensor, 1.0 / r_sensor, 1.0 / d_max,
                      1.0 / d_max, 5.0], np.float32)
    shift = np.array([0.0, 0.0, 0.0, 0.0, 0.55], np.float32)
    return scale, shift


def lstsq(a: torch.Tensor, b: torch.Tensor, rcond: float | None = None):
    """Minimum-norm least squares of ``a x = b`` in ``a``'s dtype on its
    device: a reduced QR of ``a`` (``torch.linalg.qr``), then the SVD of
    the [T, T] triangle, whose singular values below ``rcond`` times the
    largest are dropped (default ``eps * max(M, N)``, numpy's
    ``lstsq(rcond=None)``, LAPACK ``gelsd``).  One solver on every device:
    on CUDA ``torch.linalg.lstsq`` offers only ``gels``, which assumes full
    rank.  Returns (x [T, K], singular values [T], rank)."""
    m, n = a.shape
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    q, r = torch.linalg.qr(a)
    u, s, vh = torch.linalg.svd(r)
    keep = s > rcond * s[0]
    qtb = q.T @ b
    x = vh.T[:, keep] @ ((u.T[keep] @ qtb) / s[keep, None])
    return x, s, int(keep.sum())


def _select_terms(exps, coefs_list, design, keep: int):
    """Prune to the ``keep`` most important terms (shared across outputs):
    each output's |coefficient| times its monomial's rms, normalized per
    output and summed; the constant term always stays.  ``design`` is a
    float64 tensor, the coefficients numpy float64."""
    t = design.shape[1]
    if keep >= t:
        return np.arange(t)
    mono_rms = torch.sqrt((design ** 2).mean(0)).cpu().numpy()
    score = np.zeros(t)
    for c in coefs_list:
        contrib = np.abs(c) * mono_rms
        score += contrib / max(contrib.max(), 1e-30)
    score[0] = np.inf
    return np.sort(np.argsort(-score)[:keep])


def fit_lens(lens: LensSystem, degree: int = 5, n_samples: int = 200_000,
             max_terms: int = 160, seed: int = 0,
             return_diagnostics: bool = False, device=None):
    """Fit a :class:`PolyLens` to an element stack, on ``device`` (default:
    the card; the lens is moved there).

    The samples are JAX's draws; the trace runs in float32, the design
    matrix and the least squares (:func:`lstsq`) in float64.  Returns the
    fitted lens on ``device``, and with ``return_diagnostics`` also JAX's
    diagnostics dict (rms errors per output on the held-out tenth of the
    samples, in mm / slope units, the valid fraction and the term count)
    plus ``min_singular`` / ``max_singular`` / ``rank`` of the valid rays'
    design before pruning."""
    device = resolve_device(device)
    lens = lens.to(device)
    samples, r_sensor, d_max = sample_fit_domain(lens, n_samples, seed)
    s = torch.as_tensor(samples, device=device)
    with torch.no_grad():
        out, trans, ap_xy, valid = trace_to_chart(lens, s)
    scale, shift = _condition(r_sensor, d_max)
    xs = (s - torch.as_tensor(shift, device=device)) * torch.as_tensor(
        scale, device=device)

    exps = monomial_exponents(degree)
    n_train = int(0.9 * n_samples)
    a_all = _design_matrix(xs[:n_train], exps)
    a_test = _design_matrix(xs[n_train:], exps)
    v_train, v_test = valid[:n_train], valid[n_train:]
    f64 = lambda t: t.to(torch.float64)

    # geometry outputs fit on valid rays only; transmittance on all rays
    geo = f64(torch.cat([out, ap_xy], -1))
    geo_train = geo[:n_train][v_train]
    trans_train = torch.where(v_train, f64(trans[:n_train]), 0.0)[:, None]
    a_valid = a_all[v_train]
    coefs_geo, sing, rank = lstsq(a_valid, geo_train)          # [T, 6]
    coef_trans, _, _ = lstsq(a_all, trans_train)

    sel = _select_terms(
        exps,
        [coefs_geo[:, i].cpu().numpy() for i in range(6)]
        + [coef_trans[:, 0].cpu().numpy()],
        a_valid, max_terms)
    exps_s = exps[sel]
    sel_t = torch.as_tensor(sel, dtype=torch.int64, device=device)
    a_s = a_all.index_select(1, sel_t)
    coefs_geo, _, _ = lstsq(a_s[v_train], geo_train)
    coef_trans, _, _ = lstsq(a_s, trans_train)

    # diagnostics on the held-out valid rays
    a_t = a_test.index_select(1, sel_t)
    pred_geo = a_t[v_test] @ coefs_geo
    rms = torch.sqrt(((pred_geo - geo[n_train:][v_test]) ** 2).mean(0))
    rms = rms.cpu().numpy()
    # JAX's "rms_trans" takes the square root before the mean: it is the
    # mean absolute error, kept as such so the two dicts compare
    trans_rms = float(torch.abs(
        (a_t @ coef_trans)[:, 0]
        - torch.where(v_test, f64(trans[n_train:]), 0.0)).mean())

    coefs_geo = coefs_geo.cpu().numpy()
    coef_trans = coef_trans.cpu().numpy()
    cond = {"exponents": exps_s, "in_scale": scale, "in_shift": shift}
    # the lens system's constants, and the fit wide open at its housing
    constants = {k: getattr(lens, k) for k in LENS_CONSTANTS + (
        "name", "outer_chart", "inner_chart") if hasattr(lens, k)}
    constants["fstop"] = lens.efl / (2.0 * lens.aperture_housing_radius)
    constants["aperture_radius_at_fstop"] = lens.aperture_housing_radius
    poly = poly_lens_from_numpy(
        {"coeffs": np.concatenate([coefs_geo[:, :4], coef_trans],
                                  -1).T.astype(np.float32), **cond},
        {"coeffs": coefs_geo[:, 4:6].T.astype(np.float32), **cond},
        constants, device=device)
    if not return_diagnostics:
        return poly
    diag = {
        "rms_out_x": float(rms[0]), "rms_out_y": float(rms[1]),
        "rms_out_dx": float(rms[2]), "rms_out_dy": float(rms[3]),
        "rms_ap_x": float(rms[4]), "rms_ap_y": float(rms[5]),
        "rms_trans": trans_rms,
        "valid_frac": float(valid.double().mean()),
        "n_terms": int(len(sel)),
        "min_singular": float(sing[-1]),
        "max_singular": float(sing[0]),
        "rank": rank,
    }
    return poly, diag


def _fit_path(directory: str, name: str, degree: int) -> str:
    return os.path.join(directory, f"{name}__deg{degree}.npz")


def poly_lens_from_numpy(pt: dict, ap: dict, constants: dict,
                         device=None) -> PolyLens:
    """Build the port's lens from numpy arrays.

    ``pt`` and ``ap`` each hold ``exponents`` [T, 5], ``coeffs`` [O, T],
    ``in_scale`` [5] and ``in_shift`` [5] (a JAX ``PolyFunction``'s fields as
    numpy); ``constants`` holds the scalar fields of :data:`LENS_CONSTANTS`
    plus optional ``name``, ``outer_chart`` and ``inner_chart``.  The lens
    is built on ``device`` (default: the card).
    """
    def mk(f):
        return PolyFunction(
            exponents=np.array(f["exponents"], np.int64),
            coeffs=np.array(f["coeffs"], np.float32),
            in_scale=np.array(f["in_scale"], np.float32),
            in_shift=np.array(f["in_shift"], np.float32),
        )

    extra = {k: constants[k] for k in ("name", "outer_chart", "inner_chart")
             if k in constants}
    lens = PolyLens(mk(pt), mk(ap),
                    **{k: float(constants[k]) for k in LENS_CONSTANTS},
                    **extra)
    return lens.to(resolve_device(device))


def load_poly_lens(name: str, degree: int = 5, path: str | None = None,
                   device=None) -> PolyLens | None:
    """Load a fit (the ``pota_tpu.optics.fit`` npz format) onto ``device``
    (default: the card) from ``path``, by default the committed
    ``data/lenses/<name>__deg<degree>.npz``, or None when the file does not
    exist."""
    device = resolve_device(device)
    path = path or _fit_path(LENS_DIR, name, degree)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        c = z["constants"]
        cond = {"in_scale": z["in_scale"], "in_shift": z["in_shift"]}
        constants = dict(zip(LENS_CONSTANTS, (float(v) for v in c)))
        constants["name"] = str(z["name"])
        # fits saved before the cylinder charts carry no charts: sphere
        if "charts" in z.files:
            constants["outer_chart"] = str(z["charts"][0])
            constants["inner_chart"] = str(z["charts"][1])
        return poly_lens_from_numpy(
            {"exponents": z["pt_exponents"], "coeffs": z["pt_coeffs"], **cond},
            {"exponents": z["ap_exponents"], "coeffs": z["ap_coeffs"], **cond},
            constants, device=device,
        )


def save_poly_lens(poly: PolyLens, degree: int, path: str | None = None):
    """Write ``poly`` in :mod:`pota_tpu.optics.fit`'s npz format (the same
    keys and dtypes: int64 exponents, float32 coefficients and conditioning,
    float64 constants, the name and ``charts``) to ``path``, by default
    ``FIT_CACHE_DIR/<name>__deg<degree>.npz``.  Returns the path."""
    if path is None:
        os.makedirs(FIT_CACHE_DIR, exist_ok=True)
        path = _fit_path(FIT_CACHE_DIR, poly.name, degree)
    np_ = lambda t: t.detach().cpu().numpy()
    np.savez_compressed(
        path,
        pt_exponents=np_(poly.pt.exponents),
        pt_coeffs=np_(poly.pt.coeffs),
        ap_exponents=np_(poly.ap.exponents),
        ap_coeffs=np_(poly.ap.coeffs),
        in_scale=np_(poly.pt.in_scale),
        in_shift=np_(poly.pt.in_shift),
        constants=np.asarray([getattr(poly, k) for k in LENS_CONSTANTS]),
        name=np.asarray(poly.name),
        charts=np.asarray([poly.outer_chart, poly.inner_chart]),
    )
    return path


def get_or_fit_lens(name: str, degree: int = 5, device=None, **fit_kwargs):
    """A catalog lens's fit on ``device`` (default: the card): the committed
    fit in ``data/lenses/`` if there is one, else one cached in
    :data:`FIT_CACHE_DIR`, else a new fit (:func:`fit_lens` with
    ``fit_kwargs``) saved there.  Nothing is written to ``data/lenses/``."""
    device = resolve_device(device)
    poly = load_poly_lens(name, degree, device=device)
    if poly is None:
        poly = load_poly_lens(name, degree, device=device,
                              path=_fit_path(FIT_CACHE_DIR, name, degree))
    if poly is not None:
        return poly
    from ..lens.database import get_lens_system

    lens = get_lens_system(name, device=device)
    poly = fit_lens(lens, degree=degree, device=device, **fit_kwargs)
    save_poly_lens(poly, degree)
    return poly
