"""Lens fitting of the port against JAX's (``pota_tpu_torch.lens``,
``optics.geometry``, ``optics.raytrace``, ``optics.fit``).

The prescriptions are a copy of JAX's database: rows exact, the lens
systems to 1e-6 relative.  The element tracer runs in float32 on both
sides: on 2,000 seeded rays of one lens of each of the 16 base designs
``valid`` agreed on every ray and the outputs to at most 3.8e-5 mm
(positions, on values up to ~40 mm), 2.5e-6 (slopes), 1.4e-5 mm (iris) and
3.1e-6 (transmittance), measured on the CPU; the limits below are about 4x
those.  The fit (the same draws; float64 design and a QR + SVD minimum-norm
solve in place of LAPACK ``gelsd``) chose the same 160 terms as JAX's on the
flagship and its held-out rms agreed to ~1e-5 relative.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pota_tpu.lens import database as jdb
from pota_tpu.optics import fit as jfit
from pota_tpu.optics import geometry as jgeo
from pota_tpu.optics import raytrace as jrt
from pota_tpu.optics.polynomial import poly_eval as jax_poly_eval

from pota_tpu_torch.lens import database as tdb
from pota_tpu_torch.optics import fit as tfit
from pota_tpu_torch.optics import geometry as tgeo
from pota_tpu_torch.optics import raytrace as trt
from pota_tpu_torch.optics.polynomial import poly_eval

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
META = ("lens_length", "back_focal_length", "efl", "aperture_z",
        "aperture_housing_radius", "inner_pupil_radius",
        "outer_pupil_radius", "inner_pupil_curvature_radius",
        "outer_pupil_curvature_radius", "fov")
STATIC = ("aperture_index", "name", "outer_chart", "inner_chart",
          "cyl_axes")
# trace_to_chart against JAX (about 4x the agreement measured on the CPU)
VALID_AGREE = 0.999
POS_TOL, DIR_TOL, AP_TOL, TRANS_TOL = 1.5e-4, 1e-5, 6e-5, 1.5e-5
# one catalog lens of each base design
BASE_LENSES = sorted({base: name for name, (base, _) in
                      sorted(tdb.CATALOG.items())}.items())


def test_database_matches_jax():
    assert tdb.lens_names() == jdb.lens_names()
    assert len(tdb.CATALOG) == 45 and len(tdb.BASE_DESIGNS) == 16
    assert tdb.CATALOG == jdb.CATALOG
    for name in list(tdb.CATALOG) + list(tdb.BASE_DESIGNS):
        np.testing.assert_array_equal(tdb.get_lens_rows(name),
                                      jdb.get_lens_rows(name))
    with pytest.raises(KeyError, match="unknown lens"):
        tdb.get_lens_rows("no_such_lens")


@pytest.mark.parametrize("name", tdb.lens_names())
def test_lens_system_matches_jax(name):
    jl = jdb.get_lens_system(name)
    tl = tdb.get_lens_system(name, device="cpu")
    for f in trt.LensSystem.ARRAY_FIELDS:
        got = getattr(tl, f)
        assert got.dtype == torch.float32, f
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jl, f)),
                                   rtol=1e-6, err_msg=f)
    for f in META:
        np.testing.assert_allclose(getattr(tl, f), getattr(jl, f),
                                   rtol=1e-6, err_msg=f)
    for f in STATIC:
        assert getattr(tl, f) == getattr(jl, f), f


def test_paraxial_and_cauchy_match_jax():
    for rows in tdb.BASE_DESIGNS.values():
        rows = np.asarray(rows)
        assert trt._paraxial_bfl_efl(rows) == jrt._paraxial_bfl_efl(rows)
    for nd, abbe in ((1.0, 0.0), (1.5168, 64.17), (1.7, 0.0), (1.6727, 32.2)):
        assert (trt._cauchy_from_nd_abbe(nd, abbe)
                == jrt._cauchy_from_nd_abbe(nd, abbe))


def test_lens_system_to():
    tl = tdb.get_lens_system(FLAGSHIP, device="cpu")
    t64 = tl.to(dtype=torch.float64)
    assert t64.vertex_z.dtype == torch.float64 and t64.efl == tl.efl
    assert t64.device.type == "cpu"
    assert tl.vertex_z.dtype == torch.float32


# ---------------------------------------------------------------- charts


def _chart_rays(chart, n=500, seed=0):
    """Points on the pupil surface of radius R (center -R) and directions
    leaving it."""
    rng = np.random.default_rng(seed)
    R = 40.0
    pos2 = rng.uniform(-15, 15, (n, 2))
    dir2 = rng.uniform(-0.4, 0.4, (n, 2))
    return R, pos2.astype(np.float32), dir2.astype(np.float32)


@pytest.mark.parametrize("chart", ["sphere", "cyl-x", "cyl-y"])
def test_cs_to_chart_round_trip(chart):
    R, pos2, dir2 = _chart_rays(chart)
    p3, d3 = tgeo.chart_to_cs(torch.as_tensor(pos2, dtype=torch.float64),
                              torch.as_tensor(dir2, dtype=torch.float64),
                              -R, R, chart)
    back_p, back_d = tgeo.cs_to_chart(p3, d3, -R, R, chart)
    np.testing.assert_allclose(back_p.numpy(), pos2, atol=1e-9)
    np.testing.assert_allclose(back_d.numpy(), dir2, atol=1e-9)


@pytest.mark.parametrize("chart", ["sphere", "cyl-x", "cyl-y"])
def test_cs_to_chart_matches_jax(chart):
    R, pos2, dir2 = _chart_rays(chart, seed=1)
    jp3, jd3 = jgeo.chart_to_cs(jnp.asarray(pos2), jnp.asarray(dir2), -R, R,
                                chart)
    jp3, jd3 = np.array(jp3), np.array(jd3)
    # perturb the directions off the chart's own output
    jd3 = jd3 + np.random.default_rng(2).normal(0, 0.05, jd3.shape).astype(
        np.float32)
    want = jgeo.cs_to_chart(jnp.asarray(jp3), jnp.asarray(jd3), -R, R, chart)
    got = tgeo.cs_to_chart(torch.as_tensor(jp3), torch.as_tensor(jd3), -R, R,
                           chart)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="unknown pupil chart"):
        tgeo.cs_to_chart(torch.as_tensor(jp3), torch.as_tensor(jd3), -R, R,
                         "torus")


def test_plane_charts_match_jax():
    rng = np.random.default_rng(3)
    pos2 = rng.uniform(-10, 10, (300, 2)).astype(np.float32)
    dir2 = rng.uniform(-0.3, 0.3, (300, 2)).astype(np.float32)
    jp, jd = jgeo.plane_to_cs(jnp.asarray(pos2), jnp.asarray(dir2), 12.5)
    tp, td = tgeo.plane_to_cs(torch.as_tensor(pos2), torch.as_tensor(dir2),
                              12.5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    want = jgeo.cs_to_plane(jp, jd, 40.0)
    got = tgeo.cs_to_plane(tp, td, 40.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(tgeo.cs_to_plane(tp, td, 12.5)[1].numpy(),
                               dir2, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- tracer


@pytest.mark.parametrize("base, name", BASE_LENSES,
                         ids=[b for b, _ in BASE_LENSES])
def test_trace_to_chart_matches_jax(base, name):
    jl = jdb.get_lens_system(name)
    tl = tdb.get_lens_system(name, device="cpu")
    s, _, _ = jfit.sample_fit_domain(jl, 2000, seed=5)
    jo, jt, ja, jv = (np.asarray(a) for a in
                      jrt.trace_to_chart(jl, jnp.asarray(s)))
    to, tt, ta, tv = (a.numpy() for a in
                      trt.trace_to_chart(tl, torch.as_tensor(s)))
    assert (jv == tv).mean() >= VALID_AGREE
    both = jv & tv
    assert both.sum() >= 20, base
    assert np.isfinite(to[both]).all()
    np.testing.assert_allclose(to[both, :2], jo[both, :2], rtol=0,
                               atol=POS_TOL)
    np.testing.assert_allclose(to[both, 2:], jo[both, 2:], rtol=0,
                               atol=DIR_TOL)
    np.testing.assert_allclose(ta[both], ja[both], rtol=0, atol=AP_TOL)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=TRANS_TOL)


def test_trace_gradient_finite_through_planar_surfaces():
    """Both branches of the planar select stay finite: a gradient through
    the iris (a planar row) and every surface takes no NaN."""
    tl = tdb.get_lens_system(FLAGSHIP, device="cpu").to(dtype=torch.float64)
    radius = tl.radius.clone().requires_grad_(True)
    lens = trt.LensSystem(**{**tl.__dict__, "radius": radius})
    assert float((tl.radius == 0).sum()) >= 1
    s, _, _ = tfit.sample_fit_domain(tl, 500, seed=1)
    out, trans, ap, valid = trt.trace_to_chart(
        lens, torch.as_tensor(s, dtype=torch.float64))
    loss = (out[valid] ** 2).sum() + trans.sum()
    loss.backward()
    assert torch.isfinite(radius.grad).all()
    assert float(radius.grad.abs().sum()) > 0


def test_singlet_real_rays_match_paraxial():
    """tests/test_raytrace.py's singlet on the port's tracer."""
    singlet = [[50.0, 5.0, 1.5, 60.0, 20.0], [-50.0, 2.0, 1.0, 0.0, 20.0],
               [0.0, 0.0, 1.0, 0.0, 18.0]]
    lens = trt.build_lens_system(np.asarray(singlet), name="singlet",
                                 device="cpu")
    lf = torch.tensor([[0, 0, 1e-3, 0, 0.55], [1.0, 0, 0, 0, 0.55]])
    res = trt.trace_sensor_to_scene(lens, lf)
    assert bool(res["valid"].all())
    d = res["out_dir"].numpy()
    assert abs(d[0, 0] / d[0, 2]) < 1e-4
    np.testing.assert_allclose(d[1, 0] / d[1, 2], -1.0 / lens.efl, rtol=0.02)


# ---------------------------------------------------------------- fitting


def test_monomials_and_design_match_jax():
    for degree in (3, 5):
        np.testing.assert_array_equal(tfit.monomial_exponents(degree),
                                      jfit.monomial_exponents(degree))
    exps = jfit.monomial_exponents(5)
    x = np.random.default_rng(0).uniform(-1.1, 1.1, (300, 5)).astype(
        np.float32)
    np.testing.assert_allclose(
        tfit._design_matrix(torch.as_tensor(x), exps).numpy(),
        jfit._design_matrix(x, exps), rtol=1e-13, atol=1e-15)


def test_samples_are_jax_draws():
    jl = jdb.get_lens_system(FLAGSHIP)
    tl = tdb.get_lens_system(FLAGSHIP, device="cpu")
    want = jfit.sample_fit_domain(jl, 1000, seed=9)
    got = tfit.sample_fit_domain(tl, 1000, seed=9)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_lstsq_is_minimum_norm():
    """The QR + SVD solve against numpy's ``gelsd`` on a full-rank and a
    rank-deficient design."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(400, 30))
    b = rng.normal(size=(400, 3))
    for mat in (a, np.concatenate([a, a[:, :5] + a[:, 5:10]], 1)):
        want = np.linalg.lstsq(mat, b, rcond=None)[0]
        got, s, rank = tfit.lstsq(torch.as_tensor(mat), torch.as_tensor(b))
        assert rank == np.linalg.matrix_rank(mat)
        np.testing.assert_allclose(s.numpy(), np.linalg.svd(
            mat, compute_uv=False), rtol=1e-10, atol=1e-12 * float(s[0]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-10)


@pytest.fixture(scope="module")
def flagship_fits():
    """JAX's and the port's fits of the flagship at 20,000 samples."""
    jl = jdb.get_lens_system(FLAGSHIP)
    tl = tdb.get_lens_system(FLAGSHIP, device="cpu")
    out = {}
    for degree in (5, 3):
        out[degree] = (
            jfit.fit_lens(jl, degree=degree, n_samples=20_000,
                          return_diagnostics=True),
            tfit.fit_lens(tl, degree=degree, n_samples=20_000,
                          return_diagnostics=True, device="cpu"))
    return jl, tl, out


# predictions of the two fits on fresh rays, in the fit's own units
PRED_TOL = {5: (1e-3, 3e-5, 1e-3), 3: (1e-3, 3e-5, 1e-3)}


@pytest.mark.parametrize("degree", [5, 3])
def test_fit_lens_matches_jax(flagship_fits, degree):
    jl, tl, out = flagship_fits
    (jpoly, jdiag), (tpoly_, tdiag) = out[degree]
    je = {tuple(e) for e in np.asarray(jpoly.pt.exponents)}
    te = {tuple(e) for e in tpoly_.pt.exponents.numpy()}
    assert len(te) == tdiag["n_terms"] == jdiag["n_terms"]
    assert len(je ^ te) == 0, f"{len(je ^ te)} terms differ"
    assert tdiag["rank"] == tfit.monomial_exponents(degree).shape[0]
    for k, v in jdiag.items():
        if k.startswith("rms"):
            assert abs(tdiag[k] - v) <= 0.1 * v, (k, tdiag[k], v)
    assert tdiag["valid_frac"] == jdiag["valid_frac"]
    for k in META + ("fstop", "aperture_radius_at_fstop"):
        np.testing.assert_allclose(getattr(tpoly_, k), getattr(jpoly, k),
                                   rtol=1e-6)
    assert (tpoly_.name, tpoly_.outer_chart) == (jpoly.name,
                                                 jpoly.outer_chart)
    # predictions on fresh rays
    s, _, _ = jfit.sample_fit_domain(jl, 3000, seed=987)
    _, _, _, valid = jrt.trace_to_chart(jl, jnp.asarray(s))
    v = np.asarray(valid)
    jpt = np.asarray(jax_poly_eval(jpoly.pt, jnp.asarray(s)))[v]
    jap = np.asarray(jax_poly_eval(jpoly.ap, jnp.asarray(s)))[v]
    tpt = poly_eval(tpoly_.pt, torch.as_tensor(s)).numpy()[v]
    tap = poly_eval(tpoly_.ap, torch.as_tensor(s)).numpy()[v]
    pos_tol, dir_tol, ap_tol = PRED_TOL[degree]
    np.testing.assert_allclose(tpt[:, :2], jpt[:, :2], atol=pos_tol)
    np.testing.assert_allclose(tpt[:, 2:4], jpt[:, 2:4], atol=dir_tol)
    np.testing.assert_allclose(tap, jap, atol=ap_tol)


def test_npz_interop(flagship_fits, tmp_path):
    """The port's file read by JAX's loader and JAX's by the port's."""
    _, _, out = flagship_fits
    (jpoly, _), (tpoly_, _) = out[5]
    p_t = str(tmp_path / "port__deg5.npz")
    p_j = str(tmp_path / "jax__deg5.npz")
    tfit.save_poly_lens(tpoly_, 5, path=p_t)
    jfit.save_poly_lens(jpoly, 5, path=p_j)
    with np.load(p_t) as zt, np.load(p_j) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k
            assert zt[k].shape == zj[k].shape, k
    back_j = jfit.load_poly_lens("x", path=p_t)
    np.testing.assert_array_equal(np.asarray(back_j.pt.coeffs),
                                  tpoly_.pt.coeffs.numpy())
    np.testing.assert_array_equal(np.asarray(back_j.ap.exponents),
                                  tpoly_.ap.exponents.numpy())
    assert back_j.outer_chart == tpoly_.outer_chart
    assert back_j.efl == tpoly_.efl
    back_t = tfit.load_poly_lens("x", path=p_j, device="cpu")
    np.testing.assert_array_equal(back_t.pt.coeffs.numpy(),
                                  np.asarray(jpoly.pt.coeffs))
    np.testing.assert_array_equal(back_t.ap.coeffs.numpy(),
                                  np.asarray(jpoly.ap.coeffs))
    assert back_t.fstop == jpoly.fstop and back_t.name == jpoly.name


def _data_lenses_listing():
    return sorted((f, os.path.getmtime(os.path.join(tfit.LENS_DIR, f)))
                  for f in os.listdir(tfit.LENS_DIR))


def test_get_or_fit_lens_caches_outside_data(tmp_path, monkeypatch):
    before = _data_lenses_listing()
    monkeypatch.setattr(tfit, "FIT_CACHE_DIR", str(tmp_path / "fits"))
    calls = []
    fit = tfit.fit_lens

    def small_fit(*a, **kw):
        calls.append(kw)
        return fit(*a, **kw)

    monkeypatch.setattr(tfit, "fit_lens", small_fit)
    # a committed fit is read, not refitted
    committed = tfit.get_or_fit_lens(FLAGSHIP, device="cpu")
    assert committed.name == FLAGSHIP and not calls
    # a base design has no committed fit: fitted once, then read back
    poly = tfit.get_or_fit_lens("double_gauss", degree=3, device="cpu",
                                n_samples=5000, max_terms=40)
    assert len(calls) == 1 and poly.pt.exponents.shape[0] == 40
    path = tmp_path / "fits" / "double_gauss__deg3.npz"
    assert path.exists()
    again = tfit.get_or_fit_lens("double_gauss", degree=3, device="cpu")
    assert len(calls) == 1
    assert torch.equal(again.pt.coeffs, poly.pt.coeffs)
    assert _data_lenses_listing() == before


# ------------------------------------------ tests/test_fit_fidelity.py's gate


HELDOUT_SEED = 987  # the fitter uses seed 0
DEFAULT_THRESH = (0.12, 0.005, 0.04)
THRESH = {("fisheye", 5): (0.15, 0.004, 0.02),
          ("retrofocus_wideangle", 5): (0.10, 0.006, 0.04)}
FAST_SET = ["angenieux__double_gauss__1953__49mm",
            "minolta__fisheye__1978__16mm", "kodak__petzval__1948__85mm"]


def fit_fidelity(poly, lens, n: int = 1500):
    """rms (position mm, slope, iris mm) of a fit against the port's
    tracer on fresh held-out rays (tests/test_fit_fidelity.py's measure)."""
    samples, _, _ = tfit.sample_fit_domain(lens, n, seed=HELDOUT_SEED)
    s = torch.as_tensor(samples, device=lens.device)
    out, _, ap_xy, v = trt.trace_to_chart(lens, s)
    assert int(v.sum()) >= 10
    pt = poly_eval(poly.pt, s)[v]
    ap = poly_eval(poly.ap, s)[v]
    rms = lambda a: float(torch.sqrt((a.double() ** 2).mean()))
    return (rms(pt[:, :2] - out[v, :2]), rms(pt[:, 2:4] - out[v, 2:4]),
            rms(ap - ap_xy[v]))


@pytest.mark.parametrize("name", FAST_SET)
def test_committed_fits_meet_thresholds(name):
    poly = tfit.load_poly_lens(name, device="cpu")
    lens = tdb.get_lens_system(name, device="cpu")
    got = fit_fidelity(poly, lens)
    limit = THRESH.get((name.split("__")[1], 5), DEFAULT_THRESH)
    assert all(g <= t for g, t in zip(got, limit)), (got, limit)


def test_corrupted_coefficient_fails():
    """The gate binds: a 10% error on the flagship's dominant x term fails
    it (tests/test_fit_fidelity.py::test_corrupted_coefficient_fails)."""
    poly = tfit.load_poly_lens(FLAGSHIP, device="cpu")
    lens = tdb.get_lens_system(FLAGSHIP, device="cpu")
    poly.pt.coeffs[0, int(torch.argmax(poly.pt.coeffs[0].abs()))] *= 1.10
    assert fit_fidelity(poly, lens)[0] > DEFAULT_THRESH[0]
