"""Parity of the PyTorch port's RNG, sample stream and optics core with the
JAX package, on the same numpy inputs.

Tolerances: the RNG and the sample stream are integer hashing plus the same
float ops in the same order, so they must agree bit for bit.  The
polynomial paths sum 160-term products in another order (a torch matmul
against XLA's dot) and take Newton Jacobians by torch.func.jvp against
jax.linearize, so they agree to float32 rounding: each is held to a
scale-relative error (max |port - jax| / max |jax|) of 1e-5, above the
worst case measured on these inputs (reported in PERF.md).
"""
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pota_tpu import RenderConfig
from pota_tpu.optics import geometry as jgeo
from pota_tpu.optics import polynomial as jpoly
from pota_tpu.optics import samplers as jsamp
from pota_tpu.optics.fit import load_poly_lens as jax_load_poly_lens
from pota_tpu.render import sampling as jsampling
from pota_tpu.render import scene as jscene
from pota_tpu.utils import rng as jrng

from pota_tpu_torch.optics import geometry as tgeo
from pota_tpu_torch.optics import polynomial as tpoly
from pota_tpu_torch.optics import samplers as tsamp
from pota_tpu_torch.optics.fit import load_poly_lens, poly_lens_from_numpy
from pota_tpu_torch.optics.polynomial import LENS_CONSTANTS
from pota_tpu_torch.render import sampling as tsampling
from pota_tpu_torch.render import scene as tscene
from pota_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
ANAMORPHIC = "unknown__anamorphic__1960__50mm"
POLY_REL_TOL = 1e-5


def to_torch_lens(jl):
    """The port's lens from a JAX PolyLens, through numpy."""
    def fn(f):
        return {"exponents": np.asarray(f.exponents),
                "coeffs": np.asarray(f.coeffs),
                "in_scale": np.asarray(f.in_scale),
                "in_shift": np.asarray(f.in_shift)}

    consts = {k: getattr(jl, k) for k in LENS_CONSTANTS}
    consts.update(name=jl.name, outer_chart=jl.outer_chart,
                  inner_chart=jl.inner_chart)
    return poly_lens_from_numpy(fn(jl.pt), fn(jl.ap), consts, device="cpu")


def scaled_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def lenses():
    jl = jax_load_poly_lens(FLAGSHIP, degree=5)
    assert jl is not None
    return jl, load_poly_lens(FLAGSHIP, degree=5, device="cpu")


# ------------------------------------------------------------------- RNG


def test_tea_and_uniforms_bit_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    want_h = np.asarray(jrng.tea(jnp.asarray(a), jnp.asarray(b)))
    got_h = trng.tea(torch.as_tensor(a.astype(np.int64)),
                     torch.as_tensor(b.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got_h, want_h.astype(np.int64))
    want_u = np.asarray(jrng.uniforms(jnp.asarray(a), jnp.asarray(b), 6))
    got_u = trng.uniforms(torch.as_tensor(a.astype(np.int64)),
                          torch.as_tensor(b.astype(np.int64)), 6).numpy()
    np.testing.assert_array_equal(got_u, want_u)


@pytest.mark.parametrize("rc", [
    RenderConfig(xres=40, yres=24, spp=3),
    RenderConfig(xres=64, yres=48, spp=1, region_min_x=5, region_min_y=7,
                 region_max_x=30, region_max_y=40),
])
def test_frame_samples_bit_exact(rc):
    want = jsampling.frame_samples(rc, 17)
    from tests.test_torch_slice import to_port

    got = tsampling.frame_samples(to_port(rc), 17, device="cpu")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(
            got[k].numpy(), np.asarray(want[k]).astype(got[k].numpy().dtype),
            err_msg=k)


# ------------------------------------------------------------- samplers


def test_concentric_disk_matches():
    rng = np.random.default_rng(1)
    r1 = rng.uniform(size=5000).astype(np.float32)
    r2 = rng.uniform(size=5000).astype(np.float32)
    r1[:3] = [0.5, 0.5, 0.0]
    r2[:3] = [0.5, 0.0, 0.5]
    want = np.asarray(jsamp.concentric_disk_sample(jnp.asarray(r1),
                                                   jnp.asarray(r2)))
    got = tsamp.concentric_disk_sample(torch.as_tensor(r1),
                                       torch.as_tensor(r2)).numpy()
    # cos/sin of two libms: a few ulps
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sampler", ["aberrated", "aberrated_round",
                                     "triangular", "squircle"])
def test_aperture_samplers_match(sampler):
    rng = np.random.default_rng(8)
    r1 = rng.uniform(size=3000).astype(np.float32)
    r2 = rng.uniform(size=3000).astype(np.float32)
    j1, j2, t1, t2 = jnp.asarray(r1), jnp.asarray(r2), torch.as_tensor(r1), \
        torch.as_tensor(r2)
    if sampler == "aberrated":
        want = jsamp.concentric_disk_sample_aberrated(j1, j2, 0.3, 0.4)
        got = tsamp.concentric_disk_sample_aberrated(t1, t2, 0.3, 0.4)
    elif sampler == "aberrated_round":
        want = jsamp.concentric_disk_sample_aberrated(j1, j2, 0.5, 0.0)
        got = tsamp.concentric_disk_sample_aberrated(t1, t2, 0.5, 0.0)
    elif sampler == "triangular":
        want = jsamp.triangular_aperture_sample(j1, j2, 1.0, 5)
        got = tsamp.triangular_aperture_sample(t1, t2, 1.0, 5)
    else:
        want = jsamp.lerp_squircle_mapping(j1)
        got = tsamp.lerp_squircle_mapping(t1)
    # pow / log / cos / sin of two libms: a few ulps of values <= ~3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


# ---------------------------------------------------------------- charts


@pytest.mark.parametrize("chart", ["sphere", "cyl-x", "cyl-y"])
def test_chart_to_cs_matches(chart):
    rng = np.random.default_rng(2)
    pos = rng.uniform(-15, 15, (2000, 2)).astype(np.float32)
    d = rng.uniform(-0.4, 0.4, (2000, 2)).astype(np.float32)
    R = 25.6
    wp, wd = jgeo.chart_to_cs(jnp.asarray(pos), jnp.asarray(d), -R, R, chart)
    gp, gd = tgeo.chart_to_cs(torch.as_tensor(pos), torch.as_tensor(d), -R,
                              R, chart)
    assert scaled_err(gp, wp) < 1e-6
    assert scaled_err(gd, wd) < 1e-6


def test_line_plane_intersection_y0_matches():
    rng = np.random.default_rng(3)
    o = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    want = jgeo.line_plane_intersection_y0(jnp.asarray(o), jnp.asarray(d))
    got = tgeo.line_plane_intersection_y0(torch.as_tensor(o),
                                          torch.as_tensor(d))
    assert scaled_err(got, want) < 1e-6


# ------------------------------------------------- polynomial, flagship lens


def _sensor5(rng, n):
    return np.stack([
        rng.uniform(-12, 12, n), rng.uniform(-12, 12, n),
        rng.uniform(-0.25, 0.25, n), rng.uniform(-0.25, 0.25, n),
        rng.uniform(0.42, 0.68, n),
    ], -1).astype(np.float32)


def test_loader_matches_jax(lenses):
    jl, tl = lenses
    for f, g in ((jl.pt, tl.pt), (jl.ap, tl.ap)):
        np.testing.assert_array_equal(np.asarray(f.exponents),
                                      g.exponents.numpy())
        np.testing.assert_array_equal(np.asarray(f.coeffs), g.coeffs.numpy())
        np.testing.assert_array_equal(np.asarray(f.in_scale),
                                      g.in_scale.numpy())
    for k in LENS_CONSTANTS + ("name", "outer_chart", "inner_chart"):
        assert getattr(tl, k) == getattr(jl, k), k
    # the numpy converter builds the same lens
    conv = to_torch_lens(jl)
    assert torch.equal(conv.pt.coeffs, tl.pt.coeffs)
    assert torch.equal(conv.ap.exponents, tl.ap.exponents)


def test_poly_eval_matches(lenses):
    jl, tl = lenses
    s5 = _sensor5(np.random.default_rng(4), 4096)
    for jf, tf in ((jl.pt, tl.pt), (jl.ap, tl.ap)):
        want = np.asarray(jpoly.poly_eval(jf, jnp.asarray(s5)))
        got = tpoly.poly_eval(tf, torch.as_tensor(s5)).numpy()
        assert scaled_err(got, want) < POLY_REL_TOL


def test_pt_sample_aperture_matches(lenses):
    jl, tl = lenses
    rng = np.random.default_rng(5)
    n = 4096
    s5 = _sensor5(rng, n)
    s5[:, 2:4] = 0.0
    r_ap = jl.aperture_housing_radius * 0.6
    ap = rng.uniform(-r_ap, r_ap, (n, 2)).astype(np.float32)
    want = np.asarray(jpoly.pt_sample_aperture(jl, jnp.asarray(s5),
                                               jnp.asarray(ap)))
    got = tpoly.pt_sample_aperture(tl, torch.as_tensor(s5),
                                   torch.as_tensor(ap)).numpy()
    # the solved directions, scaled by their own magnitude
    assert scaled_err(got[:, 2:4], want[:, 2:4]) < POLY_REL_TOL
    np.testing.assert_array_equal(got[:, [0, 1, 4]], want[:, [0, 1, 4]])


def test_lt_sample_aperture_matches(lenses):
    jl, tl = lenses
    rng = np.random.default_rng(6)
    n = 4096
    scene = np.stack([rng.uniform(-80, 80, n), rng.uniform(-80, 80, n),
                      rng.uniform(500, 3000, n)], -1).astype(np.float32)
    ap = (rng.uniform(-1, 1, (n, 2))
          * jl.aperture_housing_radius * 0.5).astype(np.float32)
    lam = rng.uniform(0.45, 0.65, n).astype(np.float32)
    ws, wo, wt = jpoly.lt_sample_aperture(jl, jnp.asarray(scene),
                                          jnp.asarray(ap), jnp.asarray(lam))
    gs, go, gt = tpoly.lt_sample_aperture(tl, torch.as_tensor(scene),
                                          torch.as_tensor(ap),
                                          torch.as_tensor(lam))
    ws, gs = np.asarray(ws), gs.numpy()
    assert scaled_err(gs[:, :2], ws[:, :2]) < POLY_REL_TOL
    assert scaled_err(gs[:, 2:4], ws[:, 2:4]) < POLY_REL_TOL
    assert scaled_err(go, wo) < POLY_REL_TOL
    assert scaled_err(gt, wt) < POLY_REL_TOL
    np.testing.assert_array_equal(
        tpoly.inner_pupil_ok(tl, torch.as_tensor(gs)).numpy(),
        np.asarray(jpoly.inner_pupil_ok(jl, jnp.asarray(ws))))


def test_lt_sample_aperture_matches_cylinder_chart():
    """The anamorphic lens exits through a cylinder chart, the flagship's
    through the sphere: the solve's chart branch is held here."""
    jl = jax_load_poly_lens(ANAMORPHIC, degree=5)
    tl = load_poly_lens(ANAMORPHIC, degree=5, device="cpu")
    assert tl.outer_chart == jl.outer_chart != "sphere"
    rng = np.random.default_rng(7)
    n = 1024
    scene = np.stack([rng.uniform(-60, 60, n), rng.uniform(-60, 60, n),
                      rng.uniform(500, 3000, n)], -1).astype(np.float32)
    ap = (rng.uniform(-1, 1, (n, 2))
          * jl.aperture_housing_radius * 0.5).astype(np.float32)
    ws, wo, wt = jpoly.lt_sample_aperture(jl, jnp.asarray(scene),
                                          jnp.asarray(ap), 0.55)
    gs, go, gt = tpoly.lt_sample_aperture(tl, torch.as_tensor(scene),
                                          torch.as_tensor(ap), 0.55)
    assert scaled_err(gs.numpy()[:, :4], np.asarray(ws)[:, :4]) < POLY_REL_TOL
    assert scaled_err(go, wo) < POLY_REL_TOL
    assert scaled_err(gt, wt) < POLY_REL_TOL


# ----------------------------------------------------------------- scenes


@pytest.mark.parametrize("name", ["lightgrid", "teapot"])
def test_scene_shade_and_occlusion_match(name):
    """Scene tables equal JAX's; shading and the segment-occlusion probe
    agree on random rays (float32 rounding of the hit distance)."""
    if name == "lightgrid":
        js = jscene.lightgrid_scene(n=3, spacing=18.0, z=-150.0, radius=6.0)
        ts = tscene.lightgrid_scene(n=3, spacing=18.0, z=-150.0, radius=6.0,
                                    device="cpu")
    else:
        js, ts = jscene.teapot_scene(), tscene.teapot_scene(device="cpu")
    for f in ("centers", "radii", "emission", "albedo", "sky_color",
              "light_dir", "light_color"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert ts.n_objects == js.n_objects
    rng = np.random.default_rng(9)
    n = 4000
    o = np.zeros((n, 3), np.float32)
    d = np.stack([rng.uniform(-0.25, 0.25, n), rng.uniform(-0.2, 0.25, n),
                  -np.ones(n)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = js.shade(jnp.asarray(o), jnp.asarray(d))
    got = ts.shade(torch.as_tensor(o), torch.as_tensor(d))
    assert 0.05 < float(np.asarray(want["hit"]).mean()) < 0.95
    for k in ("hit", "obj_id"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    hit = np.asarray(want["hit"])
    for k in ("rgba", "P", "z"):
        assert scaled_err(got[k].numpy()[hit], np.asarray(want[k])[hit]) < 1e-5
    p_to = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    p_to[:, 2] = rng.uniform(-400, -100, n)
    occ_w = np.asarray(js.occluded(jnp.asarray(o), jnp.asarray(p_to)))
    occ_g = ts.occluded(torch.as_tensor(o), torch.as_tensor(p_to)).numpy()
    assert 0.0 < occ_w.mean() < 1.0
    np.testing.assert_array_equal(occ_g, occ_w)


# ------------------------------------------------------------ isolation


def test_port_never_imports_jax(tmp_path):
    """Importing the port and rendering a frame leaves jax and every module
    of the JAX package unloaded."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "import pota_tpu_torch as pt\n"
        "from pota_tpu_torch.optics.fit import load_poly_lens\n"
        "from pota_tpu_torch.optics.focus import POState\n"
        "from pota_tpu_torch.render import scene as sc\n"
        "from pota_tpu_torch.render.renderer import look_at, render_frame\n"
        "lens = load_poly_lens('" + FLAGSHIP + "', device='cpu')\n"
        "cfg = pt.CameraConfig(camera_type=pt.CameraType.POLYNOMIAL_OPTICS,"
        " fstop=2.8, focus_distance=20.0, vignetting_retries=1,"
        " splat_queue_mult=2)\n"
        "st = POState(aperture_radius=4.67, sensor_shift=15.09,"
        " focus_distance=200.0, tan_fov=0.37)\n"
        "img, fb = render_frame(cfg, pt.RenderConfig(xres=8, yres=8, spp=1),"
        " sc.lightgrid_scene(n=2, z=-150.0, device='cpu'),"
        " look_at([0,0,0],[0,0,-1], device='cpu'),"
        " po_lens=lens, po_state=st)\n"
        "assert img.shape == (8, 8, 4)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'jaxlib', 'pota_tpu.')) or m == 'pota_tpu')\n"
        "print('LOADED', bad)\n"
    )
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
