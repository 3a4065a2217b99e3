"""The port's thin-lens slice against the JAX package on the CPU: the
aberration helpers, the forward trace ``trace_fw_thinlens`` in every
aberration branch, K5's plain version against the Pallas thin-lens splat
kernel in interpret mode, the thin-lens frame at the ``thinlens_teapot``
golden configuration (64x64, 4 spp, teapot scene) against the committed
golden and against JAX's expanded branch on the same stream, the
differentiable frame, and 8x8 frames of the settings it refused before it
had JAX's decomposed splat (held against JAX's splat of
the same sample stream to 1e-6 of scale, as ``tests/test_torch_slice.py``
holds its same-stream splat).

Tolerances, each set from the value measured on these inputs:
- the aberration helpers and the forward trace are the same float32 ops in
  the same order, with two libms' pow / sin / cos / exp: held to a
  scale-relative error of 1e-5 (measured at most 4.0e-7, the Cardano
  inverse; the traces at most 1.4e-7), tries and weights exactly; each
  package's Rodrigues matrices are also held to a float64 oracle to 1e-6
  of scale (measured at most 6.3e-8);
- K5's plain version: a slot can cross a pixel edge under float32 rounding,
  so ``ok`` and ``lin`` are held to >= 99.9% agreement (measured: all
  8,000 slots agree in both settings);
- full frames: at most 2% of pixels off by more than 2e-3 of the plane's
  scale and RGBA energy to 1e-3, the bound the PO slice uses.  Measured:
  on JAX's stream the port's splat matches JAX's expanded branch to 5.3e-9
  of scale on RGBA and exactly on every other plane and on the energy, so
  the same-stream planes are also held to 1e-6 of scale; the port's own
  frame is 0.27% of pixels off the golden (11 of 4,096), which JAX renders
  through its decomposed branch (the same-stream splat is as far off).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pota_tpu import CameraConfig, RenderConfig
from pota_tpu.io.exr import read_exr
from pota_tpu.ops import po_pallas
from pota_tpu.optics import aberrations as jab
from pota_tpu.optics import thinlens as jtl
from pota_tpu.render import splat as jsplat

import golden_configs as gc
from tests.test_torch_optics import scaled_err
from tests.test_torch_slice import (
    assert_splat_pair_close,
    frac_pixels_off,
    ring_cdfs,
    splat_pair,
    to_port,
)

from pota_tpu_torch.ops import po_kernels as pk
from pota_tpu_torch.optics import aberrations as tab
from pota_tpu_torch.optics import thinlens as ttl
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render.bokeh_image import build_bokeh_cdf
from pota_tpu_torch.render.renderer import check_supported, look_at, render_frame
from pota_tpu_torch.render.splat import resolve_aovs, splat_frame

torch.set_num_threads(2)
# PyTorch 2.13's CPU build, with two intra-op threads, now and then computes
# the first parallel elementwise kernel of a fresh process wrongly on the
# second thread's share: torch.cos of the 4,000 float32 angles of
# _ab_inputs, run first thing in each of 400 fresh processes, came back up
# to 9.3e-5 off on elements 2000-3999 in 12 of them, and right on the
# second call in all 400; with one parallel kernel run before it, 0 of 400
# went wrong.  The port's _rotation_matrix
# was that first kernel when its parity test failed at 9.2e-5 (its JAX twin
# matched a float64 Rodrigues oracle, the port did not).  So the module
# runs one parallel kernel at import, before any test.
torch.cos(torch.zeros(1 << 16))

TRACE_TOL = 1e-5
ROTATION_TOL = 1e-6
PIXEL_TOL, MAX_PIXELS_OFF, ENERGY_TOL = 2e-3, 0.02, 1e-3
# the thinlens_teapot golden configuration (tests/golden_configs.py:65-70)
TL_CFG = CameraConfig(focal_length=50.0, fstop=1.4, focus_distance=150.0,
                      vignetting_retries=2, splat_queue_mult=6)
TL_RC = RenderConfig(xres=64, yres=64, spp=4)
# the port's copies of the two
TL_CFG_T, TL_RC_T = to_port(TL_CFG), to_port(TL_RC)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------------------- aberrations


def _ab_inputs():
    rng = np.random.default_rng(21)
    n = 4000
    uv = rng.uniform(-1.2, 1.2, (n, 2)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                        np.zeros((n, 1))], -1).astype(np.float32)
    disk = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    angle = rng.uniform(-0.05, 0.05, n).astype(np.float32)
    return uv, d, o, disk, angle


AB_CASES = {
    "optical_vignetting_square": lambda m, uv, d, o, disk, ang: m.
    optical_vignetting_square(o, d, 1.7, 1.1, 3.0, 1.4),
    "barrel_distortion": lambda m, uv, d, o, disk, ang: m.barrel_distortion(
        uv, 0.15),
    "inverse_barrel_distortion": lambda m, uv, d, o, disk, ang: m.
    inverse_barrel_distortion(uv, 0.15),
    "coma_multiplier": lambda m, uv, d, o, disk, ang: m.coma_multiplier(
        36.0, 50.0, d, disk),
    "_rotation_matrix": lambda m, uv, d, o, disk, ang: m._rotation_matrix(
        d, ang),
    "coma_perturb": lambda m, uv, d, o, disk, ang: m.coma_perturb(
        d, o, ang * 20.0, reverse=True),
}


@pytest.mark.parametrize("name", sorted(AB_CASES))
def test_aberrations_match_jax(name):
    ins = _ab_inputs()
    want = np.asarray(AB_CASES[name](jab, *(jnp.asarray(a) for a in ins)))
    got = AB_CASES[name](tab, *(_t(a) for a in ins)).numpy()
    if want.dtype == bool:
        assert 0.05 < want.mean() < 0.95
        np.testing.assert_array_equal(got, want)
    else:
        assert scaled_err(got, want) < TRACE_TOL


def _rodrigues_f64(axis, angle):
    """The rotation matrices of _rotation_matrix, in float64 numpy."""
    x, y, z = (np.asarray(axis, np.float64)[:, k] for k in range(3))
    a = np.asarray(angle, np.float64)
    c, s = np.cos(a), np.sin(a)
    oc = 1.0 - c
    return np.stack([
        np.stack([c + x * x * oc, x * y * oc - z * s, x * z * oc + y * s], -1),
        np.stack([y * x * oc + z * s, c + y * y * oc, y * z * oc - x * s], -1),
        np.stack([z * x * oc - y * s, z * y * oc + x * s, c + z * z * oc], -1),
    ], -2)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_rotation_matrix_matches_float64_rodrigues(package):
    """Each package's float32 matrices against the float64 oracle, so a
    parity failure names the side at fault: measured 5.9e-8 (JAX) and
    6.3e-8 (the port) of scale, about one float32 rounding of entries near
    1, held to ROTATION_TOL."""
    _, d, _, _, ang = _ab_inputs()
    if package == "jax":
        got = np.asarray(jab._rotation_matrix(jnp.asarray(d), jnp.asarray(ang)))
    else:
        got = tab._rotation_matrix(_t(d), _t(ang)).numpy()
    assert got.dtype == np.float32
    assert scaled_err(got, _rodrigues_f64(d, ang)) < ROTATION_TOL


# ------------------------------------------------------- forward trace


def _ring_pixels(n=16):
    yy, xx = np.mgrid[0:n, 0:n]
    r = np.sqrt((xx - (n - 1) / 2) ** 2 + (yy - (n - 1) / 2) ** 2) / (n / 2)
    ring = ((r > 0.35) & (r < 0.95)).astype(np.float32) + 0.05
    return np.stack([ring] * 3, -1)


TRACE_CASES = {
    "default": {},
    "coma": {"abb_coma": 0.6},
    "optical_vignetting": {"optical_vignetting_distance": 2.0,
                           "optical_vignetting_radius": 1.2},
    "distortion": {"abb_distortion": 0.2},
    "anamorphic": {"bokeh_anamorphic": 0.4},
    "blades": {"aperture_blades": 6},
    "abb_spherical": {"abb_spherical": 0.3, "circle_to_square": 0.4},
    "image_bokeh": {"bokeh_enable_image": True},
    "no_dof": {"enable_dof": False},
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_trace_fw_thinlens_matches_jax(case):
    from pota_tpu.render.bokeh_image import build_bokeh_cdf as jbuild

    cfg = dataclasses.replace(
        CameraConfig(focal_length=50.0, fstop=1.4, focus_distance=150.0,
                     vignetting_retries=3), **TRACE_CASES[case])
    rng = np.random.default_rng(5)
    n = 3000
    sx, sy = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(2))
    r1, r2 = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    key = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    jcdf = tcdf = None
    if case == "image_bokeh":
        jcdf = jbuild(_ring_pixels())
        tcdf = build_bokeh_cdf(_ring_pixels(), device="cpu")
    want = jtl.trace_fw_thinlens(
        cfg, *(jnp.asarray(a) for a in (sx, sy, r1, r2)),
        retry_key=jnp.asarray(key), bokeh_cdf=jcdf)
    got = ttl.trace_fw_thinlens(
        to_port(cfg), *(_t(a) for a in (sx, sy, r1, r2)),
        retry_key=_t(key.astype(np.int64)), bokeh_cdf=tcdf)
    tries_w = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), tries_w)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        assert scaled_err(g, w) < TRACE_TOL
    if case == "optical_vignetting":
        assert 0 < (tries_w > 0).mean() and (tries_w == 4).any()


def test_image_dist_matches_jax():
    z = np.linspace(-900.0, -20.0, 101).astype(np.float32)
    want = np.asarray(jtl.image_dist(50.0, jnp.asarray(z)))
    np.testing.assert_array_equal(ttl.image_dist(50.0, _t(z)).numpy(), want)


# ------------------------------------------------------------- K5 splat


def test_splat_params_without_po_state():
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [0.5, 1.0, -2.0]
    cfg = dataclasses.replace(TL_CFG, bokeh_anamorphic=0.3)
    want = np.asarray(po_pallas.splat_kernel_params(cfg, TL_RC, None,
                                                    jnp.asarray(m)))[0]
    got = pk.splat_kernel_params(to_port(cfg), TL_RC_T, None,
                                 torch.as_tensor(m))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("abb, c2s", [(0.5, 0.01), (0.3, 0.2)])
def test_tl_splat_plain_matches_pallas(abb, c2s):
    rng = np.random.default_rng(31)
    n = 8000
    pc = np.stack([rng.uniform(-25, 25, n), rng.uniform(-25, 25, n),
                   rng.uniform(-600, -40, n)], 0).astype(np.float32)
    pw = pc * 0.5
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    ctr = rng.integers(0, 40, n).astype(np.uint32)
    sky = (rng.uniform(size=n) < 0.05).astype(np.float32)
    spheres = np.array([[x, y, -150.0, 6.0] for x in (-8.0, 8.0)
                        for y in (-8.0, 8.0)], np.float32)
    cfg = dataclasses.replace(TL_CFG, bokeh_anamorphic=0.2)
    rc = RenderConfig(xres=96, yres=64, spp=1)
    params = po_pallas.splat_kernel_params(cfg, rc, None,
                                           jnp.eye(4, dtype=jnp.float32))
    kern = po_pallas.build_tl_splat_kernel(spheres.shape[0], abb, c2s,
                                           interpret=True)
    want_lin, want_ok = (np.asarray(a) for a in kern(
        *(jnp.asarray(a) for a in (*pc, *pw)), jnp.asarray(seeds),
        jnp.asarray(ctr), jnp.asarray(sky), params, jnp.asarray(spheres)))
    got_lin, got_ok = pk.tl_splat(
        *(_t(a) for a in (*pc, *pw)), _t(seeds.astype(np.int64)).to(
            torch.int32), _t(ctr.astype(np.int64)).to(torch.int32), _t(sky),
        _t(np.asarray(params)[0]), _t(spheres), abb, c2s)
    got_lin, got_ok = got_lin.numpy(), got_ok.numpy()
    assert 0.2 < want_ok.mean() < 0.95      # the inputs exercise both sides
    assert (got_ok == want_ok).mean() >= 0.999
    both = got_ok & want_ok
    assert (got_lin[both] == want_lin[both]).mean() >= 0.999


# ------------------------------------------------------------ the slice


@pytest.fixture(scope="module")
def tl_renders():
    """The port's frame, JAX's stream, and both packages' expanded splat of
    JAX's stream (JAX's through its interpret-mode kernels)."""
    from pota_tpu.render import scene as jsc
    from pota_tpu.render.renderer import render_sample_stream as jstream

    js = jstream(TL_CFG, TL_RC, jsc.teapot_scene(), gc.M, 0, use_pallas=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("POTA_SPLAT_INTERPRET", "1")
        jfb = jsplat.splat_frame(TL_CFG, TL_RC, jsc.teapot_scene(), js, gc.M,
                                 use_pallas=True, fused_splat=True)
        path = jsplat._LAST_PATH
    want = {k: np.asarray(v) for k, v in jsplat.resolve_aovs(TL_RC,
                                                              jfb).items()}
    want["raw_rgba"] = np.asarray(jfb["RGBA"])

    m = look_at([0, 0, 0], [0, 0, -1], device="cpu")
    img, fb = render_frame(TL_CFG_T, TL_RC_T, sc.teapot_scene(device="cpu"),
                           m, seed=0)
    tjs = {k: torch.as_tensor(np.asarray(v)) for k, v in js.items()}
    for k in ("px", "py", "sid", "key"):
        tjs[k] = tjs[k].to(torch.int64)
    with torch.no_grad():
        same = splat_frame(TL_CFG_T, TL_RC_T, sc.teapot_scene(device="cpu"),
                           tjs, m)
    got = {"image": img.numpy(), "raw": {k: v.numpy() for k, v in fb.items()},
           "same": {k: v.numpy() for k, v in resolve_aovs(TL_RC_T,
                                                          same).items()},
           "same_raw_rgba": same["RGBA"].numpy()}
    return got, want, path


def test_tl_jax_took_the_expanded_branch(tl_renders):
    assert tl_renders[2] == "expanded"


@pytest.mark.parametrize("plane", ["RGBA", "Z", "P", "lentil_raydir",
                                   "lentil_time", "lentil_debug"])
def test_tl_splat_matches_jax_expanded_on_same_stream(tl_renders, plane):
    got, want, _ = tl_renders
    assert np.isfinite(got["same"][plane]).all()
    assert frac_pixels_off(got["same"][plane], want[plane]) <= MAX_PIXELS_OFF
    assert scaled_err(got["same"][plane], want[plane]) < 1e-6


def test_tl_energy_matches_jax_expanded(tl_renders):
    got, want, _ = tl_renders
    e_got = float(got["same_raw_rgba"].sum())
    e_want = float(want["raw_rgba"].sum())
    assert abs(e_got - e_want) <= ENERGY_TOL * abs(e_want)
    npix = TL_RC.xres * TL_RC.yres
    w = float(got["raw"]["filter_weight"].sum())
    assert abs(w - npix) <= 1e-5 * npix


def test_tl_render_matches_golden(tl_renders):
    got, _, _ = tl_renders
    golden = read_exr(gc.golden_path("thinlens_teapot"))
    ref = np.stack([golden[f"rgba.{c}"] for c in "RGBA"], -1)
    assert np.isfinite(got["image"]).all()
    assert float(np.abs(got["image"]).max()) > 1e-3
    assert frac_pixels_off(got["image"], ref) <= MAX_PIXELS_OFF


# ------------------------------------------------------------- refusals


# case -> (camera changes, render changes, splat_frame options, route of a
# differentiable frame); every case was refused once: the settings before
# the port had JAX's decomposed splat, the differentiable frame before it
# had the thin lens's gradient
REFUSALS = {
    "tl_coma": ({"abb_coma": 0.5}, {}, {}, None),
    "tl_chromatic": ({"abb_chromatic": 0.5}, {}, {}, None),
    "tl_optical_vignetting": ({"optical_vignetting_distance": 2.0}, {}, {},
                              None),
    "tl_distortion": ({"abb_distortion": 0.1}, {}, {}, None),
    "tl_image_bokeh": ({"bokeh_enable_image": True}, {}, {}, None),
    "tl_blades": ({"aperture_blades": 6}, {}, {}, None),
    "motion_blur": ({}, {}, {"m_end": "pan"}, None),
    "id_matte": ({"abb_coma": 0.5}, {"enable_id_matte": True}, {}, None),
    "gaussian_aovs": ({}, {}, {"aovs": "extra"}, None),
    "differentiable": ({}, {}, {}, "k5"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_check_supported_refuses(case):
    """No setting is refused any more.  The differentiable frame (ROADMAP
    Q1.8c) renders through K5 and records a graph: ``backward()`` fills a
    finite, non-zero gradient of ``cam_to_world`` and of the scene's
    albedo (tests/test_torch_grad_thin.py holds it to JAX).  Every other
    case renders an 8x8 teapot frame of its setting whose splat of JAX's
    sample stream equals JAX's to 1e-6 of scale (the aberrated settings,
    motion blur and the id-matte (with coma) through the decomposed route,
    the extra gaussian AOV through K5; the id-matte with its crypto planes
    compared)."""
    from pota_tpu.render import scene as jsc

    from pota_tpu_torch.render import splat as tsplat
    from pota_tpu_torch.render.aov import DEFAULT_AOVS, GAUSSIAN, AOVSpec

    cfg_kw, rc_kw, kw, route = REFUSALS[case]
    cfg = dataclasses.replace(TL_CFG_T, **cfg_kw)
    rc = dataclasses.replace(to_port(RenderConfig(xres=8, yres=8, spp=2)),
                             **rc_kw)
    check_supported(cfg, rc)
    if route is not None:
        scene = sc.teapot_scene(device="cpu")
        scene.albedo.requires_grad_(True)
        m = look_at([0, 0, 0], [0, 0, -1], device="cpu").requires_grad_(True)
        img, _ = render_frame(cfg, rc, scene, m, differentiable=True)
        assert tsplat.LAST_ROUTE == route and img.requires_grad
        img[..., :3].mean().backward()
        for g in (m.grad, scene.albedo.grad):
            assert bool(torch.isfinite(g).all()) and float(g.norm()) > 0
        return
    opts = {}
    if kw.get("aovs") == "extra":
        opts["aovs"] = list(DEFAULT_AOVS) + [
            AOVSpec("extra", "RGBA", GAUSSIAN, "rgba")]
    if kw.get("m_end") == "pan":
        opts["m_end"] = look_at([3.0, 0, 0], [3.0, 0, -1], device="cpu").numpy()
    pair = splat_pair(cfg, rc, jsc.teapot_scene(),
                      sc.teapot_scene(device="cpu"), cdf=ring_cdfs(), **opts)
    assert tsplat.LAST_ROUTE == ("k5" if case == "gaussian_aovs"
                                 else "decomposed_tl")
    assert_splat_pair_close(pair)


def test_aberrated_thin_lens_forward_only_is_not_refused():
    """With redistribution off the aberrated thin lens renders forward only;
    with it on, its splat of JAX's stream equals JAX's."""
    from pota_tpu.render import scene as jsc

    cfg = dataclasses.replace(TL_CFG_T, abb_coma=0.5,
                              optical_vignetting_distance=2.0)
    rc = to_port(RenderConfig(xres=8, yres=8, spp=2,
                              enable_redistribution=False))
    m = look_at([0, 0, 0], [0, 0, -1], device="cpu")
    img, fb = render_frame(cfg, rc, sc.teapot_scene(device="cpu"), m)
    assert fb == {} and img.shape == (8, 8, 4)
    assert bool(torch.isfinite(img).all())
    pair = splat_pair(cfg, dataclasses.replace(rc, enable_redistribution=True),
                      jsc.teapot_scene(), sc.teapot_scene(device="cpu"))
    assert_splat_pair_close(pair)


@pytest.mark.parametrize("change", [
    {}, {"abb_spherical": 0.3}, {"circle_to_square": 0.4},
    {"bokeh_anamorphic": 0.3}])
def test_thin_lens_settings_k5_takes_are_not_refused(change):
    """K5 carries the spherical bias, the squircle and the anamorphic
    squeeze: JAX's expanded branch takes these settings."""
    from pota_tpu_torch.render.splat import _k5_takes

    cfg = dataclasses.replace(TL_CFG_T, **change)
    check_supported(cfg, TL_RC_T)
    assert _k5_takes(cfg)
