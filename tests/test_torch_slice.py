"""The port's flagship slice end to end against the JAX package on the CPU:
PO camera setup, the forward sample stream, ``splat_frame`` and
``render_frame`` + ``resolve_aovs`` at the ``po_lightgrid`` golden
configuration (48x48, 2 spp, flagship lens), the committed golden, and
energy conservation.

Tolerances.  Given the same sample stream, the port's splat (expanded
path, sorted accumulator) reproduces JAX's CPU splat (decomposed path,
scatter accumulation) to 1e-6 of each plane's scale (measured: exactly).
The forward streams agree to float32 rounding (a torch matmul against
XLA's dot inside the Newton solves; measured 6.5e-5 of scale on P).  That
rounding is enough to change some slots end to end: the occlusion probe
starts at the shaded point P with t_min = 1e-3 scene units, and P carries
up to 2.5e-3 of radial error in BOTH packages near sphere silhouettes, so
which slots self-occlude depends on P's last bits (ROADMAP Queue 3).  Full
frames are therefore held to: raw energy equal to 1e-5, and at most 2% of
pixels off by more than 2e-3 of the plane's scale (measured 17 of 2,304,
0.74%).  Eager JAX calls stand in for the jitted ``render_frame``; they
reproduce the committed golden exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from pota_tpu.io.exr import read_exr

import golden_configs as gc
from tests.test_torch_optics import scaled_err

import pota_tpu_torch as pt
from pota_tpu_torch.config import config_from_fields
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import setup_po_camera
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render.renderer import (
    look_at,
    render_frame,
    render_sample_stream,
)
from pota_tpu_torch.render.splat import resolve_aovs, resolve_imager, splat_frame

torch.set_num_threads(2)

RC = pt.RenderConfig(xres=48, yres=48, spp=2)
PLANES = ("RGBA", "Z", "P", "lentil_raydir", "lentil_time", "lentil_debug")
SAME_STREAM_TOL = 1e-6
PIXEL_TOL = 2e-3
MAX_PIXELS_OFF = 0.02
ENERGY_TOL = 1e-5


def _scene():
    return sc.lightgrid_scene(n=3, spacing=18.0, z=-150.0, radius=1.0,
                              intensity=40.0, device="cpu")


def to_port(jax_cfg):
    """The port's CameraConfig / RenderConfig from a JAX one, field by
    field (enums by name)."""
    cls = pt.RenderConfig if hasattr(jax_cfg, "xres") else pt.CameraConfig
    return config_from_fields(cls, dataclasses.asdict(jax_cfg))


def to_jax(port_cfg):
    """A JAX CameraConfig / RenderConfig from the port's one."""
    import pota_tpu

    cls = (pota_tpu.RenderConfig if hasattr(port_cfg, "xres")
           else pota_tpu.CameraConfig)
    fields = dataclasses.asdict(port_cfg)
    for k, v in fields.items():
        if hasattr(v, "name"):
            fields[k] = type(getattr(cls(), k))[v.name]
    return cls(**fields)


def jax_stream_to_torch(js):
    tjs = {k: torch.as_tensor(np.array(v)) for k, v in js.items()}
    for k in ("px", "py", "sid", "key"):
        tjs[k] = tjs[k].to(torch.int64)
    return tjs


CRYPTO_PLANES = ("crypto_rank_id", "crypto_rank_w", "crypto_total")


def splat_pair(cfg, rc, jscene, tscene, m_end=None, po=None, cdf=None,
               aovs=None, ops=None):
    """JAX's splat_frame (on the CPU: its decomposed branch) and the port's
    of JAX's sample stream, for the port's ``cfg`` / ``rc``.  ``po`` is
    ((jax lens, jax state), (port lens, port state)), ``cdf`` (jax, port)
    bokeh tables, ``m_end`` the end-of-shutter matrix as numpy, ``aovs``
    the port's AOV specs, ``ops`` the port's kernel set (default its
    kernels).  With ``rc.enable_id_matte`` both splats take the scene's
    object count as ``n_crypto_ids`` (as ``render_frame`` does), and both
    planes dicts carry the raw id-matte planes (:data:`CRYPTO_PLANES`).
    Returns (port resolved planes, JAX resolved planes, (port raw RGBA
    energy, JAX's), the port's framebuffer)."""
    from pota_tpu.render import aov as jaov
    from pota_tpu.render import splat as jsplat
    from pota_tpu.render.renderer import render_sample_stream as jstream

    jcfg, jrc = to_jax(cfg), to_jax(rc)
    (jl, js_), (tl, ts_) = po if po is not None else ((None, None),
                                                      (None, None))
    jcdf, tcdf = cdf if cdf is not None else (None, None)
    jend = None if m_end is None else np.asarray(m_end, np.float32)
    jaovs = None if aovs is None else [
        jaov.AOVSpec(a.name, a.type, a.filter, a.source, a.redistribute)
        for a in aovs]
    n_ids = tscene.n_objects if rc.enable_id_matte else 0
    js = jstream(jcfg, jrc, jscene, gc.M, 0, po_lens=jl, po_state=js_,
                 bokeh_cdf=jcdf, cam_to_world_end=jend)
    jfb = jsplat.splat_frame(jcfg, jrc, jscene, js, gc.M, po_lens=jl,
                             po_state=js_, bokeh_cdf=jcdf, aovs=jaovs,
                             n_crypto_ids=n_ids, cam_to_world_end=jend)
    want = {k: np.asarray(v)
            for k, v in jsplat.resolve_aovs(jrc, jfb, jaovs).items()}
    with torch.no_grad():
        fb = splat_frame(
            cfg, rc, tscene, jax_stream_to_torch(js),
            look_at([0, 0, 0], [0, 0, -1], device="cpu"), po_lens=tl,
            po_state=ts_, bokeh_cdf=tcdf, aovs=aovs, n_crypto_ids=n_ids,
            cam_to_world_end=(None if m_end is None
                              else torch.as_tensor(jend)),
            with_diagnostics=True, ops=ops)
    got = {k: v.numpy() for k, v in resolve_aovs(rc, fb, aovs).items()}
    if n_ids:
        got.update({k: fb[k].numpy() for k in CRYPTO_PLANES})
        want.update({k: np.asarray(jfb[k]) for k in CRYPTO_PLANES})
    energy = (float(fb["RGBA"].double().sum()),
              float(np.asarray(jfb["RGBA"], np.float64).sum()))
    return got, want, energy, fb


def assert_splat_pair_close(pair, tol=SAME_STREAM_TOL, energy_tol=ENERGY_TOL):
    """Some slots splat; every plane of the same-stream pair within ``tol``
    of its scale, the raw RGBA energy within ``energy_tol``, and energy
    conserved."""
    got, want, (e_got, e_want), fb = pair
    assert int(fb["_n_valid_splats"]) > 0
    assert set(got) == set(want)
    for plane in set(want) - set(CRYPTO_PLANES):
        assert np.isfinite(got[plane]).all(), plane
        assert scaled_err(got[plane], want[plane]) < tol, plane
    if "crypto_total" in want:
        assert_crypto_close(got, want)
    assert abs(e_got - e_want) <= energy_tol * max(abs(e_want), 1e-12)
    npix = fb["filter_weight"].numel()
    assert abs(float(fb["filter_weight"].sum()) - npix) <= 1e-5 * npix


def assert_crypto_close(got, want, total_tol=1e-6, w_tol=1e-5,
                        tie=1e-5):
    """The id-matte planes of two splats of one stream: ``crypto_total``
    within ``total_tol`` of its scale, ``crypto_rank_w`` within ``w_tol``,
    and ``crypto_rank_id`` identical except at near-ties: ranks whose
    weight in ``want`` lies within ``tie`` (relative), or within twice
    ``w_tol`` of scale, of a neighbouring rank's.  Some pixel holds an
    id."""
    tot_g, tot_w = got["crypto_total"], want["crypto_total"]
    assert float(tot_w.max()) > 0 and (want["crypto_rank_id"] >= 0).any()
    assert scaled_err(tot_g, tot_w) < total_tol
    rw_g, rw_w = got["crypto_rank_w"], want["crypto_rank_w"]
    assert scaled_err(rw_g, rw_w) < w_tol
    step = np.abs(rw_w[..., 1:] - rw_w[..., :-1])
    close = ((step <= np.maximum(tie * rw_w[..., :-1],
                                 2.0 * w_tol * float(rw_w.max())))
             & (rw_w[..., :-1] > 0))
    near = np.zeros(rw_w.shape, bool)
    near[..., 1:] |= close
    near[..., :-1] |= close
    np.testing.assert_array_equal(got["crypto_rank_id"][~near],
                                  want["crypto_rank_id"][~near])


def frac_pixels_off(got, want, tol=PIXEL_TOL):
    """Share of pixels whose largest channel error exceeds ``tol`` of the
    plane's scale."""
    got = np.asarray(got, np.float64).reshape(got.shape[0] * got.shape[1], -1)
    want = np.asarray(want, np.float64).reshape(got.shape)
    scale = max(np.abs(want).max(), 1.0)
    return float((np.abs(got - want).max(-1) > tol * scale).mean())


@pytest.fixture(scope="module")
def jax_po():
    """JAX's golden-config camera: (cfg, lens, POState)."""
    return gc._po()


@pytest.fixture(scope="module")
def port_po(jax_po):
    cfg = to_port(jax_po[0])
    lens = load_poly_lens(gc.FLAGSHIP, device="cpu")
    return cfg, lens, setup_po_camera(lens, cfg)


def _np_fb(fb):
    return {k: np.asarray(v) for k, v in fb.items()}


@pytest.fixture(scope="module")
def renders(jax_po, port_po):
    """JAX and port streams and framebuffers, plus the port's splat of the
    JAX stream."""
    from pota_tpu.render.renderer import render_sample_stream as jax_stream
    from pota_tpu.render import splat as jsplat

    jcfg, jlens, jstate = jax_po
    cfg, jrc = port_po[0], to_jax(RC)
    jscene = gc.sc.lightgrid_scene(n=3, spacing=18.0, z=-150.0, radius=1.0,
                                   intensity=40.0)
    js = jax_stream(jcfg, jrc, jscene, gc.M, 0, po_lens=jlens,
                    po_state=jstate)
    jfb = jsplat.splat_frame(jcfg, jrc, jscene, js, gc.M, po_lens=jlens,
                             po_state=jstate)
    want = _np_fb(jsplat.resolve_aovs(jrc, jfb))
    want["image"] = np.asarray(jsplat.resolve_imager(jrc, jfb))
    want["raw"] = _np_fb(jfb)
    want["stream"] = _np_fb(js)

    _, tlens, tstate = port_po
    m = look_at([0, 0, 0], [0, 0, -1], device="cpu")
    timg, tfb = render_frame(cfg, RC, _scene(), m, seed=0, po_lens=tlens,
                             po_state=tstate)
    got = {k: v.numpy() for k, v in resolve_aovs(RC, tfb).items()}
    got["image"] = timg.numpy()
    got["raw"] = {k: v.numpy() for k, v in tfb.items()}
    with torch.no_grad():
        got["stream"] = {k: v.numpy() for k, v in render_sample_stream(
            cfg, RC, _scene(), m, 0, po_lens=tlens, po_state=tstate).items()}
        same = splat_frame(cfg, RC, _scene(),
                           jax_stream_to_torch(want["stream"]), m,
                           po_lens=tlens, po_state=tstate)
    got["same_stream"] = {k: v.numpy()
                          for k, v in resolve_aovs(RC, same).items()}
    got["same_stream"]["image"] = resolve_imager(RC, same).numpy()
    return got, want


def test_setup_po_camera_matches(jax_po, port_po):
    jstate = jax_po[2]
    tstate = port_po[2]
    # the same swept shift candidate and calibration height are chosen
    assert tstate.sensor_shift == jstate.sensor_shift
    assert tstate.aperture_radius == jstate.aperture_radius
    assert tstate.focus_distance == jstate.focus_distance
    assert tstate.tan_fov == pytest.approx(jstate.tan_fov, rel=1e-12)


def test_stream_matches_jax(renders):
    got, want = renders
    g, w = got["stream"], want["stream"]
    assert set(g) == set(w)
    for k in ("px", "py", "sid", "key", "sx", "sy", "r1", "r2", "time",
              "hit", "obj_id", "weight", "rgba"):
        np.testing.assert_array_equal(g[k], w[k].astype(g[k].dtype), err_msg=k)
    hit = w["hit"]
    assert scaled_err(g["raydir"], w["raydir"]) < 1e-5
    assert scaled_err(g["P"], w["P"]) < 2e-4
    assert scaled_err(g["z"][hit], w["z"][hit]) < 2e-4


@pytest.mark.parametrize("plane", PLANES + ("image",))
def test_splat_matches_jax_on_same_stream(renders, plane):
    got, want = renders
    assert scaled_err(got["same_stream"][plane], want[plane]) < SAME_STREAM_TOL


@pytest.mark.parametrize("plane", PLANES)
def test_render_aov_plane_matches_jax(renders, plane):
    got, want = renders
    assert got[plane].shape == want[plane].shape == (48, 48, 4)
    assert np.isfinite(got[plane]).all()
    assert frac_pixels_off(got[plane], want[plane]) <= MAX_PIXELS_OFF


def test_render_energy_matches_jax(renders):
    got, want = renders
    for k in ("RGBA", "filter_weight"):
        e_got = float(got["raw"][k].sum())
        e_want = float(want["raw"][k].sum())
        assert abs(e_got - e_want) <= ENERGY_TOL * abs(e_want), (k, e_got,
                                                                 e_want)
    assert float(np.abs(got["RGBA"]).max()) > 1e-3


def test_render_matches_golden(renders):
    got, _ = renders
    golden = read_exr(gc.golden_path("po_lightgrid"))
    ref = np.stack([golden[f"rgba.{c}"] for c in "RGBA"], -1)
    assert frac_pixels_off(got["image"], ref) <= MAX_PIXELS_OFF
    # the same-stream splat reproduces the golden itself
    assert scaled_err(got["same_stream"]["image"], ref) < SAME_STREAM_TOL


def test_resolve_gaussian_matches_jax(renders):
    """The forward-only resolve (redistribution off) on JAX's stream; exp of
    two libms, so float32 rounding only."""
    from pota_tpu.render.renderer import resolve_gaussian as jax_resolve
    from pota_tpu_torch.render.renderer import resolve_gaussian

    js = {k: renders[1]["stream"][k] for k in ("ox", "oy", "rgba")}
    want = np.asarray(jax_resolve(to_jax(RC), js))
    got = resolve_gaussian(RC,
                           {k: torch.as_tensor(v) for k, v in js.items()})
    assert float(np.abs(want).max()) > 1e-3
    assert scaled_err(got, want) < SAME_STREAM_TOL


def test_energy_conservation(renders):
    """Each sample deposits exactly 1/spp of filter weight, through its
    successful slots or through the source-pixel fallback."""
    got, _ = renders
    npix = RC.xres * RC.yres
    assert abs(float(got["raw"]["filter_weight"].sum()) - npix) <= 1e-5 * npix
    assert int((got["raw"]["filter_weight"] > 0).sum()) > npix // 2


# the thin-lens splat with these settings takes JAX's decomposed branch;
# refused before the port had it, each now renders an 8x8 frame that is
# held against JAX's splat of the same sample stream
@pytest.mark.parametrize("change, match", [
    ({"camera_type": pt.CameraType.THIN_LENS, "abb_coma": 0.5}, "thin-lens"),
    ({"camera_type": pt.CameraType.THIN_LENS, "abb_chromatic": 0.5},
     "chromatic"),
    ({"camera_type": pt.CameraType.THIN_LENS, "bokeh_enable_image": True},
     "image bokeh"),
    ({"camera_type": pt.CameraType.THIN_LENS, "aperture_blades": 5}, "blade"),
])
def test_unported_configs_raise(port_po, change, match):
    from pota_tpu_torch.render import splat as tsplat

    cfg = dataclasses.replace(port_po[0], **change)
    pair = splat_pair(cfg, pt.RenderConfig(xres=8, yres=8, spp=2),
                      gc.sc.teapot_scene(), sc.teapot_scene(device="cpu"),
                      cdf=ring_cdfs())
    assert tsplat.LAST_ROUTE == "decomposed_tl"
    assert_splat_pair_close(pair)


GLASS_TINT = 0.5


def glass_teapots(tint=GLASS_TINT):
    """The teapot scene with thin glass of grey ``tint`` on its two nearest
    diffuse spheres (indices 0 and 1): JAX's and the port's (CPU)."""
    import jax.numpy as jnp

    from pota_tpu.render import scene as jsc

    jscene = jsc.teapot_scene()
    trans = np.zeros((jscene.n_objects, 3), np.float32)
    trans[:2] = tint
    jscene = dataclasses.replace(jscene, transmission=jnp.asarray(trans))
    tscene = dataclasses.replace(sc.teapot_scene(device="cpu"),
                                 transmission=torch.as_tensor(trans))
    return jscene, tscene


def ring_cdfs():
    """The golden configs' procedural ring aperture
    (``golden_configs.py::_bokeh_ring_cdf``): JAX's tables and the port's
    copy of them."""
    from pota_tpu_torch.render.bokeh_image import bokeh_image_from_numpy

    jb = gc._bokeh_ring_cdf()
    tables = [np.asarray(getattr(jb, k)) for k in (
        "cdf_row", "row_indices", "cdf_col", "col_indices", "alias_prob",
        "alias_idx")]
    return jb, bokeh_image_from_numpy(*tables, jb.resolution, device="cpu")


# the differentiable cases' labels -> the splat route they take
DIFFERENTIABLE_ROUTES = {"differentiable": "decomposed_po", "Q1.8b": "k3",
                         "Q1.8c": "k5"}


@pytest.mark.parametrize("kwargs, rc_kw, label", [
    ({"differentiable": True, "cam_to_world_end": "trucked"}, {},
     "differentiable"),
    ({"cam_to_world_end": torch.eye(4)}, {}, "motion blur"),
    ({}, {"enable_id_matte": True}, None),
    ({"differentiable": True, "aovs": "extra gaussian"}, {}, "Q1.8b"),
    ({"differentiable": True, "camera": "thin lens"}, {}, "Q1.8c"),
])
def test_unported_options_raise(jax_po, port_po, kwargs, rc_kw, label):
    """Nothing here is refused any more.  The differentiable mode with
    motion blur (ROADMAP Q1.8a, the decomposed route), with a gaussian AOV
    besides RGBA (Q1.8b, K3) and on the thin lens (Q1.8c, K5) renders an
    8x8 frame that records a graph, and ``backward()`` fills finite,
    non-zero gradients (of the lens coefficients; on the thin lens of
    ``cam_to_world``); tests/test_torch_grad_{mb,aovs,thin}.py hold them
    to JAX.  Motion blur and the id-matte, refused before the port had
    them, render an 8x8 frame held against JAX's splat of the same stream
    (the id-matte on K3, of a teapot with two glass spheres, its crypto
    planes compared)."""
    from pota_tpu_torch.render import splat as tsplat
    from pota_tpu_torch.render.aov import DEFAULT_AOVS, GAUSSIAN, AOVSpec

    cfg, lens, state = port_po
    rc = pt.RenderConfig(xres=8, yres=8, spp=1, **rc_kw)
    kwargs = dict(kwargs)
    if rc.enable_id_matte:
        jscene, tscene = glass_teapots()
        pair = splat_pair(cfg, rc, jscene, tscene,
                          po=(jax_po[1:], (lens, state)))
        assert tsplat.LAST_ROUTE == "k3"
        assert_splat_pair_close(pair)
        return
    if kwargs.get("cam_to_world_end") is not None and not kwargs.get(
            "differentiable"):
        end = look_at([2.0, 0, 0], [2.0, 0, -1], device="cpu")
        pair = splat_pair(
            cfg, rc, gc.sc.lightgrid_scene(n=3, spacing=18.0, z=-150.0,
                                           radius=1.0, intensity=40.0),
            _scene(), m_end=end.numpy(),
            po=(jax_po[1:], (lens, state)))
        assert_splat_pair_close(pair)
        return
    if kwargs.get("cam_to_world_end") == "trucked":
        kwargs["cam_to_world_end"] = look_at([2.0, 0, 0], [2.0, 0, -1],
                                             device="cpu")
    if kwargs.get("aovs") == "extra gaussian":
        kwargs["aovs"] = list(DEFAULT_AOVS) + [
            AOVSpec("P_gauss", "VECTOR", GAUSSIAN, "P")]
    m = look_at([0, 0, 0], [0, 0, -1], device="cpu")
    if kwargs.pop("camera", None) == "thin lens":
        cfg = dataclasses.replace(cfg, camera_type=pt.CameraType.THIN_LENS)
        leaves = [m.requires_grad_(True)]
    else:
        lens = load_poly_lens(gc.FLAGSHIP, device="cpu")
        leaves = [lens.pt.coeffs.requires_grad_(True),
                  lens.ap.coeffs.requires_grad_(True)]
    img, _ = render_frame(cfg, rc, sc.teapot_scene(device="cpu"), m,
                          po_lens=lens, po_state=state, **kwargs)
    assert tsplat.LAST_ROUTE == DIFFERENTIABLE_ROUTES[label]
    assert img.requires_grad
    img[..., :3].mean().backward()
    for leaf in leaves:
        assert bool(torch.isfinite(leaf.grad).all())
        assert float(leaf.grad.norm()) > 0
