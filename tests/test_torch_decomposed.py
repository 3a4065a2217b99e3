"""The port's decomposed splat route against the JAX package on the CPU:
K6's plain version (the PO backward solve) against the Pallas backward
kernel in interpret mode, the motion-blurred PO frame at the
``po_lightgrid`` golden configuration and, chromatic, with BASELINE config
3's camera (K6's three wavelength tables), the wavelengths each frame hands
K6, the aberrated thin-lens goldens
``thinlens_chromatic`` and ``bokeh_image_aperture``, motion blur in the
pattern of ``tests/test_motion_blur.py``, extra gaussian AOVs on the K3 and
decomposed routes, and the port's independence from ``pota_tpu`` and its
card-by-default constructors.

On the CPU, JAX's ``splat_frame`` always takes its decomposed branch (its
kernel resolvers return None there) with scatter accumulation, so the
same-stream comparisons hold the port's route against JAX's decomposed
branch.  Tolerances, each set from the value measured on these inputs:
- K6's plain version: the same Newton in another summation order (and
  powers built another way), on targets wide enough that the outer pupil
  crops 3-10% of them.  Each output is held to 1e-5 of its scale on 99.9%
  of the items both keep (measured at most 8.2e-7) and to 2e-4 on every
  item (measured at most 6.3e-5: one synthetic-lens item in 3,000, 1.4e-3
  mm on a 21.7 mm scale, where the Newton has not converged), and
  ``trans > 0`` on >= 99.9% of items (measured: all);
- the port's splat of JAX's sample stream: 1e-6 of each plane's scale
  (measured 2.3e-7 on RGBA of the motion-blurred PO frame, 8.2e-7 on RGBA
  of the chromatic one, every other plane exact) and raw RGBA energy to
  1e-5 (measured 2.6e-9 on the chromatic one);
- the port's own frames against JAX's frame or a golden: at most 2% of
  pixels off by more than 2e-3 of the plane's scale, as the PO slice is
  held (the forward streams differ by float32 rounding, which can move a
  slot across a pixel edge or a sphere silhouette).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pota_tpu.io.exr import read_exr
from pota_tpu.ops.po_pallas import build_po_backward_kernel
from pota_tpu.optics.fit import load_poly_lens as jax_load_poly_lens
from pota_tpu.render import aov as jaov
from pota_tpu.render import splat as jsplat

import golden_configs as gc
from tests.test_po_pallas import synthetic_lens  # noqa: F401 (fixture)
from tests.test_torch_optics import scaled_err, to_torch_lens
from tests.test_torch_slice import (
    MAX_PIXELS_OFF,
    assert_splat_pair_close,
    frac_pixels_off,
    jax_stream_to_torch,
    ring_cdfs,
    splat_pair,
    to_jax,
    to_port,
)

import pota_tpu_torch as pt
from pota_tpu_torch import ops
from pota_tpu_torch.ops import po_kernels as pk
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import setup_po_camera
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render import splat as tsplat
from pota_tpu_torch.render.aov import DEFAULT_AOVS, GAUSSIAN, AOVSpec
from pota_tpu_torch.render.renderer import look_at, render_frame

torch.set_num_threads(2)

K6_TOL, K6_TOL_ALL = 1e-5, 2e-4
SAME_STREAM_TOL = 1e-6
PLANES = ("RGBA", "Z", "P", "lentil_raydir", "lentil_time", "lentil_debug",
          "P_gauss")
EXTRA_AOVS = list(DEFAULT_AOVS) + [AOVSpec("P_gauss", "VECTOR", GAUSSIAN,
                                           "P")]
RC = pt.RenderConfig(xres=48, yres=48, spp=2)
# a 2-unit truck of the camera across the shutter
PAN_END = (2.0, 0.0, 0.0), (2.0, 0.0, -1.0)
CPU = "cpu"


def _grid(device=None):
    """The po_lightgrid golden scene (tests/golden_configs.py:76-77)."""
    kw = dict(n=3, spacing=18.0, z=-150.0, radius=1.0, intensity=40.0)
    return gc.sc.lightgrid_scene(**kw) if device is None else \
        sc.lightgrid_scene(**kw, device=device)


@functools.lru_cache(maxsize=None)
def _jax_po():
    """JAX's golden-config camera (cfg, lens, POState), built once."""
    return gc._po()


@functools.lru_cache(maxsize=None)
def _port_po():
    """The port's golden-config camera (cfg, lens, POState) on the CPU."""
    cfg = to_port(_jax_po()[0])
    lens = load_poly_lens(gc.FLAGSHIP, device=CPU)
    return cfg, lens, setup_po_camera(lens, cfg)


def _emitter(x=0.0):
    """The port's copy of golden_configs._emitter."""
    return sc.sphere_scene_from_numpy(
        centers=[[x, 0.0, -45.0]], radii=[1.0],
        emission=np.full((1, 3), 40.0), albedo=np.zeros((1, 3)),
        sky_color=np.zeros(3), light_dir=[0.0, 1.0, 0.0],
        light_color=np.zeros(3), device=CPU)


# ------------------------------------------------------- K6 backward solve


LAMS = (0.43, 0.55, 0.73)


def _backward_inputs(n, seed, xy, z, ap_r):
    """Targets, aperture points and a wavelength index into :data:`LAMS`
    per item (int32), and the items' wavelengths (f32) for the Pallas
    kernel."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(-xy, xy, n), rng.uniform(-xy, xy, n),
                  rng.uniform(*z, n)], 0).astype(np.float32)
    ap = (rng.uniform(-1, 1, (2, n)) * ap_r).astype(np.float32)
    idx = rng.integers(0, len(LAMS), n).astype(np.int32)
    return [*p, *ap], idx, np.asarray(LAMS, np.float32)[idx]


@pytest.mark.parametrize("lens_name", ["synthetic", "catalog_deg3"])
def test_po_backward_plain_matches_pallas(synthetic_lens, lens_name):
    if lens_name == "synthetic":
        jl = synthetic_lens
        ins, idx, lam = _backward_inputs(3000, 11, 250.0, (300.0, 2500.0),
                                         8.0)
    else:
        # the flagship's committed degree-3 fit (56 terms): a real catalog
        # lens whose interpret-mode kernel traces in seconds
        jl = jax_load_poly_lens(gc.FLAGSHIP, degree=3)
        ins, idx, lam = _backward_inputs(3000, 5, 500.0, (500.0, 3000.0),
                                         jl.aperture_housing_radius * 0.6)
    kern = build_po_backward_kernel(jl, iterations=5, interpret=True)
    want = [np.asarray(a) for a in kern(*(jnp.asarray(a)
                                          for a in (*ins, lam)))]
    got = pk.po_backward(to_torch_lens(jl),
                         *(torch.as_tensor(a) for a in ins), LAMS,
                         torch.as_tensor(idx), 5)
    got = [g.numpy() for g in got]
    keep_w, keep_g = want[4] > 0, got[4] > 0
    assert 0.2 < keep_w.mean() < 0.98          # both sides of the crop
    assert (keep_w == keep_g).mean() >= 0.999
    both = keep_w & keep_g
    for g, w in zip(got, want):
        err = np.abs(g[both].astype(np.float64) - w[both])
        scale = np.abs(w[both]).max()
        assert np.quantile(err, 0.999) < K6_TOL * scale
        assert err.max() < K6_TOL_ALL * scale
    assert (got[4] >= 0).all()


def test_po_backward_guards_the_chief_ray_init(synthetic_lens):
    """A target at |z| < 1e-6 takes the kernel's floored chief-ray guess
    and stays finite, as the Pallas kernel does, on a monochromatic frame's
    one wavelength.  (Such a target starts the Newton ~1e8 mm off and does
    not converge in 3 iterations; at 0.43 um the two solves then drift
    2.5e-4 of scale apart on one of the eight, by float32 rounding.)"""
    ins, _, _ = _backward_inputs(64, 3, 50.0, (300.0, 900.0), 6.0)
    ins[2][:8] = 0.0
    kern = build_po_backward_kernel(synthetic_lens, iterations=3,
                                    interpret=True)
    lam = np.full(64, 0.55, np.float32)
    want = [np.asarray(a) for a in kern(*(jnp.asarray(a)
                                          for a in (*ins, lam)))]
    got = [g.numpy() for g in pk.po_backward_plain(
        to_torch_lens(synthetic_lens), *(torch.as_tensor(a) for a in ins),
        (0.55,), None, 3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        ok = np.isfinite(w)
        assert scaled_err(g[ok], w[ok]) < K6_TOL


# --------------------------------------------- the motion-blurred PO frame


class Recorder:
    """The default kernel set (:data:`pota_tpu_torch.ops.KERNELS`), keeping
    the arguments of every ``po_backward`` call."""

    def __init__(self):
        self.backward = []

        def po_backward(*args):
            self.backward.append(args)
            return pk.po_backward(*args)

        self.ops = ops.KERNELS._replace(po_backward=po_backward)



@pytest.fixture(scope="module")
def mb_frames():
    """At the po_lightgrid golden configuration with the camera trucked
    across the shutter: JAX's stream and splat (default AOVs and with an
    extra gaussian AOV), the port's splat of JAX's stream, and both
    packages' own frames."""
    from pota_tpu.render.renderer import look_at as jlook
    from pota_tpu.render.renderer import render_sample_stream as jstream

    jcfg, jlens, jstate = _jax_po()
    jrc, jend = to_jax(RC), jlook(*PAN_END)
    jscene = _grid()
    js = jstream(jcfg, jrc, jscene, gc.M, 0, po_lens=jlens, po_state=jstate,
                 cam_to_world_end=jend)
    jaovs = [jaov.AOVSpec(a.name, a.type, a.filter, a.source, a.redistribute)
             for a in EXTRA_AOVS]
    jfb = jsplat.splat_frame(jcfg, jrc, jscene, js, gc.M, po_lens=jlens,
                             po_state=jstate, cam_to_world_end=jend,
                             aovs=jaovs)
    jax_path = jsplat._LAST_PATH
    want = {k: np.asarray(v)
            for k, v in jsplat.resolve_aovs(jrc, jfb, jaovs).items()}

    cfg, lens, state = _port_po()
    m0 = look_at([0, 0, 0], [0, 0, -1], device=CPU)
    m1 = look_at(*PAN_END, device=CPU)
    with torch.no_grad():
        same = tsplat.splat_frame(cfg, RC, _grid(CPU), jax_stream_to_torch(js),
                                  m0, po_lens=lens, po_state=state,
                                  aovs=EXTRA_AOVS, cam_to_world_end=m1,
                                  with_diagnostics=True)
    route = tsplat.LAST_ROUTE
    rec = Recorder()
    _, own = render_frame(cfg, RC, _grid(CPU), m0, po_lens=lens,
                          po_state=state, cam_to_world_end=m1,
                          aovs=EXTRA_AOVS, ops=rec.ops)
    return {
        "jax_path": jax_path, "route": route, "want": want,
        "backward_calls": rec.backward, "cfg": cfg,
        "want_energy": float(np.asarray(jfb["RGBA"], np.float64).sum()),
        "same": {k: v.numpy() for k, v in
                 tsplat.resolve_aovs(RC, same, EXTRA_AOVS).items()},
        "same_fb": same,
        "own": {k: v.numpy() for k, v in
                tsplat.resolve_aovs(RC, own, EXTRA_AOVS).items()},
        "own_fb": own,
    }


def test_mb_routes(mb_frames):
    assert mb_frames["jax_path"] == "decomposed"
    assert mb_frames["route"] == "decomposed_po"
    assert int(mb_frames["same_fb"]["_n_valid_splats"]) > 500


@pytest.mark.parametrize("plane", PLANES)
def test_mb_splat_matches_jax_on_same_stream(mb_frames, plane):
    got, want = mb_frames["same"][plane], mb_frames["want"][plane]
    assert np.isfinite(got).all()
    assert scaled_err(got, want) < SAME_STREAM_TOL


@pytest.mark.parametrize("plane", PLANES)
def test_mb_frame_matches_jax(mb_frames, plane):
    got, want = mb_frames["own"][plane], mb_frames["want"][plane]
    assert got.shape == want.shape == (48, 48, 4)
    assert np.isfinite(got).all()
    assert frac_pixels_off(got, want) <= MAX_PIXELS_OFF


def test_mb_energy_matches_jax(mb_frames):
    e_want = mb_frames["want_energy"]
    for fb in (mb_frames["same_fb"], mb_frames["own_fb"]):
        e_got = float(fb["RGBA"].double().sum())
        assert abs(e_got - e_want) <= 1e-5 * e_want
        npix = RC.xres * RC.yres
        assert abs(float(fb["filter_weight"].sum()) - npix) <= 1e-5 * npix


# ------------------------------- the chromatic motion-blurred PO frame


CHROMA_GRID = dict(n=4, spacing=14.0, z=-150.0, radius=0.8, intensity=40.0)


@pytest.fixture(scope="module")
def chroma_mb():
    """BASELINE config 3's camera with image bokeh off (three wavelengths
    per budget unit) and its lightgrid, with the camera trucked across the
    shutter, at 48x48 @ 2 spp: JAX's decomposed branch and the port's splat
    of JAX's stream (its ``po_backward`` calls recorded), and the JAX path
    taken.  The golden camera's focus state serves: ``abb_chromatic`` does
    not move it."""
    from pota_tpu import CameraConfig, CameraType

    _, jlens, jstate = _jax_po()
    jcfg = CameraConfig(
        camera_type=CameraType.POLYNOMIAL_OPTICS, lens_model=gc.FLAGSHIP,
        fstop=2.8, focus_distance=20.0, vignetting_retries=3,
        splat_queue_mult=8, abb_chromatic=0.6)
    cfg = to_port(jcfg)
    _, lens, state = _port_po()
    rec = Recorder()
    pair = splat_pair(cfg, RC, gc.sc.lightgrid_scene(**CHROMA_GRID),
                      sc.lightgrid_scene(**CHROMA_GRID, device=CPU),
                      m_end=look_at(*PAN_END, device=CPU).numpy(),
                      po=((jlens, jstate), (lens, state)), ops=rec.ops)
    return {"pair": pair, "jax_path": jsplat._LAST_PATH,
            "route": tsplat.LAST_ROUTE, "cfg": cfg,
            "backward_calls": rec.backward}


def test_chroma_mb_routes(chroma_mb):
    assert chroma_mb["jax_path"] == "decomposed"
    assert chroma_mb["route"] == "decomposed_po"
    assert int(chroma_mb["pair"][3]["_n_valid_splats"]) > 500


@pytest.mark.parametrize("plane", PLANES[:-1])
def test_chroma_mb_splat_matches_jax_on_same_stream(chroma_mb, plane):
    got, want = chroma_mb["pair"][0][plane], chroma_mb["pair"][1][plane]
    assert np.isfinite(got).all()
    assert scaled_err(got, want) < SAME_STREAM_TOL


def test_chroma_mb_energy_matches_jax(chroma_mb):
    e_got, e_want = chroma_mb["pair"][2]
    assert abs(e_got - e_want) <= 1e-5 * e_want
    fb = chroma_mb["pair"][3]
    npix = RC.xres * RC.yres
    assert abs(float(fb["filter_weight"].sum()) - npix) <= 1e-5 * npix


@pytest.mark.parametrize("frame", ["mb_frames", "chroma_mb"])
def test_backward_gets_the_frame_wavelengths(request, frame):
    """K6 is handed the frame's wavelengths as Python floats: one and no
    index for a monochromatic frame, the chroma three and the slots'
    channel (int32) as the index for a chromatic one."""
    rec = request.getfixturevalue(frame)
    (args,) = rec["backward_calls"]
    lams, lam_idx = args[6], args[7]
    cfg = rec["cfg"]
    if frame == "mb_frames":
        assert lams == (cfg.lambda_um,) and lam_idx is None
        return
    assert lams == tsplat.chroma_wavelengths(cfg) == (0.43, 0.55, 0.73)
    assert lam_idx.dtype == torch.int32
    assert lam_idx.shape == args[1].shape
    assert set(lam_idx.unique().tolist()) == {0, 1, 2}


# ------------------------------------------------------ thin-lens goldens


GOLDEN_TL = {
    # tests/golden_configs.py:83-100
    "thinlens_chromatic": (dict(abb_chromatic=1.0), 4.0),
    "bokeh_image_aperture": (dict(bokeh_enable_image=True), 0.0),
}


@pytest.fixture(scope="module")
def tl_goldens():
    out = {}
    for name, (kw, x) in GOLDEN_TL.items():
        cfg = pt.CameraConfig(focal_length=65.0, fstop=1.8,
                              focus_distance=15.0, vignetting_retries=2,
                              splat_queue_mult=6, **kw)
        rc = pt.RenderConfig(xres=48, yres=48, spp=4)
        cdf = ring_cdfs()
        pair = splat_pair(cfg, rc, gc._emitter(x=x), _emitter(x), cdf=cdf)
        route = tsplat.LAST_ROUTE
        img, _ = render_frame(cfg, rc, _emitter(x),
                              look_at([0, 0, 0], [0, 0, -1], device=CPU),
                              bokeh_cdf=cdf[1])
        out[name] = (pair, route, img.numpy())
    return out


@pytest.mark.parametrize("name", list(GOLDEN_TL))
def test_tl_golden_splat_matches_jax_on_same_stream(tl_goldens, name):
    pair, route, _ = tl_goldens[name]
    assert route == "decomposed_tl"
    assert int(pair[3]["_n_valid_splats"]) > 1000
    assert_splat_pair_close(pair)


@pytest.mark.parametrize("name", list(GOLDEN_TL))
def test_tl_golden_render_matches_golden(tl_goldens, name):
    _, _, img = tl_goldens[name]
    golden = read_exr(gc.golden_path(name))
    ref = np.stack([golden[f"rgba.{c}"] for c in "RGBA"], -1)
    assert np.isfinite(img).all()
    assert float(np.abs(img).max()) > 1e-3
    assert frac_pixels_off(img, ref) <= MAX_PIXELS_OFF


# ------------------------------------------- motion blur, port on its own


MB_TL_CFG = pt.CameraConfig(focal_length=65.0, fstop=4.0,
                            focus_distance=400.0, vignetting_retries=1,
                            max_bidir_samples=4)
MB_RC = pt.RenderConfig(xres=48, yres=48, spp=4)


def _mb_render(model, end):
    """tests/test_motion_blur.py's thin-lens frame, or the PO golden
    configuration's, with the camera matrix at the shutter's end."""
    m0 = look_at([0, 0, 0], [0, 0, -1], device=CPU)
    if model == "thin":
        scene = sc.lightgrid_scene(n=1, spacing=1.0, z=-400.0, radius=4.0,
                                   intensity=30.0, device=CPU)
        img, fb = render_frame(MB_TL_CFG, MB_RC, scene, m0,
                               cam_to_world_end=end)
    else:
        cfg, lens, state = _port_po()
        img, fb = render_frame(cfg, RC, _grid(CPU), m0, po_lens=lens,
                               po_state=state, cam_to_world_end=end)
    return img.numpy(), tsplat.LAST_ROUTE


@pytest.mark.parametrize("model", ["thin", "po"])
def test_static_end_matrix_matches_no_motion(model):
    """A static end matrix takes the decomposed route and renders what the
    fused kernels' route renders without motion blur."""
    a, route_a = _mb_render(model, None)
    b, route_b = _mb_render(model, look_at([0, 0, 0], [0, 0, -1],
                                           device=CPU))
    assert route_a == ("k5" if model == "thin" else "k3")
    assert route_b == ("decomposed_tl" if model == "thin"
                       else "decomposed_po")
    assert frac_pixels_off(b, a) <= MAX_PIXELS_OFF
    assert abs(b.sum() - a.sum()) <= 2e-3 * a.sum()


@pytest.mark.parametrize("model", ["thin", "po"])
def test_camera_pan_smears_highlight(model):
    a, _ = _mb_render(model, None)
    end = (look_at([30.0, 0, 0], [30.0, 0, -400.0], device=CPU)
           if model == "thin" else look_at([6.0, 0, 0], [6.0, 0, -1],
                                           device=CPU))
    b, _ = _mb_render(model, end)
    lit = lambda im: (im[..., :3].max(-1) > 0.05)
    cols_a = np.unique(np.where(lit(a))[1])
    cols_b = np.unique(np.where(lit(b))[1])
    assert len(cols_b) > len(cols_a) + 2, (len(cols_a), len(cols_b))
    assert 0.5 * a.sum() < b.sum() < 2.0 * a.sum()


# ------------------------------------------- extra gaussian AOV, K3 route


def test_extra_gaussian_aov_on_k3_route():
    jcfg, jlens, jstate = _jax_po()
    cfg, lens, state = _port_po()
    pair = splat_pair(cfg, RC, _grid(), _grid(CPU),
                      po=((jlens, jstate), (lens, state)), aovs=EXTRA_AOVS)
    assert tsplat.LAST_ROUTE == "k3"
    assert "P_gauss" in pair[0]
    assert float(np.abs(pair[1]["P_gauss"]).max()) > 1.0
    assert_splat_pair_close(pair)


# ------------------------------------------------ independence, devices


def test_imports_nothing_of_pota_tpu(tmp_path):
    """With ``pota_tpu`` made unimportable, the port imports and renders an
    8x8 frame on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['pota_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import pota_tpu_torch as pt\n"
        "from pota_tpu_torch.optics.fit import load_poly_lens\n"
        "from pota_tpu_torch.optics.focus import setup_po_camera\n"
        "from pota_tpu_torch.render import scene as sc\n"
        "from pota_tpu_torch.render.renderer import look_at, render_frame\n"
        "lens = load_poly_lens('" + gc.FLAGSHIP + "', device='cpu')\n"
        "cfg = pt.CameraConfig(camera_type=pt.CameraType.POLYNOMIAL_OPTICS,"
        " fstop=2.8, focus_distance=20.0, vignetting_retries=1,"
        " splat_queue_mult=2)\n"
        "img, fb = render_frame(cfg, pt.RenderConfig(xres=8, yres=8, spp=1),"
        " sc.lightgrid_scene(n=2, z=-150.0, device='cpu'),"
        " look_at([0, 0, 0], [0, 0, -1], device='cpu'), po_lens=lens,"
        " po_state=setup_po_camera(lens, cfg),"
        " cam_to_world_end=look_at([1, 0, 0], [1, 0, -1], device='cpu'))\n"
        "assert img.shape == (8, 8, 4) and bool(torch.isfinite(img).all())\n"
        "print('RENDERED', sorted(m for m in sys.modules"
        " if m.startswith('pota_tpu.')))\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "RENDERED []" in out.stdout, out.stdout


CONSTRUCTORS = {
    "lightgrid_scene": lambda: sc.lightgrid_scene(),
    "teapot_scene": lambda: sc.teapot_scene(),
    "look_at": lambda: look_at([0, 0, 0], [0, 0, -1]),
    "load_poly_lens": lambda: load_poly_lens(gc.FLAGSHIP),
    "build_bokeh_cdf": lambda: __import__(
        "pota_tpu_torch.render.bokeh_image", fromlist=["x"]).build_bokeh_cdf(
            np.ones((4, 4, 3), np.float32)),
    "default_device": lambda: pt.default_device(),
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructors_default_to_the_card(name):
    """Without CUDA, a constructor given no device raises: nothing falls
    back to the CPU silently."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CONSTRUCTORS[name]()


@pytest.mark.parametrize("entry", ["render_frame", "render_sample_stream",
                                   "splat_frame"])
def test_jax_configs_are_refused(entry):
    """A JAX config handed to the port raises TypeError; converted with
    config_from_fields it is accepted."""
    from pota_tpu_torch.render import renderer

    jcfg = _jax_po()[0]
    rc = pt.RenderConfig(xres=8, yres=8, spp=1)
    scene = _grid(CPU)
    m = look_at([0, 0, 0], [0, 0, -1], device=CPU)
    fn = {"render_frame": renderer.render_frame,
          "render_sample_stream": renderer.render_sample_stream,
          "splat_frame": tsplat.splat_frame}[entry]
    rest = ({}, m) if entry == "splat_frame" else (m,)
    with pytest.raises(TypeError, match="config_from_fields"):
        fn(jcfg, rc, scene, *rest)
    with pytest.raises(TypeError, match="config_from_fields"):
        fn(to_port(jcfg), to_jax(rc), scene, *rest)
    assert to_port(jcfg).camera_type is pt.CameraType.POLYNOMIAL_OPTICS
    assert dataclasses.asdict(to_port(jcfg)) == dataclasses.asdict(jcfg)
