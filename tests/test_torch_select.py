"""K1's select mode on the CPU: ``ops.po_forward_selected`` (K1 draws each
ray's aperture candidates, selects the first that passes the pupil crops and
hands back the ray), its plain version against K1's plain candidates of the
torch draw followed by the torch epilogue ``trace_fw_po`` ran after it,
``SelectFn``'s gradients against autograd through that route, the charts' VJP
against autograd, the routes ``trace_fw_po`` keeps, and the counts
(``k1.selected``, K1's calls a trace).  The kernels themselves are held to the
same route on the card: ``test_torch_cuda.py -k select``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import pota_tpu_torch as pt
from pota_tpu_torch import ops
from pota_tpu_torch.models import po_camera
from pota_tpu_torch.ops import po_kernels as pk
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import POState
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render.bokeh_image import build_bokeh_cdf
from pota_tpu_torch.render.renderer import look_at, render_frame
from pota_tpu_torch.utils import trace

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
STATE = POState(aperture_radius=4.672678708153359,
                sensor_shift=15.091056449990935, focus_distance=200.0,
                tan_fov=0.36734693877551)
CFG = pt.CameraConfig(
    camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
    fstop=2.8, focus_distance=20.0, vignetting_retries=3)
HSW = CFG.sensor_width * 0.5
SCALE = CFG.unit_scale_po
LAM, ITERS = 0.55, 3
CHARTS = ("sphere", "cyl-x", "cyl-y")


@pytest.fixture(scope="module")
def lenses():
    """The flagship fit with each outer chart: the cylinders take the
    flagship's constants with ``outer_chart`` swapped."""
    out = {}
    for chart in CHARTS:
        lens = load_poly_lens(FLAGSHIP, device="cpu")
        lens.outer_chart = chart
        out[chart] = lens
    return out


def screen_rays(n=192, seed=0):
    """Screen points, uniforms and retry keys of ``n`` rays; the sensor
    points reach 24 mm off axis, past the crops, so that some rays keep no
    candidate."""
    g = np.random.default_rng(seed)
    sx, sy = (g.uniform(-24, 24, n).astype(np.float32) / np.float32(HSW)
              for _ in range(2))
    r1, r2 = (g.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    key = g.integers(0, 2 ** 32, n, dtype=np.int64)
    return tuple(torch.from_numpy(a) for a in (sx, sy, r1, r2, key))


def draw_then_select(lens, sx, sy, r1, r2, key, tries, blades):
    """The route the select mode replaces, in torch: K1's plain candidates
    of the torch draw on the sensor points, then the epilogue
    (``select_rays``); with the selected candidate's sensor point, solution and
    chart."""
    x, y = sx * HSW, sy * HSW
    out4, trans, dx, dy = pk.po_forward_drawn_plain(
        lens, x, y, r1, r2, key if tries > 1 else None, tries,
        STATE.aperture_radius, blades, LAM, STATE.sensor_shift, ITERS)
    n = x.shape[0]
    out4, trans, dx, dy = (t.reshape(n, tries, *t.shape[1:])
                           for t in (out4, trans, dx, dy))
    shifted = torch.stack([x[:, None] + dx * STATE.sensor_shift,
                           y[:, None] + dy * STATE.sensor_shift, dx, dy], -1)
    rays = pk.select_rays(lens, out4, trans, shifted, SCALE)
    tries_out = rays[3].long()
    first = torch.where(tries_out == tries, 0, tries_out)
    pick = lambda t: t[torch.arange(n), first]
    return rays + (x, y, pick(dx), pick(dy), pick(out4))


@pytest.mark.parametrize("chart", CHARTS)
@pytest.mark.parametrize("blades", [0, 5])
@pytest.mark.parametrize("tries", [1, 3, 4])
def test_selected_plain_is_the_draw_and_the_epilogue(lenses, chart, tries,
                                                     blades):
    """The plain select mode, and the wrapper on the CPU, give K1's plain
    candidates followed by the torch epilogue bit for bit: origin,
    direction, weight, tries and, asked for, the selected candidate's
    sensor point, solution and chart; rays that keep no candidate get
    candidate 0's ray, weight 0 and tries K.  ``LAUNCHES`` does not count
    the plain version."""
    lens = lenses[chart]
    sx, sy, r1, r2, key = screen_rays()
    want = draw_then_select(lens, sx, sy, r1, r2, key, tries, blades)
    args = (lens, sx, sy, HSW, r1, r2, key if tries > 1 else None, tries,
            STATE.aperture_radius, blades, LAM, STATE.sensor_shift, SCALE,
            ITERS)
    ops.reset_launches()
    for fn in (pk.po_forward_selected_plain, ops.KERNELS.po_forward_selected):
        got = fn(*args, True)
        assert len(got) == 9
        assert got[3].dtype == torch.int32
        for g, w in zip(got, want):
            assert g.shape[0] == sx.shape[0]
            assert torch.equal(g, w)
        short = fn(*args)
        assert len(short) == 4
        assert all(torch.equal(g, w) for g, w in zip(short, want))
    assert not any(ops.LAUNCHES.values())
    tries_out, weight = want[3], want[2]
    missed = tries_out == tries
    assert bool(missed.any()) and bool((~missed).any())
    assert bool((weight[missed] == 0).all())
    assert bool((weight[~missed] == 1).any())


def test_selected_wrapper_checks(lenses):
    """The wrapper refuses a missing key with retries, a wrong dtype, no
    candidates, and inputs that require grad while grad mode is on."""
    lens = lenses["sphere"]
    sx, sy, r1, r2, key = screen_rays(8)
    rest = (STATE.aperture_radius, 0, LAM, STATE.sensor_shift, SCALE)
    with pytest.raises(TypeError):
        ops.KERNELS.po_forward_selected(lens, sx, sy, HSW, r1, r2, None, 4,
                                        *rest)
    with pytest.raises(TypeError):
        ops.KERNELS.po_forward_selected(lens, sx, sy, HSW, r1, r2,
                                        key.int(), 4, *rest)
    with pytest.raises(ValueError):
        ops.KERNELS.po_forward_selected(lens, sx, sy, HSW, r1, r2, key, 0,
                                        *rest)
    with pytest.raises(RuntimeError):
        ops.KERNELS.po_forward_selected(lens, sx.requires_grad_(True), sy,
                                        HSW, r1, r2, key, 4, *rest)


@pytest.mark.parametrize("chart", CHARTS)
def test_chart_rays_vjp_is_autograd(lenses, chart):
    """``chart_rays_vjp`` (the formulas of K1v's select mode) against
    autograd through ``chart_rays`` in float64, on charts inside and
    outside the pupil and the unit disk of directions (where a
    ``safe_sqrt`` stops the gradient), 1e-10 relative L2."""
    lens = lenses[chart]
    g = np.random.default_rng(3)
    n = 4000
    R = abs(lens.outer_pupil_curvature_radius)
    o = np.stack([g.uniform(-1.1 * R, 1.1 * R, n),
                  g.uniform(-1.1 * R, 1.1 * R, n),
                  g.uniform(-0.8, 0.8, n), g.uniform(-0.8, 0.8, n)], -1)
    out4 = torch.from_numpy(o).requires_grad_(True)
    g_o, g_d = (torch.from_numpy(g.standard_normal((n, 3))) for _ in range(2))
    origin, direction = pk.chart_rays(lens, out4, SCALE)
    for go, gd in ((g_o, g_d), (g_o, None), (None, g_d)):
        loss = sum((a * b).sum() for a, b in ((go, origin), (gd, direction))
                   if a is not None)
        want, = torch.autograd.grad(loss, out4, retain_graph=True)
        got = pk.chart_rays_vjp(lens, out4.detach(), go, gd, SCALE)
        assert got.dtype == torch.float64
        err = float((got - want).norm() / want.norm())
        assert err < 1e-10, err


def old_route(lens, sx, sy, r1, r2, key, tries, blades, coeffs):
    """The differentiable route before the select mode: the candidates
    drawn in torch (``drawn_rays``), K1 with its gradient on them
    (``ForwardFn``: the term trace on the CPU, K1v over the candidates),
    then the torch epilogue under autograd."""
    x, y = sx * HSW, sy * HSW
    cand = pk.ForwardFn.apply(
        *pk.drawn_rays(x, y, r1, r2, key, tries, STATE.aperture_radius,
                       blades),
        *coeffs, lens, LAM, STATE.sensor_shift, ITERS, ops.PLAIN)
    return pk._select_candidates(lens, x, y, cand, tries,
                                 STATE.sensor_shift, SCALE, False)


@pytest.mark.parametrize("chart", CHARTS)
@pytest.mark.parametrize("blades", [0, 5])
@pytest.mark.parametrize("tries", [1, 3, 4])
def test_select_fn_gradients_match_the_old_route(lenses, chart, tries,
                                                 blades):
    """``SelectFn`` on the CPU (the term trace forward, K1v's plain select
    mode taking the rays' cotangents) against autograd through the route it
    replaces (``ForwardFn`` on the torch draw and the torch epilogue): the
    same forward bits, and the ``pt`` and ``ap`` gradients within 1e-4
    relative L2 (K1v's tolerance against the torch trace,
    ``test_torch_forward_vjp.py``) for
    cotangents on origin and direction, on origin alone and on direction
    alone.  Measured: at most 5.9e-6 (the sphere, direction alone: the
    float32 normalisation's VJP, whose formulas hold autograd's to 1e-10 in
    float64, ``test_chart_rays_vjp_is_autograd``)."""
    lens = lenses[chart]
    sx, sy, r1, r2, key = screen_rays(seed=tries + 10 * blades)
    key = key if tries > 1 else None
    coeffs = (lens.pt.coeffs, lens.ap.coeffs)
    g = np.random.default_rng(tries)
    w_o, w_d = (torch.from_numpy(g.standard_normal((sx.shape[0], 3))
                                 .astype(np.float32)) for _ in range(2))
    try:
        for c in coeffs:
            c.requires_grad_(True)
        for parts in ((True, True), (True, False), (False, True)):
            res = []
            for route in ("select", "old"):
                if route == "select":
                    out = pk.SelectFn.apply(
                        sx, sy, r1, r2, key, *coeffs, lens,
                        (tries, STATE.aperture_radius, blades), LAM,
                        STATE.sensor_shift, ITERS, (HSW, SCALE), ops.PLAIN)
                else:
                    out = old_route(lens, sx, sy, r1, r2, key, tries, blades,
                                    coeffs)
                loss = sum((w * o).sum() for w, o, p in
                           ((w_o, out[0], parts[0]), (w_d, out[1], parts[1]))
                           if p)
                res.append((out, torch.autograd.grad(loss, coeffs)))
            (o_sel, g_sel), (o_old, g_old) = res
            assert all(torch.equal(a.detach(), b.detach())
                       for a, b in zip(o_sel, o_old))
            for a, b in zip(g_sel, g_old):
                assert float(b.norm()) > 0
                err = float((a - b).norm() / b.norm())
                print(f"{chart} K={tries} blades={blades} {parts}: {err:.2e}")
                assert err < 1e-4, (parts, err)
    finally:
        for c in coeffs:
            c.requires_grad_(False)


def test_select_fn_refuses_screen_points_that_require_grad(lenses):
    """``SelectFn`` gives the screen points no gradient, so it refuses
    screen points that require one rather than drop it."""
    lens = lenses["sphere"]
    sx, sy, r1, r2, key = screen_rays(8)
    with pytest.raises(ValueError, match="screen points"):
        pk.SelectFn.apply(sx.requires_grad_(True), sy, r1, r2, key,
                          lens.pt.coeffs, lens.ap.coeffs, lens,
                          (4, STATE.aperture_radius, 0), LAM,
                          STATE.sensor_shift, ITERS, (HSW, SCALE), ops.PLAIN)


class _Recording:
    """``ops.PLAIN`` with K1's select mode recorded, and the torch
    epilogue ``trace_fw_po`` calls itself."""

    def __init__(self, monkeypatch):
        self.calls = {"po_forward_selected": 0, "select_rays": 0}
        self.ops = ops.PLAIN._replace(
            po_forward_selected=self._count("po_forward_selected",
                                            ops.PLAIN.po_forward_selected))
        monkeypatch.setattr(po_camera, "select_rays", self._count(
            "select_rays", po_camera.select_rays))

    def _count(self, name, fn):
        def call(*a):
            self.calls[name] += 1
            return fn(*a)
        return call


KEPT = {
    # config changes, bokeh image, deriv_ray
    "image_bokeh": (dict(bokeh_enable_image=True), True, False),
    "no_dof": (dict(enable_dof=False), False, False),
    "deriv_ray": (dict(), False, True),
}


@pytest.mark.parametrize("case", list(KEPT))
def test_trace_fw_po_keeps_the_torch_epilogue(lenses, monkeypatch, case):
    """The image bokeh, ``enable_dof=False`` and the deriv ray keep their
    routes: K1's select mode is not called and the torch epilogue is, once;
    with depth of field (the last case) the select mode is called once and
    the epilogue is not, and its rays are the plain candidates of the torch
    draw followed by the epilogue, bit for bit."""
    changes, with_image, deriv_ray = KEPT[case]
    cfg = dataclasses.replace(CFG, **changes)
    cdf = None
    if with_image:
        yy, xx = np.mgrid[0:16, 0:16]
        disk = (((xx - 7.5) ** 2 + (yy - 7.5) ** 2) < 49).astype(np.float32)
        cdf = build_bokeh_cdf(np.stack([disk] * 3, -1), device="cpu")
    lens = lenses["sphere"]
    sx, sy, r1, r2, key = screen_rays(64)
    rec = _Recording(monkeypatch)
    out = po_camera.trace_fw_po(cfg, lens, sx, sy, r1, r2,
                                None if deriv_ray else key, STATE,
                                ops=rec.ops, bokeh_cdf=cdf,
                                deriv_ray=deriv_ray)
    assert out[0].shape == (64, 3)
    assert rec.calls == {"po_forward_selected": 0, "select_rays": 1}
    rec = _Recording(monkeypatch)
    out = po_camera.trace_fw_po(CFG, lens, sx, sy, r1, r2, key, STATE,
                                ops=rec.ops)
    assert rec.calls == {"po_forward_selected": 1, "select_rays": 0}
    want = draw_then_select(lens, sx, sy, r1, r2, key,
                            CFG.vignetting_retries + 1, 0)
    assert all(torch.equal(g, w) for g, w in zip(out, want))


def test_frame_calls_k1_once_and_counts_selected_rays(lenses):
    """A frame under ``no_grad`` calls K1 once, in its select mode (one
    ``po_forward`` launch on the card), and ``k1.selected`` counts its N rays
    while a profiler records, nothing otherwise."""
    calls = []

    def selected(*a):
        calls.append(a[1].shape[0])
        return pk.po_forward_selected(*a)

    cfg = dataclasses.replace(CFG, vignetting_retries=2, splat_queue_mult=4)
    rc = pt.RenderConfig(xres=24, yres=16, spp=1)
    args = (cfg, rc, sc.teapot_scene(device="cpu"),
            look_at([0, 0, 0], [0, 0, -1], device="cpu"))
    kw = dict(po_lens=lenses["sphere"], po_state=STATE,
              ops=ops.KERNELS._replace(po_forward_selected=selected))
    trace.reset()
    try:
        with torch.no_grad():
            render_frame(*args, **kw)
            assert calls == [24 * 16]
            assert "k1.selected" not in trace.snapshot()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                render_frame(*args, **kw)
        assert calls == [24 * 16] * 2
        assert trace.snapshot()["k1.selected"] == 24 * 16
    finally:
        trace.reset()
