"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a GPU.  The GPU host has no JAX,
so this file imports none, and is run there without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances match chip_smoke.py: masks agree on >= 99.9% of items, the
forward trace and the backward solve to 1e-3 mm on items both versions
keep, the accumulator's sums
to 1e-4 of their scale (the plain version adds in another order; K4
matches its tile-and-carry emulation bit for bit), gathers and winners
exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import pota_tpu_torch as pt
from pota_tpu_torch import ops
from pota_tpu_torch.ops import _build, po_kernels as pk
from pota_tpu_torch.ops import splat_accum as acc
from pota_tpu_torch.models import po_camera
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import POState
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render.renderer import look_at, render_frame
from test_torch_accum import (
    head_on_tile_edge, tiled_segment_accum, tiles_spanned)

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
ANAMORPHIC = "unknown__anamorphic__1960__50mm"
CFG = pt.CameraConfig(
    camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
    fstop=2.8, focus_distance=20.0, vignetting_retries=3, splat_queue_mult=8,
)
STATE = POState(aperture_radius=4.672678708153359,
                sensor_shift=15.091056449990935, focus_distance=200.0,
                tan_fov=0.36734693877551)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _t(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


@pytest.mark.parametrize("name, degree, lam_um", [
    (FLAGSHIP, 5, 0.55), (FLAGSHIP, 3, 0.45), (ANAMORPHIC, 5, 0.65)])
def test_po_forward_kernel_matches_plain(dev, name, degree, lam_um):
    """K1 on the table folded at the frame's wavelength."""
    lens = load_poly_lens(name, degree=degree, device=dev)
    rng = np.random.default_rng(0)
    n = 20000
    x, y = (rng.uniform(-14, 14, n).astype(np.float32) for _ in range(2))
    r = lens.aperture_housing_radius * 0.6
    ax, ay = (rng.uniform(-r, r, n).astype(np.float32) for _ in range(2))
    args = [_t(a, dev) for a in (x, y, ax, ay)]
    got = pk.po_forward(lens, *args, lam_um, STATE.sensor_shift, 3)
    ref = pk.po_forward_plain(lens, *args, lam_um, STATE.sensor_shift, 3)
    ok_g, ok_p = got[1] > 0, ref[1] > 0
    assert float((ok_g == ok_p).double().mean()) >= 0.999
    both = ok_g & ok_p
    assert int(both.sum()) > n // 4
    for g, r_ in zip(got, ref):
        assert float((g[both] - r_[both]).abs().max()) < 1e-3


def _drawn_rays(dev, n, seed=0):
    """Sensor points (mm), aperture uniforms and retry keys of ``n`` rays,
    with the edges: keys 0, 1, 2^32 - 2, 2^32 - 1; (r1, r2) on (0.5, 0.5)
    (the disk's both-zero branch), with one of them 0.5 (a zero square
    side), on 0 and just under 1."""
    rng = np.random.default_rng(seed)
    x, y = (rng.uniform(-14, 14, n).astype(np.float32) for _ in range(2))
    r1, r2 = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    for i, (a, b) in enumerate([(0.5, 0.5), (0.5, 0.2), (0.8, 0.5),
                                (0.0, 0.0), (0.0, 0.9999999)]):
        r1[i], r2[i] = a, b
    key = rng.integers(0, 2 ** 32, n, dtype=np.int64)
    key[:4] = (0, 1, 2 ** 32 - 2, 2 ** 32 - 1)
    return [_t(a, dev) for a in (x, y, r1, r2, key)]


def _same_bits(a, b) -> bool:
    """Equal shapes and bits (a NaN equals a NaN of the same bits)."""
    if a.is_floating_point():
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}
        a, b = a.view(bits[a.dtype]), b.view(bits[b.dtype])
    return torch.equal(a, b)


def _draw_then_select(lens, sx, sy, hsw, r1, r2, key, tries, radius, blades,
                      lam_um, sensor_shift, scale, iterations=3,
                      need_rays=False):
    """The torch chain K1's select mode replaced, called as
    ``po_forward_selected``: the candidates drawn in torch on the card
    (``drawn_rays``), K1 in its candidate mode on them, then the torch
    epilogue (``select_rays``)."""
    x, y = sx * hsw, sy * hsw
    cand = pk.po_forward(lens, *pk.drawn_rays(x, y, r1, r2, key, tries,
                                              radius, blades),
                         lam_um, sensor_shift, iterations)
    return pk._select_candidates(lens, x, y, cand, tries, sensor_shift,
                                 scale, need_rays)


@pytest.mark.parametrize("blades", [0, 5])
def test_drawn_frames_are_the_torch_chains_bits(dev, blades):
    """Frames with K1 drawing and selecting its candidates (its select
    mode) against the same frames on the torch chain
    (:func:`_draw_then_select`: the candidates drawn in torch, K1's
    candidate mode, the select in torch), both with K1v's select mode.  A 64x48
    differentiable teapot frame in 4 checkpointed chunks: the same image bits;
    K1v handed the same selected candidates a chunk (sensor point, solution and
    chart), bit for bit, so that on one cotangent it gives the same gradient
    bits of pt and ap; the frame's gradients within 1e-5 relative L2 (the
    splat's backward adds with atomics: two runs of one route differ as much).
    A 96x64 light-grid frame under ``no_grad``: RGBA and every AOV the same
    bits.  The same launches (K1 twice a chunk and once a frame)."""
    cfg = dataclasses.replace(CFG, vignetting_retries=2, splat_queue_mult=4,
                              trace_chunks=4, aperture_blades=blades)
    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    lens = load_poly_lens(FLAGSHIP, device=dev)
    coeffs = (lens.pt.coeffs, lens.ap.coeffs)
    res, launches, vjps = [], [], []
    for kernel_set in (ops.KERNELS,
                       ops.KERNELS._replace(
                           po_forward_selected=_draw_then_select)):
        calls = []

        def recording_vjp(*a):
            calls.append(a)
            return pk.po_forward_vjp_selected(*a)

        for c in coeffs:
            c.requires_grad_(True)
            c.grad = None
        ops.reset_launches()
        img, _ = render_frame(cfg, pt.RenderConfig(xres=64, yres=48, spp=1),
                              sc.teapot_scene(device=dev), m, po_lens=lens,
                              po_state=STATE, differentiable=True,
                              ops=kernel_set._replace(
                                  po_forward_vjp_selected=recording_vjp))
        img[..., :3].mean().backward()
        grads = [c.grad.clone() for c in coeffs]
        for c in coeffs:
            c.requires_grad_(False)
            c.grad = None
        with torch.no_grad():
            _, fb = render_frame(
                dataclasses.replace(cfg, vignetting_retries=3),
                pt.RenderConfig(xres=96, yres=64, spp=1),
                sc.lightgrid_scene(n=3, spacing=12.0, z=-150.0, radius=0.8,
                                   intensity=40.0, device=dev), m,
                po_lens=lens, po_state=STATE, ops=kernel_set)
        launches.append(dict(ops.LAUNCHES))
        res.append((img.detach(), *grads, fb))
        vjps.append(calls)
    assert launches[0] == launches[1]
    assert launches[0]["po_forward"] == 8 + 1
    (img, g_pt, g_ap, fb), (img_c, g_pt_c, g_ap_c, fb_c) = res
    assert _same_bits(img, img_c)
    assert len(vjps[0]) == len(vjps[1]) == 4
    with torch.no_grad():
        for a, a_c in zip(*vjps):
            assert all(_same_bits(t, t_c) for t, t_c in zip(a[1:6],
                                                             a_c[1:6]))
            got = pk.po_forward_vjp_selected(*a)
            want = pk.po_forward_vjp_selected(*a_c[:6], *a[6:])
            assert all(_same_bits(g, w) for g, w in zip(got, want))
    for g, g_c in ((g_pt, g_pt_c), (g_ap, g_ap_c)):
        assert float(g_c.norm()) > 0
        assert float((g - g_c).norm() / g_c.norm()) < 1e-5
    tensors = [k for k, v in fb.items() if isinstance(v, torch.Tensor)]
    assert "RGBA" in tensors
    for k in tensors:
        assert _same_bits(fb[k], fb_c[k]), k


HSW = CFG.sensor_width * 0.5
SCALE = CFG.unit_scale_po
CHARTS = ("sphere", "cyl-x", "cyl-y")


def _chart_lens(dev, chart):
    """The flagship fit with the outer chart ``chart`` (the cylinders take
    the flagship's constants)."""
    lens = load_poly_lens(FLAGSHIP, device=dev)
    lens.outer_chart = chart
    return lens


def _screen_rays(dev, n, seed=0):
    """:func:`_drawn_rays` with the sensor points as screen points, out to
    24 mm off axis (past the crops: some rays keep no candidate)."""
    x, y, r1, r2, key = _drawn_rays(dev, n, seed)
    return [x * (24.0 / 14.0 / HSW), y * (24.0 / 14.0 / HSW), r1, r2, key]


@pytest.mark.parametrize("chart", CHARTS)
@pytest.mark.parametrize("blades", [0, 5])
@pytest.mark.parametrize("tries", [1, 3, 4])
def test_po_forward_selected_kernel_is_the_draw_and_select(dev, tries,
                                                           blades, chart):
    """K1's select mode against the route it replaces
    (:func:`_draw_then_select`: the torch draw, K1's candidate mode and the
    torch epilogue on the card), 200,003 rays: the same bits of origin,
    direction, weight and tries, with and without the selected candidate
    asked for, and of that candidate's sensor point, solution and chart;
    rays that keep no candidate included; one ``po_forward`` launch a
    call; two runs the same bits."""
    lens = _chart_lens(dev, chart)
    sx, sy, r1, r2, key = _screen_rays(dev, 200_003, seed=tries)
    key = key if tries > 1 else None
    args = (lens, sx, sy, HSW, r1, r2, key, tries, STATE.aperture_radius,
            blades, 0.55, STATE.sensor_shift, SCALE, 3)
    want = _draw_then_select(*args, True)
    ops.reset_launches()
    got = pk.po_forward_selected(*args, True)
    short = pk.po_forward_selected(*args)
    again = pk.po_forward_selected(*args, True)
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {"po_forward": 3}
    names = ("origin", "direction", "weight", "tries", "x", "y", "dx", "dy",
             "out4")
    assert len(got) == 9 and len(short) == 4
    for name, g, w, a in zip(names, got, want, again):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _same_bits(g, w), name
        assert _same_bits(g, a), name
    for name, g, w in zip(names, short, want):
        assert _same_bits(g, w), name
    missed = want[3] == tries
    print(f"{chart} K={tries} blades={blades}: "
          f"{float(missed.double().mean()):.4f} of rays keep no candidate, "
          f"weight 1 on {float(want[2].double().mean()):.4f}")
    assert bool(missed.any()) and bool((~missed).any())


def _parent_select(sx, sy, r1, r2, key, pt_c, ap_c, lens, draw, lam, shift,
                   its, select, ops_):
    """``SelectFn.apply``'s route before the select mode, for the card:
    the candidates drawn in torch (``drawn_rays``), K1's candidate mode
    with its gradient on them (``ForwardFn``: K1v over the candidates),
    then the torch epilogue under autograd."""
    hsw, scale = select
    x, y = sx * hsw, sy * hsw
    cand = pk.ForwardFn.apply(*pk.drawn_rays(x, y, r1, r2, key, *draw), pt_c,
                              ap_c, lens, lam, shift, its, ops_)
    return pk._select_candidates(lens, x, y, cand, draw[0], shift, scale,
                                 False)


@pytest.mark.parametrize("chart", CHARTS)
@pytest.mark.parametrize("blades", [0, 5])
@pytest.mark.parametrize("tries", [1, 3, 4])
def test_select_fn_gradients_on_the_card(dev, tries, blades, chart):
    """``SelectFn`` on the card (K1's select mode, K1v's select mode taking
    the rays' cotangents) against the route it replaces
    (:func:`_parent_select`: the torch draw, K1's candidate mode, K1v over
    the candidates, the torch epilogue),
    200,003 rays: the same forward bits; the ``pt`` and ``ap`` gradients
    within 1e-4 relative L2 (K1v's tolerance) for cotangents on origin and
    direction, on origin alone and on direction alone; two runs the same
    bits."""
    lens = _chart_lens(dev, chart)
    sx, sy, r1, r2, key = _screen_rays(dev, 200_003, seed=tries + 7)
    key = key if tries > 1 else None
    coeffs = (lens.pt.coeffs, lens.ap.coeffs)
    rng = np.random.default_rng(tries)
    w_o, w_d = (_t(rng.standard_normal((200_003, 3)).astype(np.float32), dev)
                for _ in range(2))
    rest = (lens, (tries, STATE.aperture_radius, blades), 0.55,
            STATE.sensor_shift, 3, (HSW, SCALE), ops.KERNELS)
    try:
        for c in coeffs:
            c.requires_grad_(True)
        for parts in ((True, True), (True, False), (False, True)):
            res = []
            for fn in (pk.SelectFn.apply, pk.SelectFn.apply, _parent_select):
                out = fn(sx, sy, r1, r2, key, *coeffs, *rest)
                loss = sum((w * o).sum() for w, o, p in
                           ((w_o, out[0], parts[0]), (w_d, out[1], parts[1]))
                           if p)
                res.append((out, torch.autograd.grad(loss, coeffs)))
            (o1, g1), (o2, g2), (o_p, g_p) = res
            assert all(_same_bits(a.detach(), b.detach())
                       for a, b in zip(o1, o_p))
            assert all(_same_bits(a.detach(), b.detach())
                       for a, b in zip(o1, o2))
            assert all(_same_bits(a, b) for a, b in zip(g1, g2))
            for a, b in zip(g1, g_p):
                err = float((a - b).norm() / b.norm())
                print(f"{chart} K={tries} blades={blades} {parts}: {err:.2e}")
                assert bool(torch.isfinite(a).all()) and float(b.norm()) > 0
                assert err < 1e-4, (parts, err)
    finally:
        for c in coeffs:
            c.requires_grad_(False)


@pytest.mark.parametrize("blades", [0, 5])
def test_select_frames_are_the_parent_routes(dev, monkeypatch, blades):
    """Frames through K1's select mode against the same frames through the
    route before it (the torch draw, K1's candidate mode, the torch
    epilogue, K1v over the candidates: ``SelectFn`` replaced by
    :func:`_parent_select` and the select mode by
    :func:`_draw_then_select`).  A 64x48
    differentiable teapot frame in 4 checkpointed chunks: the same image
    bits, gradients within 1e-4 relative L2, the same launches (K1 twice a
    chunk, K1v once); two runs of the select route the same image bits and
    gradients within 1e-5 (the splat's backward adds with atomics).  A
    96x64 light-grid frame under ``no_grad``: RGBA and every AOV the same
    bits, one K1 launch."""
    cfg = dataclasses.replace(CFG, vignetting_retries=2, splat_queue_mult=4,
                              trace_chunks=4, aperture_blades=blades)
    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    lens = load_poly_lens(FLAGSHIP, device=dev)
    coeffs = (lens.pt.coeffs, lens.ap.coeffs)
    res, launches = [], []
    for route in ("select", "select", "parent"):
        kernel_set = ops.KERNELS
        if route == "parent":
            monkeypatch.setattr(po_camera, "SelectFn", type(
                "ParentSelect", (), {"apply": staticmethod(_parent_select)}))
            kernel_set = ops.KERNELS._replace(
                po_forward_selected=_draw_then_select)
        for c in coeffs:
            c.requires_grad_(True)
            c.grad = None
        ops.reset_launches()
        img, _ = render_frame(cfg, pt.RenderConfig(xres=64, yres=48, spp=1),
                              sc.teapot_scene(device=dev), m, po_lens=lens,
                              po_state=STATE, differentiable=True,
                              ops=kernel_set)
        img[..., :3].mean().backward()
        grads = [c.grad.clone() for c in coeffs]
        for c in coeffs:
            c.requires_grad_(False)
            c.grad = None
        step = dict(ops.LAUNCHES)
        ops.reset_launches()
        with torch.no_grad():
            _, fb = render_frame(
                dataclasses.replace(cfg, vignetting_retries=3),
                pt.RenderConfig(xres=96, yres=64, spp=1),
                sc.lightgrid_scene(n=3, spacing=12.0, z=-150.0, radius=0.8,
                                   intensity=40.0, device=dev), m,
                po_lens=lens, po_state=STATE, ops=kernel_set)
        launches.append((step, dict(ops.LAUNCHES)))
        res.append((img.detach(), *grads, fb))
    assert launches[0] == launches[1] == launches[2]
    assert launches[0][0]["po_forward"] == 8
    assert launches[0][0]["po_forward_vjp"] == 4
    assert launches[0][1]["po_forward"] == 1
    (img, g_pt, g_ap, fb), (img2, g_pt2, g_ap2, _), (img_p, g_pt_p, g_ap_p,
                                                     fb_p) = res
    assert _same_bits(img, img_p) and _same_bits(img, img2)
    for g, g2, g_p in ((g_pt, g_pt2, g_pt_p), (g_ap, g_ap2, g_ap_p)):
        assert float(g_p.norm()) > 0
        err = float((g - g_p).norm() / g_p.norm())
        print(f"blades={blades}: frame gradient {err:.2e} from the parent's, "
              f"{float((g - g2).norm() / g2.norm()):.2e} run to run")
        assert err < 1e-4
        assert float((g - g2).norm() / g2.norm()) < 1e-5
    tensors = [k for k, v in fb.items() if isinstance(v, torch.Tensor)]
    assert "RGBA" in tensors
    for k in tensors:
        assert _same_bits(fb[k], fb_p[k]), k


def _vjp_args(lens, dev, n, full, seed=0):
    """K1v's arguments on ``n`` seeded candidates at K1's solution: the
    frame's cotangent (out4 only, two rows in three zero, as the
    first-success select leaves them) or, ``full``, every cotangent."""
    rng = np.random.default_rng(seed)
    x, y = (rng.uniform(-14, 14, n).astype(np.float32) for _ in range(2))
    r = lens.aperture_housing_radius * 0.6
    ax, ay = (rng.uniform(-r, r, n).astype(np.float32) for _ in range(2))
    rays = [_t(a, dev) for a in (x, y, ax, ay)]
    with torch.no_grad():
        _, _, dx, dy = pk.po_forward(lens, *rays, 0.55, STATE.sensor_shift, 3)
    g4 = rng.standard_normal((n, 4)).astype(np.float32)
    if not full:
        g4[np.arange(n) % 3 != 0] = 0.0
        return (lens, *rays, dx, dy, _t(g4, dev), None, None, None, 0.55,
                STATE.sensor_shift, False)
    g = [_t(rng.standard_normal(n).astype(np.float32), dev)
         for _ in range(3)]
    return (lens, *rays, dx, dy, _t(g4, dev), *g, 0.55, STATE.sensor_shift,
            True)


@pytest.mark.parametrize("name", [FLAGSHIP, ANAMORPHIC])
@pytest.mark.parametrize("full", [False, True], ids=["out4", "all"])
@pytest.mark.parametrize("n", [20000, 300_001])
def test_po_forward_vjp_kernel_matches_plain(dev, name, full, n):
    """K1v against its plain version (the fit's own terms) at K1's
    solution: the coefficient cotangents (and, with every cotangent given,
    the rays') within 1e-4 relative L2; two runs give the same bits."""
    lens = load_poly_lens(name, device=dev)
    args = _vjp_args(lens, dev, n, full)
    with torch.no_grad():
        got = pk.po_forward_vjp(*args)
        again = pk.po_forward_vjp(*args)
        want = pk.po_forward_vjp_plain(*args)
    assert len(got) == (6 if full else 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).norm() / w.norm()) < 1e-4


@pytest.mark.parametrize("name", [FLAGSHIP, ANAMORPHIC])
def test_po_forward_vjp_kernel_sparse_cotangents(dev, name):
    """K1v with 6.4% of the candidates carrying a cotangent (config 5's
    share, scattered: the live-candidate queue fills across strides) at a
    config 5 chunk's count: within 1e-4 relative L2 of its plain version,
    the same bits in two runs, the dead candidates' ray cotangents zero."""
    n = 777_600
    lens = load_poly_lens(name, device=dev)
    args = list(_vjp_args(lens, dev, n, True, seed=3))
    live = torch.as_tensor(np.random.default_rng(4).uniform(size=n) < 0.064,
                           device=dev)
    for i in range(7, 11):    # the cotangents
        args[i] = torch.where(live[:, None] if i == 7 else live, args[i],
                              0.0).contiguous()
    with torch.no_grad():
        got = pk.po_forward_vjp(*args)
        again = pk.po_forward_vjp(*args)
        want = pk.po_forward_vjp_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got, want):
        assert float((g - w).norm() / w.norm()) < 1e-4
    assert not any(bool(g[~live].any()) for g in got[2:])


def test_po_forward_vjp_kernel_on_two_streams(dev):
    """K1v launched on two streams at once, each on its own chunk (its
    scratch is kept per stream): each stream's result is the bits of the
    same launch on the default stream."""
    lens = load_poly_lens(FLAGSHIP, device=dev)
    chunks = [_vjp_args(lens, dev, 777_600, True, seed=s) for s in (5, 6)]
    with torch.no_grad():
        want = [pk.po_forward_vjp(*a) for a in chunks]
        torch.cuda.synchronize(dev)
        streams = [torch.cuda.Stream(dev) for _ in chunks]
        got = []
        for st, a in zip(streams, chunks):
            st.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(st):
                got.append(pk.po_forward_vjp(*a))
        torch.cuda.synchronize(dev)
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


def test_po_forward_vjp_kernel_takes_an_empty_queue(dev):
    lens = load_poly_lens(FLAGSHIP, device=dev)
    args = _vjp_args(lens, dev, 0, True)
    ops.reset_launches()
    with torch.no_grad():
        got = pk.po_forward_vjp(*args)
    assert ops.LAUNCHES["po_forward_vjp"] == 1
    assert got[0].shape == lens.pt.coeffs.shape
    assert not any(bool(t.any()) for t in got)


@pytest.mark.parametrize("name", [FLAGSHIP, ANAMORPHIC])
@pytest.mark.parametrize("n", [20000, 2_073_600])
def test_po_forward_jvp_kernel_matches_plain(dev, name, n):
    """K1j: its primal is K1's bit for bit on every ray; on the rays that
    it and the plain version keep, the primal within 1e-5 (K1 and
    ``po_forward_plain`` round alike but for rare float64 ties) and the
    Jacobian within 1e-4 relative L2 of the plain version's."""
    lens = load_poly_lens(name, device=dev)
    rng = np.random.default_rng(5)
    x, y = (rng.uniform(-14, 14, n).astype(np.float32) for _ in range(2))
    r = lens.aperture_housing_radius * 0.6
    ax, ay = (rng.uniform(-r, r, n).astype(np.float32) for _ in range(2))
    args = (lens, *(_t(a, dev) for a in (x, y, ax, ay)), 0.55,
            STATE.sensor_shift, 3)
    ops.reset_launches()
    with torch.no_grad():
        got = pk.po_forward_jvp(*args)
        k1 = pk.po_forward(*args)
        ref = pk.po_forward_jvp_plain(*args)
    assert ops.LAUNCHES["po_forward_jvp"] == 1
    assert got[4].shape == (n, 4, 2)
    for g, k in zip(got[:4], k1):
        assert torch.equal(g, k)
    both = (got[1] > 0) & (ref[1] > 0)
    assert int(both.sum()) > n // 4
    for g, p in zip(got[:4], ref[:4]):
        assert float((g[both] - p[both]).abs().max()) < 1e-5
    jg, jp = got[4][both].double(), ref[4][both].double()
    assert bool(torch.isfinite(jg).all())
    assert float((jg - jp).norm() / jp.norm()) < 1e-4


def test_po_forward_jvp_kernel_takes_an_empty_queue(dev):
    lens = load_poly_lens(FLAGSHIP, device=dev)
    empty = torch.empty((0,), dtype=torch.float32, device=dev)
    ops.reset_launches()
    with torch.no_grad():
        got = pk.po_forward_jvp(lens, empty, empty, empty, empty, 0.55,
                                STATE.sensor_shift, 3)
    assert ops.LAUNCHES["po_forward_jvp"] == 1
    assert got[4].shape == (0, 4, 2)


@pytest.mark.parametrize("n, s", [
    (5000, 40000),   # 16-byte runs
    (5000, 39998),   # ragged: S % 4 != 0, scalar runs
    (5000, 0),       # an empty queue
    (0, 40),         # an empty table: every index out of range gives 0
])
def test_expand_kernel_is_exact(dev, n, s):
    rng = np.random.default_rng(1)
    src = np.sort(rng.integers(0, max(n, 1), s)).astype(np.int32)
    tf = rng.normal(size=(pk.TF_ROWS + 1, n)).astype(np.float32)
    ti = rng.integers(-(1 << 30), 1 << 30, (pk.TI_ROWS, n)).astype(np.int32)
    got = pk.expand(_t(src, dev), _t(tf, dev), _t(ti, dev))
    assert got[0].shape == (pk.TF_ROWS + 1, s)
    assert got[1].shape == (pk.TI_ROWS, s)
    if n == 0:
        assert not bool(got[0].any()) and not bool(got[1].any())
        return
    ref = pk.expand_plain(_t(src, dev), _t(tf, dev), _t(ti, dev))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("name, degree", [(FLAGSHIP, 5), (FLAGSHIP, 3),
                                          (ANAMORPHIC, 5)])
@pytest.mark.parametrize("lam_um", [0.55, 0.45])
def test_po_splat_kernel_matches_plain(dev, name, degree, lam_um):
    lens = load_poly_lens(name, degree=degree, device=dev)
    rng = np.random.default_rng(2)
    n = 50000
    pc = np.stack([rng.uniform(-60, 60, n), rng.uniform(-35, 35, n),
                   rng.uniform(-400, -60, n)], 0).astype(np.float32)
    seed = rng.integers(0, 2 ** 31, n).astype(np.int32)
    ctr = rng.integers(0, 200, n).astype(np.int32)
    sky = (rng.uniform(size=n) < 0.05).astype(np.float32)
    rc = pt.RenderConfig(xres=1920, yres=1080, spp=1)
    cfg = dataclasses.replace(CFG, wavelength=lam_um * 1000.0)
    params = pk.splat_kernel_params(cfg, rc, STATE, torch.eye(4, device=dev))
    spheres = _t(np.array([[x, y, -150.0, 0.8] for x in (-12.0, 0.0, 12.0)
                           for y in (-12.0, 0.0, 12.0)], np.float32), dev)
    args = (lens, *(_t(a, dev) for a in pc), *(_t(a, dev) for a in pc),
            _t(seed, dev), _t(ctr, dev), _t(sky, dev), params, spheres,
            lam_um, 3)
    lin_g, ok_g = pk.po_splat(*args)
    lin_p, ok_p = pk.po_splat_plain(*args)
    assert 0.05 < float(ok_p.double().mean()) < 0.99
    assert float((ok_g == ok_p).double().mean()) >= 0.999
    both = ok_g & ok_p
    assert float((lin_g[both] == lin_p[both]).double().mean()) >= 0.999


def _slot_inputs(rng, n, dev):
    pc = np.stack([rng.uniform(-60, 60, n), rng.uniform(-35, 35, n),
                   rng.uniform(-400, -60, n)], 0).astype(np.float32)
    seed = rng.integers(0, 2 ** 31, n).astype(np.int32)
    ctr = rng.integers(0, 200, n).astype(np.int32)
    sky = (rng.uniform(size=n) < 0.05).astype(np.float32)
    spheres = _t(np.array([[x, y, -150.0, 0.8] for x in (-12.0, 0.0, 12.0)
                           for y in (-12.0, 0.0, 12.0)], np.float32), dev)
    return pc, seed, ctr, sky, spheres


def _assert_masks_agree(got, ref):
    lin_g, ok_g = got
    lin_p, ok_p = ref
    assert 0.05 < float(ok_p.double().mean()) < 0.99
    assert float((ok_g == ok_p).double().mean()) >= 0.999
    both = ok_g & ok_p
    assert float((lin_g[both] == lin_p[both]).double().mean()) >= 0.999


CHROMA = (0.43, 0.55, 0.73)     # chroma_wavelengths at abb_chromatic 0.6


def _k3b_args(variant, lens, n, lams, dev, rng, chromatic_queue=False):
    """K3b's arguments for ``n`` seeded slots: one wavelength and no index,
    or three and an index per slot, drawn at random or, with
    ``chromatic_queue``, ``slot % 3`` as a chromatic queue lays them out."""
    pc, seed, ctr, sky, spheres = _slot_inputs(rng, n, dev)
    rc = pt.RenderConfig(xres=512, yres=512, spp=2)
    params = pk.splat_kernel_params(CFG, rc, STATE, torch.eye(4, device=dev))
    if variant == "po_splat_ext":
        r = STATE.aperture_radius
        a, b = (_t(rng.uniform(-r, r, n).astype(np.float32) * 0.7, dev)
                for _ in range(2))
    else:
        a, b = _t(seed, dev), _t(ctr, dev)
    idx = (np.arange(n) % 3 if chromatic_queue
           else rng.integers(0, len(lams), n)).astype(np.int32)
    return (lens, *(_t(x, dev) for x in pc), *(_t(x, dev) for x in pc), a, b,
            lams, None if len(lams) == 1 else _t(idx, dev), _t(sky, dev),
            params, spheres, 3)


@pytest.mark.parametrize("variant", ["po_splat_lam", "po_splat_ext"])
@pytest.mark.parametrize("degree", [5, 3])
@pytest.mark.parametrize("lams, layout", [
    ((0.55,), "one"), (CHROMA, "random"), (CHROMA, "chromatic_queue")])
def test_po_splat_variant_kernel_matches_plain(dev, variant, degree, lams,
                                               layout):
    """K3b on one folded table, or three picked per slot (at random, or
    ``slot % 3`` as a chromatic queue has them, which the kernel's
    channel-uniform warps take), against its plain version, for the
    flagship's degree-5 and degree-3 fits; 50,001 slots, a ragged last
    channel group."""
    lens = load_poly_lens(FLAGSHIP, degree=degree, device=dev)
    args = _k3b_args(variant, lens, 50001, lams, dev,
                     np.random.default_rng(5),
                     chromatic_queue=layout == "chromatic_queue")
    ops.reset_launches()
    got = getattr(pk, variant)(*args)
    assert ops.LAUNCHES[variant] == 1
    _assert_masks_agree(got, getattr(pk, f"{variant}_plain")(*args))


@pytest.mark.parametrize("variant", ["po_splat_lam", "po_splat_ext"])
@pytest.mark.parametrize("lams", [(0.55,), CHROMA])
def test_po_splat_variant_kernel_takes_an_empty_queue(dev, variant, lams):
    lens = load_poly_lens(FLAGSHIP, device=dev)
    args = _k3b_args(variant, lens, 0, lams, dev, np.random.default_rng(1))
    ops.reset_launches()
    lin, ok = getattr(pk, variant)(*args)
    assert lin.shape == ok.shape == (0,)
    assert ops.LAUNCHES[variant] == 1


def _tl_args(dev, n, abb=0.5, c2s=0.01, seed=6):
    rng = np.random.default_rng(seed)
    pc, seed_, ctr, sky, spheres = _slot_inputs(rng, n, dev)
    cfg = pt.CameraConfig(focal_length=50.0, fstop=1.4, focus_distance=150.0,
                          bokeh_anamorphic=0.2)
    rc = pt.RenderConfig(xres=256, yres=256, spp=16)
    params = pk.splat_kernel_params(cfg, rc, None, torch.eye(4, device=dev))
    return (*(_t(x * 0.1, dev) for x in pc), *(_t(x * 0.1, dev) for x in pc),
            _t(seed_, dev), _t(ctr, dev), _t(sky, dev), params, spheres, abb,
            c2s)


@pytest.mark.parametrize("abb, c2s", [(0.5, 0.01), (0.3, 0.2)])
def test_tl_splat_kernel_matches_plain(dev, abb, c2s):
    args = _tl_args(dev, 100000, abb, c2s)
    _assert_masks_agree(pk.tl_splat(*args), pk.tl_splat_plain(*args))


@pytest.mark.parametrize("n", [1000, 2_000_003])
def test_tl_splat_kernel_below_one_wave_and_many(dev, n):
    """K5's grid holds whole waves of resident blocks: 1,000 slots fill
    part of one block, 2,000,003 slots take each thread round a
    grid-stride loop many times (a ragged last round)."""
    args = _tl_args(dev, n, seed=n)
    ops.reset_launches()
    got = pk.tl_splat(*args)
    assert ops.LAUNCHES["tl_splat"] == 1
    assert got[0].shape == got[1].shape == (n,)
    _assert_masks_agree(got, pk.tl_splat_plain(*args))


def test_tl_splat_kernel_takes_an_empty_queue(dev):
    args = _tl_args(dev, 0)
    ops.reset_launches()
    lin, ok = pk.tl_splat(*args)
    assert lin.shape == ok.shape == (0,)
    assert ops.LAUNCHES["tl_splat"] == 1


def test_tl_splat_blocks_per_sm(dev):
    """The occupancy K5 sizes its grid from: 1-8 resident blocks of 256
    threads, the same when asked again (kept) and for another sphere
    count."""
    lib = _build.lib()
    got = lib.pota_tl_splat_blocks_per_sm(9)
    assert 1 <= got <= 8
    assert lib.pota_tl_splat_blocks_per_sm(9) == got
    assert 1 <= lib.pota_tl_splat_blocks_per_sm(1) <= 8
    assert lib.pota_tl_splat_blocks_per_sm(9) == got


@pytest.mark.parametrize("name", [FLAGSHIP, ANAMORPHIC])
@pytest.mark.parametrize("lams", [(0.55,), CHROMA])
def test_po_backward_kernel_matches_plain(dev, name, lams):
    """K6 on one folded table, or three picked per item by ``lam_idx``.
    ``trans > 0`` agrees on >= 99.9% of items, (sx, sy) lie within 1e-3 mm
    on >= 99.9% of the items both keep (measured: all but 1-2 of ~47,000,
    items 17-48 mm off axis, outside the sensor, where the folded walk
    falls up to 3.2e-3 mm from a float64 solve and the runtime-term plain
    version within 1.4e-3), and (sdx, sdy, trans) within 1e-3 on all of
    them (measured at most 4.1e-4)."""
    lens = load_poly_lens(name, device=dev)
    rng = np.random.default_rng(7)
    n = 50000
    pc, _, _, _, _ = _slot_inputs(rng, n, dev)
    r = STATE.aperture_radius
    ap = rng.uniform(-r, r, (2, n)).astype(np.float32) * 0.7
    idx = (None if len(lams) == 1 else
           _t(rng.integers(0, len(lams), n).astype(np.int32), dev))
    args = (lens, *(_t(-10.0 * x, dev) for x in pc), _t(ap[0], dev),
            _t(ap[1], dev), lams, idx, 3)
    got = pk.po_backward(*args)
    ref = pk.po_backward_plain(*args)
    keep_g, keep_p = got[4] > 0, ref[4] > 0
    assert 0.05 < float(keep_p.double().mean()) < 0.99
    assert float((keep_g == keep_p).double().mean()) >= 0.999
    both = keep_g & keep_p
    far = ((got[0] - ref[0]).abs().maximum((got[1] - ref[1]).abs())
           > 1e-3)[both]
    assert float(far.double().mean()) <= 1e-3
    for g, r_ in zip(got[2:], ref[2:]):
        assert float((g[both] - r_[both]).abs().max()) < 1e-3


@pytest.mark.parametrize("lams", [(0.55,), CHROMA])
def test_po_backward_kernel_takes_an_empty_queue(dev, lams):
    lens = load_poly_lens(FLAGSHIP, device=dev)
    e = torch.empty(0, device=dev)
    idx = None if len(lams) == 1 else torch.empty(0, dtype=torch.int32,
                                                  device=dev)
    ops.reset_launches()
    got = pk.po_backward(lens, e, e, e, e, e, lams, idx, 3)
    assert [tuple(g.shape) for g in got] == [(0,)] * 5
    assert ops.LAUNCHES["po_backward"] == 1


def test_fit_outside_the_basis_is_refused_before_the_frame(dev):
    """A PO frame on the card refuses a fit with a monomial outside the
    degree-5 basis before any kernel runs."""
    lens = load_poly_lens(FLAGSHIP, degree=3, device=dev)
    for fn in (lens.pt, lens.ap):
        fn.exponents[-1] = torch.tensor([6, 0, 0, 0, 0], device=dev)
        fn.max_degree = 6
    scene = sc.lightgrid_scene(n=2, z=-150.0, device=dev)
    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    ops.reset_launches()
    for end in (None, look_at([2.0, 0, 0], [2.0, 0, -1], device=dev)):
        with pytest.raises(ValueError, match="outside the degree-5 basis"):
            render_frame(CFG, pt.RenderConfig(xres=32, yres=32, spp=1),
                         scene, m, po_lens=lens, po_state=STATE,
                         cam_to_world_end=end)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


@pytest.mark.parametrize("k", [5, 9, 17])  # RGBA, + 1 and + 3 gaussian AOVs
def test_segment_accum_kernel_matches_plain(dev, k):
    rng = np.random.default_rng(3)
    npix, w = 3000, 200000
    pix = rng.integers(0, npix + 1, w)        # npix = dead writer
    pix[:5000] = 17                           # a hot pixel
    depth = np.round(rng.uniform(1, 50, w)).astype(np.float32)  # ties
    payload = rng.normal(size=(w, k)).astype(np.float32)
    sid = rng.integers(0, 1 << 30, w).astype(np.int32)
    keys, perm = acc.sort_writers(_t(pix, dev), _t(depth, dev))
    args = (keys, perm, _t(payload, dev), _t(sid, dev), npix)
    got = acc.segment_accum(*args)
    ref = acc.segment_accum_plain(*args)
    scale = max(float(ref[0].abs().max()), 1.0)
    assert float((got[0] - ref[0]).abs().max()) <= 1e-4 * scale
    for g, r_ in zip(got[1:], ref[1:]):
        assert torch.equal(g, r_)
    # two runs give identical bits (no atomics)
    assert torch.equal(acc.segment_accum(*args)[0], got[0])


def _accum_args(stream, dev):
    pix, depth, payload, sid, npix = stream
    keys, perm = acc.sort_writers(_t(pix, dev), _t(depth, dev))
    return keys, perm, _t(payload, dev), _t(sid, dev), npix


def _long_stream(case, k):
    """Streams whose segments cross K4's tiles of acc.TILE_ROWS rows:
    ``spanning`` 40 pixels over 60,000 writers (each segment ~1,100-1,900
    rows, most crossing a tile edge), ``hot`` one pixel holding 250,000 of
    300,000 writers (more than 100 tiles), ``edge`` segment heads exactly
    on tile edges and one segment of exactly two tiles, ``no_writer`` a
    writer on every 16th pixel only; a quarter of the other writers
    dead."""
    if case == "edge":
        return head_on_tile_edge(acc.TILE_ROWS, k)
    rng = np.random.default_rng(12)
    npix, n = {"spanning": (40, 60000), "hot": (5000, 300000),
               "no_writer": (20000, 60000)}[case]
    pix = rng.integers(0, npix, n)
    if case == "no_writer":
        pix = pix // 16 * 16
    pix[rng.uniform(size=n) < 0.25] = npix
    if case == "hot":
        pix[:250000] = 1234
    depth = np.round(rng.uniform(1, 50, n)).astype(np.float32)  # ties
    payload = rng.normal(size=(n, k)).astype(np.float32)
    sid = rng.integers(0, 1 << 30, n).astype(np.int32)
    return pix.astype(np.int32), depth, payload, sid, npix


@pytest.mark.parametrize("k", [5, 9, 17])
@pytest.mark.parametrize("case", ["spanning", "hot", "edge", "no_writer"])
def test_segment_accum_kernel_tiles(dev, case, k):
    """K4 sums a segment that crosses tiles in every thread and tile it
    spans: its sums are the tile-and-carry emulation's bit for bit
    (tests/test_torch_accum.py, at the kernel's tile), within 1e-4 of
    scale of the plain version's, its winners identical, two runs
    identical."""
    args = _accum_args(_long_stream(case, k), dev)
    ops.reset_launches()
    got = acc.segment_accum(*args)
    assert ops.LAUNCHES["segment_accum"] == 1
    spans = tiles_spanned(args[0].cpu(), args[4], acc.TILE_ROWS)
    assert spans >= {"spanning": 2, "hot": 101, "edge": 2,
                     "no_writer": 1}[case]
    ref = acc.segment_accum_plain(*args)
    scale = max(float(ref[0].abs().max()), 1.0)
    assert float((got[0] - ref[0]).abs().max()) <= 1e-4 * scale
    for g, r_ in zip(got[1:], ref[1:]):
        assert torch.equal(g, r_)
    emu = tiled_segment_accum(*(a.cpu() if torch.is_tensor(a) else a
                                for a in args))
    for g, e in zip(got, emu):
        assert torch.equal(g.cpu(), e)
    again = acc.segment_accum(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if case == "hot":
        # the hot pixel's sum is not the sequential one
        rows = args[2].cpu()[args[1].cpu()[(args[0] >> 32).cpu() == 1234]]
        seq = np.cumsum(rows.numpy(), axis=0, dtype=np.float32)[-1]
        assert not np.array_equal(got[0][1234].cpu().numpy(), seq)


@pytest.mark.parametrize("n", [0, 5000])
def test_segment_accum_kernel_without_live_writers(dev, n):
    """W = 0, and a stream whose writers are all dead: every output zero."""
    npix = 700
    pix = np.full(n, npix, np.int32)
    stream = (pix, np.ones(n, np.float32),
              np.ones((n, 5), np.float32), np.arange(n, dtype=np.int32), npix)
    ops.reset_launches()
    got = acc.segment_accum(*_accum_args(stream, dev))
    assert ops.LAUNCHES["segment_accum"] == 1
    assert got[0].shape == (npix, 5)
    for g in got:
        assert not bool(g.any())


def test_render_kernels_match_plain(dev):
    lens = load_poly_lens(FLAGSHIP, device=dev)
    scene = sc.lightgrid_scene(n=3, spacing=18.0, z=-150.0, radius=1.0,
                               intensity=40.0, device=dev)
    rc = pt.RenderConfig(xres=96, yres=64, spp=2)
    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    flagship = {"po_forward": 1, "expand": 1, "po_splat": 1,
                "segment_accum": 1, "tl_splat": 0, "po_splat_lam": 0,
                "po_splat_ext": 0, "po_backward": 0, "po_forward_vjp": 0,
                "po_forward_jvp": 0}
    ops.reset_launches()
    img_k, fb_k = render_frame(CFG, rc, scene, m, po_lens=lens,
                               po_state=STATE)
    assert ops.LAUNCHES == flagship, ops.LAUNCHES
    img_p, fb_p = render_frame(CFG, rc, scene, m, po_lens=lens,
                               po_state=STATE, ops=ops.PLAIN)
    assert ops.LAUNCHES == flagship, ops.LAUNCHES
    npix = rc.xres * rc.yres
    assert abs(float(fb_k["filter_weight"].sum()) - npix) <= 1e-4 * npix
    scale = max(float(img_p.abs().max()), 1.0)
    off = ((img_k - img_p).abs().amax(-1) > 2e-3 * scale).double().mean()
    assert float(off) <= 0.02


def _ring_cdf(dev):
    from pota_tpu_torch.render.bokeh_image import build_bokeh_cdf

    n = 32
    yy, xx = np.mgrid[0:n, 0:n]
    r = np.sqrt((xx - (n - 1) / 2) ** 2 + (yy - (n - 1) / 2) ** 2) / (n / 2)
    ring = ((r > 0.5) & (r < 0.95)).astype(np.float32)
    return build_bokeh_cdf(np.stack([ring] * 3, -1), device=dev)


@pytest.mark.parametrize("case, kernel", [
    ("thin_lens", "tl_splat"),
    ("chroma", "po_splat_lam"),
    ("bokeh_chroma", "po_splat_ext"),
    ("blades", "po_splat_ext"),
])
def test_render_variant_kernels_match_plain(dev, case, kernel):
    import dataclasses

    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    rc = pt.RenderConfig(xres=96, yres=64, spp=2)
    kw = {}
    if case == "thin_lens":
        cfg = pt.CameraConfig(focal_length=50.0, fstop=1.4,
                              focus_distance=150.0, vignetting_retries=3,
                              splat_queue_mult=8)
        scene = sc.teapot_scene(device=dev)
    else:
        cfg = dataclasses.replace(CFG, abb_chromatic=0.6 * (case != "blades"),
                                  bokeh_enable_image=case == "bokeh_chroma",
                                  aperture_blades=6 * (case == "blades"))
        scene = sc.lightgrid_scene(n=4, spacing=14.0, z=-150.0, radius=0.8,
                                   intensity=40.0, device=dev)
        kw = dict(po_lens=load_poly_lens(FLAGSHIP, device=dev),
                  po_state=STATE, bokeh_cdf=_ring_cdf(dev))
    ops.reset_launches()
    img_k, fb_k = render_frame(cfg, rc, scene, m, **kw)
    assert ops.LAUNCHES[kernel] == 1, ops.LAUNCHES
    img_p, _ = render_frame(cfg, rc, scene, m, ops=ops.PLAIN, **kw)
    npix = rc.xres * rc.yres
    assert abs(float(fb_k["filter_weight"].sum()) - npix) <= 1e-4 * npix
    assert bool(torch.isfinite(img_k).all())
    scale = max(float(img_p.abs().max()), 1.0)
    off = ((img_k - img_p).abs().amax(-1) > 2e-3 * scale).double().mean()
    assert float(off) <= 0.02


@pytest.mark.parametrize("chroma", [0.0, 0.6])
def test_render_motion_blur_kernels_match_plain(dev, chroma):
    """The motion-blurred flagship frame takes the decomposed route: K1, K2,
    K6 and K4, not K3; chromatic, K6 takes three tables."""
    cfg = dataclasses.replace(CFG, abb_chromatic=chroma)
    lens = load_poly_lens(FLAGSHIP, device=dev)
    scene = sc.lightgrid_scene(n=3, spacing=18.0, z=-150.0, radius=1.0,
                               intensity=40.0, device=dev)
    rc = pt.RenderConfig(xres=64, yres=64, spp=2)
    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    end = look_at([2.0, 0, 0], [2.0, 0, -1], device=dev)
    ops.reset_launches()
    img_k, fb_k = render_frame(cfg, rc, scene, m, po_lens=lens,
                               po_state=STATE, cam_to_world_end=end)
    assert ops.LAUNCHES == {
        "po_forward": 1, "expand": 1, "po_splat": 0, "segment_accum": 1,
        "tl_splat": 0, "po_splat_lam": 0, "po_splat_ext": 0,
        "po_backward": 1, "po_forward_vjp": 0, "po_forward_jvp": 0}, \
        ops.LAUNCHES
    img_p, _ = render_frame(cfg, rc, scene, m, po_lens=lens, po_state=STATE,
                            cam_to_world_end=end, ops=ops.PLAIN)
    npix = rc.xres * rc.yres
    assert abs(float(fb_k["filter_weight"].sum()) - npix) <= 1e-4 * npix
    assert bool(torch.isfinite(img_k).all())
    scale = max(float(img_p.abs().max()), 1.0)
    off = ((img_k - img_p).abs().amax(-1) > 2e-3 * scale).double().mean()
    assert float(off) <= 0.02


@pytest.mark.parametrize("s_cap", [4000, 40000, 200000])
def test_expand_fn_backward_on_the_card(dev, s_cap):
    """``ExpandFn`` with the kernel on the card: forward exact, and the
    table gradient (the range sums over each source's live slots) against
    the same backward on CPU tensors (the plain expand), to 1e-6 of scale,
    with the same bits on two card runs; at 200,000 slots the queue's live
    end is at ~14% (a four-card rank's band, mostly dead slots)."""
    from pota_tpu_torch.render.splat import splat_queue_compact

    rng = np.random.default_rng(4)
    n = 3000
    budget = torch.as_tensor(rng.integers(4, 20, n).astype(np.int32))
    redistribute = torch.as_tensor(rng.uniform(size=n) < 0.8)
    src, slot_on, slots = splat_queue_compact(budget, redistribute, s_cap)
    if s_cap == 200000:
        assert float(slot_on.double().mean()) < 0.2
    n_src = int((slots > 0).sum())
    offs = torch.cumsum(slots[slots > 0], 0)
    bounds = torch.stack([offs - slots[slots > 0], offs]).clamp(
        max=s_cap).to(torch.int32)
    tf = rng.normal(size=(pk.TF_ROWS, n_src)).astype(np.float32)
    ti = rng.integers(0, 1000, (pk.TI_ROWS, n_src)).astype(np.int32)
    d_ex = rng.normal(size=(pk.TF_ROWS, s_cap)).astype(np.float32)
    grads = []
    for d in (dev, torch.device("cpu")):
        t = _t(tf, d).requires_grad_(True)
        ops.reset_launches()
        ex_f, ex_i = pk.ExpandFn.apply(t, src.to(d, torch.int32), _t(ti, d),
                                       bounds.to(d), pk.expand)
        assert ops.LAUNCHES["expand"] == (1 if d.type == "cuda" else 0)
        ref = pk.expand_plain(src.to(d, torch.int32), _t(tf, d), _t(ti, d))
        assert torch.equal(ex_f.detach(), ref[0])
        (g,) = torch.autograd.grad(ex_f, t, _t(d_ex, d), retain_graph=True)
        if d.type == "cuda":
            again = torch.autograd.grad(ex_f, t, _t(d_ex, d))[0]
            assert torch.equal(g, again)
        grads.append(g.cpu())
    scale = float(grads[1].abs().max())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-6 * scale


def test_source_table_gradient_on_the_card(dev):
    """The source table's reorder (``PermuteFn``) on the card: forward the
    indexing's bits, and its gradient (a gather by the inverse
    permutation) equal to autograd's gradient of ``cols[:, order]``, on a
    has-slots mask with ties over 1,000,003 columns."""
    from pota_tpu_torch.render.splat import PermuteFn

    g = torch.Generator(device=dev).manual_seed(21)
    n = 1_000_003
    has = torch.rand(n, generator=g, device=dev) < 0.6
    order = torch.argsort((~has).to(torch.int8), stable=True)
    cols = torch.randn((13, n), generator=g, device=dev)
    ct = torch.randn((13, n), generator=g, device=dev)
    a = cols.clone().requires_grad_(True)
    out = PermuteFn.apply(a, order)
    b = cols.clone().requires_grad_(True)
    want = b[:, order]
    assert torch.equal(out.detach(), want.detach())
    out.backward(ct)
    want.backward(ct)
    assert torch.equal(a.grad, b.grad)


def test_accum_fn_backward_on_the_card(dev):
    """``AccumFn`` with K4 on the card: the payload gradient (the
    accumulator's gradient gathered at each live writer's pixel) equals
    the same backward on CPU tensors, bit for bit."""
    rng = np.random.default_rng(8)
    w, npix, k = 20000, 3000, 5
    pix = rng.integers(0, npix, w)
    pix[rng.uniform(size=w) < 0.25] = npix
    depth = np.round(rng.uniform(1, 60, w)).astype(np.float32)
    payload = rng.normal(size=(w, k)).astype(np.float32)
    sid = rng.integers(0, 1 << 20, w).astype(np.int32)
    d_accum = rng.normal(size=(npix, k)).astype(np.float32)
    got = []
    for d in (dev, torch.device("cpu")):
        p = _t(payload, d).requires_grad_(True)
        ops.reset_launches()
        out = acc.accumulate_sorted(_t(pix, d), _t(depth, d), p, _t(sid, d),
                                    npix)
        assert ops.LAUNCHES["segment_accum"] == (1 if d.type == "cuda" else 0)
        (g,) = torch.autograd.grad(out[0], p, _t(d_accum, d))
        got.append((out[0].detach().cpu(), g.cpu()))
    scale = float(got[1][0].abs().max())
    assert float((got[0][0] - got[1][0]).abs().max()) <= 1e-4 * scale
    assert torch.equal(got[0][1], got[1][1])


def test_render_differentiable_on_the_card(dev):
    """A differentiable PO frame on the card: K2, K3 and K4 launched once
    each, the trace through ``ForwardFn`` in its 4 checkpointed chunks (K1
    twice a chunk, forward and recompute, K1v once); gradients finite,
    non-zero, and within 5e-2 relative L2 of the same frame's through the
    plain versions (a loose limit: K3 and its plain version may split a
    grazing source differently; chip_smoke.py's 256x144 parity frame
    measures 6.5e-5)."""
    scene = sc.teapot_scene(device=dev)
    rc = pt.RenderConfig(xres=64, yres=48, spp=1)
    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    cfg = dataclasses.replace(CFG, vignetting_retries=2, splat_queue_mult=4,
                              trace_chunks=4)
    lens = load_poly_lens(FLAGSHIP, device=dev)
    lens.pt.coeffs.requires_grad_(True)
    lens.ap.coeffs.requires_grad_(True)
    grads = []
    for kernel_set in (ops.KERNELS, ops.PLAIN):
        lens.pt.coeffs.grad = lens.ap.coeffs.grad = None
        ops.reset_launches()
        img, _ = render_frame(cfg, rc, scene, m, po_lens=lens,
                              po_state=STATE, differentiable=True,
                              ops=kernel_set)
        img[..., :3].mean().backward()
        if kernel_set is ops.KERNELS:
            assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
                "po_forward": 8, "expand": 1, "po_splat": 1,
                "segment_accum": 1, "po_forward_vjp": 4}
        grads.append(lens.pt.coeffs.grad.clone())
    assert bool(torch.isfinite(grads[0]).all())
    assert float(grads[0].norm()) > 0
    assert float((grads[0] - grads[1]).norm() / grads[1].norm()) < 5e-2


@pytest.mark.parametrize("w_total, npix", [(200_000, 4096), (3_000_001, 65536)])
def test_crypto_topk_on_the_card_matches_float64(dev, w_total, npix):
    """The id-matte's two-sort rank extraction on the card against
    chip_smoke.py's float64 oracle of the same records (a ``torch.unique``
    inverse and float64 ``index_add_``): kept coverages and pixel totals
    within 1e-6 relative, ids identical away from near-ties."""
    from chip_smoke import crypto_oracle
    from pota_tpu_torch.render.crypto import crypto_topk

    rng = np.random.default_rng(w_total)
    pix = rng.integers(-3, npix + 3, w_total)
    ids = rng.integers(-1, 9, w_total)
    w = rng.uniform(0.0, 1.0, w_total).astype(np.float32)
    w[rng.uniform(size=w_total) < 0.1] = 0.0
    args = [_t(a, dev) for a in (pix, ids, w)]
    rid, rw, tot = crypto_topk(*args, npix, k=6)
    o_id, o_w, o_tot = crypto_oracle(*args, npix, 6)
    kept = o_w > 0
    assert int(kept.sum()) > npix
    assert float(((rw.double() - o_w).abs()[kept] / o_w[kept]).max()) < 1e-6
    assert not bool((rw[~kept] != 0).any())
    on = o_tot > 0
    assert float(((tot.double() - o_tot).abs()[on] / o_tot[on]).max()) < 1e-6
    apart = torch.ones_like(kept)
    close = (((o_w[:, :-1] - o_w[:, 1:]).abs() <= 1e-6 * o_w[:, :-1])
             & (o_w[:, :-1] > 0))
    apart[:, 1:] &= ~close
    apart[:, :-1] &= ~close
    assert torch.equal(rid.long()[apart], o_id[apart])


def test_render_id_matte_on_the_card(dev):
    """A PO frame of chip_smoke.py's glass teapot with the id-matte on the
    card: K1-K4 launched once each; the id-matte planes through the kernels
    against those through the plain versions (pixel totals to 1e-3 of
    scale on >= 98% of pixels, as the frames' planes)."""
    from chip_smoke import glass_teapot
    from pota_tpu_torch.render.splat import resolve_crypto

    scene = glass_teapot(dev)
    rc = pt.RenderConfig(xres=96, yres=64, spp=1, enable_id_matte=True)
    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    lens = load_poly_lens(FLAGSHIP, device=dev)
    fbs = []
    for kernel_set in (ops.KERNELS, ops.PLAIN):
        ops.reset_launches()
        _, fb = render_frame(CFG, rc, scene, m, po_lens=lens, po_state=STATE,
                             ops=kernel_set)
        if kernel_set is ops.KERNELS:
            assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
                "po_forward": 1, "expand": 1, "po_splat": 1,
                "segment_accum": 1}
        fbs.append(fb)
    tot_k, tot_p = fbs[0]["crypto_total"], fbs[1]["crypto_total"]
    assert float(tot_p.max()) > 0
    off = (tot_k - tot_p).abs() > 1e-3 * float(tot_p.abs().max())
    assert float(off.double().mean()) <= 0.02
    layers = resolve_crypto(fbs[0])
    assert all(bool(torch.isfinite(layer).all()) for layer in layers)
    assert float(layers[0][..., 1].max()) <= 1.0 + 1e-5


# ------------------------------------------- fitting, differentials, replay


def test_fit_on_the_card_matches_the_cpu(dev):
    """The flagship fitted on the card (float32 trace, float64 QR + SVD
    solve) against the same fit on the CPU: the tracers' valid rays agree
    on >= 99.9%, the held-out rms within 10%, most terms shared (a float32
    trace difference can move a term across the cut), and predictions on
    fresh rays within the fidelity gate's position limit's 1%."""
    from pota_tpu_torch.lens.database import get_lens_system
    from pota_tpu_torch.optics import fit as tfit
    from pota_tpu_torch.optics.polynomial import poly_eval
    from pota_tpu_torch.optics.raytrace import trace_to_chart

    fits = {}
    for d in (dev, torch.device("cpu")):
        lens = get_lens_system(FLAGSHIP, device=d)
        fits[d.type] = tfit.fit_lens(lens, n_samples=20_000,
                                     return_diagnostics=True, device=d)
    (pc, dc), (pp, dp) = fits["cuda"], fits["cpu"]
    assert pc.pt.coeffs.device.type == "cuda"
    for k, v in dp.items():
        if k.startswith("rms"):
            assert abs(dc[k] - v) <= 0.1 * v, (k, dc[k], v)
    te = lambda p: {tuple(e) for e in p.pt.exponents.tolist()}
    assert len(te(pc) & te(pp)) >= 150
    lens = get_lens_system(FLAGSHIP, device="cpu")
    s, _, _ = tfit.sample_fit_domain(lens, 5000, seed=987)
    s = torch.as_tensor(s)
    _, _, _, v = trace_to_chart(lens, s)
    _, _, _, vc = trace_to_chart(lens.to(dev), s.to(dev))
    assert float((vc.cpu() == v).double().mean()) >= 0.999
    got = poly_eval(pc.pt, s.to(dev)).cpu()[v]
    want = poly_eval(pp.pt, s)[v]
    assert float((got[:, :2] - want[:, :2]).abs().max()) < 1.2e-3


def test_derivs_on_the_card(dev):
    """Ray differentials of a 96x64 PO frame on the card: K1 once for the
    primary rays and K1j once for both axes, the differentials finite and
    within float32 rounding of the CPU's (the term trace's jvp) on the same
    samples, and of the term trace's ``torch.func.jvp`` on the card; without
    depth of field no K1j."""
    from pota_tpu_torch.models.po_camera import trace_fw_po
    from pota_tpu_torch.optics.focus import setup_po_camera
    from pota_tpu_torch.render.renderer import trace_camera_rays_with_derivs
    from pota_tpu_torch.render.sampling import frame_samples

    cfg = dataclasses.replace(CFG, focus_distance=150.0)
    rc = pt.RenderConfig(xres=96, yres=64, spp=1)
    out = {}
    for d in (dev, torch.device("cpu")):
        lens = load_poly_lens(FLAGSHIP, device=d)
        state = setup_po_camera(lens, cfg)
        smp = frame_samples(rc, 0, device=d)
        ops.reset_launches()
        out[d.type] = trace_camera_rays_with_derivs(
            cfg, rc, smp, po_lens=lens, po_state=state)
        if d.type == "cuda":
            assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
                "po_forward": 1, "po_forward_jvp": 1}
            ops.reset_launches()
            trace_camera_rays_with_derivs(
                dataclasses.replace(cfg, enable_dof=False), rc, smp,
                po_lens=lens, po_state=state)
            assert ops.LAUNCHES["po_forward_jvp"] == 0

            def deriv_trace(sx, sy):
                return trace_fw_po(cfg, lens, sx, sy, smp["r1"], smp["r2"],
                                   None, state, deriv_ray=True)[:2]

            zeros = torch.zeros_like(smp["sx"])
            (dOdx, dDdx), (dOdy, dDdy) = (
                torch.func.jvp(deriv_trace, (smp["sx"], smp["sy"]), t)[1]
                for t in ((torch.full_like(zeros, 2.0 / rc.xres), zeros),
                          (zeros, torch.full_like(zeros, 2.0 / rc.yres))))
            out["terms"] = {"dOdx": dOdx, "dOdy": dOdy, "dDdx": dDdx,
                            "dDdy": dDdy}
    live = (out["cuda"][2].cpu() > 0) & (out["cpu"][2] > 0)
    assert int(live.sum()) > 0.9 * live.numel()
    for k, want in out["cpu"][3].items():
        got = out["cuda"][3][k].cpu()
        assert bool(torch.isfinite(got[live]).all()), k
        assert float((got - want)[live].abs().max()) < 1e-5, k
        terms = out["terms"][k].cpu()
        assert float((got - terms)[live].abs().max()) < 1e-5, k


@pytest.mark.parametrize("with_scene", [True, False],
                         ids=["scene", "null_scene"])
def test_replay_on_the_card(dev, tmp_path, with_scene):
    """A 96x64 flagship stream saved, read back onto the card and replayed:
    with the scene K2, K3 and K4 once each (K1 never) and the live frame's
    bits; without one the decomposed route (K2, K6, K4)."""
    from pota_tpu_torch.render import replay, splat
    from pota_tpu_torch.render.renderer import render_sample_stream

    lens = load_poly_lens(FLAGSHIP, device=dev)
    scene = sc.lightgrid_scene(n=3, spacing=18.0, z=-150.0, radius=1.0,
                               intensity=40.0, device=dev)
    rc = pt.RenderConfig(xres=96, yres=64, spp=1)
    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    po = dict(po_lens=lens, po_state=STATE)
    live, _ = render_frame(CFG, rc, scene, m, **po)
    with torch.no_grad():
        stream = render_sample_stream(CFG, rc, scene, m, 0, **po)
    p = str(tmp_path / "s.pstream")
    replay.save_capture(p, stream)
    loaded = replay.load_capture(p, device=dev)
    assert loaded["rgba"].device.type == "cuda"
    ops.reset_launches()
    img, _ = replay.replay_splat(CFG, rc, loaded, m,
                                 scene=scene if with_scene else None, **po)
    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
    assert bool(torch.isfinite(img).all())
    if with_scene:
        assert launched == {"expand": 1, "po_splat": 1, "segment_accum": 1}
        assert torch.equal(img, live)
    else:
        assert launched == {"expand": 1, "po_backward": 1,
                            "segment_accum": 1}
        assert splat.LAST_ROUTE == "decomposed_po"
        assert float(img[..., :3].sum()) > 0


def test_render_frame_sharded_world_one_on_the_card(dev, tmp_path):
    """``render_frame_sharded`` on a world-size-1 NCCL group at 64x64: K1-K4
    once each, the image and every plane bit-identical to
    ``render_frame``'s."""
    import torch.distributed as dist

    from pota_tpu_torch.parallel import sharded as sh

    lens = load_poly_lens(FLAGSHIP, device=dev)
    scene = sc.lightgrid_scene(n=3, spacing=18.0, z=-150.0, radius=1.0,
                               intensity=40.0, device=dev)
    rc = pt.RenderConfig(xres=64, yres=64, spp=1)
    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    po = dict(po_lens=lens, po_state=STATE)
    want_img, want = render_frame(CFG, rc, scene, m, **po)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = sh.make_mesh(1)
        assert mesh.backend == "nccl" and mesh.device == dev
        ops.reset_launches()
        img, fb = sh.render_frame_sharded(CFG, rc, scene, m, mesh, **po)
        torch.cuda.synchronize()
        assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
            "po_forward": 1, "expand": 1, "po_splat": 1, "segment_accum": 1}
    finally:
        dist.destroy_process_group()
    assert torch.equal(img, want_img) and set(fb) == set(want)
    for k, v in want.items():
        assert torch.equal(fb[k], v), k
