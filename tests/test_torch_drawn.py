"""K1's draw mode on the CPU: ``ops.po_forward_drawn`` (K1 draws each ray's
aperture candidates itself), its plain version against the torch chain the
PO trace ran before it (the retry uniforms, the aperture sampler, the
candidates repeated into K1's layout, then plain K1), ``trace_fw_po``'s
choice between the two modes, ``DrawnForwardFn`` against ``ForwardFn``, and
its counts (``LAUNCHES``, ``k1.drawn``).  The kernel itself is held to the
same chain on the card: ``test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import pota_tpu_torch as pt
from pota_tpu_torch import ops
from pota_tpu_torch.models import po_camera
from pota_tpu_torch.ops import po_kernels as pk
from pota_tpu_torch.optics import samplers
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import POState
from pota_tpu_torch.render.bokeh_image import build_bokeh_cdf
from pota_tpu_torch.utils import rng as prng
from pota_tpu_torch.utils import trace

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
STATE = POState(aperture_radius=4.672678708153359,
                sensor_shift=15.091056449990935, focus_distance=200.0,
                tan_fov=0.36734693877551)
CFG = pt.CameraConfig(
    camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
    fstop=2.8, focus_distance=20.0, vignetting_retries=3)
LAM, ITERS = 0.55, 3


@pytest.fixture(scope="module")
def lens():
    return load_poly_lens(FLAGSHIP, device="cpu")


def rays(n=96, seed=0):
    """Sensor points (mm), uniforms and retry keys of ``n`` rays, with the
    edges: keys 0, 1, 2^32 - 2 and 2^32 - 1; (r1, r2) on (0.5, 0.5) (the
    disk's both-zero branch), on 0.5 in one coordinate (a zero square
    side), on 0 and just under 1."""
    g = np.random.default_rng(seed)
    x, y = (g.uniform(-12, 12, n).astype(np.float32) for _ in range(2))
    r1, r2 = (g.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    edges = [(0.5, 0.5), (0.5, 0.2), (0.8, 0.5), (0.0, 0.0), (0.0, 0.9999999)]
    for i, (a, b) in enumerate(edges):
        r1[i], r2[i] = a, b
    key = g.integers(0, 2 ** 32, n, dtype=np.int64)
    key[:4] = (0, 1, 2 ** 32 - 2, 2 ** 32 - 1)
    return tuple(torch.from_numpy(a) for a in (x, y, r1, r2, key))


def torch_chain(x, y, r1, r2, key, tries, radius, blades):
    """The candidates as the PO trace drew them in torch before K1 drew
    them: JAX's retry draws, the sampler times the radius, K1's layout."""
    n = x.shape[0]
    if tries > 1:
        tries_idx = torch.arange(1, tries, dtype=torch.int64)
        us = prng.uniforms(key[:, None], tries_idx[None, :], 2)
        r1k = torch.cat([r1[:, None], us[..., 0]], 1)
        r2k = torch.cat([r2[:, None], us[..., 1]], 1)
    else:
        r1k, r2k = r1[:, None], r2[:, None]
    if blades < 2:
        aperture = samplers.concentric_disk_sample(r1k, r2k)
    else:
        aperture = samplers.triangular_aperture_sample(r1k, r2k, 1.0, blades)
    aperture = aperture * radius
    rep = lambda a: a[:, None].expand(n, tries).reshape(-1)
    return (rep(x), rep(y), aperture[..., 0].reshape(-1).contiguous(),
            aperture[..., 1].reshape(-1).contiguous())


@pytest.mark.parametrize("blades", [0, 5])
@pytest.mark.parametrize("tries", [1, 3, 4])
def test_drawn_plain_is_the_torch_chain(lens, tries, blades):
    """The plain draw mode, and the wrapper on the CPU, give the torch
    chain's candidates and K1's outputs on them bit for bit; without
    ``need_rays`` only K1's four outputs; ``LAUNCHES`` does not count the
    plain version."""
    x, y, r1, r2, key = rays()
    radius = STATE.aperture_radius
    want_rays = torch_chain(x, y, r1, r2, key, tries, radius, blades)
    want = pk.po_forward_plain(lens, *want_rays, LAM, STATE.sensor_shift,
                               ITERS)
    args = (lens, x, y, r1, r2, key, tries, radius, blades, LAM,
            STATE.sensor_shift, ITERS)
    ops.reset_launches()
    for fn in (pk.po_forward_drawn_plain, ops.KERNELS.po_forward_drawn):
        got = fn(*args, True)
        assert len(got) == 8
        for g, w in zip(got, (*want, *want_rays)):
            assert g.shape[0] == x.shape[0] * tries
            assert torch.equal(g, w)
        short = fn(*args)
        assert len(short) == 4
        assert all(torch.equal(g, w) for g, w in zip(short, want))
    assert ops.LAUNCHES["po_forward"] == 0
    if tries == 1:
        got = ops.KERNELS.po_forward_drawn(lens, x, y, r1, r2, None, *args[6:])
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool((want[1] > 0).any())


def test_drawn_wrapper_checks(lens):
    """The wrapper refuses a missing key with retries, a wrong dtype, and
    inputs that require grad while grad mode is on."""
    x, y, r1, r2, key = rays(8)
    rest = (STATE.aperture_radius, 0, LAM, STATE.sensor_shift, ITERS)
    with pytest.raises(TypeError):
        ops.KERNELS.po_forward_drawn(lens, x, y, r1, r2, None, 4, *rest)
    with pytest.raises(TypeError):
        ops.KERNELS.po_forward_drawn(lens, x, y, r1, r2, key.int(), 4, *rest)
    with pytest.raises(ValueError):
        ops.KERNELS.po_forward_drawn(lens, x, y, r1, r2, key, 0, *rest)
    with pytest.raises(RuntimeError):
        ops.KERNELS.po_forward_drawn(lens, x.requires_grad_(True), y, r1,
                                     r2, key, 4, *rest)


def test_k1_drawn_counts_only_while_a_profiler_records(lens):
    """``k1.drawn`` adds N x K a draw-mode call while a profiler records,
    and nothing otherwise."""
    x, y, r1, r2, key = rays(40)
    args = (lens, x, y, r1, r2, key, 4, STATE.aperture_radius, 0, LAM,
            STATE.sensor_shift, ITERS)
    trace.reset()
    try:
        ops.KERNELS.po_forward_drawn(*args)
        assert "k1.drawn" not in trace.snapshot()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            ops.KERNELS.po_forward_drawn(*args)
            ops.KERNELS.po_forward_drawn(*args[:6], 2, *args[7:])
        assert trace.snapshot()["k1.drawn"] == 40 * 4 + 40 * 2
    finally:
        trace.reset()


class _Counting:
    """``ops.PLAIN`` counting K1's calls in each mode, and the three
    autograd functions' applications."""

    def __init__(self, monkeypatch):
        self.calls = {"po_forward": 0, "po_forward_drawn": 0,
                      "po_forward_selected": 0, "ForwardFn": 0,
                      "DrawnForwardFn": 0, "SelectFn": 0}
        self.ops = ops.PLAIN._replace(**{
            k: self._count(k, getattr(ops.PLAIN, k))
            for k in ("po_forward", "po_forward_drawn",
                      "po_forward_selected")})
        for name in ("ForwardFn", "DrawnForwardFn", "SelectFn"):
            fn = getattr(po_camera, name)
            monkeypatch.setattr(po_camera, name, type(
                name, (), {"apply": staticmethod(self._count(name,
                                                             fn.apply))}))

    def _count(self, name, fn):
        def call(*a):
            self.calls[name] += 1
            return fn(*a)
        return call


CASES = {
    # (config changes, bokeh image, deriv_ray) -> the call expected
    "dof": (dict(), False, False, "po_forward_drawn"),
    "blades": (dict(aperture_blades=6), False, False, "po_forward_drawn"),
    "no_retries": (dict(vignetting_retries=0), False, False,
                   "po_forward_drawn"),
    "image_bokeh": (dict(bokeh_enable_image=True), True, False,
                    "po_forward"),
    "bokeh_flag_without_image": (dict(bokeh_enable_image=True), False,
                                 False, "po_forward_drawn"),
    "image_without_flag": (dict(), True, False, "po_forward_drawn"),
    "no_dof": (dict(enable_dof=False), False, False, None),
    "deriv_ray": (dict(), False, True, None),
}


@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["no_grad", "differentiable"])
@pytest.mark.parametrize("case", list(CASES))
def test_trace_fw_po_takes_the_draw_mode(lens, monkeypatch, case,
                                         differentiable):
    """``trace_fw_po`` draws in K1 exactly when depth of field is on, the
    image bokeh is off (its flag and a CDF) and the call is not the deriv
    ray's: in K1's select mode, ``ops.po_forward_selected``, or on the
    CPU's differentiable route ``DrawnForwardFn``; the image bokeh takes
    ``ops.po_forward`` or ``ForwardFn``; no depth of field and the deriv
    ray take neither."""
    changes, with_image, deriv_ray, want = CASES[case]
    cfg = dataclasses.replace(CFG, **changes)
    cdf = None
    if with_image:
        yy, xx = np.mgrid[0:16, 0:16]
        disk = (((xx - 7.5) ** 2 + (yy - 7.5) ** 2) < 49).astype(np.float32)
        cdf = build_bokeh_cdf(np.stack([disk] * 3, -1), device="cpu")
    x, y, r1, r2, key = rays(64)
    counting = _Counting(monkeypatch)
    with torch.set_grad_enabled(differentiable):
        if differentiable:
            lens.pt.coeffs.requires_grad_(True)
        try:
            out = po_camera.trace_fw_po(
                cfg, lens, x / 18.0, y / 18.0, r1, r2,
                None if deriv_ray else key, STATE, ops=counting.ops,
                bokeh_cdf=cdf, differentiable=differentiable,
                deriv_ray=deriv_ray)
        finally:
            lens.pt.coeffs.requires_grad_(False)
    assert out[0].shape == (64, 3)
    if want is not None:
        want = {(False, "po_forward"): "po_forward",
                (True, "po_forward"): "ForwardFn",
                (False, "po_forward_drawn"): "po_forward_selected",
                (True, "po_forward_drawn"): "DrawnForwardFn"}[
                    differentiable, want]
    assert {k: v for k, v in counting.calls.items() if v} == (
        {want: 1} if want else {})


def test_drawn_forward_fn_matches_forward_fn(lens):
    """``DrawnForwardFn`` on the CPU: the outputs of ``ForwardFn`` on the
    torch chain's candidates, bit for bit, and the same coefficient
    gradients; the sensor point's cotangents are ``ForwardFn``'s summed
    over each ray's candidates."""
    x, y, r1, r2, key = rays(48)
    tries, blades = 4, 0
    draw = (tries, STATE.aperture_radius, blades)
    rest = (LAM, STATE.sensor_shift, ITERS, ops.PLAIN)
    coeffs = (lens.pt.coeffs, lens.ap.coeffs)
    res = []
    try:
        for drawn in (True, False):
            for c in coeffs:
                c.requires_grad_(True)
                c.grad = None
            xs, ys = (t.clone().requires_grad_(True) for t in (x, y))
            if drawn:
                out = pk.DrawnForwardFn.apply(xs, ys, r1, r2, key, *coeffs,
                                              lens, draw, *rest)
            else:
                cand = torch_chain(xs, ys, r1, r2, key, *draw)
                out = pk.ForwardFn.apply(*cand, *coeffs, lens, *rest)
            w = torch.linspace(-1.0, 1.0, out[0].numel()).view(-1, 4)
            loss = (out[0] * w).sum() + out[1].sum()
            loss.backward()
            res.append((out, [c.grad.clone() for c in coeffs],
                        xs.grad, ys.grad))
    finally:
        for c in coeffs:
            c.requires_grad_(False)
            c.grad = None
    (o1, g1, x1, y1), (o2, g2, x2, y2) = res
    assert all(torch.equal(a.detach(), b.detach()) for a, b in zip(o1, o2))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert float(g1[0].norm()) > 0
    for a, b in ((x1, x2), (y1, y2)):
        assert a.shape == (48,)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
