"""K1's candidates as its select mode draws them, on the CPU: the torch draw
(``po_kernels.drawn_rays``) and K1's plain candidates on it
(``po_forward_drawn_plain``, which the select mode's plain version runs)
against the torch chain the PO trace ran before K1 drew (the retry
uniforms, the aperture sampler, the candidates repeated into K1's layout,
then plain K1), and ``trace_fw_po``'s choice of K1 mode.  The select kernel
itself is held to the same chain on the card: ``test_torch_cuda.py``.
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
    """``drawn_rays`` gives the torch chain's candidates, and
    ``po_forward_drawn_plain`` K1's plain outputs on them, bit for bit;
    with K 1 also without a key; ``LAUNCHES`` does not count the plain
    version."""
    x, y, r1, r2, key = rays()
    radius = STATE.aperture_radius
    want_rays = torch_chain(x, y, r1, r2, key, tries, radius, blades)
    want = pk.po_forward_plain(lens, *want_rays, LAM, STATE.sensor_shift,
                               ITERS)
    draw = (tries, radius, blades)
    rest = (LAM, STATE.sensor_shift, ITERS)
    keys = (key, None) if tries == 1 else (key,)
    ops.reset_launches()
    for k in keys:
        got_rays = pk.drawn_rays(x, y, r1, r2, k, *draw)
        for g, w in zip(got_rays, want_rays):
            assert g.shape[0] == x.shape[0] * tries
            assert torch.equal(g, w)
        got = pk.po_forward_drawn_plain(lens, x, y, r1, r2, k, *draw, *rest)
        assert len(got) == 4
        for g, w in zip(got, want):
            assert g.shape[0] == x.shape[0] * tries
            assert torch.equal(g, w)
    assert ops.LAUNCHES["po_forward"] == 0
    assert bool((want[1] > 0).any())


class _Counting:
    """``ops.PLAIN`` counting K1's calls in each mode, and the two
    autograd functions' applications."""

    def __init__(self, monkeypatch):
        self.calls = {"po_forward": 0, "po_forward_selected": 0,
                      "ForwardFn": 0, "SelectFn": 0}
        self.ops = ops.PLAIN._replace(**{
            k: self._count(k, getattr(ops.PLAIN, k))
            for k in ("po_forward", "po_forward_selected")})
        for name in ("ForwardFn", "SelectFn"):
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
    "dof": (dict(), False, False, "po_forward_selected"),
    "blades": (dict(aperture_blades=6), False, False, "po_forward_selected"),
    "no_retries": (dict(vignetting_retries=0), False, False,
                   "po_forward_selected"),
    "image_bokeh": (dict(bokeh_enable_image=True), True, False,
                    "po_forward"),
    "bokeh_flag_without_image": (dict(bokeh_enable_image=True), False,
                                 False, "po_forward_selected"),
    "image_without_flag": (dict(), True, False, "po_forward_selected"),
    "no_dof": (dict(enable_dof=False), False, False, None),
    "deriv_ray": (dict(), False, True, None),
}


@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["no_grad", "differentiable"])
@pytest.mark.parametrize("case", list(CASES))
def test_trace_fw_po_takes_the_select_mode(lens, monkeypatch, case,
                                           differentiable):
    """``trace_fw_po`` draws in K1 exactly when depth of field is on, the
    image bokeh is off (its flag and a CDF) and the call is not the deriv
    ray's: K1's select mode, ``ops.po_forward_selected``, or with a
    gradient ``SelectFn``, on the CPU as on the card; the image bokeh takes
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
                (False, "po_forward_selected"): "po_forward_selected",
                (True, "po_forward_selected"): "SelectFn"}[
                    differentiable, want]
    assert {k: v for k, v in counting.calls.items() if v} == (
        {want: 1} if want else {})
