"""Ray differentials and the reverse ray of the port against JAX's
(``pota_tpu_torch.render.renderer.trace_camera_rays_with_derivs``,
``camera_reverse_ray``), and the forward-mode rule of the aperture solve.

The differentials are one ``torch.func.jvp`` per screen axis over the
deriv-ray path (one candidate, no retries), as JAX's ``jax.jvp``; they are
held to JAX's on the same ``frame_samples`` at 32x32, and to central
differences of the same path as tests/test_derivs.py holds JAX's
(``rtol=2e-2, atol=2e-4``).  The PO path's differences run in float64
(lens buffers and samples cast): in float32 a 1e-3-pixel step is below the
trace's rounding.  Against JAX the port agrees to float32 rounding: the
differentials measured at most 5.6e-9 (thin lens) and 2.4e-7 (PO, on
values up to 0.047), so their limit is 1e-6 absolute; the PO primal rays
(K1's plain version on its folded table against JAX's trace) 2.2e-6 on
origins near 1, so theirs is 1e-5.
"""
import copy

import numpy as np
import pytest
import torch

from pota_tpu import CameraConfig, CameraType, RenderConfig
from pota_tpu.render import sampling as jsampling
from pota_tpu.render.renderer import camera_reverse_ray as jax_reverse
from pota_tpu.render.renderer import trace_camera_rays_with_derivs as jax_d

from tests.test_torch_slice import jax_stream_to_torch, to_port

from pota_tpu_torch.models.po_camera import trace_fw_po
from pota_tpu_torch.optics import polynomial as tpoly
from pota_tpu_torch.optics import thinlens
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import setup_po_camera
from pota_tpu_torch.render.renderer import (
    camera_reverse_ray, trace_camera_rays_with_derivs)

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
RC = RenderConfig(xres=32, yres=32, spp=1)
CFG = CameraConfig(focal_length=50.0, fstop=2.8, focus_distance=120.0,
                   vignetting_retries=1)
CFG_PO = CameraConfig(camera_type=CameraType.POLYNOMIAL_OPTICS,
                      lens_model=FLAGSHIP, fstop=2.8, focus_distance=150.0,
                      vignetting_retries=1)
KEYS = ("dOdx", "dOdy", "dDdx", "dDdy")
JAX_TOL = 1e-6
PRIMAL_TOL = 1e-5
FD_RTOL, FD_ATOL = 2e-2, 2e-4      # tests/test_derivs.py:57


@pytest.fixture(scope="module")
def samples():
    js = jsampling.frame_samples(RC, seed=3)
    return js, jax_stream_to_torch(js)


@pytest.fixture(scope="module")
def po():
    from pota_tpu.optics.fit import load_poly_lens as jload
    from pota_tpu.optics.focus import setup_po_camera as jsetup

    jlens = jload(FLAGSHIP)
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    return (dict(po_lens=jlens, po_state=jsetup(jlens, CFG_PO)),
            dict(po_lens=lens, po_state=setup_po_camera(lens,
                                                        to_port(CFG_PO))))


@pytest.mark.parametrize("camera", ["thin", "po"])
def test_derivs_match_jax(samples, po, camera):
    js, ts = samples
    cfg, jkw, tkw = ((CFG, {}, {}) if camera == "thin"
                     else (CFG_PO, *po))
    jo, jd, jw, jder = jax_d(cfg, RC, js, **jkw)
    to, td, tw, tder = trace_camera_rays_with_derivs(to_port(cfg),
                                                     to_port(RC), ts, **tkw)
    jw, tw = np.asarray(jw), tw.numpy()
    np.testing.assert_array_equal(tw > 0, jw > 0)
    live = tw > 0
    assert live.sum() > 0.5 * live.size
    np.testing.assert_allclose(to.numpy()[live], np.asarray(jo)[live],
                               rtol=0, atol=PRIMAL_TOL)
    np.testing.assert_allclose(td.numpy()[live], np.asarray(jd)[live],
                               rtol=0, atol=PRIMAL_TOL)
    for k in KEYS:
        got = tder[k].numpy()
        assert got.shape == (RC.xres * RC.yres, 3)
        assert np.isfinite(got[live]).all(), k
        np.testing.assert_allclose(got[live], np.asarray(jder[k])[live],
                                   rtol=0, atol=JAX_TOL, err_msg=k)


def _fd_derivs(trace, s, step_frac=1e-3):
    """Central differences of the deriv-ray path, per pixel step."""
    hx = (2.0 / RC.xres) * step_frac
    hy = (2.0 / RC.yres) * step_frac
    sx, sy = s["sx"], s["sy"]
    ox1, dx1 = trace(sx + hx, sy)
    ox0, dx0 = trace(sx - hx, sy)
    oy1, dy1 = trace(sx, sy + hy)
    oy0, dy0 = trace(sx, sy - hy)
    return {"dOdx": (ox1 - ox0) / (2 * step_frac),
            "dDdx": (dx1 - dx0) / (2 * step_frac),
            "dOdy": (oy1 - oy0) / (2 * step_frac),
            "dDdy": (dy1 - dy0) / (2 * step_frac)}


def test_thin_jvp_matches_finite_differences(samples):
    ts = samples[1]
    cfg = to_port(CFG)
    _, _, _, der = trace_camera_rays_with_derivs(cfg, to_port(RC), ts)

    def trace(sx, sy):
        o, d, _, _ = thinlens.trace_fw_thinlens(cfg, sx, sy, ts["r1"],
                                                ts["r2"], deriv_ray=True)
        return o, d

    fd = _fd_derivs(trace, ts)
    for k in KEYS:
        assert torch.isfinite(der[k]).all(), k
        np.testing.assert_allclose(der[k].numpy(), fd[k].numpy(),
                                   rtol=FD_RTOL, atol=FD_ATOL, err_msg=k)


def test_po_jvp_matches_float64_finite_differences(samples, po):
    """The PO differentials (float32 jvp) against central differences of
    the deriv-ray path run in float64."""
    ts = samples[1]
    cfg = to_port(CFG_PO)
    tkw = po[1]
    _, _, w, der = trace_camera_rays_with_derivs(cfg, to_port(RC), ts, **tkw)
    lens64 = copy.deepcopy(tkw["po_lens"]).double()
    s64 = {k: ts[k].double() for k in ("sx", "sy", "r1", "r2")}

    def trace(sx, sy):
        o, d, _, _ = trace_fw_po(cfg, lens64, sx, sy, s64["r1"], s64["r2"],
                                 None, tkw["po_state"], deriv_ray=True)
        return o, d

    fd = _fd_derivs(trace, s64)
    live = w > 0
    for k in KEYS:
        np.testing.assert_allclose(der[k][live].numpy(),
                                   fd[k][live].numpy(),
                                   rtol=FD_RTOL, atol=FD_ATOL, err_msg=k)


def test_thin_origin_derivs_zero(samples):
    """The thin lens's lens point does not move with the screen position."""
    _, _, _, der = trace_camera_rays_with_derivs(to_port(CFG), to_port(RC),
                                                 samples[1])
    assert float(der["dOdx"].abs().max()) < 1e-6
    assert float(der["dOdy"].abs().max()) < 1e-6
    assert float(der["dDdx"].abs().max()) > 1e-4
    assert float(der["dDdy"].abs().max()) > 1e-4


def test_po_deriv_ray_draws_no_retries(samples, po):
    """``deriv_ray`` traces the primary candidate only: where the primary
    ray passes, its ray is the one of the retried trace."""
    ts = samples[1]
    cfg = to_port(CFG_PO)
    tkw = po[1]
    o1, d1, w1, _ = trace_fw_po(cfg, tkw["po_lens"], ts["sx"], ts["sy"],
                                ts["r1"], ts["r2"], None, tkw["po_state"],
                                deriv_ray=True)
    o, d, w, tries = trace_fw_po(cfg, tkw["po_lens"], ts["sx"], ts["sy"],
                                 ts["r1"], ts["r2"], ts["key"],
                                 tkw["po_state"], differentiable=True)
    first = (tries == 0) & (w > 0)
    assert int(first.sum()) > 0
    assert torch.equal(w1[first], w[first])
    assert torch.equal(o1[first], o[first])
    assert torch.equal(d1[first], d[first])


@pytest.mark.parametrize("camera", ["thin", "po"])
def test_reverse_ray_matches_jax(po, camera):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    p = rng.uniform(-30, 30, (200, 3)).astype(np.float32)
    p[:, 2] = -np.abs(p[:, 2])
    p[:3] = [[0.0, 0.0, -200.0], [10.0, -5.0, -100.0], [1.0, 2.0, 0.0]]
    cfg = CFG if camera == "thin" else CFG_PO
    lens = {} if camera == "thin" else dict(po_lens=po[0]["po_lens"])
    tlens = {} if camera == "thin" else dict(po_lens=po[1]["po_lens"])
    want = np.asarray(jax_reverse(cfg, jnp.asarray(p), **lens))
    got = camera_reverse_ray(to_port(cfg), torch.as_tensor(p), **tlens)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    if camera == "thin":
        tan_fov = to_port(CFG).thinlens_tan_fov
        np.testing.assert_allclose(
            got[1].numpy(), [10.0 / (100.0 * tan_fov),
                             -5.0 / (100.0 * tan_fov)], rtol=1e-6)


def _aperture_inputs(lens, n=256, seed=0):
    rng = np.random.default_rng(seed)
    s5 = np.stack([rng.uniform(-12, 12, n), rng.uniform(-12, 12, n),
                   np.zeros(n), np.zeros(n), rng.uniform(0.45, 0.65, n)], -1)
    r = 0.6 * lens.aperture_housing_radius
    ap = rng.uniform(-r, r, (n, 2))
    return torch.as_tensor(s5), torch.as_tensor(ap), rng


def test_aperture_solve_jvp_matches_float64_finite_differences():
    """``_ApertureSolve.jvp`` (the implicit-function tangent) against a
    float64 central difference of its forward, in every input at once."""
    lens = load_poly_lens(FLAGSHIP, device="cpu").double()
    s5, ap, rng = _aperture_inputs(lens)
    coeffs = lens.ap.coeffs

    def f(s, a, c):
        return tpoly._ApertureSolve.apply(s, a, c, lens.ap, lens.aperture_z,
                                          8)

    ts = torch.as_tensor(rng.normal(size=s5.shape))
    ts[:, 2:4] = 0.0                       # the start point gets no tangent
    ta = torch.as_tensor(rng.normal(size=ap.shape))
    tc = torch.as_tensor(rng.normal(size=coeffs.shape)) * 1e-3
    d, dd = torch.func.jvp(f, (s5, ap, coeffs), (ts, ta, tc))
    torch.testing.assert_close(d, f(s5, ap, coeffs), rtol=0, atol=0)
    h = 1e-6
    fd = (f(s5 + h * ts, ap + h * ta, coeffs + h * tc)
          - f(s5 - h * ts, ap - h * ta, coeffs - h * tc)) / (2 * h)
    rel = float((dd - fd).norm() / fd.norm())
    assert rel < 1e-6, rel
    # one input at a time: the tangents add
    parts = [torch.func.jvp(lambda v: f(*(v if j == i else x
                                          for j, x in
                                          enumerate((s5, ap, coeffs)))),
                            (x,), (t,))[1]
             for i, (x, t) in enumerate(((s5, ts), (ap, ta), (coeffs, tc)))]
    torch.testing.assert_close(sum(parts), dd, rtol=1e-9, atol=1e-12)


def _newton_reference(fn, coeffs, s5, ap, aperture_z, iterations):
    """The aperture solve's forward as it stood before it gained a
    forward-mode rule: the straight-line start and the fixed-iteration 2x2
    Newton."""
    residual = tpoly._ap_residual(fn, coeffs, s5, ap)
    d = torch.stack([(ap[..., 0] - s5[..., 0]) / aperture_z,
                     (ap[..., 1] - s5[..., 1]) / aperture_z], -1)
    for _ in range(iterations):
        r, jac = tpoly._batched_jacobian(residual, d, 2)
        d0, d1 = tpoly._solve2(jac[..., 0, 0], jac[..., 0, 1],
                               jac[..., 1, 0], jac[..., 1, 1], r[..., 0],
                               r[..., 1])
        d = d - torch.stack([d0, d1], -1)
    return d


def test_config5_forward_unchanged():
    """Config 5's differentiable trace: the aperture solve's forward is
    bit for bit the fixed-iteration Newton, with and without a gradient
    recorded and under ``torch.func.jvp``; its backward still reaches the
    coefficients."""
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    s5, ap, _ = _aperture_inputs(lens, n=4096, seed=11)
    s5, ap = s5.float(), ap.float()
    want = _newton_reference(lens.ap, lens.ap.coeffs, s5, ap,
                             lens.aperture_z, 3)
    got = tpoly.pt_sample_aperture(lens, s5, ap, iterations=3)[..., 2:4]
    assert torch.equal(got, want)
    c = lens.ap.coeffs.clone().requires_grad_(True)
    d = tpoly._ApertureSolve.apply(s5, ap, c, lens.ap, lens.aperture_z, 3)
    assert torch.equal(d.detach(), want)
    d.sum().backward()
    assert torch.isfinite(c.grad).all() and float(c.grad.abs().sum()) > 0
    primal, _ = torch.func.jvp(
        lambda s: tpoly._ApertureSolve.apply(s, ap, lens.ap.coeffs, lens.ap,
                                             lens.aperture_z, 3),
        (s5,), (torch.ones_like(s5),))
    assert torch.equal(primal, want)
