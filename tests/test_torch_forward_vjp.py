"""K1v, the VJP of the PO forward trace (K1), against the JAX package on
the CPU: ``po_forward_vjp_plain`` against ``jax.vjp`` of JAX's pure path,
the folded cotangents K1v sums mapped back onto the fit's terms
(``unfold_forward_grads``), ``ForwardFn`` (K1 with its VJP) against
autograd through the port's torch trace, float64 central differences, and
the differentiable frame's checkpointed trace chunks through ``ForwardFn``.

Inputs: 4,096 seeded candidates (sensor points within 14 mm, aperture
points within 0.6 of the housing radius, cotangents standard normal) of
the flagship fit and of a sphere-chart catalog fit, at 0.55 um and a
2 mm sensor shift.  Tolerances (measured values in the tests' docstrings):
* the plain VJP against ``jax.vjp`` at JAX's own solution: 1e-4 relative
  L2 for the ``pt`` and ``ap`` coefficients and the four ray inputs;
* the float64 folded sums unfolded against the float64 plain VJP: 1e-6;
* ``ForwardFn`` (on the CPU the term trace forward, the plain VJP), and
  the plain VJP at K1's rounding (the card's ``PLAIN`` route), against
  autograd through ``_po_forward_terms``: 1e-4;
* float64 central differences of six coefficients: 1e-6 relative;
* ``trace_chunks`` 4 against 1: the same image, gradients to 1e-6.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import pota_tpu_torch as pt
from pota_tpu_torch import ops
from pota_tpu_torch.ops import po_kernels as pk
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import setup_po_camera
from pota_tpu_torch.optics.polynomial import _solve2
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render.renderer import look_at, render_frame

torch.set_num_threads(2)

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
CATALOG = "cooke__speed_panchro__1920__50mm"   # sphere charts, folds
LENSES = [FLAGSHIP, CATALOG]
M = 4096
LAM, SHIFT = 0.55, 2.0


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(lens, seed=0):
    """Seeded rays (x, y, ax, ay) and cotangents (g_out4, g_trans, g_dx,
    g_dy), float32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    r = lens.aperture_housing_radius * 0.6
    rays = [f(rng.uniform(-14, 14, M)), f(rng.uniform(-14, 14, M)),
            f(rng.uniform(-r, r, M)), f(rng.uniform(-r, r, M))]
    cts = [f(rng.standard_normal((M, 4))), *(f(rng.standard_normal(M))
                                             for _ in range(3))]
    return rays, cts


def _t(arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


def _jax_vjp(name, rays, cts):
    """JAX's pure path (``pt_sample_aperture`` then the sensor shift and
    ``pt_evaluate``) and its VJP with respect to (pt, ap, x, y, ax, ay):
    returns (dx, dy, gradients)."""
    import jax
    import jax.numpy as jnp

    from pota_tpu.optics import polynomial as jpoly
    from pota_tpu.optics.fit import load_poly_lens as jload

    jlens = jload(name, degree=5)

    def trace(c_pt, c_ap, x, y, ax, ay):
        lens = dataclasses.replace(
            jlens, pt=dataclasses.replace(jlens.pt, coeffs=c_pt),
            ap=dataclasses.replace(jlens.ap, coeffs=c_ap))
        zero = jnp.zeros_like(x)
        lam = jnp.full_like(x, LAM)
        solved = jpoly.pt_sample_aperture(
            lens, jnp.stack([x, y, zero, zero, lam], -1),
            jnp.stack([ax, ay], -1), iterations=3)
        dx, dy = solved[..., 2], solved[..., 3]
        out4, trans = jpoly.pt_evaluate(lens, jnp.stack(
            [x + dx * SHIFT, y + dy * SHIFT, dx, dy, lam], -1))
        return out4, trans, dx, dy

    (_, _, dx, dy), vjp = jax.vjp(trace, jlens.pt.coeffs, jlens.ap.coeffs,
                                  *map(jnp.asarray, rays))
    grads = vjp(tuple(jnp.asarray(c) for c in cts))
    return np.asarray(dx), np.asarray(dy), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", LENSES)
def test_plain_vjp_matches_jax(name):
    """``po_forward_vjp_plain`` at JAX's solution and cotangents against
    ``jax.vjp`` of JAX's pure path (its ``custom_root`` rule).  Measured
    (flagship / catalog): pt 4.1e-7 / 4.3e-7, ap 6.7e-7 / 9.0e-7, the rays
    at most 8.2e-7 / 4.8e-6."""
    lens = load_poly_lens(name, device="cpu")
    rays, cts = _inputs(lens)
    dx, dy, want = _jax_vjp(name, rays, cts)
    got = pk.po_forward_vjp_plain(lens, *_t(rays), *_t([dx, dy]),
                                  *_t(cts), LAM, SHIFT, need_inputs=True)
    errs = [rel_l2(g.numpy(), w) for g, w in zip(got, want)]
    print(f"{name}: rel L2 pt {errs[0]:.2e} ap {errs[1]:.2e} rays "
          f"{max(errs[2:]):.2e}")
    assert max(errs) < 1e-4, errs


def folded_vjp_f64(lens, x, y, dx, dy, g_out4, g_trans, g_dx, g_dy):
    """K1v's algorithm (``csrc/po_forward_vjp.cu``) in float64 on K1's
    folded rows: the weights w and -l of each candidate, the 7 x 126
    folded sums, and the rays' cotangents (x, y, ax, ay)."""
    scale, shift, ap, ptr = pk._forward_rows(lens, LAM, "cpu")
    exps = torch.tensor(pk.BASIS)

    def monomials(u):
        """mono [M, 126] and d mono / d u_v, v = 0..3."""
        pw = [torch.stack([v ** e for e in range(6)], -1) for v in u]
        dpw = [torch.stack([e * v ** max(e - 1, 0) for e in range(6)], -1)
               for v in u]
        f = [pw[v][:, exps[:, v]] for v in range(4)]
        df = [dpw[v][:, exps[:, v]] for v in range(4)]
        mono = f[0] * f[1] * f[2] * f[3]
        dmono = [df[v] * torch.prod(torch.stack(
            [f[w] for w in range(4) if w != v]), 0) for v in range(4)]
        return mono, dmono

    cond = lambda v, i: (v - shift[i]) * scale[i]
    u = [cond(x, 0), cond(y, 1), cond(dx, 2), cond(dy, 3)]
    up = [cond(x + dx * SHIFT, 0), cond(y + dy * SHIFT, 1), u[2], u[3]]
    mono_p, dmono_p = monomials(up)
    raw = mono_p @ ptr[4]
    w = torch.stack([*g_out4.unbind(1), torch.where(raw > 0, g_trans, 0.0)],
                    1)
    q = w @ ptr
    gu = [(q * dmono_p[v]).sum(1) * scale[v] for v in range(4)]
    hx = gu[0] * SHIFT + gu[2] + g_dx
    hy = gu[1] * SHIFT + gu[3] + g_dy
    mono, dmono = monomials(u)
    J = [[(dmono[v] @ ap[i]) * scale[v] for v in range(4)] for i in range(2)]
    l0, l1 = _solve2(J[0][2], J[1][2], J[0][3], J[1][3], hx, hy)
    G_pt = w.T @ mono_p
    G_ap = -(torch.stack([l0, l1], 1).T @ mono)
    rays = (gu[0] - (l0 * J[0][0] + l1 * J[1][0]),
            gu[1] - (l0 * J[0][1] + l1 * J[1][1]), l0, l1)
    return G_ap, G_pt, rays


@pytest.mark.parametrize("name", LENSES)
def test_unfolded_folded_sums_match_plain(name):
    """The folded cotangents K1v sums, formed in float64 by its algorithm
    (:func:`folded_vjp_f64`) and mapped onto the fit's terms by
    ``unfold_forward_grads``, against the float64 plain VJP on the fit's
    own terms at the same float64 solution, 1e-6 relative L2; the rays'
    cotangents too.  Measured (flagship / catalog): at most 2.2e-15 /
    1.2e-14."""
    lens = load_poly_lens(name, device="cpu")
    rays, cts = _inputs(lens, seed=1)
    x, y, ax, ay = _t(rays, torch.float64)
    with torch.no_grad():
        _, _, dx, dy = pk._po_forward_terms(
            copy.deepcopy(lens).double(), x, y, ax, ay, LAM, SHIFT, 10)
    c64 = _t(cts, torch.float64)
    G_ap, G_pt, g_rays = folded_vjp_f64(lens, x, y, dx, dy, *c64)
    got = (*pk.unfold_forward_grads(lens, G_ap, G_pt, LAM), *g_rays)
    want = pk.po_forward_vjp_plain(lens, x, y, ax, ay, dx, dy, *c64, LAM,
                                   SHIFT, need_inputs=True)
    assert all(w.dtype == torch.float64 for w in want)
    errs = [rel_l2(g.numpy(), w.numpy()) for g, w in zip(got, want)]
    print(f"{name}: unfolded vs plain, max rel L2 {max(errs):.2e}")
    assert max(errs) < 1e-6, errs


@pytest.mark.parametrize("name", LENSES)
@pytest.mark.parametrize("inputs_grad", [False, True],
                         ids=["coeffs", "coeffs+rays"])
def test_forward_fn_matches_torch_trace(name, inputs_grad):
    """``ForwardFn`` on the CPU (the term trace forward, the plain VJP
    backward) and with K1's plain version as its forward (the card's
    ``PLAIN`` route) against autograd through
    the port's torch trace (``_po_forward_terms``: ``_ApertureSolve`` and
    ``pt_evaluate``), the route ``trace_fw_po`` took before, 1e-4 relative
    L2.  Measured: ``ForwardFn`` 0 (the same forward, the same VJP at its
    solution); K1's rounding at most 5.2e-7 (flagship) and 4.4e-6 (the
    catalog fit's rays), its solution ~1e-7 from the term trace's."""
    lens = load_poly_lens(name, device="cpu")
    lens.pt.coeffs.requires_grad_(True)
    lens.ap.coeffs.requires_grad_(True)
    rays, cts = _inputs(lens, seed=2)
    cts = _t(cts)

    def loss(out):
        return sum((c * o).sum() for c, o in zip(cts, out))

    results = {}
    for route in ("fn", "terms"):
        xs = [r.requires_grad_(inputs_grad) for r in _t(rays)]
        if route == "fn":
            out = pk.ForwardFn.apply(*xs, lens.pt.coeffs, lens.ap.coeffs,
                                     lens, LAM, SHIFT, 3, ops.KERNELS)
        else:
            out = pk._po_forward_terms(lens, *xs, LAM, SHIFT, 3)
        wrt = [lens.pt.coeffs, lens.ap.coeffs] + (xs if inputs_grad else [])
        results[route] = torch.autograd.grad(loss(out), wrt)
    with torch.no_grad():
        _, _, dx, dy = pk.po_forward_plain(lens, *_t(rays), LAM, SHIFT, 3)
    results["k1_rounding"] = pk.po_forward_vjp_plain(
        lens, *_t(rays), dx, dy, *cts, LAM, SHIFT, inputs_grad)
    for route in ("fn", "k1_rounding"):
        errs = [rel_l2(g.numpy(), w.numpy())
                for g, w in zip(results[route], results["terms"])]
        print(f"{name} {inputs_grad}: {route} vs torch trace {errs}")
        assert max(errs) < 1e-4, errs


def test_forward_fn_cotangent_subsets():
    """Only the outputs a loss reads carry a cotangent (the frame reads
    ``out4`` alone); the other outputs' cotangents are zero, so each subset
    matches the full VJP with the rest zeroed, and no cotangent gives no
    gradient."""
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    lens.pt.coeffs.requires_grad_(True)
    rays, cts = _inputs(lens, seed=3)
    rays, cts = _t(rays), _t(cts)
    out = pk.ForwardFn.apply(*rays, lens.pt.coeffs, lens.ap.coeffs, lens,
                             LAM, SHIFT, 3, ops.KERNELS)
    got = torch.autograd.grad((out[0] * cts[0]).sum(), lens.pt.coeffs,
                              retain_graph=True)[0]
    want = pk.po_forward_vjp_plain(lens, *rays, out[2], out[3], cts[0],
                                   torch.zeros(M), None, torch.zeros(M), LAM,
                                   SHIFT)[0]
    assert torch.equal(got, want)
    assert got.abs().sum() > 0
    # candidates whose cotangent is zero add nothing (K1v skips them):
    # in float64, the VJP equals the sum over the other candidates alone
    g4 = cts[0].double()
    g4[::3] = 0.0
    r64 = [t.detach().double() for t in (*rays, out[2], out[3])]
    a = pk.po_forward_vjp_plain(lens, *r64, g4, None, None, None, LAM, SHIFT)
    b, c = (pk.po_forward_vjp_plain(
        lens, *(t[k::3] for t in r64), g4[k::3].contiguous(), None, None,
        None, LAM, SHIFT) for k in (1, 2))
    for u, v, w in zip(a, b, c):
        assert rel_l2(u.numpy(), (v + w).numpy()) < 1e-12
    none = pk.po_forward_vjp_plain(lens, *rays, out[2], out[3], None, None,
                                   None, None, LAM, SHIFT, need_inputs=True)
    assert len(none) == 6 and not any(bool(t.any()) for t in none)


def test_po_forward_vjp_refuses_tensors_that_require_grad():
    """As every kernel wrapper: an argument (or the lens's coefficients)
    requiring grad with grad mode on raises; under ``no_grad`` it runs."""
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    rays, cts = _inputs(lens, seed=4)
    args = [*_t(rays), *_t(rays[:2]), *_t(cts)]
    args[6] = args[6].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        pk.po_forward_vjp(lens, *args, LAM, SHIFT)
    with torch.no_grad():
        pk.po_forward_vjp(lens, *args, LAM, SHIFT)
    args[6] = args[6].detach()
    lens.ap.coeffs.requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        pk.po_forward_vjp(lens, *args, LAM, SHIFT)


@pytest.mark.parametrize("name", LENSES)
def test_plain_vjp_matches_central_differences(name):
    """In float64 at a converged solve (10 Newton iterations), the plain
    VJP's cotangent of six coefficients (three of pt, three of ap, the
    largest gradients) against central differences of the loss through
    ``_po_forward_terms`` at 1e-3 of each coefficient, 1e-6 relative.
    Measured at most 6.0e-8 / 1.4e-7 (flagship / catalog; smaller steps
    lose to the loss's rounding: its largest gradients are of coefficients
    ~1e-5)."""
    lens = copy.deepcopy(load_poly_lens(name, device="cpu")).double()
    rays, cts = _inputs(lens, seed=5)
    rays, cts = _t(rays, torch.float64), _t(cts, torch.float64)

    def loss():
        with torch.no_grad():
            out = pk._po_forward_terms(lens, *rays, LAM, SHIFT, 10)
            return float(sum((c * o).sum() for c, o in zip(cts, out)))

    with torch.no_grad():
        _, _, dx, dy = pk._po_forward_terms(lens, *rays, LAM, SHIFT, 10)
    grads = pk.po_forward_vjp_plain(lens, *rays, dx, dy, *cts, LAM, SHIFT)
    errs = []
    for fn, g in zip((lens.pt, lens.ap), grads):
        for idx in torch.topk(g.abs().flatten(), 3).indices.tolist():
            r, t = divmod(idx, g.shape[1])
            c0 = float(fn.coeffs[r, t])
            eps = 1e-3 * abs(c0)
            vals = []
            for sign in (1.0, -1.0):
                with torch.no_grad():
                    fn.coeffs[r, t] = c0 + sign * eps
                vals.append(loss())
            with torch.no_grad():
                fn.coeffs[r, t] = c0
            fd = (vals[0] - vals[1]) / (2.0 * eps)
            errs.append(abs(fd - float(g[r, t])) / abs(float(g[r, t])))
    print(f"{name}: central differences, max rel err {max(errs):.2e}")
    assert max(errs) < 1e-6, errs


class _Counting:
    """The CPU kernel set, counting the calls of K1 and K1v (both modes
    each)."""

    def __init__(self):
        self.calls = {"po_forward": 0, "po_forward_selected": 0,
                      "po_forward_vjp": 0, "po_forward_vjp_selected": 0}
        self.ops = ops.KERNELS._replace(**{
            k: self._count(k, getattr(ops.KERNELS, k)) for k in self.calls})

    def _count(self, name, fn):
        def call(*a):
            self.calls[name] += 1
            return fn(*a)
        return call


def test_trace_chunks_through_select_fn():
    """The differentiable frame's PO trace goes through ``SelectFn`` (K1's
    select mode): with ``trace_chunks`` 4 (checkpointed) K1v's plain
    select mode runs once a chunk and its candidate mode never; the
    forward takes the term trace on the CPU, so the kernel set's K1 is not
    called, in either mode (on the card K1 runs twice a chunk, the forward
    and the backward's recompute: ``chip_smoke.py``).  The image equals
    one chunk's bit for bit and the gradients agree to 1e-6 (the chunks'
    VJPs are summed chunk by chunk; measured: identical at 32x32)."""
    cfg = pt.CameraConfig(
        camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
        fstop=2.8, focus_distance=20.0, vignetting_retries=2,
        splat_queue_mult=4)
    rc = pt.RenderConfig(xres=32, yres=32, spp=1)
    fit = load_poly_lens(FLAGSHIP, device="cpu")
    state = setup_po_camera(fit, cfg)
    scene = sc.teapot_scene(device="cpu")
    m = look_at([0, 0, 0], [0, 0, -1], device="cpu")
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    coeffs = (lens.pt.coeffs.requires_grad_(True),
              lens.ap.coeffs.requires_grad_(True))
    res = {}
    for chunks in (1, 4):
        counting = _Counting()
        for c in coeffs:
            c.grad = None
        img, _ = render_frame(dataclasses.replace(cfg, trace_chunks=chunks),
                              rc, scene, m, po_lens=lens, po_state=state,
                              differentiable=True, ops=counting.ops)
        img[..., :3].mean().backward()
        res[chunks] = (img.detach(), [c.grad.clone() for c in coeffs])
        assert counting.calls == {"po_forward": 0, "po_forward_selected": 0,
                                  "po_forward_vjp": 0,
                                  "po_forward_vjp_selected": chunks}
    assert torch.equal(res[1][0], res[4][0])
    for g, want in zip(res[4][1], res[1][1]):
        assert float(want.norm()) > 0
        assert rel_l2(g.numpy(), want.numpy()) <= 1e-6
