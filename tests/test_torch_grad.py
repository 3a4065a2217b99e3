"""The port's differentiable mode (BASELINE config 5's step) against the
JAX package on the CPU: the implicit-function aperture solve, the VJPs of
K2 (``ExpandFn``) and K4 (``AccumFn``), the whole step's lens-coefficient
gradients, the checkpointed trace chunks, the differentiable image, the
refold after an in-place coefficient update, and the kernel wrappers'
refusal of tensors that require grad.

The whole step runs at 48x48 @ 1 spp on the teapot scene with the flagship
lens, ``splat_queue_mult=4`` and 3 candidates a ray, on the mono (K3) and
chromatic (K3b ``po_splat_lam``) routes.  JAX's side is its pure route
(``render_frame(..., use_pallas=False)``), which JAX's own
``test_expanded_splat.py::test_differentiable_mode_matches_pure_grad``
ties to its ``differentiable=True`` route at rtol 2e-3; it runs once per
route in a module fixture.

Tolerances (measured values in brackets):
* the aperture solve's gradient: against ``jax.grad`` through JAX's
  ``pt_sample_aperture`` 1e-4 relative L2 [3.6e-7 for ``ap.coeffs``, 2.4e-7
  for the target], against a float64 autograd through the unrolled,
  converged Newton loop 1e-10 [at most 5.6e-16];
* the VJPs of K2 and K4: 1e-6 of scale [exact: the same float32 sums, or
  gathers];
* the whole step at JAX's own forward values (the port's graph, its
  forward values replaced by JAX's stream; see
  :func:`test_step_gradient_at_jax_forward_values`): on the mean loss 1e-3
  relative L2 [mono and chromatic: 8.5e-5 and 8.3e-5 for ``pt.coeffs``,
  1.4e-4 for ``ap.coeffs``]; on the L2 loss 5e-3 [pt 8.3e-4 and 6.6e-5, ap
  1.02e-3 and 1.8e-4: its residual image is ~1e-3 of the frame, so the
  float32 rounding of the two accumulators' sums weighs more], the loss
  itself 1e-5 [1e-7];
* the whole step end to end: 3e-2 relative L2 on ``pt.coeffs`` of the
  mean loss [1.70e-2 mono, 1.67e-2 chromatic], 5e-2 on ``ap.coeffs``
  [2.18e-2, 2.20e-2].  The two packages' float32 forward streams differ by
  up to 5.6e-3 on P at grazing hits (ROADMAP Queue 3, self-occlusion at
  silhouettes), which moves the splat decisions of a few sources; a few
  grazing hits, whose hit-point derivative grows as 1/sqrt(disc), carry
  much of the gradient, so those few moves shift it by ~1.7%.  At
  identical forward values the two agree to 1e-4 (above); with the pixels
  of the one source (of 2,304) whose splats differ taken out of the loss,
  to 1e-3 [3.5e-5 pt, 5.4e-5 ap on both routes;
  :func:`test_step_gradient_gap_is_the_sources_whose_splats_differ`];
* the differentiable image against JAX's: <= 2% of pixels off by 2e-3 of
  scale, as ``test_torch_slice.py`` [0.22%, 0.26%];
* ``trace_chunks=4`` against one chunk: the image identical, gradients
  1e-6 relative [1.1e-8 and 1.6e-8: the VJPs summed chunk by chunk].
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import pota_tpu_torch as pt
from pota_tpu_torch.ops import PLAIN, po_kernels as pk
from pota_tpu_torch.ops import splat_accum as tacc
from pota_tpu_torch.optics import polynomial as tpoly
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import setup_po_camera
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render import splat as tsplat
from pota_tpu_torch.render.renderer import (
    look_at,
    render_frame,
    render_sample_stream,
)
from pota_tpu_torch.render.splat import (
    resolve_imager,
    splat_frame,
    splat_queue_compact,
)
from test_torch_slice import frac_pixels_off, to_port

torch.set_num_threads(2)

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
RES = 48
STREAM_KEYS = ("rgba", "z", "P", "raydir")


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_cfg(chroma: bool, **kw):
    from pota_tpu import CameraConfig, CameraType

    return CameraConfig(
        camera_type=CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
        fstop=2.8, focus_distance=20.0, vignetting_retries=2,
        splat_queue_mult=4, abb_chromatic=0.6 if chroma else 0.0, **kw)


def _perturbed(c, seed):
    """``c`` moved by a seeded 1e-3 relative amount (float32)."""
    rng = np.random.default_rng(seed)
    c = np.asarray(c, np.float32)
    return (c * (1.0 + 1e-3 * rng.standard_normal(c.shape))).astype(
        np.float32)


# ------------------------------------------------------------ JAX's step


@pytest.fixture(scope="module", params=[False, True], ids=["mono", "chroma"])
def jax_step(request):
    """JAX's step on one route.  End to end: the image at the fit's
    coefficients (c0) and the mean loss's gradients with respect to (pt,
    ap).  In two pieces (the forward stream's VJP, then the splat's), so
    that the forward stream is known: the mean loss's gradients at c0, and
    the L2 loss's against the c0 image at coefficients moved by a seeded
    1e-3 relative amount (c1), with the streams at c0 and c1."""
    import jax
    import jax.numpy as jnp

    from pota_tpu import RenderConfig
    from pota_tpu.optics.fit import load_poly_lens as jload
    from pota_tpu.optics.focus import setup_po_camera as jsetup
    from pota_tpu.render import scene as jsc
    from pota_tpu.render import splat as jsplat
    from pota_tpu.render.renderer import (
        look_at as jlook,
        render_frame as jrender,
        render_sample_stream as jstream,
    )

    chroma = request.param
    jcfg = _jax_cfg(chroma)
    jlens = jload(FLAGSHIP, degree=5)
    jstate = jsetup(jlens, jcfg)
    jrc = RenderConfig(xres=RES, yres=RES, spp=1)
    jscene = jsc.teapot_scene()
    m = jlook([0, 0, 0], [0, 0, -1])

    def lens_of(c, ca):
        return dataclasses.replace(
            jlens, pt=dataclasses.replace(jlens.pt, coeffs=c),
            ap=dataclasses.replace(jlens.ap, coeffs=ca))

    def render_img(c, ca):
        img, _ = jrender(jcfg, jrc, jscene, m, seed=0,
                         po_lens=lens_of(c, ca), po_state=jstate,
                         use_pallas=False)
        return img

    c0 = (np.asarray(jlens.pt.coeffs), np.asarray(jlens.ap.coeffs))
    c1 = (_perturbed(c0[0], 1), _perturbed(c0[1], 2))
    img0, vjp0 = jax.vjp(render_img, *map(jnp.asarray, c0))
    n_rgb = img0.shape[0] * img0.shape[1] * 3
    mean_ct = jnp.zeros_like(img0).at[..., :3].set(1.0 / n_rgb)
    g_mean = [np.asarray(g) for g in vjp0(mean_ct)]

    @jax.jit
    def stream_fn(c, ca):
        s = jstream(jcfg, jrc, jscene, m, 0, po_lens=lens_of(c, ca),
                    po_state=jstate, use_pallas=False)
        return tuple(s[k] for k in STREAM_KEYS), s

    vals0, vjp_s0, base = jax.vjp(stream_fn, *map(jnp.asarray, c0),
                                  has_aux=True)
    vals1, vjp_s1, _ = jax.vjp(stream_fn, *map(jnp.asarray, c1),
                               has_aux=True)

    @jax.jit
    def splat_img(vals, c, ca):
        # the splat geometry reads the same coefficients, without gradient
        s = dict(base)
        s.update(zip(STREAM_KEYS, vals))
        fb = jsplat.splat_frame(jcfg, jrc, jscene, s, m,
                                po_lens=lens_of(c, ca), po_state=jstate,
                                use_pallas=False)
        return jsplat.resolve_imager(jrc, fb)

    def splat_vjp(vals, c):
        return jax.vjp(lambda v: splat_img(v, *map(jnp.asarray, c)), vals)

    _, vjp_p0 = splat_vjp(vals0, c0)
    g_pieces = [np.asarray(g) for g in vjp_s0(*vjp_p0(mean_ct))]
    img1, vjp_p1 = splat_vjp(vals1, c1)
    l2_ct = 2.0 * (img1 - img0) / img0.size
    g_l2 = [np.asarray(g) for g in vjp_s1(*vjp_p1(l2_ct))]
    return dict(cfg=jcfg, rc=jrc, c0=c0, c1=c1, img0=np.asarray(img0),
                vjp0=vjp0, mean_ct=np.asarray(mean_ct), g_mean=g_mean,
                g_pieces=g_pieces, g_l2=g_l2,
                l2=float(jnp.mean((img1 - img0) ** 2)),
                vals0=[np.asarray(v) for v in vals0],
                vals1=[np.asarray(v) for v in vals1])


def _port_lens(coeffs, device="cpu"):
    """The flagship fit with the coefficients ``coeffs`` (pt, ap), which
    require grad."""
    lens = load_poly_lens(FLAGSHIP, device=device)
    with torch.no_grad():
        lens.pt.coeffs.copy_(torch.as_tensor(coeffs[0]))
        lens.ap.coeffs.copy_(torch.as_tensor(coeffs[1]))
    lens.pt.coeffs.requires_grad_(True)
    lens.ap.coeffs.requires_grad_(True)
    return lens


def _port_step(js, coeffs, target=None, trace_chunks=1, stream_vals=None,
               pixel_mask=None):
    """The port's step on ``js``'s route with lens coefficients ``coeffs``:
    the mean loss (or, with ``target``, the L2 loss against it) and its
    gradients with respect to (pt, ap).  ``stream_vals`` replaces the
    forward stream's values by JAX's (the port's graph kept);
    ``pixel_mask`` [H, W] zeroes pixels out of the mean loss.  Returns
    (image, loss, (d pt, d ap))."""
    cfg = dataclasses.replace(to_port(js["cfg"]), trace_chunks=trace_chunks)
    rc = to_port(js["rc"])
    # the camera is set up from the fit's own coefficients, as JAX's is
    state = setup_po_camera(load_poly_lens(FLAGSHIP, device="cpu"), cfg)
    lens = _port_lens(coeffs)
    scene = sc.teapot_scene(device="cpu")
    m = look_at([0, 0, 0], [0, 0, -1], device="cpu")
    if stream_vals is None:
        img, _ = render_frame(cfg, rc, scene, m, seed=0, po_lens=lens,
                              po_state=state, differentiable=True)
    else:
        stream = render_sample_stream(cfg, rc, scene, m, 0, po_lens=lens,
                                      po_state=state, differentiable=True)
        for k, v in zip(STREAM_KEYS, stream_vals):
            stream[k] = stream[k] + (torch.as_tensor(v) - stream[k]).detach()
        fb = splat_frame(cfg, rc, scene, stream, m, po_lens=lens,
                         po_state=state, differentiable=True)
        img = resolve_imager(rc, fb)
    if pixel_mask is not None:
        loss = (img[..., :3] * torch.as_tensor(pixel_mask)[..., None]).sum() \
            / img[..., :3].numel()
    elif target is None:
        loss = img[..., :3].mean()
    else:
        loss = ((img - torch.as_tensor(target)) ** 2).mean()
    loss.backward()
    return (img.detach().numpy(), float(loss.detach()),
            (lens.pt.coeffs.grad.numpy(), lens.ap.coeffs.grad.numpy()))


@pytest.fixture(scope="module")
def port_step(jax_step):
    return _port_step(jax_step, jax_step["c0"])


# ------------------------------------------- (a) the aperture solve's IFT


def _aperture_inputs(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-15.0, 15.0, n)
    y = rng.uniform(-10.0, 10.0, n)
    sensor5 = np.stack([x, y, np.zeros(n), np.zeros(n), np.full(n, 0.55)],
                       -1).astype(np.float32)
    target = rng.uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    w = rng.standard_normal((n, 2)).astype(np.float32)
    return sensor5, target, w


def test_aperture_solve_gradient_matches_jax():
    """``pt_sample_aperture``'s implicit-function gradient with respect to
    ``ap.coeffs`` and the aperture target against ``jax.grad`` through
    JAX's ``lax.custom_root`` solve, on the flagship fit."""
    import jax
    import jax.numpy as jnp

    from pota_tpu.optics import polynomial as jpoly
    from pota_tpu.optics.fit import load_poly_lens as jload

    sensor5, target, w = _aperture_inputs()
    jlens = jload(FLAGSHIP, degree=5)

    def jloss(c, t):
        lens = dataclasses.replace(jlens,
                                   ap=dataclasses.replace(jlens.ap, coeffs=c))
        out = jpoly.pt_sample_aperture(lens, jnp.asarray(sensor5), t)
        return jnp.sum(out[..., 2:4] * w)

    jg_c, jg_t = jax.grad(jloss, argnums=(0, 1))(jlens.ap.coeffs,
                                                  jnp.asarray(target))
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    lens.ap.coeffs.requires_grad_(True)
    t = torch.as_tensor(target).requires_grad_(True)
    out = tpoly.pt_sample_aperture(lens, torch.as_tensor(sensor5), t)
    g_c, g_t = torch.autograd.grad((out[..., 2:4] * torch.as_tensor(w)).sum(),
                                   [lens.ap.coeffs, t])
    assert rel_l2(g_c.numpy(), jg_c) < 1e-4
    assert rel_l2(g_t.numpy(), jg_t) < 1e-4


def test_aperture_solve_gradient_matches_unrolled_newton():
    """In float64, the implicit-function gradient (at a converged solve)
    against autograd through the unrolled Newton iterations, for the
    coefficients, the target and the sensor position; the forward values
    are those of the unrolled loop bit for bit."""
    sensor5, target, w = _aperture_inputs(n=1000, seed=1)
    lens = copy.deepcopy(load_poly_lens(FLAGSHIP, device="cpu")).double()
    coeffs = lens.ap.coeffs.requires_grad_(True)
    s5 = torch.as_tensor(sensor5, dtype=torch.float64).requires_grad_(True)
    t = torch.as_tensor(target, dtype=torch.float64).requires_grad_(True)
    wt = torch.as_tensor(w, dtype=torch.float64)
    iters = 10

    out = tpoly.pt_sample_aperture(lens, s5, t, iterations=iters)
    got = torch.autograd.grad((out[..., 2:4] * wt).sum(), [coeffs, t, s5])

    x, y, lam = s5[..., 0], s5[..., 1], s5[..., 4]
    d = torch.stack([(t[..., 0] - x) / lens.aperture_z,
                     (t[..., 1] - y) / lens.aperture_z], -1)
    residual = tpoly._ap_residual(lens.ap, coeffs, s5, t)
    for _ in range(iters):
        r, jac = tpoly._batched_jacobian(residual, d, 2)
        d0, d1 = tpoly._solve2(jac[..., 0, 0], jac[..., 0, 1],
                               jac[..., 1, 0], jac[..., 1, 1], r[..., 0],
                               r[..., 1])
        d = d - torch.stack([d0, d1], -1)
    assert torch.equal(out[..., 2:4], d.detach())
    want = torch.autograd.grad((d * wt).sum(), [coeffs, t, s5])
    for g, r in zip(got, want):
        assert rel_l2(g.numpy(), r.numpy()) < 1e-10
    # the sensor's direction columns are outputs only
    assert float(got[2][..., 2:4].abs().max()) == 0.0


# ------------------------------------------------------ (b) K2's transpose


def _queue(case: str, seed: int = 3):
    """A seeded splat queue.  ``cut``: budgets that overflow a 60-slot
    queue, so the >= 1-unit clamp cuts the last sources at the queue end;
    ``short``: a queue longer than its sources' slots, whose tail slots
    read the last source; ``dead``: as ``short``, with its live end at
    ~10% of the queue (a four-card rank's band, which asks for 8.5% of its
    queue).  ``bounds`` int32 [2, n_src] are the compact sources' slot
    ranges cut at the queue end, as ``splat_frame`` hands them to
    ``ExpandFn``."""
    rng = np.random.default_rng(seed)
    n = 50
    budget = np.where(rng.uniform(size=n) < 0.5, 4, 400).astype(np.int32)
    redistribute = rng.uniform(size=n) < 0.9
    if case in ("short", "dead"):
        budget = rng.integers(4, 9, n).astype(np.int32)
    s_cap = {"cut": 60, "short": 600, "dead": 3000}[case]
    src, slot_on, slots = splat_queue_compact(
        torch.as_tensor(budget), torch.as_tensor(redistribute), s_cap)
    n_src = int((slots > 0).sum())
    offs = torch.cumsum(slots[slots > 0], 0)
    bounds = torch.stack([offs - slots[slots > 0], offs]).clamp(
        max=s_cap).to(torch.int32)
    table_f = torch.as_tensor(rng.standard_normal((12, n_src)),
                              dtype=torch.float32)
    table_i = torch.as_tensor(rng.integers(0, 100, (4, n_src)),
                              dtype=torch.int32)
    d_ex = torch.as_tensor(rng.standard_normal((12, s_cap)),
                           dtype=torch.float32)
    return src.to(torch.int32), slot_on, slots, bounds, table_f, table_i, d_ex


@pytest.mark.parametrize("case", ["cut", "short", "dead"])
def test_expand_fn_backward(case):
    """``ExpandFn``'s gradient of ``table_f`` against autograd of the plain
    expand (a gather) with the slots past the queue end masked out, and
    against a float64 per-source sum over each source's slot range
    [start, end) cut at the queue end, as JAX's transpose sums it."""
    src, slot_on, slots, bounds, table_f, table_i, d_ex = _queue(case)
    s_cap = src.shape[0]
    offs = torch.cumsum(slots[slots > 0], 0)
    if case == "cut":
        assert int(offs[-1]) > s_cap and bool(slot_on.all())
    else:
        assert int(offs[-1]) < s_cap and not bool(slot_on.all())
    if case == "dead":
        assert 0.05 < float(slot_on.double().mean()) < 0.15
    tf = table_f.clone().requires_grad_(True)
    ex_f, ex_i = pk.ExpandFn.apply(tf, src, table_i, bounds, pk.expand)
    want_f, want_i = pk.expand_plain(src, table_f, table_i)
    assert torch.equal(ex_f.detach(), want_f) and torch.equal(ex_i, want_i)
    (got,) = torch.autograd.grad(ex_f, tf, d_ex)

    tf2 = table_f.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(pk.expand_plain(src, tf2, table_i)[0], tf2,
                                  d_ex * slot_on)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale

    starts = (offs - slots[slots > 0]).tolist()
    oracle = np.zeros(tuple(table_f.shape))
    d64 = d_ex.double().numpy()
    for c, (a, b) in enumerate(zip(starts, offs.tolist())):
        oracle[:, c] = d64[:, min(a, s_cap):min(b, s_cap)].sum(1)
    assert float(np.abs(got.double().numpy() - oracle).max()) <= 1e-6 * scale


def test_expand_fn_backward_sums_only_the_rows_named():
    """With ``rows`` (the source table's rows whose values carry a
    gradient), ``ExpandFn`` sums those rows as it sums every row without,
    and gives the others 0."""
    src, _, _, bounds, table_f, table_i, d_ex = _queue("short")
    rows = (7, 8, 9, 10)
    grads = []
    for r in (None, rows):
        tf = table_f.clone().requires_grad_(True)
        ex_f, _ = pk.ExpandFn.apply(tf, src, table_i, bounds, pk.expand, r)
        grads.append(torch.autograd.grad(ex_f, tf, d_ex)[0])
    assert torch.equal(grads[1][list(rows)], grads[0][list(rows)])
    others = [k for k in range(12) if k not in rows]
    assert grads[0][others].any() and not grads[1][others].any()


@pytest.mark.parametrize("case", ["cut", "dead"])
def test_expand_fn_backward_same_bits_twice(case):
    """Two backwards of one ``ExpandFn`` give the same bits: no atomics,
    and the range sums' scans add in a fixed order."""
    src, _, _, bounds, table_f, table_i, d_ex = _queue(case)
    tf = table_f.clone().requires_grad_(True)
    ex_f, _ = pk.ExpandFn.apply(tf, src, table_i, bounds, pk.expand)
    first = torch.autograd.grad(ex_f, tf, d_ex, retain_graph=True)[0]
    assert torch.equal(first, torch.autograd.grad(ex_f, tf, d_ex)[0])


@pytest.mark.parametrize("s", [5, 1024, 1025, 3 * 1024 * 1024 + 7])
def test_range_sums_against_float64(s):
    """``range_sums`` over queues shorter than one scan row, of one row,
    and of three levels of rows (1024^2 slots and more): each range's
    float64 sum rounded once, empty ranges 0, the slots outside every
    range never read (NaN there)."""
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s)).astype(np.float32)
    x[:, s - s // 5:] = np.nan
    live = s - s // 5
    cuts = np.sort(rng.integers(0, live + 1, 400))
    lo, hi = cuts[:-1].copy(), cuts[1:].copy()
    # long ranges too, across many scan rows
    lo[::7] = np.minimum(lo[::7], rng.integers(0, live + 1, lo[::7].size))
    hi[3::11] = lo[3::11]
    bounds = torch.as_tensor(np.stack([lo, hi]), dtype=torch.int32)
    got = pk.range_sums(torch.as_tensor(x), bounds)
    c = np.concatenate([np.zeros((2, 1)), np.cumsum(
        x[:, :live].astype(np.float64), 1)], 1)
    want = (c[:, hi] - c[:, lo]).astype(np.float32)
    scale = float(np.abs(x[:, :live]).sum(1).max()) * 1e-15
    assert np.all(np.abs(got.double().numpy() - want) <= np.abs(want) * 2**-23
                  + scale)
    assert (lo == hi).any() and not got[:, lo == hi].any()


def test_source_table_gradient_is_the_indexing_gradient():
    """``_source_table``'s float rows carry the same gradient as autograd
    of ``cols_f[:, order]`` (the stable reorder on a has-slots mask with
    ties): its backward gathers by the inverse permutation."""
    rng = np.random.default_rng(12)
    n = 5000
    has = torch.as_tensor(rng.uniform(size=n) < 0.6)
    leaves = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
              for shape in ((n, 3), (n, 3), (n, 4), (n,))]
    sky = torch.as_tensor(rng.uniform(size=n) < 0.1)
    stream = {"px": torch.as_tensor(rng.integers(0, 64, n)),
              "py": torch.as_tensor(rng.integers(0, 64, n))}
    starts = torch.as_tensor(rng.integers(0, 4 * n, n))
    ct = torch.as_tensor(rng.standard_normal((12, n)), dtype=torch.float32)

    got = [t.clone().requires_grad_(True) for t in leaves]
    table_f, _, rows = tsplat._source_table(
        stream, got[0], got[1], sky, got[2], got[3], starts, has)
    assert rows == tuple(range(12)[:6]) + tuple(range(7, 12))
    table_f.backward(ct)

    want = [t.clone().requires_grad_(True) for t in leaves]
    p_cam, p_ws, vals, depth = want
    cols_f = torch.stack([
        p_cam[:, 0], p_cam[:, 1], p_cam[:, 2], p_ws[:, 0], p_ws[:, 1],
        p_ws[:, 2], sky.to(torch.float32), vals[:, 0], vals[:, 1],
        vals[:, 2], vals[:, 3], depth], 0)
    order = torch.argsort((~has).to(torch.int8), stable=True)
    assert torch.equal(table_f.detach(), cols_f[:, order].detach())
    cols_f[:, order].backward(ct)
    for g, w in zip(got, want):
        assert torch.equal(g.grad, w.grad)


# ------------------------------------------------------ (c) K4's transpose


def _writer_stream(seed=5, w=3000, npix=400, k=5):
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, npix, w)
    pix[rng.uniform(size=w) < 0.25] = npix
    depth = np.round(rng.uniform(1.0, 60.0, w)).astype(np.float32)
    payload = rng.standard_normal((w, k)).astype(np.float32)
    sid = rng.integers(0, 1 << 20, w).astype(np.int32)
    d_accum = rng.standard_normal((npix, k)).astype(np.float32)
    return pix, depth, payload, sid, npix, d_accum


def test_accum_fn_backward_matches_autograd_of_plain():
    """``AccumFn``'s payload gradient against autograd through the sort and
    ``segment_accum_plain``; forward identical to ``accumulate_sorted``."""
    pix, depth, payload, sid, npix, d_accum = _writer_stream()
    pix_t, depth_t = torch.as_tensor(pix), torch.as_tensor(depth)
    p = torch.as_tensor(payload).requires_grad_(True)
    out = tacc.AccumFn.apply(p, pix_t, depth_t, torch.as_tensor(sid), npix,
                             tacc.segment_accum)
    ref = tacc.accumulate_sorted(pix_t, depth_t, torch.as_tensor(payload),
                                 torch.as_tensor(sid), npix)
    for a, b in zip(out, ref):
        assert torch.equal(a.detach(), b)
    assert not any(o.requires_grad for o in out[1:])
    (got,) = torch.autograd.grad(out[0], p, torch.as_tensor(d_accum))

    p2 = torch.as_tensor(payload).requires_grad_(True)
    keys, perm = tacc.sort_writers(pix_t, depth_t)
    acc = tacc.segment_accum_plain(keys, perm, p2, torch.as_tensor(sid),
                                   npix)[0]
    (want,) = torch.autograd.grad(acc, p2, torch.as_tensor(d_accum))
    assert torch.equal(got, want)
    assert float(got[pix == npix].abs().max()) == 0.0


def test_accum_fn_backward_matches_jax():
    """The same VJP against JAX's ``_accumulate_sorted_diff`` (the Pallas
    accumulator in interpret mode) on the same writer stream."""
    import jax
    import jax.numpy as jnp

    from pota_tpu.render.splat import _accumulate_sorted_diff

    pix, depth, payload, sid, npix, d_accum = _writer_stream(seed=6)

    def run(*cols):
        return _accumulate_sorted_diff(
            jnp.asarray(pix, jnp.int32), jnp.asarray(depth), list(cols),
            jnp.asarray(sid), npix, interpret=True)[0]

    cols = [jnp.asarray(payload[:, c]) for c in range(payload.shape[1])]
    accum_j, vjp = jax.vjp(run, *cols)
    want = np.stack([np.asarray(g) for g in vjp(jnp.asarray(d_accum))], 1)
    p = torch.as_tensor(payload).requires_grad_(True)
    out = tacc.accumulate_sorted(torch.as_tensor(pix), torch.as_tensor(depth),
                                 p, torch.as_tensor(sid), npix)
    scale = float(np.abs(accum_j).max())
    assert float((out[0].detach() - torch.as_tensor(np.asarray(accum_j)))
                 .abs().max()) <= 1e-5 * scale
    (got,) = torch.autograd.grad(out[0], p, torch.as_tensor(d_accum))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------- (d) the step


def test_step_gradient_matches_jax(jax_step, port_step):
    """The whole step: the port's gradients of the mean loss (pt and ap)
    against JAX's ``jax.grad``; finite and non-zero (limits and their
    cause in the module docstring)."""
    _, loss, (g_pt, g_ap) = port_step
    j_pt, j_ap = jax_step["g_mean"]
    for g in (g_pt, g_ap):
        assert np.isfinite(g).all() and np.linalg.norm(g) > 0
    assert rel_l2(g_pt, j_pt) < 3e-2
    assert rel_l2(g_ap, j_ap) < 5e-2


def test_step_gradient_at_jax_forward_values(jax_step):
    """The whole step's gradient chain held at JAX's own forward stream:
    the port's differentiable stream with its values replaced by JAX's
    (rgba, z, P, raydir; the port's graph kept), then the port's
    differentiable splat, against JAX's gradient taken in the same two
    pieces: the mean loss at the fit's coefficients with respect to (pt,
    ap), and the L2 loss of JAX's ``train_step_sharded`` (one device)
    against JAX's frame at the fit's coefficients, at seeded 1e-3 perturbed
    coefficients.  (End to end, the L2 gradient's cosine with JAX's is
    0.76: the residual image is carried by the splat decisions the two
    forward streams' rounding moves.)"""
    _, _, (g_pt, g_ap) = _port_step(jax_step, jax_step["c0"],
                                    stream_vals=jax_step["vals0"])
    j_pt, j_ap = jax_step["g_pieces"]
    assert rel_l2(g_pt, j_pt) < 1e-3
    assert rel_l2(g_ap, j_ap) < 1e-3
    _, loss, grads = _port_step(jax_step, jax_step["c1"],
                                target=jax_step["img0"],
                                stream_vals=jax_step["vals1"])
    assert abs(loss - jax_step["l2"]) <= 1e-5 * jax_step["l2"]
    for g, want in zip(grads, jax_step["g_l2"]):
        assert np.isfinite(g).all() and np.linalg.norm(g) > 0
        assert rel_l2(g, want) < 5e-3


def _writers_by_sample(js, stream_vals, monkeypatch):
    """The port's step at the fit's coefficients on its own forward stream
    (or JAX's values): each sample's live writers, as (pixels, weights)
    sorted, read from the accumulator's arguments."""
    from pota_tpu_torch.render import splat as tsplat

    seen = {}
    accumulate = tsplat.accumulate_sorted

    def recording(pix, depth, payload, sample, npix, ops=None):
        seen["w"] = (pix, sample, payload[:, 4].detach(), npix)
        return accumulate(pix, depth, payload, sample, npix, ops=ops)

    monkeypatch.setattr(tsplat, "accumulate_sorted", recording)
    _port_step(js, js["c0"], stream_vals=stream_vals)
    monkeypatch.undo()
    pix, sample, w, npix = seen["w"]
    live = pix < npix
    pix, sample, w = (t[live].numpy() for t in (pix, sample, w))
    order = np.lexsort((w, pix, sample))
    pix, sample, w = pix[order], sample[order], w[order]
    cuts = np.flatnonzero(np.diff(sample)) + 1
    return {int(sample[a]): (pix[a:b], w[a:b])
            for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(sample)])}


def test_step_gradient_gap_is_the_sources_whose_splats_differ(jax_step,
                                                              monkeypatch):
    """Queue 3 item 2.  The sources whose splat decisions (writer pixels
    or weights) differ between the port's float32 forward stream and JAX's
    (the port's splat on JAX's stream reproduces JAX's splat) are few; with
    every pixel they write in either package taken out of the mean loss,
    the whole step's gradient agrees with JAX's to 1e-3, as it does at
    JAX's own forward values.  Measured, mono / chromatic: 1 source of
    2,304 on both, 5 / 6 pixels; the gap 1.70e-2 / 1.67e-2 -> 3.5e-5 (pt),
    2.18e-2 / 2.20e-2 -> 5.4e-5 (ap)."""
    own = _writers_by_sample(jax_step, None, monkeypatch)
    theirs = _writers_by_sample(jax_step, jax_step["vals0"], monkeypatch)
    differ = [k for k in set(own) | set(theirs)
              if k not in own or k not in theirs
              or not all(np.array_equal(a, b)
                         for a, b in zip(own[k], theirs[k]))]
    mask = np.ones(RES * RES, np.float32)
    for k in differ:
        for side in (own, theirs):
            if k in side:
                mask[side[k][0]] = 0.0
    mask = mask.reshape(RES, RES)
    print(f"sources whose splats differ: {len(differ)} of {RES * RES}; "
          f"pixels out of the loss: {int((mask == 0).sum())}")
    assert 0 < len(differ) <= 0.01 * RES * RES
    _, _, grads = _port_step(jax_step, jax_step["c0"], pixel_mask=mask)
    ct = jax_step["mean_ct"] * mask[..., None]
    want = [np.asarray(g) for g in jax_step["vjp0"](ct)]
    errs = [rel_l2(g, w) for g, w in zip(grads, want)]
    print(f"gradient rel L2 with those pixels out: pt {errs[0]:.3e} "
          f"ap {errs[1]:.3e}")
    assert max(errs) < 1e-3, errs


# ------------------------------------------------ (e) checkpointed chunks


def test_trace_chunks_give_the_same_gradient(jax_step, port_step):
    """``trace_chunks=4`` (checkpointed, recomputed in the backward) gives
    the one-chunk image and gradients."""
    img, loss, grads = _port_step(jax_step, jax_step["c0"], trace_chunks=4)
    assert np.array_equal(img, port_step[0]) and loss == port_step[1]
    for g, want in zip(grads, port_step[2]):
        assert rel_l2(g, want) <= 1e-6


# ------------------------------------------------------------- (f) image


def test_differentiable_image_matches_jax(jax_step, port_step):
    img = port_step[0]
    assert np.isfinite(img).all()
    assert frac_pixels_off(img, jax_step["img0"]) <= 0.02


# ------------------------------------------------------------- (g) refold


def test_in_place_update_refolds():
    """K3's folded table, built from coefficients that require grad, holds
    no graph; an in-place gradient step bumps the coefficients' version, so
    the next frame folds again, and the table is the fold of the new
    coefficients: K3's solve on it (the float32 emulation of
    ``po_basis_solve``) lands where the new lens's plain solve does, and
    K3's plain version reads the new coefficients."""
    from test_torch_fold import basis_solve_f32

    lens = load_poly_lens(FLAGSHIP, device="cpu")
    lens.pt.coeffs.requires_grad_(True)
    lens.ap.coeffs.requires_grad_(True)
    folds = []
    table0 = pk._folded_table(lens, "solve", (0.55,), "cpu",
                              on_fold=lambda: folds.append(1))
    assert not table0.requires_grad and len(folds) == 1
    assert pk._folded_table(lens, "solve", (0.55,), "cpu",
                            on_fold=lambda: folds.append(1)) is table0
    new = (_perturbed(lens.pt.coeffs.detach(), 7),
           _perturbed(lens.ap.coeffs.detach(), 8))
    with torch.no_grad():
        lens.pt.coeffs.sub_(lens.pt.coeffs - torch.as_tensor(new[0]))
        lens.ap.coeffs.sub_(lens.ap.coeffs - torch.as_tensor(new[1]))
    table1 = pk._folded_table(lens, "solve", (0.55,), "cpu",
                              on_fold=lambda: folds.append(1))
    assert len(folds) == 2 and not table1.requires_grad
    fresh = _port_lens(new)
    assert torch.equal(table1, pk.fold_solve_tables(fresh, 0.55, "cpu"))
    assert not torch.equal(table1, table0)

    rng = np.random.default_rng(9)
    n = 500
    p = torch.as_tensor(np.stack([rng.uniform(-40, 40, n),
                                  rng.uniform(-30, 30, n),
                                  rng.uniform(800, 3000, n)]),
                        dtype=torch.float32)
    a = torch.as_tensor(rng.uniform(-3, 3, (2, n)), dtype=torch.float32)
    with torch.no_grad():
        got = basis_solve_f32(table1, lens, *p, *a)
        want = pk.po_backward_plain(fresh, *p, *a, (0.55,), None)
        old = basis_solve_f32(table0, lens, *p, *a)
    keep = (got[4] > 0) & (want[4] > 0)
    assert int(keep.sum()) > n // 2
    err = (got[0] - want[0]).abs().maximum((got[1] - want[1]).abs())[keep]
    moved = (old[0] - want[0]).abs().maximum((old[1] - want[1]).abs())[keep]
    assert float(err.max()) < 1e-3 < float(moved.max())

    # K3's plain version on the CPU reads the updated coefficients
    params = torch.zeros(pk.SPLAT_PARAM_COUNT)
    params[pk.SP_LAMBDA] = 0.55
    slots = [torch.as_tensor(rng.uniform(-1, 1, 64), dtype=torch.float32)
             for _ in range(6)]
    slots[2] = slots[2] - 100.0
    seed = torch.arange(64, dtype=torch.int32)
    args = (*slots, seed, seed, torch.zeros(64), params,
            torch.zeros((0, 4)), 0.55)
    with torch.no_grad():
        assert all(torch.equal(u, v) for u, v in zip(
            pk.po_splat(lens, *args), pk.po_splat_plain(fresh, *args)))


# ------------------------------------------- (h) wrappers refuse grad


def _wrapper_args(name):
    """Small valid arguments of each kernel wrapper (CPU tensors)."""
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    f = lambda *s: torch.zeros(s)
    i = lambda n: torch.zeros(n, dtype=torch.int32)
    slots6 = [f(4) for _ in range(6)]
    slots6[2] = slots6[2] - 100.0
    params = f(pk.SPLAT_PARAM_COUNT)
    params[pk.SP_LAMBDA] = 0.55
    sph = f(0, 4)
    keys, perm = tacc.sort_writers(torch.full((4,), 3), f(4))
    return {
        "expand": (pk.expand, (i(4), f(12, 3), torch.zeros((4, 3),
                                                           dtype=torch.int32)),
                   1),
        "segment_accum": (tacc.segment_accum, (keys, perm, f(4, 5), i(4), 3),
                          2),
        "po_forward": (pk.po_forward, (lens, f(4), f(4), f(4), f(4), 0.55,
                                       15.0, 3), 1),
        "po_splat": (pk.po_splat, (lens, *slots6, i(4), i(4), f(4), params,
                                   sph, 0.55, 3), 1),
        "po_splat_lam": (pk.po_splat_lam, (lens, *slots6, i(4), i(4),
                                           (0.55,), None, f(4), params, sph,
                                           3), 1),
        "po_splat_ext": (pk.po_splat_ext, (lens, *slots6, f(4), f(4),
                                           (0.55,), None, f(4), params, sph,
                                           3), 1),
        "po_backward": (pk.po_backward, (lens, f(4), f(4), f(4) + 1000.0,
                                         f(4), f(4), (0.55,), None, 3), 1),
        "tl_splat": (pk.tl_splat, (*slots6, i(4), i(4), f(4), params, sph),
                     0),
    }[name]


@pytest.mark.parametrize("name", ["expand", "segment_accum", "po_forward",
                                  "po_splat", "po_splat_lam", "po_splat_ext",
                                  "po_backward", "tl_splat"])
def test_wrappers_refuse_tensors_that_require_grad(name):
    """Each kernel wrapper raises for an argument that requires grad with
    grad mode on (its output would carry no gradient), and for a lens
    whose coefficients do; under ``no_grad`` it runs."""
    fn, args, pos = _wrapper_args(name)
    args = list(args)
    args[pos] = args[pos].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*args)
    with torch.no_grad():
        fn(*args)
    if isinstance(args[0], tpoly.PolyLens):
        args[pos] = args[pos].detach()
        args[0].pt.coeffs.requires_grad_(True)
        with pytest.raises(RuntimeError, match="requires grad"):
            fn(*args)


def test_plain_kernel_set_takes_the_differentiable_route():
    """The differentiable frame runs through the plain kernel set as well
    (the parity check on the card renders it both ways)."""
    cfg = to_port(_jax_cfg(False))
    rc = pt.RenderConfig(xres=16, yres=16, spp=1)
    fit = load_poly_lens(FLAGSHIP, device="cpu")
    lens = _port_lens((fit.pt.coeffs.numpy(), fit.ap.coeffs.numpy()))
    state = setup_po_camera(fit, cfg)
    scene = sc.teapot_scene(device="cpu")
    m = look_at([0, 0, 0], [0, 0, -1], device="cpu")
    grads = []
    for ops in (None, PLAIN):
        lens.pt.coeffs.grad = None
        img, _ = render_frame(cfg, rc, scene, m, po_lens=lens,
                              po_state=state, differentiable=True, ops=ops)
        img[..., :3].mean().backward()
        grads.append(lens.pt.coeffs.grad.clone())
    assert torch.isfinite(grads[0]).all() and float(grads[0].norm()) > 0
    assert rel_l2(grads[1].numpy(), grads[0].numpy()) <= 1e-6
