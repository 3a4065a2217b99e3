"""K1's derivatives on the CPU: K1j's plain version (``po_forward_jvp_plain``,
K1's function with its Jacobian in the sensor point) against the JAX
package and central differences, the card's route of the PO ray
differentials (``trace_camera_rays`` and ``trace_fw_po_jvp``, through K1
and K1j) against JAX's, and an emulation of K1v's redesigned reduction (the live-candidate
queue of ``csrc/po_forward_vjp.cu``) against K1v's plain version.

Inputs: 4,096 seeded candidates (sensor points within 14 mm, aperture
points within 0.6 of the housing radius) of the flagship fit and of the
anamorphic catalog fit, at 0.55 um and a 2 mm sensor shift.  Tolerances
(measured values in the tests' docstrings):
* the primal: bit-equal to ``po_forward_plain``;
* the Jacobian against ``jax.jvp`` of JAX's pure path: 1e-4 relative L2;
* against float64 central differences of a converged solve: 1e-4;
* the ray differentials of the card's route against JAX's at 32x32:
  ``test_torch_derivs.py``'s ``JAX_TOL`` (1e-6 absolute);
* the emulated queue order's sums against K1v's float64 plain version:
  1e-4 relative L2.
"""
import copy
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from pota_tpu import CameraConfig, CameraType, RenderConfig
from pota_tpu.render import sampling as jsampling
from pota_tpu.render.renderer import trace_camera_rays_with_derivs as jax_d

from tests.test_torch_slice import jax_stream_to_torch, to_port

from pota_tpu_torch import ops
from pota_tpu_torch.ops import po_kernels as pk
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import setup_po_camera
from pota_tpu_torch.optics.polynomial import _solve2
from pota_tpu_torch.models.po_camera import trace_fw_po_jvp
from pota_tpu_torch.render.renderer import (trace_camera_rays,
                                            trace_camera_rays_with_derivs)

torch.set_num_threads(2)

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
ANAMORPHIC = "unknown__anamorphic__1960__50mm"
LENSES = [FLAGSHIP, ANAMORPHIC]
M = 4096
LAM, SHIFT = 0.55, 2.0
JAC_TOL = 1e-4
JAX_TOL = 1e-6                      # tests/test_torch_derivs.py
VJP_SUMS_TOL = 1e-4
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pota_tpu_torch", "csrc")


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _rays(lens, seed=0, m=M):
    """Seeded (x, y, ax, ay), float32 tensors."""
    rng = np.random.default_rng(seed)
    r = lens.aperture_housing_radius * 0.6
    return [torch.as_tensor(a.astype(np.float32)) for a in (
        rng.uniform(-14, 14, m), rng.uniform(-14, 14, m),
        rng.uniform(-r, r, m), rng.uniform(-r, r, m))]


@pytest.mark.parametrize("name", LENSES)
def test_plain_primal_is_po_forward_plain(name):
    """K1j's primal is K1's: the plain versions agree bit for bit, and the
    Jacobian has its shape and is finite."""
    lens = load_poly_lens(name, device="cpu")
    rays = _rays(lens)
    got = pk.po_forward_jvp_plain(lens, *rays, LAM, SHIFT, 3)
    want = pk.po_forward_plain(lens, *rays, LAM, SHIFT, 3)
    assert len(got) == 5
    for g, w in zip(got[:4], want):
        assert torch.equal(g, w)
    assert got[4].shape == (M, 4, 2) and got[4].dtype == torch.float32
    assert bool(torch.isfinite(got[4]).all())


def _jax_jvp(name, rays):
    """JAX's pure path (``pt_sample_aperture``, the sensor shift,
    ``pt_evaluate``) and ``jax.jvp`` along x and along y: (out4, [J_x,
    J_y]) as numpy."""
    import jax
    import jax.numpy as jnp

    from pota_tpu.optics import polynomial as jpoly
    from pota_tpu.optics.fit import load_poly_lens as jload

    jlens = jload(name, degree=5)
    _, _, ax, ay = (jnp.asarray(r.numpy()) for r in rays)

    def out4(x, y):
        zero = jnp.zeros_like(x)
        lam = jnp.full_like(x, LAM)
        solved = jpoly.pt_sample_aperture(
            jlens, jnp.stack([x, y, zero, zero, lam], -1),
            jnp.stack([ax, ay], -1), iterations=3)
        dx, dy = solved[..., 2], solved[..., 3]
        return jpoly.pt_evaluate(jlens, jnp.stack(
            [x + dx * SHIFT, y + dy * SHIFT, dx, dy, lam], -1))[0]

    x, y = (jnp.asarray(r.numpy()) for r in rays[:2])
    one, zero = jnp.ones_like(x), jnp.zeros_like(x)
    cols = [jax.jvp(out4, (x, y), t)[1] for t in ((one, zero), (zero, one))]
    return np.asarray(out4(x, y)), [np.asarray(c) for c in cols]


@pytest.mark.parametrize("name", LENSES)
def test_plain_jacobian_matches_jax(name):
    """The Jacobian of out4 in (x, y) against ``jax.jvp`` of JAX's pure
    path (its ``custom_root`` tangent), each column, 1e-4 relative L2.
    Measured (flagship / anamorphic): 1.1e-6 / 5.5e-7 (the two float32
    traces round apart; their out4 by 5.8e-7 / 4.2e-7)."""
    lens = load_poly_lens(name, device="cpu")
    rays = _rays(lens, seed=1)
    got = pk.po_forward_jvp_plain(lens, *rays, LAM, SHIFT, 3)
    want_out4, want = _jax_jvp(name, rays)
    errs = [rel_l2(got[4][..., c].numpy(), want[c]) for c in range(2)]
    print(f"{name}: Jacobian against jax.jvp, rel L2 {errs}; out4 "
          f"{rel_l2(got[0].numpy(), want_out4):.2e}")
    assert max(errs) < JAC_TOL, errs


@pytest.mark.parametrize("name", LENSES)
def test_plain_jacobian_matches_central_differences(name):
    """Against float64 central differences (1e-4 mm each way) of K1's
    function on the fit's terms at a converged solve (10 Newton
    iterations: the tangent is the implicit function's at the solution),
    on the rays whose solve converges (the Newton's last update under 1e-9
    in float64), 1e-4 relative L2.  Measured (flagship / anamorphic):
    7.5e-7 / 3.4e-7 on 4,094 rays of 4,096."""
    lens = load_poly_lens(name, device="cpu")
    lens64 = copy.deepcopy(lens).double()
    rays = _rays(lens, seed=2)
    got = pk.po_forward_jvp_plain(lens, *rays, LAM, SHIFT, 3)[4]
    x, y, ax, ay = (r.double() for r in rays)
    h = 1e-4

    def out4(x_, y_, iters=10):
        with torch.no_grad():
            return pk._po_forward_terms(lens64, x_, y_, ax, ay, LAM, SHIFT,
                                        iters)
    conv = ((out4(x, y)[2] - out4(x, y, 9)[2]).abs() < 1e-9)
    conv &= (out4(x, y)[1] > 0)
    assert int(conv.sum()) > M // 4
    fd = [(out4(x + h, y)[0] - out4(x - h, y)[0]) / (2 * h),
          (out4(x, y + h)[0] - out4(x, y - h)[0]) / (2 * h)]
    errs = [rel_l2(got[conv][..., c].numpy(), fd[c][conv].numpy())
            for c in range(2)]
    print(f"{name}: Jacobian against float64 central differences on "
          f"{int(conv.sum())} rays, rel L2 {errs}")
    assert max(errs) < JAC_TOL, errs


def test_po_forward_jvp_wrapper_on_the_cpu():
    """The wrapper takes the plain version for CPU tensors, refuses other
    dtypes and inputs that require grad, and takes an empty batch."""
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    rays = _rays(lens, seed=3, m=64)
    got = pk.po_forward_jvp(lens, *rays, LAM, SHIFT)
    want = pk.po_forward_jvp_plain(lens, *rays, LAM, SHIFT)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(TypeError):
        pk.po_forward_jvp(lens, *(r.double() for r in rays), LAM, SHIFT)
    grad = [rays[0].clone().requires_grad_(True), *rays[1:]]
    with pytest.raises(RuntimeError, match="requires grad"):
        pk.po_forward_jvp(lens, *grad, LAM, SHIFT)
    empty = pk.po_forward_jvp(lens, *(r[:0] for r in rays), LAM, SHIFT)
    assert empty[4].shape == (0, 4, 2)


# --------------------------------- the card's route of the ray differentials
RC = RenderConfig(xres=32, yres=32, spp=1)
CFG_PO = CameraConfig(camera_type=CameraType.POLYNOMIAL_OPTICS,
                      lens_model=FLAGSHIP, fstop=2.8, focus_distance=150.0,
                      vignetting_retries=1)
KEYS = ("dOdx", "dOdy", "dDdx", "dDdy")


@pytest.fixture(scope="module")
def frame():
    """JAX's and the port's samples, lenses and camera state; JAX takes the
    port's state (test_torch_slice.py::test_setup_po_camera_matches holds
    the two setups equal), which spares JAX's focus search."""
    from pota_tpu.optics.fit import load_poly_lens as jload
    from pota_tpu.optics.focus import POState as JaxPOState

    js = jsampling.frame_samples(RC, seed=3)
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    state = setup_po_camera(lens, to_port(CFG_PO))
    return (js, jax_stream_to_torch(js),
            dict(po_lens=jload(FLAGSHIP),
                 po_state=JaxPOState(**dataclasses.asdict(state))),
            dict(po_lens=lens, po_state=state))


class _Counting:
    """``ops.PLAIN``, counting K1's (each mode) and K1j's calls."""

    def __init__(self):
        self.calls = {"po_forward": 0, "po_forward_selected": 0,
                      "po_forward_jvp": 0}
        self.ops = ops.PLAIN._replace(**{
            k: self._count(k, getattr(ops.PLAIN, k)) for k in self.calls})

    def _count(self, name, fn):
        def call(*a):
            self.calls[name] += 1
            return fn(*a)
        return call


def test_card_route_matches_jax(frame):
    """The differentials as the card computes them, on K1's and K1j's plain
    versions (``ops=PLAIN``): ``trace_camera_rays`` for the primary rays
    and :func:`trace_fw_po_jvp` once for both pixel steps, each called
    once; the primal rays are the CPU route's, and the differentials lie
    within ``JAX_TOL`` of JAX's ``jax.jvp`` on live rays, and of the CPU's
    route (the term trace's ``torch.func.jvp``).  Measured: at most 1.9e-7
    against JAX (test_torch_derivs.py: the term trace's route 2.4e-7)."""
    js, ts, jkw, tkw = frame
    _, _, jw, jder = jax_d(CFG_PO, RC, js, **jkw)
    cfg, counting = to_port(CFG_PO), _Counting()
    to, td, tw = trace_camera_rays(cfg, ts, ops=counting.ops, **tkw)
    steps = ((torch.full_like(ts["sx"], 2.0 / RC.xres),
              torch.zeros_like(ts["sx"])),
             (torch.zeros_like(ts["sy"]),
              torch.full_like(ts["sy"], 2.0 / RC.yres)))
    (dOdx, dDdx), (dOdy, dDdy) = trace_fw_po_jvp(
        cfg, tkw["po_lens"], ts["sx"], ts["sy"], ts["r1"], ts["r2"],
        tkw["po_state"], steps, ops=counting.ops)
    card = {"dOdx": dOdx, "dOdy": dOdy, "dDdx": dDdx, "dDdy": dDdy}
    assert counting.calls == {"po_forward": 0, "po_forward_selected": 1,
                              "po_forward_jvp": 1}
    live = tw.numpy() > 0
    np.testing.assert_array_equal(live, np.asarray(jw) > 0)
    assert live.sum() > 0.5 * live.size
    cpu = trace_camera_rays_with_derivs(cfg, to_port(RC), ts, ops=ops.PLAIN,
                                        **tkw)
    assert torch.equal(cpu[0], to) and torch.equal(cpu[1], td)
    errs = {}
    for k in KEYS:
        got = card[k].numpy()
        assert got.shape == (RC.xres * RC.yres, 3)
        assert np.isfinite(got[live]).all(), k
        errs[k] = float(np.abs(got[live] - np.asarray(jder[k])[live]).max())
        np.testing.assert_allclose(got[live], np.asarray(jder[k])[live],
                                   rtol=0, atol=JAX_TOL, err_msg=k)
        np.testing.assert_allclose(got[live], cpu[3][k].numpy()[live],
                                   rtol=0, atol=JAX_TOL, err_msg=k)
    print(f"card route against JAX: {errs}")


def test_route_without_depth_of_field_matches_jax(frame):
    """``enable_dof=False`` has no aperture solve, so no K1j on any device:
    ``trace_camera_rays_with_derivs`` takes ``torch.func.jvp`` over
    ``pt_evaluate`` and lies within ``JAX_TOL`` of JAX's differentials on
    live rays."""
    js, ts, jkw, tkw = frame
    jcfg = dataclasses.replace(CFG_PO, enable_dof=False)
    _, _, jw, jder = jax_d(jcfg, RC, js, **jkw)
    counting = _Counting()
    _, _, tw, got = trace_camera_rays_with_derivs(
        to_port(jcfg), to_port(RC), ts, ops=counting.ops, **tkw)
    assert counting.calls["po_forward_jvp"] == 0
    live = tw.numpy() > 0
    np.testing.assert_array_equal(live, np.asarray(jw) > 0)
    assert live.sum() > 200          # 238 of 1,024: the pinhole vignettes
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy()[live],
                                   np.asarray(jder[k])[live], rtol=0,
                                   atol=JAX_TOL, err_msg=k)


# ----------------------------------------------- K1v's live-candidate queue
def _cuda_constant(name: str) -> int:
    """A ``constexpr int`` of ``csrc/po_forward_vjp.cu``."""
    with open(os.path.join(CSRC, "po_forward_vjp.cu")) as f:
        src = f.read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def k1v_batches(live, blocks: int, threads: int) -> dict:
    """The order in which K1v walks and sums the candidates: per (block,
    warp), its batches of at most 32 live candidates.  A warp queues the
    live candidates of its grid-stride range in stride and lane order,
    each over one of its own slots (entry j at its stride j // 32, lane j %
    32), and takes them 32 at a time, the last batch partial."""
    m = live.shape[0]
    warps = threads // 32
    stride = blocks * threads
    out = {}
    for b in range(blocks):
        for w in range(warps):
            first = (b * warps + w) * 32
            queued = [int(i) for base in range(first, m, stride)
                      for i in range(base, min(base + 32, m)) if live[i]]
            slots = [first + (j // 32) * stride + j % 32
                     for j in range(len(queued))]
            assert all(s < m for s in slots)
            out[(b, w)] = [queued[k:k + 32]
                           for k in range(0, len(queued), 32)]
    return out


def _f32_mul(a, b):
    return (a.float() * b.float()).float()


def k1v_sums(weights, points, blocks: int, threads: int,
             live) -> torch.Tensor:
    """K1v's float64 sums [7, 126] (ap's rows, then pt's) in the kernel's
    order: per warp, each batch's candidates in queue order, each lane's
    monomials (lane, lane + 32, ...) from the staged float32 powers, its
    float32 sums by fused multiply-adds; the block's warps added in warp
    order in float32; the blocks' rows in float64 as
    ``po_forward_vjp_finish`` adds them (of its W = kFinishThreads / 32
    warps, warp v the rows v, v + W, ...; then the W warp sums in order).
    ``weights`` [M, 7] f32:
    pt's five then -l; ``points`` (u', u) f32 [M, 4] each."""
    exps = torch.tensor(pk.BASIS)
    warps = threads // 32
    # the staged powers u^e by running products, as the kernel stages them
    pows = []
    for p in points:
        pw = [torch.ones_like(p)]
        for _ in range(pk.BASIS_DEGREE):
            pw.append(_f32_mul(pw[-1], p))
        pows.append(torch.stack(pw, -1))              # [M, 4, 6]

    def monomials(pw, idx):
        got = pw[idx, 0][:, exps[:, 0]]
        for v in range(1, 4):
            got = _f32_mul(got, pw[idx, v][:, exps[:, v]])
        return got                                     # [len(idx), 126]

    rows = torch.zeros((blocks, 7, len(pk.BASIS)), dtype=torch.float32)
    for (b, w), batches in k1v_batches(live, blocks, threads).items():
        acc = torch.zeros((7, len(pk.BASIS)), dtype=torch.float32)
        for batch in batches:
            idx = torch.tensor(batch)
            mp, ma = monomials(pows[0], idx), monomials(pows[1], idx)
            for t in range(len(batch)):
                wt = weights[idx[t]]
                acc[:2] = pk._fma(wt[5:, None], ma[t][None], acc[:2])
                acc[2:] = pk._fma(wt[:5, None], mp[t][None], acc[2:])
        rows[b] = acc if w == 0 else (rows[b] + acc)
    fin = _cuda_constant("kFinishThreads") // 32
    parts = []
    for v in range(fin):
        part = torch.zeros((7, len(pk.BASIS)), dtype=torch.float64)
        for b in range(v, blocks, fin):
            part = part + rows[b].double()
        parts.append(part)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _vjp_weights(lens, x, y, dx, dy, g_out4):
    """Per candidate, in float64: pt's five weights (out4's cotangent; no
    trans cotangent) and -l from J^T l = h, and the points (u', u)."""
    scale, shift, ap, ptr = pk._forward_rows(lens, LAM, "cpu")
    dm = lambda u: pk._basis_partials(u)
    cond = lambda v, i: (v - shift[i]) * scale[i]
    u = [cond(x, 0), cond(y, 1), cond(dx, 2), cond(dy, 3)]
    up = [cond(x + dx * SHIFT, 0), cond(y + dy * SHIFT, 1), u[2], u[3]]
    w = torch.cat([g_out4, torch.zeros_like(x)[:, None]], 1)
    q = w @ ptr
    gu = [(q * d).sum(1) * scale[v] for v, d in enumerate(dm(up))]
    hx, hy = gu[0] * SHIFT + gu[2], gu[1] * SHIFT + gu[3]
    da = dm(u)
    J = [[(da[v] @ ap[i]) * scale[v] for v in range(4)] for i in range(2)]
    l0, l1 = _solve2(J[0][2], J[1][2], J[0][3], J[1][3], hx, hy)
    return (torch.cat([w, -l0[:, None], -l1[:, None]], 1),
            (torch.stack(up, 1), torch.stack(u, 1)))


@pytest.mark.parametrize("name", LENSES)
@pytest.mark.parametrize("live_share", [0.064, 1.0], ids=["sparse", "dense"])
@pytest.mark.parametrize("blocks", [32, 7])
def test_k1v_queue_order_sums_match_plain(name, live_share, blocks):
    """The emulated queue order's sums (:func:`k1v_sums`, on per-candidate
    float32 weights and points), mapped onto the fit's terms, against
    K1v's float64 plain version, 1e-4 relative L2, with 6.4% of the
    candidates live (config 5's share) and all live, at one block a
    128 candidates and at fewer blocks than that (7: each warp walks
    several strides).  Measured at most 3.1e-7 (dense, 7 blocks; sparse
    1.6e-7)."""
    threads = _cuda_constant("kThreads")
    lens = load_poly_lens(name, device="cpu")
    rng = np.random.default_rng(7)
    x, y, ax, ay = (r.double() for r in _rays(lens, seed=4))
    with torch.no_grad():
        _, _, dx, dy = pk._po_forward_terms(
            copy.deepcopy(lens).double(), x, y, ax, ay, LAM, SHIFT, 10)
    g4 = torch.as_tensor(rng.standard_normal((M, 4)))
    live = torch.as_tensor(rng.uniform(size=M) < live_share)
    g4[~live] = 0.0
    weights, points = _vjp_weights(lens, x, y, dx, dy, g4)
    G = k1v_sums(weights.float(), [p.float() for p in points], blocks,
                 threads, live)
    got = pk.unfold_forward_grads(lens, G[:2], G[2:], LAM)
    want = pk.po_forward_vjp_plain(lens, x, y, ax, ay, dx, dy, g4, None,
                                   None, None, LAM, SHIFT)
    errs = [rel_l2(g.numpy(), w.numpy()) for g, w in zip(got, want)]
    print(f"{name} live {live_share} blocks {blocks}: rel L2 {errs}")
    assert max(errs) < VJP_SUMS_TOL, errs


def test_k1v_queue_order_depends_on_count_and_blocks_only():
    """The order is a function of the candidate count, the block count and
    which candidates carry a cotangent: each live candidate is walked once,
    by warp ``(i // 32) % (blocks * warps)``, each warp's batches hold its
    live candidates in increasing order, 32 a batch but the last; the
    values of the cotangents do not enter.  A warp's queue fits in its own
    slots of the [M] queue."""
    threads = _cuda_constant("kThreads")
    warps = threads // 32
    rng = np.random.default_rng(9)
    for m, blocks, share in ((M, 32, 0.064), (M, 7, 0.5), (1000, 3, 1.0),
                             (77, 5, 0.3)):
        live = rng.uniform(size=m) < share
        order = k1v_batches(live, blocks, threads)
        assert order == k1v_batches(live.copy(), blocks, threads)
        seen = []
        for (b, w), batches in order.items():
            flat = [i for batch in batches for i in batch]
            assert flat == sorted(flat)
            assert all(len(bt) == 32 for bt in batches[:-1])
            assert all((i // 32) % (blocks * warps) == b * warps + w
                       for i in flat)
            seen += flat
        assert sorted(seen) == list(np.flatnonzero(live))
