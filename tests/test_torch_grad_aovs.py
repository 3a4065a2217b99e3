"""A gaussian AOV besides RGBA under ``differentiable=True`` (the K3 route
with a payload wider than RGBA's five columns) against JAX's pure route
on the CPU, which JAX reaches through ``render_sample_stream`` +
``splat_frame(aovs=...)`` + ``resolve_aovs`` (its ``render_frame`` takes no
AOV list): config 5's camera (the flagship fit, fstop 2.8, focus 20, 3
candidates a ray, ``splat_queue_mult`` 4) on the teapot, 32x32 @ 1 spp,
``DEFAULT_AOVS`` + ``AOVSpec("P_gauss", "VECTOR", GAUSSIAN, "P")``: K4
sums nine payload columns.  The loss is the mean of the beauty's RGB plus
1e-2 times the mean of the resolved ``P_gauss`` plane, differentiated with
respect to the lens's ``pt`` and ``ap`` coefficients: the extra plane's
slot columns (``values[oid] * w_slot``) carry the gradient to the stream's
``P`` through the gather and ``AccumFn``.  (~1.3 min on one worker: one
JAX compile of ~60 s.)

Tolerances (measured values in brackets, pt / ap):
* end to end: 3e-2 / 5e-2 relative L2, as config 5's
  (``test_torch_grad.py``) [1.51e-2 / 1.55e-2];
* at JAX's forward values (the port's graph, its stream's values replaced
  by JAX's): 1e-3 [3.0e-4 / 3.6e-4];
* with every pixel written by a source whose splats differ between the
  two forward streams (2 of 1,024 sources, 8 pixels) out of the loss:
  1e-3 [1.0e-4 / 4.3e-5];
* the beauty and the ``P_gauss`` plane: <= 2% of pixels off JAX's by 2e-3
  of scale [0.68%, 0.68%];
* ``trace_chunks=4`` against one chunk: 1e-6 [0];
* with K3's outputs held, the loss's central difference along -g at 1e-8
  of |c| over the gradient's prediction in [0.8, 1.2] [0.989].
"""
import numpy as np
import pytest
import torch

import pota_tpu_torch as pt
from pota_tpu_torch.render import splat as tsplat
from pota_tpu_torch.render.renderer import render_frame
from pota_tpu_torch.render.splat import resolve_aovs
from torch_grad_routes import (
    CFG5,
    JaxRoute,
    PortRoute,
    Route,
    differing_sources_mask,
    held_ratio,
    planes_off,
    rel_l2,
)

torch.set_num_threads(2)

RES = 32
ROUTE = Route("aovs", CFG5, pt.RenderConfig(xres=RES, yres=RES, spp=1),
              "k3", extra=("P_gauss", "VECTOR", "P"), extra_weight=1e-2)
END_TO_END_TOL = (3e-2, 5e-2)
AGREE_TOL = 1e-3
HELD_RATIO, HELD_STEP = (0.8, 1.2), 1e-8


@pytest.fixture(scope="module")
def pair():
    """(JAX's route, its run, the port's route, its base step)."""
    jax_route = JaxRoute(ROUTE)
    port = PortRoute(ROUTE)
    return jax_route, jax_route.run(), port, port.step(ROUTE.params0())


def test_route_records_a_graph(pair):
    """The frame takes K3, records a graph, accumulates nine payload
    columns, and fills finite, non-zero gradients of ``pt`` and ``ap``,
    from the extra plane's term alone too."""
    _, _, port, (_, _, grads) = pair
    scene, m, lens, leaves = port.inputs(ROUTE.params0())
    widths = []
    accumulate = tsplat.accumulate_sorted

    def recording(pix, depth, payload, *a, **k):
        widths.append(payload.shape[1])
        return accumulate(pix, depth, payload, *a, **k)

    tsplat.accumulate_sorted = recording
    try:
        img, fb = render_frame(ROUTE.cfg, ROUTE.rc, scene, m, po_lens=lens,
                               po_state=port.state, aovs=ROUTE.aovs,
                               differentiable=True)
    finally:
        tsplat.accumulate_sorted = accumulate
    assert tsplat.LAST_ROUTE == ROUTE.route and img.requires_grad
    assert widths == [9]
    for g in grads:
        assert np.isfinite(g).all() and np.linalg.norm(g) > 0
    extra = resolve_aovs(ROUTE.rc, fb, ROUTE.aovs)["P_gauss"]
    for g in torch.autograd.grad(extra.mean(), leaves):
        assert bool(torch.isfinite(g).all()) and float(g.norm()) > 0


def test_gradient_matches_jax(pair):
    _, (_, j_grads, _, _), _, (_, _, grads) = pair
    for g, want, tol in zip(grads, j_grads, END_TO_END_TOL):
        assert rel_l2(g, want) < tol


def test_gradient_at_jax_forward_values(pair):
    _, (_, j_grads, _, vals), port, _ = pair
    _, _, grads = port.step(ROUTE.params0(), stream_vals=vals)
    for g, want in zip(grads, j_grads):
        assert rel_l2(g, want) < AGREE_TOL


def test_gap_is_the_sources_whose_splats_differ(pair, monkeypatch):
    """PR 11's method: the sources whose splats (writer pixels or weights)
    differ between the two float32 forward streams are at most 1%; with
    the pixels they write out of the loss (both planes) the gradients
    agree."""
    jax_route, (_, _, _, vals), port, _ = pair
    p0 = ROUTE.params0()
    mask, n_differ = differing_sources_mask(port, p0, vals, monkeypatch)
    print(f"sources whose splats differ: {n_differ} of {RES * RES}; pixels "
          f"out of the loss: {int((mask == 0).sum())}")
    assert n_differ <= 0.01 * RES * RES
    _, j_grads, _, _ = jax_route.run(mask=mask)
    _, _, grads = port.step(p0, mask=mask)
    for g, want in zip(grads, j_grads):
        assert rel_l2(g, want) < AGREE_TOL


def test_differentiable_planes_match_jax(pair):
    """The beauty and the extra plane, resolved as JAX's ``resolve_aovs``
    resolves them."""
    _, (_, _, j_planes, _), _, (planes, _, _) = pair
    off = planes_off(planes, j_planes)
    assert set(off) == {"RGBA", "P_gauss"}
    for k, share in off.items():
        assert np.isfinite(planes[k]).all() and share <= 0.02, k


def test_trace_chunks_give_the_same_gradient(pair):
    _, _, port, (planes, loss, grads) = pair
    planes4, loss4, grads4 = port.step(ROUTE.params0(), trace_chunks=4)
    assert np.array_equal(planes4["RGBA"], planes["RGBA"]) and loss4 == loss
    for g, want in zip(grads4, grads):
        assert rel_l2(g, want) <= 1e-6


def test_held_decisions_give_the_gradient(pair, monkeypatch):
    """K3's outputs held at the base frame's: the loss's central
    difference is the gradient's prediction."""
    _, _, port, (_, _, grads) = pair
    ratio = held_ratio(port, ROUTE.params0(), grads, HELD_STEP, monkeypatch)
    assert HELD_RATIO[0] <= ratio <= HELD_RATIO[1], ratio
