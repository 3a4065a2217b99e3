"""Camera motion blur under ``differentiable=True`` (the decomposed PO
route: K2, K6 and the world-space occlusion probe under ``no_grad``, K4)
against JAX's pure route on the CPU: config 5's camera (the flagship fit,
fstop 2.8, focus 20, 3 candidates a ray, ``splat_queue_mult`` 4) on the
teapot, the camera trucked from ``look_at([0,0,0],[0,0,-1])`` to
``look_at([2,0,0],[2,0,-1])`` across the shutter, 32x32 @ 1 spp; the loss
is the mean of the beauty's RGB, differentiated with respect to the lens's
``pt`` and ``ap`` coefficients.  (~2.4 min on one worker: two JAX
compiles of ~55 s each.)

The port does not differentiate its Newton solve of the decomposed
projection (``optics/polynomial.py::lt_sample_aperture``, unrolled, under
``no_grad``): every output of JAX's projection reaches the image only
through ``floor``, a boolean or a constant weight, so its cotangent is
zero almost everywhere.  JAX's own switch shows it: with
``differentiate_splat_geometry`` True (its ``custom_root`` backward
through the solve) and False (``stop_gradient``) its gradients are equal
and finite.

Tolerances (measured values in brackets, pt / ap):
* end to end: 3e-2 / 5e-2 relative L2, as config 5's
  (``test_torch_grad.py``) [1.18e-2 / 7.35e-3];
* at JAX's forward values (the port's graph, its stream's values replaced
  by JAX's): 1e-3 [3.2e-5 / 2.0e-5];
* with every pixel written by a source whose splats differ between the
  two forward streams (3 of 1,024 sources, 10 pixels) out of the loss:
  1e-3 [1.3e-5 / 1.7e-5];
* JAX's two settings of ``differentiate_splat_geometry``: 1e-6 [equal];
* the image: <= 2% of pixels off JAX's by 2e-3 of scale [0.98%];
* ``trace_chunks=4`` against one chunk: 1e-6 [0];
* with the splat decisions (K6's projection and the occlusion probe) held,
  the loss's central difference along -g at 1e-8 of |c| over the
  gradient's prediction in [0.8, 1.2] [1.003].
"""
import numpy as np
import pytest
import torch

import pota_tpu_torch as pt
from pota_tpu_torch.render import splat as tsplat
from pota_tpu_torch.render.renderer import render_frame
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
ROUTE = Route("mb", CFG5, pt.RenderConfig(xres=RES, yres=RES, spp=1),
              "decomposed_po", motion_blur=True)
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
    """The trucked frame takes the decomposed route, records a graph and
    fills finite, non-zero gradients of ``pt`` and ``ap``."""
    _, _, port, (_, _, grads) = pair
    scene, m, lens, _ = port.inputs(ROUTE.params0())
    img, _ = render_frame(ROUTE.cfg, ROUTE.rc, scene, m, po_lens=lens,
                          po_state=port.state, cam_to_world_end=port.m_end,
                          differentiable=True)
    assert tsplat.LAST_ROUTE == ROUTE.route and img.requires_grad
    for g in grads:
        assert np.isfinite(g).all() and np.linalg.norm(g) > 0


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
    the pixels they write out of the loss the gradients agree."""
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


def test_jax_splat_geometry_gradient_is_zero(pair):
    """JAX with ``differentiate_splat_geometry=False`` gives the gradient
    it gives with True (its implicit-function backward through the
    decomposed projection's Newton solve): the solve needs no backward."""
    _, (_, j_grads, _, _), _, _ = pair
    _, off_grads, _, _ = JaxRoute(
        ROUTE, differentiate_splat_geometry=False).run()
    for g, want in zip(off_grads, j_grads):
        assert np.isfinite(want).all() and np.isfinite(g).all()
        assert rel_l2(g, want) <= 1e-6


def test_differentiable_image_matches_jax(pair):
    _, (_, _, j_planes, _), _, (planes, _, _) = pair
    assert np.isfinite(planes["RGBA"]).all()
    assert planes_off(planes, j_planes)["RGBA"] <= 0.02


def test_trace_chunks_give_the_same_gradient(pair):
    _, _, port, (planes, loss, grads) = pair
    planes4, loss4, grads4 = port.step(ROUTE.params0(), trace_chunks=4)
    assert np.array_equal(planes4["RGBA"], planes["RGBA"]) and loss4 == loss
    for g, want in zip(grads4, grads):
        assert rel_l2(g, want) <= 1e-6


def test_held_decisions_give_the_gradient(pair, monkeypatch):
    """K6's projection and the occlusion probe held at the base frame's:
    the loss's central difference is the gradient's prediction."""
    _, _, port, (_, _, grads) = pair
    ratio = held_ratio(port, ROUTE.params0(), grads, HELD_STEP, monkeypatch)
    assert HELD_RATIO[0] <= ratio <= HELD_RATIO[1], ratio
