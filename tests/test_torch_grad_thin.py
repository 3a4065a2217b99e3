"""The thin lens under ``differentiable=True`` against JAX's pure route on
the CPU: BASELINE config 1's camera (f 50, fstop 1.4, focus 150, 4
candidates, ``splat_queue_mult`` 8) on the teapot at 32x32 @ 1 spp, on K5
(``k5``) and with coma 0.5 on the decomposed projection
(``decomposed_tl``).  The camera's fields are static, so what gets a
gradient is the scene's tensors and ``cam_to_world``; the loss is the mean
of the beauty's RGB.  (~40 s on one worker, most of it JAX's compile and
one eager JAX frame.)

Tolerances (measured values in brackets, k5 / decomposed_tl):
* end to end: ``albedo``, ``emission``, ``light_dir`` and ``sky_color``
  within 1e-3 relative L2 [at most 2.3e-5 / 1.9e-5]; ``centers``,
  ``radii`` and ``cam_to_world``, which reach the image only through the
  hit point, within 1e-1 [6.0e-2, 4.1e-2, 5.0e-2 / 4.3e-3, 4.4e-3,
  3.2e-3];
* that gap is the grazing hits: where a ray meets its sphere at a small
  |n . d|, the hit distance's derivative grows as 1 / |n . d|, and float32
  rounding moves the sample's gradient (k5's largest share is one sample
  at |n . d| = 0.018).  With the samples under |n . d| = 0.2 (8 / 3 of
  1,024) cut out of both gradients they agree to 1e-3 [3.1e-5 / 2.6e-5 at
  most], on the port's forward stream and at JAX's forward values alike
  (the port's splat of JAX's stream gives JAX's image to 6e-8); with the
  one sample under 0.05 cut [4.0e-5 / 9.1e-4].  Taking out the pixels of
  the sources whose splats differ between the two forward streams (0 / 1
  of 1,024) changes nothing.  JAX's jitted frame and the same frame run
  eagerly differ on ``cam_to_world`` by more than 1e-2 themselves
  [5.1e-2]; the port lies 1e-3 from the eager run [5.1e-4 at most];
* the image: <= 2% of pixels off JAX's by 2e-3 of scale [0%];
* ``trace_chunks=4`` against one chunk: 1e-6 [0];
* with the splat decisions held, the loss's central difference along -g
  at 1e-8 of |params| over the gradient's prediction in [0.8, 1.2]
  [0.997 / 0.934].  Below that the float32 loss's rounding shows (1.41 /
  1.78 at 1e-9); above it the forward trace's own decisions move (1.81
  for k5 at 1e-7) and then the queue (from 1e-6 / 1e-5).
"""
import dataclasses

import numpy as np
import pytest
import torch

import pota_tpu_torch as pt
from pota_tpu_torch.render import splat as tsplat
from pota_tpu_torch.render.renderer import render_frame
from torch_grad_routes import (
    SCENE_FIELDS,
    JaxRoute,
    PortRoute,
    Route,
    differing_sources_mask,
    grazing_samples,
    held_ratio,
    planes_off,
    rel_l2,
)

torch.set_num_threads(2)

RES = 32
CFG1 = pt.CameraConfig(focal_length=50.0, fstop=1.4, focus_distance=150.0,
                       vignetting_retries=3, splat_queue_mult=8)
ROUTES = {
    "k5": Route("k5", CFG1, pt.RenderConfig(xres=RES, yres=RES, spp=1),
                "k5"),
    "decomposed_tl": Route(
        "decomposed_tl", dataclasses.replace(CFG1, abb_coma=0.5),
        pt.RenderConfig(xres=RES, yres=RES, spp=1), "decomposed_tl"),
}
NAMES = SCENE_FIELDS + ("cam_to_world",)
SMOOTH = ("albedo", "emission", "light_dir", "sky_color")
SMOOTH_TOL, HIT_POINT_TOL, AGREE_TOL = 1e-3, 1e-1, 1e-3
GRAZING_COS = 0.2
HELD_RATIO = (0.8, 1.2)
HELD_STEP = 1e-8


@pytest.fixture(scope="module", params=list(ROUTES))
def pair(request):
    """(route, JAX's route, its run, the port's route, its base step)."""
    route = ROUTES[request.param]
    jax_route = JaxRoute(route)
    port = PortRoute(route)
    return (route, jax_route, jax_route.run(), port,
            port.step(route.params0()))


def test_route_records_a_graph(pair):
    """The frame takes its route, records a graph and fills finite,
    non-zero gradients of the scene and the camera."""
    route, _, _, port, (_, _, grads) = pair
    scene, m, _, _ = port.inputs(route.params0())
    img, _ = render_frame(route.cfg, route.rc, scene, m,
                          differentiable=True)
    assert tsplat.LAST_ROUTE == route.route and img.requires_grad
    for name, g in zip(NAMES, grads):
        assert np.isfinite(g).all() and np.linalg.norm(g) > 0, name


def test_gradient_matches_jax(pair):
    """End to end: the fields that shade a hit point smoothly within
    ``SMOOTH_TOL``; the hit point's own fields within ``HIT_POINT_TOL``
    (the grazing hits below)."""
    _, _, (_, j_grads, _, _), _, (_, _, grads) = pair
    for name, g, want in zip(NAMES, grads, j_grads):
        tol = SMOOTH_TOL if name in SMOOTH else HIT_POINT_TOL
        assert rel_l2(g, want) < tol, (name, rel_l2(g, want))


def test_gap_is_the_grazing_hits(pair):
    """With the grazing hits' stream values cut out of both gradients (at
    most 1% of the samples), the port's and JAX's agree to ``AGREE_TOL``
    on every field, on the port's own forward stream and at JAX's forward
    values."""
    route, jax_route, (_, _, _, vals), port, _ = pair
    p0 = route.params0()
    drop = grazing_samples(port, p0, GRAZING_COS)
    assert 0 < drop.sum() <= 0.01 * drop.size, drop.sum()
    _, j_grads, _, _ = jax_route.run(drop=drop)
    for stream_vals in (None, vals):
        _, _, grads = port.step(p0, stream_vals=stream_vals, drop=drop)
        errs = {n: rel_l2(g, w) for n, g, w in zip(NAMES, grads, j_grads)}
        assert max(errs.values()) < AGREE_TOL, errs


@pytest.mark.parametrize("pair", ["k5"], indirect=True)
def test_jax_against_itself_eager(pair):
    """JAX's K5 frame run eagerly (~30 s): its ``cam_to_world`` gradient
    differs from the jitted frame's by more than 1e-2, and the port's lies
    within ``AGREE_TOL`` of it, every field."""
    route, _, (_, j_grads, _, _), _, (_, _, grads) = pair
    _, e_grads, _, _ = JaxRoute(route, jit=False).run()
    cam = NAMES.index("cam_to_world")
    assert rel_l2(j_grads[cam], e_grads[cam]) > 1e-2
    for name, g, want in zip(NAMES, grads, e_grads):
        assert rel_l2(g, want) < AGREE_TOL, name


def test_gap_is_the_sources_whose_splats_differ(pair, monkeypatch):
    """PR 11's method: the sources whose splats differ between the two
    forward streams are at most 1%, and with the pixels they write out of
    the loss (and the grazing hits out) the gradients agree."""
    route, jax_route, (_, _, _, vals), port, _ = pair
    p0 = route.params0()
    mask, n_differ = differing_sources_mask(port, p0, vals, monkeypatch)
    assert n_differ <= 0.01 * RES * RES
    drop = grazing_samples(port, p0, GRAZING_COS)
    _, j_grads, _, _ = jax_route.run(mask=mask, drop=drop)
    _, _, grads = port.step(p0, mask=mask, drop=drop)
    for name, g, want in zip(NAMES, grads, j_grads):
        assert rel_l2(g, want) < AGREE_TOL, name


def test_differentiable_image_matches_jax(pair):
    _, _, (_, _, j_planes, _), _, (planes, _, _) = pair
    assert np.isfinite(planes["RGBA"]).all()
    assert planes_off(planes, j_planes)["RGBA"] <= 0.02


def test_trace_chunks_give_the_same_gradient(pair):
    route, _, _, port, (planes, loss, grads) = pair
    planes4, loss4, grads4 = port.step(route.params0(), trace_chunks=4)
    assert np.array_equal(planes4["RGBA"], planes["RGBA"]) and loss4 == loss
    for g, want in zip(grads4, grads):
        assert rel_l2(g, want) <= 1e-6


def test_held_decisions_give_the_gradient(pair, monkeypatch):
    """The splat's decisions (K5's outputs, or the decomposed projection
    and its occlusion) held at the base frame's: the loss's central
    difference along -g is the gradient's prediction; the queue does not
    move."""
    route, _, _, port, (_, _, grads) = pair
    ratio = held_ratio(port, route.params0(), grads, HELD_STEP, monkeypatch)
    assert HELD_RATIO[0] <= ratio <= HELD_RATIO[1], ratio
