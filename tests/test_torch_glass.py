"""The id-matte and thin glass through the port's splat against the JAX
package on the CPU: the port's ``splat_frame`` of JAX's sample stream of a
teapot with two glass spheres, id-matte on, on K5 and on the decomposed PO
route with K6 (K3's: ``test_torch_slice.py::test_unported_options_raise``;
K3b's and the aberrated thin lens's: ``test_torch_bokeh_chroma.py``); the
transmitted-energy gate on
JAX's stream and in the port's own render; and the lens-coefficient
gradient of a glass frame against ``jax.grad``.

Tolerances (measured values in brackets):
* the splat of JAX's sample stream: ``crypto_total`` 1e-6 of scale,
  ``rank_w`` 1e-5, ``rank_id`` identical except at near-ties (ranks within
  1e-5 relative of a neighbour), every other plane 1e-6
  (``test_torch_slice.assert_splat_pair_close``);
* the gate: the lit-pixel ratio of JAX's ``test_gates.py::
  test_transmission_scene_end_to_end``;
* the glass frame's gradient (16x16 @ 1 spp, id-matte on): finite in both
  packages, and within 5e-3 relative L2 of JAX's on ``pt`` and ``ap``
  [3.4e-4 and 2.7e-4].
JAX's camera state is the port's (``setup_po_camera`` gives both packages
the same numbers: ``test_torch_slice.py::test_setup_po_camera_matches``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import golden_configs as gc

import pota_tpu_torch as pt
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import setup_po_camera
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render import splat as tsplat
from pota_tpu_torch.render.renderer import look_at, render_frame
from test_torch_slice import (
    assert_splat_pair_close,
    glass_teapots,
    splat_pair,
    to_port,
)

torch.set_num_threads(2)


def _cpu_m():
    return look_at([0, 0, 0], [0, 0, -1], device="cpu")


def _jax_state(state):
    """JAX's ``POState`` holding the port's numbers."""
    from pota_tpu.optics.focus import POState

    return POState(**dataclasses.asdict(state))


# ---------------------------------------------- the splat of JAX's stream


@pytest.fixture(scope="module")
def po_cam():
    """The golden configs' PO camera (``golden_configs._po``): JAX's
    (lens, state) and the port's (cfg, lens, state)."""
    from pota_tpu import CameraConfig, CameraType
    from pota_tpu.optics.fit import load_poly_lens as jload

    cfg = to_port(CameraConfig(
        camera_type=CameraType.POLYNOMIAL_OPTICS, lens_model=gc.FLAGSHIP,
        fstop=2.8, focus_distance=20.0, vignetting_retries=2,
        splat_queue_mult=6))
    lens = load_poly_lens(gc.FLAGSHIP, device="cpu")
    state = setup_po_camera(lens, cfg)
    return ((jload(gc.FLAGSHIP, degree=5), _jax_state(state)),
            (cfg, lens, state))


@pytest.mark.parametrize("route", ["k5", "decomposed_po"])
def test_id_matte_splat_matches_jax(po_cam, route):
    """The port's splat of JAX's sample stream of the glass teapot with the
    id-matte on K5 (the plain thin lens) and on the decomposed PO route
    with K6 (camera motion blur).  K3's route (the PO lens) is held the
    same way by ``test_torch_slice.py::test_unported_options_raise``."""
    jscene, tscene = glass_teapots()
    (jl, js_), (cfg, lens, state) = po_cam
    kw = dict(po=((jl, js_), (lens, state)))
    rc = pt.RenderConfig(xres=16, yres=16, spp=2, enable_id_matte=True)
    if route == "k5":
        cfg = pt.CameraConfig(focal_length=50.0, fstop=1.4,
                              focus_distance=150.0, vignetting_retries=2,
                              splat_queue_mult=6)
        rc = dataclasses.replace(rc, spp=4)
        kw = {}
    elif route == "decomposed_po":
        kw["m_end"] = look_at([3.0, 0, 0], [3.0, 0, -1], device="cpu").numpy()
    pair = splat_pair(cfg, rc, jscene, tscene, **kw)
    assert tsplat.LAST_ROUTE == route
    assert_splat_pair_close(pair)
    # both coverage layers ride: the glass spheres' pixels hold two ids
    got = pair[0]
    assert ((got["crypto_rank_id"] >= 0).sum(-1) >= 2).any()


def _glass_lightgrid():
    """``test_gates.py::test_transmission_scene_end_to_end``'s scene: a
    highlight behind 90% glass (JAX's and the port's)."""
    import jax.numpy as jnp

    from pota_tpu.render import scene as jsc

    kw = dict(n=1, spacing=1.0, z=-400.0, radius=3.0, intensity=40.0)
    jbase = jsc.lightgrid_scene(**kw)
    tbase = sc.lightgrid_scene(device="cpu", **kw)
    fields = {}
    for name, extra in (("centers", [[0.0, 0.0, -300.0]]), ("radii", [30.0]),
                        ("emission", np.zeros((1, 3))),
                        ("albedo", np.zeros((1, 3))),
                        ("transmission", np.full((1, 3), 0.9))):
        base = (np.zeros((1, 3)) if name == "transmission"
                else np.asarray(getattr(jbase, name)))
        fields[name] = np.concatenate([base, np.asarray(extra)], 0).astype(
            np.float32)
    jscene = dataclasses.replace(
        jbase, **{k: jnp.asarray(v) for k, v in fields.items()})
    tscene = dataclasses.replace(
        tbase, **{k: torch.as_tensor(v) for k, v in fields.items()})
    return jscene, tscene


def test_transmission_scene_end_to_end():
    """A highlight behind thin glass only redistributes when
    ``enable_bidir_transmission`` is on (ref src/lentil_filter.cpp:152-159),
    in the port's own render."""
    _, tscene = _glass_lightgrid()
    rc = pt.RenderConfig(xres=48, yres=48, spp=4)
    lit = []
    for on in (False, True):
        cfg = pt.CameraConfig(focal_length=65.0, fstop=1.8,
                              focus_distance=150.0,
                              enable_bidir_transmission=on)
        img, _ = render_frame(cfg, rc, tscene, _cpu_m(), seed=0)
        lit.append(int((img[..., :3].amax(-1) > 0.02).sum()))
    assert lit[1] > lit[0] * 1.5, lit


@pytest.mark.parametrize("bidir_transmission", [False, True])
def test_transmission_gate_matches_jax(bidir_transmission):
    """The transmitted-energy gate: the splat of JAX's stream equals JAX's
    splat, with the highlight behind glass kept from (off) or sent into
    (on) redistribution."""
    jscene, tscene = _glass_lightgrid()
    cfg = pt.CameraConfig(focal_length=65.0, fstop=1.8, focus_distance=150.0,
                          enable_bidir_transmission=bidir_transmission)
    pair = splat_pair(cfg, pt.RenderConfig(xres=48, yres=48, spp=4), jscene,
                      tscene)
    assert_splat_pair_close(pair)


# ------------------------------------------------------ the glass gradient


def test_glass_frame_gradient_matches_jax():
    """The mean loss of a 16x16 @ 1 spp frame of the glass teapot (the
    flagship lens, id-matte on) differentiated with respect to the fit's
    ``pt`` and ``ap`` coefficients, against ``jax.grad`` of JAX's pure
    route.  A ray that misses probes the glass exit at ~1e30, where the
    intersection's discriminant is NaN in float32; both packages keep that
    branch out of the gradient (finite in both)."""
    import jax
    from pota_tpu import CameraConfig, CameraType, RenderConfig
    from pota_tpu.optics.fit import load_poly_lens as jload
    from pota_tpu.render.renderer import render_frame as jrender

    jscene, tscene = glass_teapots()
    jcfg = CameraConfig(camera_type=CameraType.POLYNOMIAL_OPTICS,
                        lens_model=gc.FLAGSHIP, fstop=2.8, focus_distance=20.0,
                        vignetting_retries=2, splat_queue_mult=4)
    jrc = RenderConfig(xres=16, yres=16, spp=1, enable_id_matte=True)
    cfg, rc = to_port(jcfg), to_port(jrc)
    state = setup_po_camera(load_poly_lens(gc.FLAGSHIP, device="cpu"), cfg)
    jlens, jstate = jload(gc.FLAGSHIP, degree=5), _jax_state(state)

    def loss(c, ca):
        lens = dataclasses.replace(
            jlens, pt=dataclasses.replace(jlens.pt, coeffs=c),
            ap=dataclasses.replace(jlens.ap, coeffs=ca))
        img, _ = jrender(jcfg, jrc, jscene, gc.M, seed=0, po_lens=lens,
                         po_state=jstate, use_pallas=False)
        return img[..., :3].mean()

    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jlens.pt.coeffs, jlens.ap.coeffs)]

    lens = load_poly_lens(gc.FLAGSHIP, device="cpu")
    lens.pt.coeffs.requires_grad_(True)
    lens.ap.coeffs.requires_grad_(True)
    img, fb = render_frame(cfg, rc, tscene, _cpu_m(), seed=0, po_lens=lens,
                           po_state=state, differentiable=True)
    assert not fb["crypto_rank_w"].requires_grad
    img[..., :3].mean().backward()
    got = [lens.pt.coeffs.grad.numpy(), lens.ap.coeffs.grad.numpy()]
    for g, w in zip(got, want):
        assert np.isfinite(w).all() and np.isfinite(g).all()
        assert np.linalg.norm(g) > 0
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        print(f"\nglass gradient rel L2 {rel:.3e}")
        assert rel < 5e-3
