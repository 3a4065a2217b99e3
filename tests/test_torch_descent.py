"""Is config 5's gradient a descent direction?  The L2 loss of JAX's
``train_step_sharded`` toward the frame at the flagship fit's own
coefficients, at seeded 1e-3 perturbed coefficients c1
(``test_torch_grad.py``'s ``c1``), 48x48 @ 1 spp on the teapot: its
central differences along d = -g/|g| against the first-order prediction,
for the port and for JAX's pure route.

What the measurement showed (ROADMAP Queue 3 item 1; PERF.md section 6):
the L2 loss is not smooth at any step the float32 coefficients can take.
At h = 1e-11 of |c| (33 coefficients moved by one ulp) one K3 slot already
flips and the loss moves by 1.1e-4, 10^6 times the first-order term; from
1e-8 the splat queue moves; at 1e-4 (``chip_smoke.py``'s old step) the
loss rises.  JAX's L2 loss jumps the same way.  With the splat decisions
held (K3's outputs replayed from c1; the queue and the forward trace's
retries do not move at these steps, which the test asserts), the loss's
change is the gradient's prediction: the port's gradient is the
derivative of the smooth part of its loss.

Limits (measured in brackets): the held loss's change over the prediction
within [0.8, 1.2] at h = 1e-9 and 3e-9 of |c| [0.951, 0.901; float32
rounding of the image: the change is ~2e-5 of the loss]; the free loss's
change over the prediction above 100 in size at 1e-9, in both packages
[7189 port, 958 JAX along JAX's own direction]; at 3e-5, where the lens
changes grossly, the two packages' differences equal to 1e-3 [8e-6].
"""
import dataclasses

import numpy as np
import pytest
import torch

import pota_tpu_torch as pt
from pota_tpu_torch import ops as tops
from pota_tpu_torch.models import po_camera
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import setup_po_camera
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render.renderer import look_at, render_frame

torch.set_num_threads(2)

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
RES = 48
CFG = pt.CameraConfig(camera_type=pt.CameraType.POLYNOMIAL_OPTICS,
                      lens_model=FLAGSHIP, fstop=2.8, focus_distance=20.0,
                      vignetting_retries=2, splat_queue_mult=4)
RC = pt.RenderConfig(xres=RES, yres=RES, spp=1)
HELD_RATIO = (0.8, 1.2)
JUMP_RATIO = 100.0
LARGE_STEP_TOL = 1e-3


def _perturbed(c, seed):
    rng = np.random.default_rng(seed)
    c = np.asarray(c, np.float32)
    return (c * (1.0 + 1e-3 * rng.standard_normal(c.shape))).astype(
        np.float32)


class PortLoss:
    """The port's L2 loss as a function of the flat coefficients (pt, ap),
    on the differentiable route, recording K3's outputs, the slot ->
    source map and the forward trace's retry counts of each frame; with
    ``held`` K3 returns the recorded outputs of c1 instead."""

    def __init__(self):
        fit = load_poly_lens(FLAGSHIP, device="cpu")
        self.state = setup_po_camera(fit, CFG)
        self.scene = sc.teapot_scene(device="cpu")
        self.m = look_at([0, 0, 0], [0, 0, -1], device="cpu")
        self.shapes = (tuple(fit.pt.coeffs.shape), tuple(fit.ap.coeffs.shape))
        self.c0 = self.flat(fit.pt.coeffs, fit.ap.coeffs)
        self.c1 = self.flat(_perturbed(fit.pt.coeffs, 1),
                            _perturbed(fit.ap.coeffs, 2))
        self.rec, self.held = {}, None
        self.ops = tops.KERNELS._replace(po_splat=self._k3,
                                         expand=self._expand)
        self.target = self.image(self.c0)[0].detach()
        img, lens = self.image(self.c1, grad=True)
        loss = ((img - self.target) ** 2).mean()
        loss.backward()
        self.loss1 = float(loss.detach())
        self.g = self.flat(lens.pt.coeffs.grad, lens.ap.coeffs.grad)
        self.base = dict(self.rec)

    @staticmethod
    def flat(a, b):
        return np.concatenate([np.asarray(a, np.float64).ravel(),
                               np.asarray(b, np.float64).ravel()])

    def _k3(self, *a):
        out = tops.KERNELS.po_splat(*a)
        self.rec["k3"] = out
        return self.held if self.held is not None else out

    def _expand(self, *a):
        self.rec["src"] = a[0]
        return tops.KERNELS.expand(*a)

    def image(self, c, grad=False):
        n = int(np.prod(self.shapes[0]))
        lens = load_poly_lens(FLAGSHIP, device="cpu")
        with torch.no_grad():
            lens.pt.coeffs.copy_(torch.as_tensor(
                c[:n].reshape(self.shapes[0]), dtype=torch.float32))
            lens.ap.coeffs.copy_(torch.as_tensor(
                c[n:].reshape(self.shapes[1]), dtype=torch.float32))
        if grad:
            lens.pt.coeffs.requires_grad_(True)
            lens.ap.coeffs.requires_grad_(True)
        trace = po_camera.trace_fw_po

        def recording_trace(*a, **k):
            out = trace(*a, **k)
            self.rec["tries"] = out[3]
            return out

        po_camera.trace_fw_po = recording_trace
        try:
            img, _ = render_frame(CFG, RC, self.scene, self.m, seed=0,
                                  po_lens=lens, po_state=self.state,
                                  differentiable=True, ops=self.ops)
        finally:
            po_camera.trace_fw_po = trace
        return img, lens

    def loss(self, c, held=False) -> float:
        self.held = self.base["k3"] if held else None
        try:
            img = self.image(c)[0].detach()
        finally:
            self.held = None
        return float(((img - self.target) ** 2).double().mean())

    def moved(self):
        """(queue moved, retries changed, K3 slots changed) against c1."""
        b, r = self.base, self.rec
        if not torch.equal(b["src"], r["src"]):
            return True, None, None
        flips = (b["k3"][0] != r["k3"][0]) | (b["k3"][1] != r["k3"][1])
        return (False, int((b["tries"] != r["tries"]).sum()),
                int(flips.sum()))


def steps(c, d, h):
    """c +- h d rounded to float32, and the step actually taken."""
    cp = (c + h * d).astype(np.float32).astype(np.float64)
    cm = (c - h * d).astype(np.float32).astype(np.float64)
    return cp, cm, cp - cm


@pytest.fixture(scope="module")
def port():
    return PortLoss()


@pytest.fixture(scope="module")
def jax_loss(port):
    """JAX's pure route: the jitted L2 loss toward its own frame at the
    fit's coefficients, and its gradient at c1."""
    import jax
    import jax.numpy as jnp

    from pota_tpu import CameraConfig, CameraType, RenderConfig
    from pota_tpu.optics.fit import load_poly_lens as jload
    from pota_tpu.optics.focus import setup_po_camera as jsetup
    from pota_tpu.render import scene as jsc
    from pota_tpu.render.renderer import look_at as jlook
    from pota_tpu.render.renderer import render_frame as jrender

    jcfg = CameraConfig(camera_type=CameraType.POLYNOMIAL_OPTICS,
                        lens_model=FLAGSHIP, fstop=2.8, focus_distance=20.0,
                        vignetting_retries=2, splat_queue_mult=4)
    jrc = RenderConfig(xres=RES, yres=RES, spp=1)
    jlens = jload(FLAGSHIP, degree=5)
    jstate = jsetup(jlens, jcfg)
    jscene, jm = jsc.teapot_scene(), jlook([0, 0, 0], [0, 0, -1])
    n = int(np.prod(port.shapes[0]))

    def image(c):
        pt_c = c[:n].reshape(port.shapes[0])
        ap_c = c[n:].reshape(port.shapes[1])
        lens = dataclasses.replace(
            jlens, pt=dataclasses.replace(jlens.pt, coeffs=pt_c),
            ap=dataclasses.replace(jlens.ap, coeffs=ap_c))
        return jrender(jcfg, jrc, jscene, jm, seed=0, po_lens=lens,
                       po_state=jstate, use_pallas=False)[0]

    target = jax.jit(image)(jnp.asarray(port.c0, jnp.float32))
    loss = jax.jit(lambda c: jnp.mean((image(c) - target) ** 2))
    _, g = jax.jit(jax.value_and_grad(
        lambda c: jnp.mean((image(c) - target) ** 2)))(
        jnp.asarray(port.c1, jnp.float32))
    return (lambda c: float(loss(jnp.asarray(c, jnp.float32))),
            np.asarray(g, np.float64))


@pytest.mark.parametrize("r", [1e-9, 3e-9])
def test_held_decisions_give_the_gradient(port, r):
    """K3's decisions held at c1's: the loss's central difference is the
    gradient's prediction, where the queue and the retries do not move."""
    d = -port.g / np.linalg.norm(port.g)
    cp, cm, step = steps(port.c1, d, r * np.linalg.norm(port.c1))
    pred = float(port.g @ step)
    dl = port.loss(cp, held=True)
    assert port.moved()[:2] == (False, 0)
    dl -= port.loss(cm, held=True)
    assert port.moved()[:2] == (False, 0)
    assert pred < 0.0
    assert HELD_RATIO[0] <= dl / pred <= HELD_RATIO[1], (r, dl, pred)


def test_splat_decisions_dominate_the_l2_loss(port, jax_loss):
    """The free loss at h = 1e-9 of |c|: K3 slots flip (the queue and the
    retries hold) and the change dwarfs the prediction, in the port along
    its direction and in JAX along JAX's."""
    h = 1e-9 * np.linalg.norm(port.c1)
    d = -port.g / np.linalg.norm(port.g)
    cp, cm, step = steps(port.c1, d, h)
    dl = port.loss(cp)
    queue_moved, retries, flips = port.moved()
    assert not queue_moved and retries == 0 and flips > 0
    dl -= port.loss(cm)
    assert abs(dl) > JUMP_RATIO * abs(port.g @ step)

    loss_j, g_j = jax_loss
    d_j = -g_j / np.linalg.norm(g_j)
    cp, cm, step = steps(port.c1, d_j, h)
    assert abs(loss_j(cp) - loss_j(cm)) > JUMP_RATIO * abs(g_j @ step)


def test_large_steps_agree_with_jax(port, jax_loss):
    """At h = 3e-5 of |c| along the port's d the lens changes grossly; the
    two packages' loss differences agree."""
    d = -port.g / np.linalg.norm(port.g)
    cp, cm, _ = steps(port.c1, d, 3e-5 * np.linalg.norm(port.c1))
    dl = port.loss(cp) - port.loss(cm)
    loss_j, _ = jax_loss
    dl_j = loss_j(cp) - loss_j(cm)
    assert abs(dl - dl_j) <= LARGE_STEP_TOL * abs(dl_j), (dl, dl_j)


def test_the_old_descent_step_raises_the_loss(port):
    """``chip_smoke.py``'s old step, 1e-4 of |c| along d, moves the queue
    and raises the loss: it crosses splat decisions (its 4K losses rose
    0.122, 0.159, 0.162)."""
    d = -port.g / np.linalg.norm(port.g)
    c = (port.c1 + 1e-4 * np.linalg.norm(port.c1) * d)
    assert port.loss(c) > port.loss1
    assert port.moved()[0]
