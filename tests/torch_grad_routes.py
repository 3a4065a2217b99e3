"""The harness of the differentiable-route tests (``test_torch_grad_mb.py``,
``test_torch_grad_aovs.py``, ``test_torch_grad_thin.py``): one route's
frame, loss and gradient in JAX's pure route (``use_pallas=False``) and in
the port's ``differentiable=True``, on the same seeded inputs.

A :class:`Route` names the camera, the frame, the AOV list, the loss and
what is differentiated: the PO lens's ``pt`` / ``ap`` coefficients, or, on
the thin lens (whose camera fields are static), the scene's tensors and
``cam_to_world``.  The loss is the mean of the beauty's RGB, plus
``extra_weight`` times the mean of the resolved extra gaussian plane.

JAX's gradient is ``jax.grad`` of the whole frame, jitted as JAX's
``render_frame`` is; the same function returns the forward stream's
values (``rgba``, ``z``, ``P``, ``raydir``), so that the port's splat can
be run on JAX's stream, and takes a pixel mask of the loss and a set of
samples whose stream values are cut out of the gradient.
"""
import dataclasses

import numpy as np
import torch

import pota_tpu_torch as pt
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import setup_po_camera
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render import splat as tsplat
from pota_tpu_torch.render.aov import DEFAULT_AOVS, GAUSSIAN, AOVSpec
from pota_tpu_torch.render.renderer import look_at, render_sample_stream
from test_torch_slice import frac_pixels_off, to_jax

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
# config 5's camera (bench.py:249-297)
CFG5 = pt.CameraConfig(camera_type=pt.CameraType.POLYNOMIAL_OPTICS,
                       lens_model=FLAGSHIP, fstop=2.8, focus_distance=20.0,
                       vignetting_retries=2, splat_queue_mult=4)
STREAM_KEYS = ("rgba", "z", "P", "raydir")
SCENE_FIELDS = ("albedo", "emission", "centers", "radii", "light_dir",
                "sky_color")
EYE_END = ([2.0, 0.0, 0.0], [2.0, 0.0, -1.0])


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def flat(arrays) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in arrays])


def unflat(v, like) -> list:
    out, k = [], 0
    for a in like:
        n = int(np.prod(np.shape(a)))
        out.append(np.asarray(v[k:k + n], np.float32).reshape(np.shape(a)))
        k += n
    return out


@dataclasses.dataclass
class Route:
    """One differentiable route.  ``cfg`` / ``rc`` are the port's configs;
    ``extra`` an extra gaussian AOV (name, type, stream source) besides
    RGBA; ``motion_blur`` trucks the camera 2 units across the shutter."""
    name: str
    cfg: pt.CameraConfig
    rc: pt.RenderConfig
    route: str
    extra: tuple | None = None
    extra_weight: float = 0.0
    motion_blur: bool = False

    @property
    def thin(self) -> bool:
        return self.cfg.camera_type == pt.CameraType.THIN_LENS

    @property
    def aovs(self):
        if self.extra is None:
            return None
        name, typ, source = self.extra
        return list(DEFAULT_AOVS) + [AOVSpec(name, typ, GAUSSIAN, source)]

    def params0(self) -> list:
        """The differentiated inputs at their base values (numpy)."""
        if self.thin:
            scene = sc.teapot_scene(device="cpu")
            return ([getattr(scene, f).numpy() for f in SCENE_FIELDS]
                    + [look_at([0, 0, 0], [0, 0, -1], device="cpu").numpy()])
        fit = load_poly_lens(FLAGSHIP, device="cpu")
        return [fit.pt.coeffs.numpy(), fit.ap.coeffs.numpy()]

    def loss(self, planes, mask=None):
        """The route's loss of resolved planes (JAX or torch arrays);
        ``mask`` [H, W] zeroes pixels out of it."""
        terms = [(planes["RGBA"][..., :3], 1.0)]
        if self.extra is not None:
            terms.append((planes[self.extra[0]], self.extra_weight))
        total = 0.0
        for plane, w in terms:
            n = plane.shape[0] * plane.shape[1] * plane.shape[2]
            if mask is not None:
                plane = plane * mask[..., None]
            total = total + w * plane.sum() / n
        return total


# ------------------------------------------------------------------ JAX


class JaxRoute:
    """JAX's pure route of ``route`` at the base parameters, jitted as
    JAX's ``render_frame`` is, or eager (``jit=False``, op by op)."""

    def __init__(self, route: Route, differentiate_splat_geometry=True,
                 jit=True):
        import jax

        from pota_tpu.optics.fit import load_poly_lens as jload
        from pota_tpu.optics.focus import setup_po_camera as jsetup
        from pota_tpu.render import aov as jaov
        from pota_tpu.render import scene as jsc
        from pota_tpu.render.renderer import look_at as jlook

        self.route = route
        self.jit = jax.jit if jit else (lambda f: f)
        self.cfg = dataclasses.replace(
            to_jax(route.cfg),
            differentiate_splat_geometry=differentiate_splat_geometry)
        self.rc = to_jax(route.rc)
        self.scene = jsc.teapot_scene()
        self.m = jlook([0, 0, 0], [0, 0, -1])
        self.m_end = jlook(*EYE_END) if route.motion_blur else None
        self.lens = self.state = None
        if not route.thin:
            self.lens = jload(FLAGSHIP, degree=5)
            self.state = jsetup(self.lens, self.cfg)
        self.aovs = None if route.aovs is None else [
            jaov.AOVSpec(a.name, a.type, a.filter, a.source, a.redistribute)
            for a in route.aovs]
        self.p0 = [jax.numpy.asarray(p) for p in route.params0()]
        self._run = None

    def _inputs(self, params):
        if self.route.thin:
            scene = dataclasses.replace(
                self.scene, **dict(zip(SCENE_FIELDS, params[:-1])))
            return scene, params[-1], None
        lens = dataclasses.replace(
            self.lens, pt=dataclasses.replace(self.lens.pt, coeffs=params[0]),
            ap=dataclasses.replace(self.lens.ap, coeffs=params[1]))
        return self.scene, self.m, lens

    def stream(self, params):
        from pota_tpu.render.renderer import render_sample_stream as jstream

        scene, m, lens = self._inputs(params)
        s = jstream(self.cfg, self.rc, scene, m, 0, po_lens=lens,
                    po_state=self.state, cam_to_world_end=self.m_end,
                    use_pallas=False)
        return tuple(s[k] for k in STREAM_KEYS), s

    def planes(self, stream, params):
        from pota_tpu.render import splat as jsplat

        scene, m, lens = self._inputs(params)
        fb = jsplat.splat_frame(self.cfg, self.rc, scene, stream, m,
                                po_lens=lens, po_state=self.state,
                                aovs=self.aovs, cam_to_world_end=self.m_end,
                                use_pallas=False)
        return jsplat.resolve_aovs(self.rc, fb, self.aovs)

    def run(self, mask=None, drop=None):
        """JAX's gradient of the route's loss at the base parameters, in
        one (jitted) function: (loss, gradients, resolved planes, stream
        values).  ``mask`` [H, W] zeroes pixels out of the loss; ``drop``
        [N] bool cuts those samples' stream values out of the gradient."""
        import jax
        import jax.numpy as jnp

        if self._run is None:
            def f(params, mask, keep):
                vals, s = self.stream(params)
                cut = lambda v: keep.reshape((-1,) + (1,) * (v.ndim - 1))
                vals = tuple(v * cut(v) + jax.lax.stop_gradient(
                    v * (1.0 - cut(v))) for v in vals)
                s = dict(s, **dict(zip(STREAM_KEYS, vals)))
                planes = self.planes(s, params)
                return self.route.loss(planes, mask), (planes, vals)

            self._run = self.jit(jax.value_and_grad(f, has_aux=True))
        h, w = self.rc.yres, self.rc.xres
        n = h * w * self.rc.spp
        mask = jnp.ones((h, w)) if mask is None else jnp.asarray(mask)
        keep = jnp.ones((n,)) if drop is None else jnp.asarray(
            ~np.asarray(drop), jnp.float32)
        (loss, (planes, vals)), g = self._run(self.p0, mask, keep)
        return (float(loss), [np.asarray(x) for x in g],
                {k: np.asarray(v) for k, v in planes.items()},
                [np.asarray(v) for v in vals])


# ----------------------------------------------------------------- port


class PortRoute:
    """The port's ``differentiable=True`` frame of ``route`` on the CPU."""

    def __init__(self, route: Route):
        self.route = route
        self.scene = sc.teapot_scene(device="cpu")
        self.state = None
        if not route.thin:
            self.state = setup_po_camera(
                load_poly_lens(FLAGSHIP, device="cpu"), route.cfg)
        self.m_end = (look_at(*EYE_END, device="cpu") if route.motion_blur
                      else None)

    def inputs(self, params):
        """(scene, cam_to_world, lens, leaves): the leaves require grad."""
        leaves = [torch.tensor(np.asarray(p)).requires_grad_(True)
                  for p in params]
        if self.route.thin:
            scene = dataclasses.replace(
                self.scene, **dict(zip(SCENE_FIELDS, leaves[:-1])))
            return scene, leaves[-1], None, leaves
        lens = load_poly_lens(FLAGSHIP, device="cpu")
        with torch.no_grad():
            lens.pt.coeffs.copy_(leaves[0])
            lens.ap.coeffs.copy_(leaves[1])
        lens.pt.coeffs.requires_grad_(True)
        lens.ap.coeffs.requires_grad_(True)
        return (self.scene, look_at([0, 0, 0], [0, 0, -1], device="cpu"),
                lens, [lens.pt.coeffs, lens.ap.coeffs])

    def step(self, params, stream_vals=None, mask=None, trace_chunks=1,
             ops=None, grad=True, drop=None):
        """The frame at ``params``: (resolved planes as numpy, loss,
        gradients or None).  ``stream_vals`` replaces the forward stream's
        values by JAX's (the port's graph kept); ``mask`` [H, W] zeroes
        pixels out of the loss; ``ops`` the kernel set; ``drop`` [N] bool
        cuts those samples' stream values out of the gradient."""
        from pota_tpu_torch.render.splat import resolve_aovs, splat_frame

        route = self.route
        cfg = dataclasses.replace(route.cfg, trace_chunks=trace_chunks)
        scene, m, lens, leaves = self.inputs(params)
        with torch.enable_grad() if grad else torch.no_grad():
            stream = render_sample_stream(
                cfg, route.rc, scene, m, 0, po_lens=lens,
                po_state=self.state, ops=ops, cam_to_world_end=self.m_end,
                differentiable=True)
            if stream_vals is not None:
                for k, v in zip(STREAM_KEYS, stream_vals):
                    stream[k] = stream[k] + (torch.tensor(v)
                                             - stream[k]).detach()
            if drop is not None:
                for k in STREAM_KEYS:
                    cut = torch.as_tensor(drop).reshape(
                        (-1,) + (1,) * (stream[k].dim() - 1))
                    stream[k] = torch.where(cut, stream[k].detach(),
                                            stream[k])
            fb = splat_frame(cfg, route.rc, scene, stream, m, po_lens=lens,
                             po_state=self.state, aovs=route.aovs,
                             cam_to_world_end=self.m_end, ops=ops,
                             differentiable=True)
            planes = resolve_aovs(route.rc, fb, route.aovs)
            loss = route.loss(planes, None if mask is None
                              else torch.as_tensor(mask))
        grads = None
        if grad:
            grads = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
        return ({k: v.detach().numpy() for k, v in planes.items()},
                float(loss.detach()), grads)

    def writers_by_sample(self, params, stream_vals, monkeypatch):
        """Each sample's live writers of the frame on the port's forward
        stream (or JAX's values), as (pixels, weights) sorted, read from
        the accumulator's arguments."""
        seen = {}
        accumulate = tsplat.accumulate_sorted

        def recording(pix, depth, payload, sample, npix, ops=None):
            seen["w"] = (pix, sample, payload[:, 4].detach(), npix)
            return accumulate(pix, depth, payload, sample, npix, ops=ops)

        monkeypatch.setattr(tsplat, "accumulate_sorted", recording)
        self.step(params, stream_vals=stream_vals, grad=False)
        monkeypatch.undo()
        pix, sample, w, npix = seen["w"]
        live = pix < npix
        pix, sample, w = (t[live].numpy() for t in (pix, sample, w))
        order = np.lexsort((w, pix, sample))
        pix, sample, w = pix[order], sample[order], w[order]
        cuts = np.flatnonzero(np.diff(sample)) + 1
        return {int(sample[a]): (pix[a:b], w[a:b])
                for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(sample)])}


def differing_sources_mask(port: PortRoute, params, jax_vals, monkeypatch):
    """The [H, W] mask that takes out of the loss every pixel written by a
    source whose splats (pixels or weights) differ between the port's
    forward stream and JAX's (the port's splat on JAX's stream reproduces
    JAX's splat).  Returns (mask, number of such sources)."""
    own = port.writers_by_sample(params, None, monkeypatch)
    theirs = port.writers_by_sample(params, jax_vals, monkeypatch)
    differ = [k for k in set(own) | set(theirs)
              if k not in own or k not in theirs
              or not all(np.array_equal(a, b)
                         for a, b in zip(own[k], theirs[k]))]
    rc = port.route.rc
    mask = np.ones(rc.yres * rc.xres, np.float32)
    for k in differ:
        for side in (own, theirs):
            if k in side:
                mask[side[k][0]] = 0.0
    return mask.reshape(rc.yres, rc.xres), len(differ)


def grazing_samples(port: PortRoute, params, cos_max: float) -> np.ndarray:
    """[N] bool: the samples whose ray meets its sphere at a grazing angle,
    |n . d| < ``cos_max``, on the port's forward stream.  There the hit
    distance's derivative grows as 1 / |n . d|, so float32 rounding moves
    the sample's gradient."""
    scene, m, lens, _ = port.inputs(params)
    with torch.no_grad():
        s = render_sample_stream(port.route.cfg, port.route.rc, scene, m, 0,
                                 po_lens=lens, po_state=port.state,
                                 cam_to_world_end=port.m_end)
        oid = s["obj_id"].to(torch.int64).clamp(min=0)
        cos = (((s["P"] - scene.centers[oid]) * s["raydir"]).sum(-1).abs()
               / scene.radii[oid])
    return (s["hit"] & (cos < cos_max)).numpy()


class Holder:
    """A kernel set and splat hooks that record, or replay (``held``), the
    splat's decisions of a frame: the fused kernel's outputs (K3 / K5), or
    the decomposed projection and its occlusion probe; the slot -> source
    map of K2 is recorded (``rec["src"]``) so a test can see the queue
    move."""

    def __init__(self, route: Route, monkeypatch):
        from pota_tpu_torch import ops as tops

        self.rec, self.held, self.base = {}, False, {}
        kernels = tops.KERNELS

        def expand(*a):
            self.rec["src"] = a[0]
            return kernels.expand(*a)

        def hold(key, fn):
            def run(*a, **k):
                out = fn(*a, **k)
                self.rec[key] = out
                return self.base[key] if self.held else out
            return run

        self.ops = kernels._replace(
            expand=expand, po_splat=hold("po_splat", kernels.po_splat),
            tl_splat=hold("tl_splat", kernels.tl_splat))
        for name in ("po_backward_project", "thinlens_backward_project",
                     "_occluded_through_camera"):
            monkeypatch.setattr(tsplat, name,
                                hold(name, getattr(tsplat, name)))

    def keep_base(self):
        """The last frame's decisions become those to replay."""
        self.base = dict(self.rec)

    def queue_moved(self) -> bool:
        return not torch.equal(self.base["src"], self.rec["src"])


def held_ratio(port: PortRoute, params, grads, step: float,
               monkeypatch) -> float:
    """The loss's central difference along -g/|g|, ``step`` of |params|,
    with the splat's decisions held at the base frame's (:class:`Holder`),
    over the gradient's first-order prediction g . (the step taken in
    float32); asserts that the queue did not move and that the prediction
    is a decrease."""
    holder = Holder(port.route, monkeypatch)
    port.step(params, ops=holder.ops, grad=False)
    holder.keep_base()
    c, g = flat(params), flat(grads)
    d = -g / np.linalg.norm(g)
    h = step * np.linalg.norm(c)
    cp, cm = (flat(unflat(c + s * h * d, params)) for s in (1.0, -1.0))
    pred = float(g @ (cp - cm))
    assert pred < 0.0
    holder.held = True
    losses = []
    for cc in (cp, cm):
        losses.append(port.step(unflat(cc, params), ops=holder.ops,
                                grad=False)[1])
        assert not holder.queue_moved()
    return (losses[0] - losses[1]) / pred


def planes_off(planes, jax_planes) -> dict:
    """Each gaussian plane's share of pixels off JAX's
    (``frac_pixels_off``)."""
    return {k: frac_pixels_off(planes[k], jax_planes[k])
            for k in ("RGBA", "P_gauss") if k in jax_planes}
