"""Polynomial-optics kernels K1-K3 with their plain PyTorch versions.

Each wrapper takes the plain version for CPU tensors and launches its CUDA
kernel (``csrc/``) for CUDA tensors; there is no fallback between the two.
The plain versions are the same functions written with the port's tensor
code, and are what the CPU tests hold against the JAX package.

* :func:`po_forward` — K1, the PO forward trace
  (``pota_tpu/ops/po_pallas.py::build_po_forward_kernel``);
* :func:`expand` — K2, compact source table -> queue slots
  (``po_pallas.py::build_expand_kernel``);
* :func:`po_splat` — K3, the per-slot backward splat with in-kernel aperture
  sampling (``po_pallas.py::build_po_splat_kernel``, ``sample_aperture=True``).
"""
from __future__ import annotations

import torch

from ..optics import samplers
from ..optics.geometry import CHARTS
from ..optics.polynomial import (
    PolyLens,
    inner_pupil_ok,
    lt_sample_aperture,
    pt_evaluate,
    pt_sample_aperture,
)
from ..optics.thinlens import image_dist_focusdist
from ..utils import rng as prng
from . import _build

# ---------------------------------------------------------------- table rows
# compact source table: f32 rows and int32 rows side by side
TF_PCX, TF_PCY, TF_PCZ = 0, 1, 2
TF_PWX, TF_PWY, TF_PWZ = 3, 4, 5
TF_SKY = 6
TF_R, TF_G, TF_B, TF_A = 7, 8, 9, 10
TF_Z = 11
TF_ROWS = 12
TI_PX, TI_PY, TI_START, TI_SID = 0, 1, 2, 3
TI_ROWS = 4

# per-frame scalar layout of the splat kernel (po_pallas.py _SP_*)
SPLAT_PARAM_COUNT = 32
SP_ROT, SP_TRANS = 0, 9
SP_XRES, SP_YRES, SP_RMINX, SP_RMINY = 12, 13, 14, 15
SP_XRES_R, SP_YRES_R, SP_INV_UNIT, SP_SHIFT = 16, 17, 18, 19
SP_HSW, SP_ASPECT, SP_AP_RADIUS, SP_LAMBDA = 20, 21, 22, 23


def splat_kernel_params(cfg, rc, po_state, cam_to_world) -> torch.Tensor:
    """The per-frame scalars the splat kernel reads ([32] f32, the layout of
    ``po_pallas.py::splat_kernel_params``)."""
    m = cam_to_world.to(torch.float32)
    ca = cfg.abb_chromatic
    tail = torch.tensor([
        rc.xres, rc.yres, rc.region_min_x, rc.region_min_y,
        rc.xres_region, rc.yres_region,
        1.0 / cfg.unit_scale_filter, po_state.sensor_shift,
        cfg.sensor_width * 0.5, rc.xres / rc.yres,
        po_state.aperture_radius, cfg.lambda_um,
        0.35 + (1.0 - ca) * 0.2, 0.55, 0.55 + ca * 0.3,
        cfg.thinlens_aperture_radius, cfg.effective_focal_length,
        image_dist_focusdist(cfg), cfg.effective_anamorphic, 0.0,
    ], dtype=torch.float32, device=m.device)
    return torch.cat([m[:3, :3].reshape(-1), m[:3, 3], tail])


# ------------------------------------------------------------ argument checks


def _check(name, t, dtype, device, shape=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _cond(lens: PolyLens, device) -> torch.Tensor:
    """[10] f32: input scales then shifts.  The kernels condition every
    variable with one set, so pt and ap must share it."""
    if not (torch.equal(lens.pt.in_scale, lens.ap.in_scale)
            and torch.equal(lens.pt.in_shift, lens.ap.in_shift)):
        raise ValueError(f"lens {lens.name!r}: pt and ap must share their "
                         "input conditioning for the kernels")
    return torch.cat([lens.pt.in_scale, lens.pt.in_shift]).to(
        device, torch.float32).contiguous()


def _exps_i8(fn, device) -> torch.Tensor:
    e = fn.exponents
    if int(e.min()) < 0 or int(e.max()) > 127:
        raise ValueError("exponents must lie in [0, 127]")
    return e.to(device=device, dtype=torch.int8).contiguous()


# ------------------------------------------------------- K1: PO forward trace


def po_forward_plain(lens: PolyLens, x, y, ax, ay, lam, sensor_shift: float,
                     iterations: int = 3):
    """Plain K1: Newton aperture solve, sensor shift, pt_evaluate.
    Returns (out4 [M, 4], trans [M] >= 0, dx [M], dy [M])."""
    zero = torch.zeros_like(x)
    sensor5 = torch.stack([x, y, zero, zero, lam], -1)
    solved = pt_sample_aperture(lens, sensor5, torch.stack([ax, ay], -1),
                                iterations=iterations)
    dx, dy = solved[..., 2], solved[..., 3]
    shifted = torch.stack([x + dx * sensor_shift, y + dy * sensor_shift,
                           dx, dy, lam], -1)
    out4, trans = pt_evaluate(lens, shifted)
    return out4, trans, dx, dy


def po_forward(lens: PolyLens, x, y, ax, ay, lam, sensor_shift: float,
               iterations: int = 3):
    """K1 wrapper: plain version on the CPU, the CUDA kernel on the card.
    Rays are f32 [M] contiguous, on the lens's device."""
    dev = x.device
    m = x.shape[0]
    for name, t in (("x", x), ("y", y), ("ax", ax), ("ay", ay), ("lam", lam)):
        _check(name, t, torch.float32, dev, (m,))
    if lens.device != dev:
        raise ValueError(f"lens on {lens.device}, rays on {dev}")
    if dev.type == "cpu":
        return po_forward_plain(lens, x, y, ax, ay, lam, sensor_shift,
                                iterations)
    ap_e, pt_e = _exps_i8(lens.ap, dev), _exps_i8(lens.pt, dev)
    ap_c = lens.ap.coeffs.contiguous()
    pt_c = lens.pt.coeffs.contiguous()
    if ap_c.shape[0] != 2 or pt_c.shape[0] != 5:
        raise ValueError("expected ap coeffs [2, T] and pt coeffs [5, T]")
    cond = _cond(lens, dev)
    out4 = torch.empty((m, 4), dtype=torch.float32, device=dev)
    trans, dx, dy = (torch.empty((m,), dtype=torch.float32, device=dev)
                     for _ in range(3))
    err = _build.lib().pota_po_forward(
        x.data_ptr(), y.data_ptr(), ax.data_ptr(), ay.data_ptr(),
        lam.data_ptr(), m, ap_e.data_ptr(), ap_c.data_ptr(), ap_c.shape[1],
        pt_e.data_ptr(), pt_c.data_ptr(), pt_c.shape[1], cond.data_ptr(),
        1.0 / lens.aperture_z, float(sensor_shift), int(iterations),
        out4.data_ptr(), trans.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        _stream(dev))
    _build.check(err, "po_forward")
    _build.LAUNCHES["po_forward"] += 1
    return out4, trans, dx, dy


# ------------------------------------------------------------- K2: expand


def expand_plain(src, table_f, table_i):
    """Plain K2: ``ex[r, s] = table[r, src[s]]`` for both tables."""
    idx = src.to(torch.int64)
    return table_f[:, idx], table_i[:, idx]


def expand(src, table_f, table_i):
    """K2 wrapper.  ``src`` int32 [S] indexes the columns of ``table_f`` f32
    [Rf, N] and ``table_i`` int32 [Ri, N]; returns ([Rf, S], [Ri, S])."""
    dev = src.device
    s = src.shape[0]
    n = table_f.shape[1]
    _check("src", src, torch.int32, dev, (s,))
    _check("table_f", table_f, torch.float32, dev)
    _check("table_i", table_i, torch.int32, dev, (table_i.shape[0], n))
    if dev.type == "cpu":
        return expand_plain(src, table_f, table_i)
    ef = torch.empty((table_f.shape[0], s), dtype=torch.float32, device=dev)
    ei = torch.empty((table_i.shape[0], s), dtype=torch.int32, device=dev)
    err = _build.lib().pota_expand(
        src.data_ptr(), s, table_f.data_ptr(), table_f.shape[0],
        table_i.data_ptr(), table_i.shape[0], n, ef.data_ptr(),
        ei.data_ptr(), _stream(dev))
    _build.check(err, "expand")
    _build.LAUNCHES["expand"] += 1
    return ef, ei


# ------------------------------------------------------------- K3: PO splat


def _occlude_spheres(pwx, pwy, pwz, cwx, cwy, cwz, spheres, t_min=1e-3):
    """Segment occlusion of (world point -> world lens point) against the
    sphere table [n, 4] (center, radius)."""
    segx, segy, segz = cwx - pwx, cwy - pwy, cwz - pwz
    dist = torch.sqrt(torch.clamp(segx * segx + segy * segy + segz * segz,
                                  min=1e-24))
    inv_d = 1.0 / dist
    ddx, ddy, ddz = segx * inv_d, segy * inv_d, segz * inv_d
    occ = torch.zeros_like(pwx, dtype=torch.bool)
    for i in range(spheres.shape[0]):
        ocx = pwx - spheres[i, 0]
        ocy = pwy - spheres[i, 1]
        ocz = pwz - spheres[i, 2]
        r = spheres[i, 3]
        b = ocx * ddx + ocy * ddy + ocz * ddz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b * b - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = -b - sq
        t1 = -b + sq
        t = torch.where(t0 > t_min, t0, t1)
        occ |= (disc > 0.0) & (t > t_min) & (t < dist - t_min)
    return occ


def _floor_clip(v, hi):
    """floor then clip to [0, hi], keeping NaN (as jnp.clip does)."""
    f = torch.floor(v)
    f = torch.where(f < 0.0, 0.0, f)
    return torch.where(f > hi, hi, f)


def po_splat_plain(lens: PolyLens, pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr,
                   sky, params, spheres, iterations: int = 3):
    """Plain K3, composed of the port's sampler, ``lt_sample_aperture``, the
    pixel map and the occlusion probe (as JAX's decomposed path is).
    ``seed`` / ``ctr`` hold uint32 words (int32 or int64 tensors).
    Returns (lin int32 [S], ok bool [S])."""
    p = params
    u = prng.uniforms(seed.to(torch.int64) & prng.MASK32,
                      ctr.to(torch.int64) & prng.MASK32, 2)
    disk = samplers.concentric_disk_sample(u[..., 0], u[..., 1])
    ap = disk * p[SP_AP_RADIUS]
    target = torch.stack([pcx * -10.0, pcy * -10.0, pcz * -10.0], -1)
    sensor5, _, trans = lt_sample_aperture(lens, target, ap, p[SP_LAMBDA],
                                           iterations=iterations)
    ok = (trans > 0.0) & inner_pupil_ok(lens, sensor5)
    x, y, dx, dy = (sensor5[..., k] for k in range(4))
    sx = (x + dx * -p[SP_SHIFT]) / p[SP_HSW]
    sy = (y + dy * -p[SP_SHIFT]) / p[SP_HSW] * p[SP_ASPECT]
    pixel_x = (sx + 1.0) * 0.5 * p[SP_XRES] - p[SP_RMINX]
    pixel_y = (-sy + 1.0) * 0.5 * p[SP_YRES] - p[SP_RMINY]
    xr, yr = p[SP_XRES_R], p[SP_YRES_R]
    ok &= (pixel_x >= 0.0) & (pixel_x < xr) & (pixel_y >= 0.0) & (pixel_y < yr)
    lin = _floor_clip(pixel_y, yr - 1.0) * xr + _floor_clip(pixel_x, xr - 1.0)
    lin = torch.where(torch.isfinite(lin), lin, 0.0).to(torch.int32)

    inv_unit = p[SP_INV_UNIT]
    lcx = -ap[..., 0] * 0.1 * inv_unit
    lcy = -ap[..., 1] * 0.1 * inv_unit
    cw = [p[SP_ROT + 3 * k] * lcx + p[SP_ROT + 3 * k + 1] * lcy
          + p[SP_TRANS + k] for k in range(3)]
    occ = _occlude_spheres(pwx, pwy, pwz, *cw, spheres)
    ok &= ~(occ & (sky < 0.5))
    return lin, ok


def _splat_lens_consts(lens: PolyLens, device) -> torch.Tensor:
    """[8] f32 lens constants of the splat kernel, formed in double on the
    host as the TPU kernel's baked immediates were."""
    R = lens.outer_pupil_curvature_radius
    return torch.tensor([
        R, R * R, abs(R), lens.outer_pupil_radius ** 2,
        lens.back_focal_length + lens.lens_length, lens.back_focal_length,
        1.0 / lens.aperture_z, lens.inner_pupil_radius ** 2,
    ], dtype=torch.float32, device=device)


def po_splat(lens: PolyLens, pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, sky,
             params, spheres, iterations: int = 3):
    """K3 wrapper.  Per-slot inputs are f32 [S] (camera-space point, world
    point, sky flag) and int32 [S] (seed, counter: uint32 bits);
    ``params`` is :func:`splat_kernel_params`, ``spheres`` f32 [n, 4].
    Returns (lin int32 [S], ok bool [S])."""
    dev = pcx.device
    s = pcx.shape[0]
    for name, t in (("pcx", pcx), ("pcy", pcy), ("pcz", pcz), ("pwx", pwx),
                    ("pwy", pwy), ("pwz", pwz), ("sky", sky)):
        _check(name, t, torch.float32, dev, (s,))
    _check("seed", seed, torch.int32, dev, (s,))
    _check("ctr", ctr, torch.int32, dev, (s,))
    _check("params", params, torch.float32, dev, (SPLAT_PARAM_COUNT,))
    _check("spheres", spheres, torch.float32, dev, (spheres.shape[0], 4))
    if lens.device != dev:
        raise ValueError(f"lens on {lens.device}, slots on {dev}")
    if dev.type == "cpu":
        return po_splat_plain(lens, pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr,
                              sky, params, spheres, iterations)
    if not torch.equal(lens.pt.exponents, lens.ap.exponents):
        raise ValueError(
            f"lens {lens.name!r}: pt/ap term sets must be shared for the "
            "splat kernel (refit with a common term set)")
    exps = _exps_i8(lens.pt, dev)
    coeffs = torch.cat([lens.ap.coeffs[:2], lens.pt.coeffs[:5]]).contiguous()
    cond = _cond(lens, dev)
    lensc = _splat_lens_consts(lens, dev)
    lin = torch.empty((s,), dtype=torch.int32, device=dev)
    ok = torch.empty((s,), dtype=torch.bool, device=dev)
    err = _build.lib().pota_po_splat(
        pcx.data_ptr(), pcy.data_ptr(), pcz.data_ptr(), pwx.data_ptr(),
        pwy.data_ptr(), pwz.data_ptr(), seed.data_ptr(), ctr.data_ptr(),
        sky.data_ptr(), s, exps.data_ptr(), coeffs.data_ptr(),
        coeffs.shape[1], cond.data_ptr(), lensc.data_ptr(),
        CHARTS.index(lens.outer_chart), int(iterations), params.data_ptr(),
        spheres.data_ptr(), spheres.shape[0], lin.data_ptr(), ok.data_ptr(),
        _stream(dev))
    _build.check(err, "po_splat")
    _build.LAUNCHES["po_splat"] += 1
    return lin, ok
