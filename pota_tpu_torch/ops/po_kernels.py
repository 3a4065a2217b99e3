"""Polynomial-optics and thin-lens kernels K1-K3, K5 and K6 with their
plain PyTorch versions.

Each wrapper takes the plain version for CPU tensors and launches its CUDA
kernel (``csrc/``) for CUDA tensors; there is no fallback between the two.
The plain versions are the same functions written with the port's tensor
code, and are what the CPU tests hold against the JAX package.

* :func:`po_forward` — K1, the PO forward trace
  (``pota_tpu/ops/po_pallas.py::build_po_forward_kernel``), on the table
  :func:`fold_forward_tables` folds at the frame's wavelength.  K1 has
  two modes: the candidate mode, :func:`po_forward` (the caller hands
  every candidate; :class:`ForwardFn` with a gradient), which the image
  bokeh takes, and the select mode, :func:`po_forward_selected` (K1 draws
  each ray's aperture candidates itself, selects the first that passes the
  pupil crops and hands back the ray; :class:`SelectFn` with a gradient),
  which every other trace with depth of field takes; and
  :func:`po_forward_vjp` — K1v, its VJP on the same table (no TPU kernel:
  JAX differentiates its pure path), which :class:`ForwardFn` binds as
  K1's gradient, with its select mode :func:`po_forward_vjp_selected`,
  which :class:`SelectFn` binds; and
  :func:`po_forward_jvp` — K1j, K1's function with its Jacobian in the
  sensor point (no TPU kernel: JAX takes ``jax.jvp`` of its pure path), for
  the PO ray differentials;
* :func:`expand` — K2, compact source table -> queue slots
  (``po_pallas.py::build_expand_kernel``), and :class:`ExpandFn`, K2 with
  the linear transpose JAX defines for it, for the differentiable splat;
* :func:`po_splat` — K3, the per-slot backward splat with in-kernel aperture
  sampling (``po_pallas.py::build_po_splat_kernel``, ``sample_aperture=True``),
  and K3b, its variants :func:`po_splat_lam` (a wavelength per slot,
  ``lam_input=True``) and :func:`po_splat_ext` (the aperture point and
  wavelength per slot, ``sample_aperture=False``), the wavelengths picked
  per slot from one to three folded tables;
* :func:`tl_splat` — K5, the thin-lens backward splat
  (``po_pallas.py::build_tl_splat_kernel``);
* :func:`po_backward` — K6, the PO backward solve alone
  (``po_pallas.py::build_po_backward_kernel``), for the decomposed splat,
  on one table :func:`fold_solve_tables` folds per wavelength.

On the card every PO kernel (K1, K3, K3b, K6) takes only fits whose terms
lie on the degree-5 basis the folds use; :func:`check_basis` refuses
another before a frame starts.  The plain versions take any fit.

The kernels compute values only.  A wrapper handed a tensor (or a lens
whose coefficients) that requires grad while grad mode is on raises
``RuntimeError`` (:func:`_refuse_grad`): its output would be cut off from
the graph.  The differentiable routes call them under ``no_grad`` or inside
an ``autograd.Function`` (:class:`ForwardFn`, :class:`SelectFn`,
:class:`ExpandFn`, ``splat_accum.AccumFn``).
"""
from __future__ import annotations

import itertools
import math
import struct
import weakref

import torch

from ..optics import geometry as geo
from ..optics import samplers
from ..optics.geometry import CHARTS
from ..optics.polynomial import (
    PolyLens,
    _solve2,
    aperture_solve_vjp,
    inner_pupil_ok,
    lt_sample_aperture,
    poly_eval,
    pt_evaluate,
    pt_sample_aperture,
)
from ..optics.thinlens import image_dist_focusdist
from ..utils import rng as prng
from ..utils import trace
from ..utils.trace import span
from . import _build

# ---------------------------------------------------------------- table rows
# compact source table: f32 rows and int32 rows side by side
TF_PCX, TF_PCY, TF_PCZ = 0, 1, 2
TF_PWX, TF_PWY, TF_PWZ = 3, 4, 5
TF_SKY = 6
TF_R, TF_G, TF_B, TF_A = 7, 8, 9, 10
TF_Z = 11
TF_ROWS = 12
TF_TIME = TF_ROWS   # the shutter time, a row only under motion blur
TI_PX, TI_PY, TI_START, TI_SID = 0, 1, 2, 3
TI_ROWS = 4

# per-frame scalar layout of the splat kernel (po_pallas.py _SP_*)
SPLAT_PARAM_COUNT = 32
SP_ROT, SP_TRANS = 0, 9
SP_XRES, SP_YRES, SP_RMINX, SP_RMINY = 12, 13, 14, 15
SP_XRES_R, SP_YRES_R, SP_INV_UNIT, SP_SHIFT = 16, 17, 18, 19
SP_HSW, SP_ASPECT, SP_AP_RADIUS, SP_LAMBDA = 20, 21, 22, 23
SP_TL_APR, SP_TL_F, SP_TL_IDFD, SP_TL_ANAM = 27, 28, 29, 30


def splat_kernel_params(cfg, rc, po_state, cam_to_world) -> torch.Tensor:
    """The per-frame scalars the splat kernels read ([32] f32, the layout of
    ``po_pallas.py::splat_kernel_params``); a thin-lens frame passes
    ``po_state=None``."""
    m = cam_to_world.to(torch.float32)
    ca = cfg.abb_chromatic
    if po_state is not None:
        ap_radius, shift = po_state.aperture_radius, po_state.sensor_shift
    else:
        ap_radius = shift = 0.0
    trace.host_write(m.device)
    tail = torch.tensor([
        rc.xres, rc.yres, rc.region_min_x, rc.region_min_y,
        rc.xres_region, rc.yres_region,
        1.0 / cfg.unit_scale_filter, shift,
        cfg.sensor_width * 0.5, rc.xres / rc.yres,
        ap_radius, cfg.lambda_um,
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


def _refuse_grad(name, *tensors, lens=None) -> None:
    """``RuntimeError`` if grad mode is on and a tensor of ``tensors`` (or
    a coefficient tensor of ``lens``) requires grad: a kernel writes into
    fresh tensors, so its result would carry no gradient."""
    if not torch.is_grad_enabled():
        return
    if lens is not None:
        tensors += (lens.pt.coeffs, lens.ap.coeffs)
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel computes values "
            "only; call it under torch.no_grad() or through its "
            "autograd.Function")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_shared_conditioning(lens: PolyLens) -> None:
    """The folded tables condition every variable with one set of scales
    and shifts, so pt and ap must share it."""
    for a, b in ((lens.pt.in_scale, lens.ap.in_scale),
                 (lens.pt.in_shift, lens.ap.in_shift)):
        trace.host_read(a)
        if not torch.equal(a, b):
            raise ValueError(f"lens {lens.name!r}: pt and ap must share "
                             "their input conditioning for the kernels")


# the most folded solve tables K3b and K6 take at once: one wavelength a
# frame, or the three chroma wavelengths (csrc/po_solve_basis.cuh
# kMaxSolveTables)
MAX_SOLVE_TABLES = 3


def _check_lams(lams, lam_idx, device, n) -> tuple:
    """K3b's and K6's wavelength arguments: ``lams`` one wavelength (um)
    and ``lam_idx`` None, or up to :data:`MAX_SOLVE_TABLES` and ``lam_idx``
    int32 [n] on ``device``.  Returns ``lams`` as a tuple of floats."""
    lams = tuple(float(lam) for lam in lams)
    if (not 1 <= len(lams) <= MAX_SOLVE_TABLES
            or (lam_idx is None) != (len(lams) == 1)):
        raise ValueError(
            f"lams {lams}: one wavelength without lam_idx, or up to "
            f"{MAX_SOLVE_TABLES} with an int32 lam_idx")
    if lam_idx is not None:
        _check("lam_idx", lam_idx, torch.int32, device, (n,))
    return lams


def _lam_per_item(lams, lam_idx, like) -> torch.Tensor:
    """Item ``i``'s wavelength ``lams[lam_idx[i]]``, or ``lams[0]`` when
    ``lam_idx`` is None, in ``like``'s dtype and on its device."""
    lam_tab = torch.tensor(lams, dtype=like.dtype, device=like.device)
    return lam_tab[0] if lam_idx is None else lam_tab[lam_idx.long()]


# ------------------------------------------------------------- K2: expand


def expand_plain(src, table_f, table_i):
    """Plain K2: ``ex[r, s] = table[r, src[s]]`` for both tables."""
    idx = src.to(torch.int64)
    return table_f[:, idx], table_i[:, idx]


@span("pota.k2")
def expand(src, table_f, table_i):
    """K2 wrapper.  ``src`` int32 [S] indexes the columns of ``table_f`` f32
    [Rf, N] and ``table_i`` int32 [Ri, N]; returns ([Rf, S], [Ri, S])."""
    _refuse_grad("expand", src, table_f, table_i)
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


# the row length of range_sums' scans: PyTorch scans each row of a 2-D
# tensor in a fixed order, where a whole 1-D CUDA tensor takes CUB's
# decoupled look-back, whose float sums follow the blocks' timing
SCAN_BLOCK = 1024


def _prefix_f64(v):
    """Inclusive prefix sum of a float64 vector, the same bits on every
    run: rows of :data:`SCAN_BLOCK` scanned in place (two rows at least, so
    that the scan is a 2-D one), each row's total carried by the same scan
    one level up."""
    m = v.numel()
    rows = max(2, -(-m // SCAN_BLOCK))
    w = torch.zeros(rows * SCAN_BLOCK, dtype=torch.float64, device=v.device)
    w[:m] = v
    wb = w.view(rows, SCAN_BLOCK)
    wb.cumsum_(1)
    if m > SCAN_BLOCK:
        wb[1:] += _prefix_f64(wb[:, -1])[:-1, None]
    return w[:m]


def range_sums(x, bounds, rows=None):
    """``out[:, j] = x[:, bounds[0, j]:bounds[1, j]].sum(1)`` for ``x``
    [R, S] and int32 ``bounds`` [2, n] (each within [0, S]; an empty range
    sums to 0), summed in float64 and rounded once to ``x``'s dtype, with
    the same bits on every run: no atomics, and no 1-D scan of the whole
    queue (:data:`SCAN_BLOCK`, :func:`_prefix_f64`).  ``rows`` (default
    all) are the rows summed; the others are 0.  A row at a time: its
    float64 prefix sums, and each range the difference of two of them, so
    a slot outside every range adds to no sum."""
    r, s = x.shape
    blocks = max(2, -(-s // SCAN_BLOCK))
    dev = x.device
    # z[i]: x[:i] summed (z[0] = 0; past S, what the last block leaves)
    z = torch.zeros(blocks * SCAN_BLOCK + 1, dtype=torch.float64,
                    device=dev)
    zb = z[1:].view(blocks, SCAN_BLOCK)
    out = (torch.empty if rows is None else torch.zeros)(
        (r, bounds.shape[1]), dtype=x.dtype, device=dev)
    acc = torch.empty(bounds.shape[1], dtype=torch.float64, device=dev)
    tmp = torch.empty_like(acc)
    for k in range(r) if rows is None else rows:
        z[1:s + 1] = x[k]
        zb.cumsum_(1)
        zb[1:] += _prefix_f64(zb[:-1, -1])[:, None]
        torch.index_select(z, 0, bounds[1], out=acc)
        acc -= torch.index_select(z, 0, bounds[0], out=tmp)
        out[k] = acc
    return out


class ExpandFn(torch.autograd.Function):
    """K2 with a gradient for ``table_f``: ``ExpandFn.apply(table_f, src,
    table_i, bounds, expand_impl[, rows])`` returns ``expand_impl(src,
    table_f, table_i)`` (a kernel set's ``expand``: the kernel on the card,
    the plain version on the CPU).

    The backward is JAX's transpose (``_expand_differentiable``,
    ``pota_tpu/render/splat.py:282-325``): the gradient of a table column
    is the sum of ``d_ex_f`` over the slots that read it, the source's
    contiguous slot range ``bounds[:, j]`` (int32 [2, n], [start, end) cut
    at the queue's live end ``min(offs[-1], S)``: a slot past it, which
    reads the last source, contributes nothing; a column with no slot gets
    0).  :func:`range_sums` sums each range in float64, not in JAX's
    float32 prefix difference, which loses per-source totals once the
    queue passes 2^24 slots, and gives the same bits on every run.
    ``rows`` (default all) names the rows of ``table_f`` whose values
    carry a gradient (the source table's, :func:`render.splat._source_table`):
    only those are summed, the others' gradient is 0.  ``src``, ``table_i``
    and ``bounds`` are indices and get no gradient; ``bounds`` may be None
    where no gradient is asked for."""

    @staticmethod
    def forward(ctx, table_f, src, table_i, bounds, expand_impl, rows=None):
        ctx.save_for_backward(bounds)
        ctx.rows = rows
        ex_f, ex_i = expand_impl(src, table_f.detach(), table_i)
        ctx.mark_non_differentiable(ex_i)
        return ex_f, ex_i

    @staticmethod
    @span("pota.expand.vjp")
    def backward(ctx, d_ex_f, _d_ex_i):
        (bounds,) = ctx.saved_tensors
        return (range_sums(d_ex_f, bounds, ctx.rows), None, None, None, None,
                None)


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


def _pixel_lin(pixel_x, pixel_y, p):
    """In-region test and linear pixel index of the splat kernels."""
    xr, yr = p[SP_XRES_R], p[SP_YRES_R]
    inside = ((pixel_x >= 0.0) & (pixel_x < xr) & (pixel_y >= 0.0)
              & (pixel_y < yr))
    lin = _floor_clip(pixel_y, yr - 1.0) * xr + _floor_clip(pixel_x, xr - 1.0)
    lin = torch.where(torch.isfinite(lin), lin, 0.0).to(torch.int32)
    return lin, inside


def _lens_point_ws(lcx, lcy, p):
    """Camera-space lens point (z = 0) -> world, by the params' matrix."""
    return [p[SP_ROT + 3 * k] * lcx + p[SP_ROT + 3 * k + 1] * lcy
            + p[SP_TRANS + k] for k in range(3)]


def _disk_aperture(seed, ctr, radius):
    """The (seed, counter) stream's concentric disk point times ``radius``
    (``seed`` / ``ctr`` hold uint32 words in int32 or int64 tensors)."""
    u = prng.uniforms(seed.to(torch.int64) & prng.MASK32,
                      ctr.to(torch.int64) & prng.MASK32, 2)
    disk = samplers.concentric_disk_sample(u[..., 0], u[..., 1]) * radius
    return disk[..., 0], disk[..., 1]


def po_splat_plain(lens: PolyLens, pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr,
                   sky, params, spheres, lam_um: float, iterations: int = 3):
    """Plain K3: disk aperture from (seed, counter), the frame's one
    wavelength ``lam_um`` (um).  Returns (lin int32 [S], ok bool [S])."""
    ax, ay = _disk_aperture(seed, ctr, params[SP_AP_RADIUS])
    return po_splat_ext_plain(lens, pcx, pcy, pcz, pwx, pwy, pwz, ax, ay,
                              (lam_um,), None, sky, params, spheres,
                              iterations)


def po_splat_lam_plain(lens: PolyLens, pcx, pcy, pcz, pwx, pwy, pwz, seed,
                       ctr, lams, lam_idx, sky, params, spheres,
                       iterations: int = 3):
    """Plain K3b ``lam_input`` variant: disk aperture from (seed, counter),
    slot ``i`` at the wavelength ``lams[lam_idx[i]]`` (um; ``lams[0]`` when
    ``lam_idx`` is None)."""
    ax, ay = _disk_aperture(seed, ctr, params[SP_AP_RADIUS])
    return po_splat_ext_plain(lens, pcx, pcy, pcz, pwx, pwy, pwz, ax, ay,
                              lams, lam_idx, sky, params, spheres, iterations)


def po_splat_ext_plain(lens: PolyLens, pcx, pcy, pcz, pwx, pwy, pwz, ax, ay,
                       lams, lam_idx, sky, params, spheres,
                       iterations: int = 3):
    """Plain K3b external-aperture variant: the PO splat for the aperture
    point ``ax, ay`` (mm) of each slot at the wavelength ``lams[lam_idx[i]]``
    (um; ``lams[0]`` when ``lam_idx`` is None), formed in the points' dtype,
    composed of ``lt_sample_aperture`` on the fit's own terms, the pupil
    crops, the pixel map and the occlusion probe (as JAX's decomposed path
    is).  The other two plain variants draw the aperture point first and
    call it.  Returns (lin int32 [S], ok bool [S])."""
    p = params
    target = torch.stack([pcx * -10.0, pcy * -10.0, pcz * -10.0], -1)
    sensor5, _, trans = lt_sample_aperture(
        lens, target, torch.stack([ax, ay], -1),
        _lam_per_item(lams, lam_idx, pcx), iterations=iterations)
    ok = (trans > 0.0) & inner_pupil_ok(lens, sensor5)
    x, y, dx, dy = (sensor5[..., k] for k in range(4))
    sx = (x + dx * -p[SP_SHIFT]) / p[SP_HSW]
    sy = (y + dy * -p[SP_SHIFT]) / p[SP_HSW] * p[SP_ASPECT]
    pixel_x = (sx + 1.0) * 0.5 * p[SP_XRES] - p[SP_RMINX]
    pixel_y = (-sy + 1.0) * 0.5 * p[SP_YRES] - p[SP_RMINY]
    lin, inside = _pixel_lin(pixel_x, pixel_y, p)
    ok &= inside

    inv_unit = p[SP_INV_UNIT]
    cw = _lens_point_ws(-ax * 0.1 * inv_unit, -ay * 0.1 * inv_unit, p)
    occ = _occlude_spheres(pwx, pwy, pwz, *cw, spheres)
    ok &= ~(occ & (sky < 0.5))
    return lin, ok


def _splat_lens_consts(lens: PolyLens, device) -> torch.Tensor:
    """[8] f32 lens constants of the splat kernel, formed in double on the
    host as the TPU kernel's baked immediates were."""
    R = lens.outer_pupil_curvature_radius
    trace.host_write(device)
    return torch.tensor([
        R, R * R, abs(R), lens.outer_pupil_radius ** 2,
        lens.back_focal_length + lens.lens_length, lens.back_focal_length,
        1.0 / lens.aperture_z, lens.inner_pupil_radius ** 2,
    ], dtype=torch.float32, device=device)


# ------------------------------------ the folded solve table (K3, K3b, K6)
# With one wavelength per frame, every term's lambda power folds into its
# coefficient, and the solve's polynomial becomes one over the complete
# degree-<=5 basis in the four unknowns (x, y, dx, dy): 126 monomials, known
# at compile time, walked in this order by csrc/po_solve_basis.cuh (kExps).
BASIS_DEGREE = 5
BASIS = tuple((a, b, c, d)
              for a in range(BASIS_DEGREE + 1)
              for b in range(BASIS_DEGREE + 1 - a)
              for c in range(BASIS_DEGREE + 1 - a - b)
              for d in range(BASIS_DEGREE + 1 - a - b - c))
_BASIS_POS = {m: i for i, m in enumerate(BASIS)}
# the monomials of degree <= 4, whose Jacobian rows the table carries
_LOW = [i for i, m in enumerate(BASIS) if sum(m) < BASIS_DEGREE]
_HIGH = [i for i, m in enumerate(BASIS) if sum(m) == BASIS_DEGREE]
# d/du_v of c[m + e_v] u^(m + e_v) is (m_v + 1) c[m + e_v] u^m
_UP = [[_BASIS_POS[tuple(a + (k == v) for k, a in enumerate(BASIS[i]))]
        for v in range(4)] for i in _LOW]
_UP_MULT = [[BASIS[i][v] + 1.0 for v in range(4)] for i in _LOW]
# Table layout (f32): a header of the unknowns' conditioning scale[4],
# shift[4]; then per monomial, in basis order, a block of values in the slot
# order FOLD_SLOTS (o0, o1, trans, apx, apy, o2, o3, 0: the final evaluation
# reads the first four only), followed, for a monomial of degree <= 4, by
# the derivatives d(row)/d(raw unknown v) at [8 + 4 * row + v] for the six
# Newton rows apx, apy, o0..o3.  Blocks are 32 floats (degree <= 4) or 8,
# so every block starts on a 16-byte boundary.
FOLD_HEADER, FOLD_LOW_STRIDE, FOLD_HIGH_STRIDE = 8, 32, 8
FOLD_SLOTS = (3, 4, 0, 1, 5, 6, 2)   # slot of apx, apy, o0..o3, trans
_BLOCK_OFF = list(itertools.accumulate(
    (FOLD_LOW_STRIDE if sum(m) < BASIS_DEGREE else FOLD_HIGH_STRIDE
     for m in BASIS[:-1]), initial=FOLD_HEADER))
FOLD_TABLE_FLOATS = _BLOCK_OFF[-1] + FOLD_HIGH_STRIDE   # the last is x^5


def _basis_positions(lens: PolyLens, fn) -> list:
    """Each term's index in :data:`BASIS` by its exponents of (x, y, dx,
    dy), read to the host; ``ValueError`` for a term outside the basis."""
    trace.host_read(fn.exponents)
    pos = [_BASIS_POS.get(tuple(e[:4])) for e in fn.exponents.cpu().tolist()]
    if None in pos:
        raise ValueError(
            f"lens {lens.name!r}: a term's monomial in (x, y, dx, dy) lies "
            f"outside the degree-{BASIS_DEGREE} basis of the folded kernels "
            "(K1, K3, K3b, K6)")
    return pos


def _fold_conditioning(lens: PolyLens, lam_um: float, device):
    """float64 scale [5] and shift [5] of the inputs (one set for ap and pt,
    as the kernels take it) and the conditioned wavelength, on ``device``."""
    _check_shared_conditioning(lens)
    f64 = dict(device=device, dtype=torch.float64)
    scale = lens.pt.in_scale.to(**f64)
    shift = lens.pt.in_shift.to(**f64)
    return scale, shift, (float(lam_um) - shift[4]) * scale[4]


def _fold_rows(lens: PolyLens, fn, n_rows: int, ul) -> torch.Tensor:
    """The first ``n_rows`` coefficient rows of ``fn`` with each term's
    conditioned wavelength power ``ul ** e_4`` folded in, summed onto
    :data:`BASIS` by the term's own exponents: float64 [n_rows, 126] on
    ``ul``'s device."""
    dev = ul.device
    pos = _basis_positions(lens, fn)
    trace.host_write(dev)
    pos = torch.tensor(pos, device=dev)
    lam_pow = ul ** fn.exponents[:, 4].to(dev, torch.float64)
    rows = fn.coeffs[:n_rows].to(dev, torch.float64) * lam_pow
    return torch.zeros((n_rows, len(BASIS)), dtype=torch.float64,
                       device=dev).index_add_(1, pos, rows)


def fold_solve_tables(lens: PolyLens, lam_um: float, device) -> torch.Tensor:
    """The backward solve's tables for one wavelength ``lam_um`` (um), as
    K3, K3b and K6 read them: f32 [FOLD_TABLE_FLOATS]
    on ``device`` (layout above).

    Folds the conditioned wavelength's power ``((lam - shift_4) * scale_4)
    ** e_4`` into each coefficient of ap's rows apx, apy and pt's rows
    o0..o3, trans, sums the terms onto :data:`BASIS` (:func:`_fold_rows`),
    and forms the Newton rows' derivative tables ``(m_v + 1) * c[m + e_v]
    * scale_v``.  Computes in float64 on ``device`` and casts to f32 at the
    end.  Reads the exponents to the host.  Raises ``ValueError`` for a
    lens whose folded monomials fall outside the basis."""
    dev = torch.device(device)
    scale, shift, ul = _fold_conditioning(lens, lam_um, dev)
    folded = torch.cat([_fold_rows(lens, lens.ap, 2, ul),
                        _fold_rows(lens, lens.pt, 5, ul)])
    f64 = dict(device=dev, dtype=torch.float64)
    # the six index tables below, each copied to the device
    trace.host_write(dev, 6)
    slots = torch.tensor(FOLD_SLOTS, device=dev)
    vals = torch.zeros((len(BASIS), 8), **f64)
    vals[:, slots] = folded.T
    low_i = torch.tensor(_LOW, device=dev)
    # [70, 6 rows, 4 unknowns]
    der = (folded[:6, torch.tensor(_UP, device=dev)].permute(1, 0, 2)
           * torch.tensor(_UP_MULT, **f64)[:, None, :] * scale[:4])
    low = torch.cat([vals[low_i], der.reshape(len(_LOW), 24)], 1)
    off = torch.tensor(_BLOCK_OFF, device=dev)
    table = torch.zeros((FOLD_TABLE_FLOATS,), **f64)
    table[:4] = scale[:4]
    table[4:8] = shift[:4]
    table[off[low_i][:, None] + torch.arange(FOLD_LOW_STRIDE, device=dev)] = low
    high_i = torch.tensor(_HIGH, device=dev)
    table[off[high_i][:, None]
          + torch.arange(FOLD_HIGH_STRIDE, device=dev)] = vals[high_i]
    return table.to(torch.float32)


# ------------------------------------------ the folded forward table (K1)
# K1's two polynomials folded at the frame's wavelength onto BASIS, each by
# its own term set, as csrc/po_forward_basis.cuh reads them (fwd::k*).
# Table layout (f32): a header of the unknowns' conditioning scale[4],
# shift[4]; ap's rows (apx, apy) per monomial in basis order; pt's rows
# (o0, o1, o2, o3) per monomial; pt's trans per monomial, padded to a
# multiple of 4.  Every section starts on 16 bytes.
FWD_HEADER = 8
FWD_AP = FWD_HEADER
FWD_PT = FWD_AP + 2 * len(BASIS)
FWD_TRANS = FWD_PT + 4 * len(BASIS)
FWD_TABLE_FLOATS = FWD_TRANS + -(-len(BASIS) // 4) * 4
# the rows of K1's polynomials, ap's (apx, apy) then pt's (o0..o3, trans):
# the rows of K1v's folded cotangents (csrc/po_forward_vjp.cu kRows)
FWD_AP_ROWS, FWD_PT_ROWS = 2, 5


def _forward_rows(lens: PolyLens, lam_um: float, device):
    """K1's two polynomials folded at ``lam_um`` (um) onto :data:`BASIS`,
    float64 on ``device``: (scale [5], shift [5], ap [2, 126], pt [5,
    126])."""
    scale, shift, ul = _fold_conditioning(lens, lam_um, device)
    return (scale, shift, _fold_rows(lens, lens.ap, FWD_AP_ROWS, ul),
            _fold_rows(lens, lens.pt, FWD_PT_ROWS, ul))


def fold_forward_tables(lens: PolyLens, lam_um: float,
                        device) -> torch.Tensor:
    """K1's table for one wavelength ``lam_um`` (um): f32
    [FWD_TABLE_FLOATS] on ``device`` (layout above).  Folds the conditioned
    wavelength's power into each coefficient of ap's two rows and pt's five
    and sums each polynomial's terms onto :data:`BASIS` by its own term set
    (:func:`_fold_rows`).  Computes in float64 on ``device`` and casts to
    f32 at the end.  Reads the exponents to the host.  Raises
    ``ValueError`` for a lens whose folded monomials fall outside the
    basis.  K1v (:func:`po_forward_vjp`) reads the same table."""
    dev = torch.device(device)
    scale, shift, ap, pt = _forward_rows(lens, lam_um, dev)
    table = torch.zeros((FWD_TABLE_FLOATS,), dtype=torch.float64, device=dev)
    table[:4] = scale[:4]
    table[4:8] = shift[:4]
    table[FWD_AP:FWD_PT] = ap.T.reshape(-1)
    table[FWD_PT:FWD_TRANS] = pt[:4].T.reshape(-1)
    table[FWD_TRANS:FWD_TRANS + len(BASIS)] = pt[4]
    return table.to(torch.float32)


# ------------------------------------------------- the fold cache, the check
_FOLDS = {"solve": fold_solve_tables, "forward": fold_forward_tables}
# per lens: (the fit's buffer versions, {key: folded tables, or the basis
# check's verdict})
_FOLD_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _fold_cache(lens: PolyLens) -> dict:
    """The lens's cache, emptied when a buffer of the fit is replaced or
    changed in place."""
    sig = tuple((t.data_ptr(), t._version) for t in (
        lens.ap.coeffs, lens.pt.coeffs, lens.pt.exponents, lens.ap.exponents,
        lens.pt.in_scale, lens.pt.in_shift, lens.ap.in_scale,
        lens.ap.in_shift))
    hit = _FOLD_CACHE.get(lens)
    if hit is None or hit[0] != sig:
        hit = _FOLD_CACHE[lens] = (sig, {})
    return hit[1]


def _cached(lens: PolyLens, key: tuple, make):
    """The value under ``key`` in the lens's fold cache (looked up through
    the module's :func:`_fold_cache`), made by ``make()`` without a graph
    where the cache lacks it.  ``key[0]`` names the look-up (``basis``,
    ``forward``, ``solve``, ``unfold``, ``forward_vjp``); a miss runs in a
    ``pota.fold`` span and counts in the counter ``folds.<key[0]>``."""
    cache = _fold_cache(lens)
    if key not in cache:
        trace.count(f"folds.{key[0]}")
        with span("pota.fold"), torch.no_grad():
            cache[key] = make()
    return cache[key]


def _folded_table(lens: PolyLens, kind: str, lams, device,
                  on_fold=None) -> torch.Tensor:
    """The ``kind`` tables of ``lens`` (``"solve"``:
    :func:`fold_solve_tables`, ``"forward"``: :func:`fold_forward_tables`)
    at each wavelength of ``lams`` (um), one after another, on ``device``.
    Folded once per lens, kind, wavelengths and device (and again when a
    buffer of the fit changes), so a frame reads nothing back from the card
    after the first; K3, K3b and K6 share the solve tables.  The tables
    are folded without a graph, from the coefficients' values: an in-place
    update of coefficients that require grad (a gradient step under
    ``no_grad``) bumps their version, so the next frame folds again.
    ``on_fold``, if given, runs before a fold."""
    key = (kind, tuple(float(lam) for lam in lams), str(device))

    def fold():
        if on_fold is not None:
            on_fold()
        return torch.cat([_FOLDS[kind](lens, lam, device) for lam in key[1]])
    return _cached(lens, key, fold)


def check_basis(lens: PolyLens) -> None:
    """Raise ``ValueError`` (the folds' message) unless every term of the
    fit's ``ap`` and ``pt`` is a monomial of :data:`BASIS` in (x, y, dx,
    dy): the fits the card's PO kernels K1, K3, K3b and K6 take.
    Reads the exponents to the host once per lens and buffer version."""
    def check():
        for fn in (lens.ap, lens.pt):
            _basis_positions(lens, fn)
        return True
    _cached(lens, ("basis",), check)


# ------------------------------------------------------- K1: PO forward trace


def _fma(a, b, c):
    """``fmaf(a, b, c)`` of float32 tensors: the product is exact in
    float64, so the sum is rounded once (to float64, then to float32: the
    two roundings differ from one only on float32 ties)."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _basis_walk(u):
    """Yield (k, c, d, value) for every monomial x^a y^b dx^c dy^d of
    :data:`BASIS` in order, the value formed by running products as
    ``basis::for_each_monomial`` forms it; a None in ``u`` is the literal
    1, which the kernel multiplies away."""
    mul = lambda p, v: p if v is None else p * v
    k = 0
    pa = torch.ones_like(u[0])
    for a in range(BASIS_DEGREE + 1):
        pb = pa
        for b in range(BASIS_DEGREE + 1 - a):
            pc = pb
            for c in range(BASIS_DEGREE + 1 - a - b):
                pd = pc
                for d in range(BASIS_DEGREE + 1 - a - b - c):
                    yield k, c, d, pd
                    k += 1
                    pd = mul(pd, u[3])
                pc = mul(pc, u[2])
            pb = mul(pb, u[1])
        pa = mul(pa, u[0])


# the 21 monomials dx^c dy^d of K1's collapsed ap rows (fwd::pair_index)
_PAIR = {(c, d): j for j, (c, d) in enumerate(
    (c, d) for c in range(BASIS_DEGREE + 1)
    for d in range(BASIS_DEGREE + 1 - c))}


def _pair_poly(A, u, v):
    """``fwd::pair_poly``: the value of sum A[pair(c, d)] u^c v^d and its
    partials along u and v, by nested Horner (A: [N, rows] per pair)."""
    top_d = BASIS_DEGREE
    p = A[_PAIR[(0, top_d)]]
    pu = pv = None
    for d in range(top_d - 1, -1, -1):
        top = top_d - d
        q, qu = A[_PAIR[(top, d)]], None
        for c in range(top - 1, -1, -1):
            qu = q if c == top - 1 else _fma(qu, u, q)
            q = _fma(q, u, A[_PAIR[(c, d)]])
        pv = p if d == top_d - 1 else _fma(pv, v, p)
        pu = qu if d == top_d - 1 else _fma(pu, v, qu)
        p = _fma(p, v, q)
    return p, pu, pv


def _po_forward_terms(lens: PolyLens, x, y, ax, ay, lam_um: float,
                      sensor_shift: float, iterations: int = 3):
    """K1's function on the fit's own term set: ``pt_sample_aperture`` for
    (dx, dy), the sensor shift, ``pt_evaluate``.  Returns (out4, trans,
    dx, dy) as :func:`po_forward_plain` does."""
    zero = torch.zeros_like(x)
    lam = torch.full_like(x, lam_um)
    solved = pt_sample_aperture(lens, torch.stack([x, y, zero, zero, lam], -1),
                                torch.stack([ax, ay], -1),
                                iterations=iterations)
    dx, dy = solved[..., 2], solved[..., 3]
    out4, trans = pt_evaluate(lens, torch.stack(
        [x + dx * sensor_shift, y + dy * sensor_shift, dx, dy, lam], -1))
    return out4.contiguous(), trans, dx.contiguous(), dy.contiguous()


def po_forward_plain(lens: PolyLens, x, y, ax, ay, lam_um: float,
                     sensor_shift: float, iterations: int = 3):
    """Plain K1: the kernel's arithmetic (``po_forward_trace`` of
    ``csrc/po_forward_basis.cuh``) in PyTorch, on the same table
    (:func:`fold_forward_tables` at the frame's wavelength ``lam_um``, um):
    ap collapsed to its 21 (dx, dy) coefficients, the 2x2 Newton on their
    Horner rows, the sensor shift, pt's rows over the basis, every float32
    operation in the kernel's order with its fused multiply-adds rounded
    once.  It computes what ``pt_sample_aperture`` then ``pt_evaluate``
    compute, with the kernel's rounding: a forward trace that rounds
    otherwise, even an exact one, moves grazing sphere hits and so the
    splats of whole highlight sources, which no frame parity absorbs.
    A fit outside the basis, which the card refuses, takes
    :func:`_po_forward_terms`.  Rays are f32 [M].
    Returns (out4 [M, 4], trans [M] >= 0, dx [M], dy [M])."""
    try:
        check_basis(lens)
    except ValueError:
        return _po_forward_terms(lens, x, y, ax, ay, lam_um, sensor_shift,
                                 iterations)
    t = _folded_table(lens, "forward", (lam_um,), x.device)
    s0, s1, s2, s3, h0, h1, h2, h3 = t[:FWD_HEADER]
    ap = t[FWD_AP:FWD_PT].view(-1, 2)
    A = [torch.zeros(x.shape + (2,), dtype=x.dtype, device=x.device)
         for _ in _PAIR]
    for k, c, d, xy in _basis_walk(((x - h0) * s0, (y - h1) * s1, None,
                                    None)):
        A[_PAIR[(c, d)]] = _fma(ap[k], xy[:, None], A[_PAIR[(c, d)]])
    inv_ap_z = torch.tensor(1.0 / lens.aperture_z, dtype=x.dtype,
                            device=x.device)
    dx = (ax - x) * inv_ap_z
    dy = (ay - y) * inv_ap_z
    for _ in range(iterations):
        p, pu, pv = _pair_poly(A, ((dx - h2) * s2)[:, None],
                               ((dy - h3) * s3)[:, None])
        j00, j10 = pu[:, 0] * s2, pu[:, 1] * s2
        j01, j11 = pv[:, 0] * s3, pv[:, 1] * s3
        r0, r1 = p[:, 0] - ax, p[:, 1] - ay
        det = _fma(j00, j11, -(j01 * j10))
        det = torch.where(det.abs() < 1e-12, 1e-12, det)
        dx = dx - _fma(j11, r0, -(j01 * r1)) / det
        dy = dy - _fma(-j10, r0, j00 * r1) / det
    shift = torch.tensor(sensor_shift, dtype=x.dtype, device=x.device)
    u = ((_fma(dx, shift, x) - h0) * s0, (_fma(dy, shift, y) - h1) * s1,
         (dx - h2) * s2, (dy - h3) * s3)
    pt_o = t[FWD_PT:FWD_TRANS].view(-1, 4)
    pt_t = t[FWD_TRANS:FWD_TRANS + len(BASIS)]
    out4 = torch.zeros(x.shape + (4,), dtype=x.dtype, device=x.device)
    trans = torch.zeros_like(x)
    for k, _, _, mono in _basis_walk(u):
        out4 = _fma(pt_o[k], mono[:, None], out4)
        trans = _fma(pt_t[k], mono, trans)
    return out4, torch.clamp(trans, min=0.0), dx, dy


@span("pota.k1")
def po_forward(lens: PolyLens, x, y, ax, ay, lam_um: float,
               sensor_shift: float, iterations: int = 3):
    """K1 wrapper: plain version on the CPU, the CUDA kernel on the card.
    Rays are f32 [M] contiguous, on the lens's device; ``lam_um`` is the
    frame's wavelength (um), at which the kernel's table is folded
    (:func:`fold_forward_tables`)."""
    _refuse_grad("po_forward", x, y, ax, ay, lens=lens)
    dev = x.device
    m = x.shape[0]
    for name, t in (("x", x), ("y", y), ("ax", ax), ("ay", ay)):
        _check(name, t, torch.float32, dev, (m,))
    if lens.device != dev:
        raise ValueError(f"lens on {lens.device}, rays on {dev}")
    if dev.type == "cpu":
        return po_forward_plain(lens, x, y, ax, ay, lam_um, sensor_shift,
                                iterations)
    table = _folded_table(lens, "forward", (lam_um,), dev)
    out4 = torch.empty((m, 4), dtype=torch.float32, device=dev)
    trans, dx, dy = (torch.empty((m,), dtype=torch.float32, device=dev)
                     for _ in range(3))
    err = _build.lib().pota_po_forward(
        x.data_ptr(), y.data_ptr(), ax.data_ptr(), ay.data_ptr(), m,
        table.data_ptr(), 1.0 / lens.aperture_z, float(sensor_shift),
        int(iterations), out4.data_ptr(), trans.data_ptr(), dx.data_ptr(),
        dy.data_ptr(), _stream(dev))
    _build.check(err, "po_forward")
    _build.LAUNCHES["po_forward"] += 1
    return out4, trans, dx, dy


# ------------------------- K1's candidates, as its select mode draws them


def aperture_sample(r1, r2, blades: int):
    """The PO camera's unit aperture point [..., 2] of the uniforms (r1,
    r2): the concentric disk with fewer than 2 blades, else the blade fan
    (ref src/lentil.h:312-324)."""
    if blades < 2:
        return samplers.concentric_disk_sample(r1, r2)
    return samplers.triangular_aperture_sample(r1, r2, 1.0, blades)


def candidate_rays(x, y, aperture):
    """K1's rays of N rays' K candidates, ray-major, [N * K] each and
    contiguous: the sensor point ``x, y`` [N] repeated, the aperture point
    ``aperture`` [N, K, 2] (mm)."""
    n, tries = aperture.shape[:2]
    rep = lambda a: a[:, None].expand(n, tries).reshape(-1)
    return (rep(x), rep(y), aperture[..., 0].reshape(-1).contiguous(),
            aperture[..., 1].reshape(-1).contiguous())


def drawn_rays(x, y, r1, r2, key, tries: int, radius: float, blades: int):
    """The candidates' rays that K1's select mode draws, in torch
    (``utils.rng.retry_uniforms``, :func:`aperture_sample` times
    ``radius``, :func:`candidate_rays`)."""
    aperture = aperture_sample(*prng.retry_uniforms(r1, r2, key, tries),
                               blades) * radius
    return candidate_rays(x, y, aperture)


def po_forward_drawn_plain(lens: PolyLens, x, y, r1, r2, key, tries: int,
                           radius: float, blades: int, lam_um: float,
                           sensor_shift: float, iterations: int = 3):
    """K1's plain candidates of N rays at the sensor points ``x, y``: the
    candidates drawn in torch (:func:`drawn_rays`), then
    :func:`po_forward_plain` on them.  Returns (out4 [N * K, 4], trans, dx,
    dy [N * K]) ray-major."""
    return po_forward_plain(lens, *drawn_rays(x, y, r1, r2, key, tries,
                                              radius, blades),
                            lam_um, sensor_shift, iterations)


# --------------------------------- K1's select mode: it hands back rays


def chart_rays(lens: PolyLens, out4, scale: float):
    """The outer pupil's chart ``out4`` [..., 4] (mm) to camera-space rays
    in scene units: ``chart_to_cs``, the scale ``scale`` (the camera's
    ``unit_scale_po``, negative: it reverses the rays and converts mm to
    units), the direction normalised.  Returns (origin [..., 3], direction
    [..., 3])."""
    R = lens.outer_pupil_curvature_radius
    origin, direction = geo.chart_to_cs(out4[..., :2], out4[..., 2:4], -R, R,
                                        lens.outer_chart)
    origin = origin * scale
    direction = direction * scale
    dir_n2 = torch.sum(direction * direction, -1, keepdim=True)
    return origin, direction / torch.sqrt(torch.clamp(dir_n2, min=1e-24))


def select_rays(lens: PolyLens, out4, trans, shifted, scale: float):
    """The PO trace's epilogue over each ray's K candidates: the crops
    (``trans > 0``, the outer pupil's radius, ``inner_pupil_ok`` at the
    shifted sensor point ``shifted`` [N, K, 4] = (xk, yk, dx, dy)), the
    first-success select (the lowest candidate that passes, candidate 0
    when none does), :func:`chart_rays` of its chart (``out4`` [N, K, 4]),
    the finite test.  Returns (origin [N, 3], direction [N, 3], weight [N]:
    1 where a candidate passed and the ray is finite, tries [N] int32: the
    candidate taken, K when none passed)."""
    n, n_tries = trans.shape
    ok = trans > 0.0
    ok &= out4[..., 0] ** 2 + out4[..., 1] ** 2 <= lens.outer_pupil_radius ** 2
    ok &= inner_pupil_ok(lens, shifted)

    # first-success select over the K candidates
    first = torch.argmax(ok.to(torch.int32), -1)
    any_ok = ok.any(-1)
    out_sel = torch.gather(out4, 1, first[:, None, None].expand(n, 1, 4))[:, 0]

    origin, direction = chart_rays(lens, out_sel, scale)

    finite = torch.all(torch.isfinite(origin) & torch.isfinite(direction), -1)
    weight = torch.where(any_ok & finite, 1.0, 0.0)
    tries = torch.where(any_ok, first, n_tries).to(torch.int32)
    return origin, direction, weight, tries


def _select_candidates(lens: PolyLens, x, y, cand, tries: int,
                       sensor_shift: float, scale: float, need_rays: bool):
    """:func:`select_rays` of K1's outputs ``cand`` = (out4, trans, dx, dy)
    on the rays' K candidates, ray-major, at the sensor points ``x, y``
    [N]; with ``need_rays`` also the selected candidate's (x, y, dx, dy
    [N], out4 [N, 4])."""
    n = x.shape[0]
    out4, trans, dx, dy = (t.reshape(n, tries, *t.shape[1:]) for t in cand)
    xk = x[:, None] + dx * sensor_shift
    yk = y[:, None] + dy * sensor_shift
    out = select_rays(lens, out4, trans, torch.stack([xk, yk, dx, dy], -1),
                      scale)
    if not need_rays:
        return out
    first = torch.where(out[3] == tries, 0, out[3]).long()[:, None]
    pick = lambda t: torch.gather(t, 1, first)[:, 0]
    out_sel = torch.gather(out4, 1, first[..., None].expand(n, 1, 4))[:, 0]
    return out + (x, y, pick(dx), pick(dy), out_sel)


def po_forward_selected_plain(lens: PolyLens, sx, sy, hsw: float, r1, r2,
                              key, tries: int, radius: float, blades: int,
                              lam_um: float, sensor_shift: float,
                              scale: float, iterations: int = 3,
                              need_rays: bool = False):
    """Plain K1 select mode: the sensor points ``sx * hsw``, ``sy * hsw``,
    the plain candidates (:func:`po_forward_drawn_plain`) on them, then the
    epilogue in torch (:func:`select_rays`).  Returns what
    :func:`po_forward_selected` returns."""
    x, y = sx * hsw, sy * hsw
    cand = po_forward_drawn_plain(lens, x, y, r1, r2, key, tries, radius,
                                  blades, lam_um, sensor_shift, iterations)
    return _select_candidates(lens, x, y, cand, tries, sensor_shift, scale,
                              need_rays)


def _f32(v: float) -> float:
    """``v`` rounded to float32, as torch rounds a Python scalar that meets
    a float32 tensor."""
    return struct.unpack("f", struct.pack("f", v))[0]


def _pupil_select(lens: PolyLens, scale: float) -> tuple:
    """The select mode's pupil constants (``csrc/po_chart.cuh``
    ``PupilSelect``, in its order): the chart's index in :data:`CHARTS`,
    then R, R ** 2, 1 / R, 1 / |R|, -R, the unit scale and the crops' outer
    radius squared, inner radius squared and back focal length, each the
    float32 that the torch epilogue's Python scalar becomes (a division by
    a scalar is a product with its float32 reciprocal)."""
    R = lens.outer_pupil_curvature_radius
    return (CHARTS.index(lens.outer_chart), _f32(R), _f32(R ** 2),
            _f32(1.0 / _f32(R)), _f32(1.0 / _f32(abs(R))), _f32(-R),
            _f32(scale), _f32(lens.outer_pupil_radius ** 2),
            _f32(lens.inner_pupil_radius ** 2),
            _f32(lens.back_focal_length))


@span("pota.k1")
def po_forward_selected(lens: PolyLens, sx, sy, hsw: float, r1, r2, key,
                        tries: int, radius: float, blades: int,
                        lam_um: float, sensor_shift: float, scale: float,
                        iterations: int = 3, need_rays: bool = False):
    """K1 in its select mode: K1 hands back each ray, not its candidates
    (``csrc/po_forward.cu``, ``pota_po_forward_selected``; its plain
    version on the CPU).  The sensor point ``sx * hsw, sy * hsw``, the K =
    ``tries`` candidates drawn as :func:`drawn_rays` draws them in torch
    and traced until the first that passes the pupil crops, the chart of
    that one (of candidate 0 when none passes) mapped to the ray at the
    unit scale ``scale``: bit for bit the torch draw, K1's candidate mode
    and :func:`select_rays`.  ``sx, sy, r1, r2`` f32 [N] contiguous, the
    rays' aperture uniforms ``r1, r2``, their uint32 retry keys ``key``
    (int64 [N]; None when K is 1), ``hsw`` half the sensor width (mm),
    ``radius`` the aperture radius (mm), ``blades`` the aperture's blades
    (fewer than 2: the concentric disk), the rest as :func:`po_forward`
    takes it.  Counts one ``po_forward``
    launch, and the rays selected in ``k1.selected`` while a profiler
    records.  Returns (origin [N, 3], direction [N, 3], weight [N], tries
    [N] int32), and with ``need_rays`` the selected candidate's sensor
    point, solution and chart (x, y, dx, dy [N], out4 [N, 4]) after them,
    which K1v's select mode (:func:`po_forward_vjp_selected`) takes."""
    _refuse_grad("po_forward_selected", sx, sy, r1, r2, lens=lens)
    dev = sx.device
    n, tries, blades = sx.shape[0], int(tries), int(blades)
    for name, t in (("sx", sx), ("sy", sy), ("r1", r1), ("r2", r2)):
        _check(name, t, torch.float32, dev, (n,))
    if key is not None or tries > 1:
        _check("key", key, torch.int64, dev, (n,))
    if tries < 1 or n * tries >= 2 ** 31:
        raise ValueError(f"po_forward_selected: {n} rays of {tries} "
                         "candidates")
    if lens.device != dev:
        raise ValueError(f"lens on {lens.device}, rays on {dev}")
    trace.count("k1.selected", n)
    if dev.type == "cpu":
        return po_forward_selected_plain(lens, sx, sy, hsw, r1, r2, key,
                                         tries, radius, blades, lam_um,
                                         sensor_shift, scale, iterations,
                                         need_rays)
    table = _folded_table(lens, "forward", (lam_um,), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    origin, direction = (torch.empty((n, 3), **f32) for _ in range(2))
    weight = torch.empty((n,), **f32)
    tries_out = torch.empty((n,), dtype=torch.int32, device=dev)
    saved = (tuple(torch.empty((n,), **f32) for _ in range(4))
             + (torch.empty((n, 4), **f32),)) if need_rays else ()
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.lib().pota_po_forward_selected(
        sx.data_ptr(), sy.data_ptr(), float(hsw), r1.data_ptr(),
        r2.data_ptr(), ptr(key), n, tries, float(radius), blades,
        2.0 * math.pi / blades if blades >= 2 else 0.0, table.data_ptr(),
        1.0 / lens.aperture_z, float(sensor_shift), int(iterations),
        *_pupil_select(lens, scale), origin.data_ptr(), direction.data_ptr(),
        weight.data_ptr(), tries_out.data_ptr(),
        *(ptr(t) for t in saved or (None,) * 5), _stream(dev))
    _build.check(err, "po_forward_selected")
    _build.LAUNCHES["po_forward"] += 1
    return (origin, direction, weight, tries_out) + saved


# -------------------------------------------- K1v: the VJP of K1's function


def _grads(out, wrt, ct=None) -> list:
    """``torch.autograd.grad`` of ``out`` (cotangent ``ct``) with zeros
    for the tensors of ``wrt`` it does not reach."""
    got = torch.autograd.grad(out, wrt, grad_outputs=ct, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(got, wrt)]


def po_forward_vjp_plain(lens: PolyLens, x, y, ax, ay, dx, dy, g_out4,
                         g_trans, g_dx, g_dy, lam_um: float,
                         sensor_shift: float, need_inputs: bool = False):
    """Plain K1v: the VJP of K1's function at its solution ``dx, dy``, on
    the fit's own term set, by autograd of ``pt_evaluate`` and
    :func:`~pota_tpu_torch.optics.polynomial.aperture_solve_vjp` (the
    aperture solve's backward, without its recompute).

    Rays and solution are [M] in one dtype (the coefficients are taken in
    it: float64 inputs give a float64 oracle); the cotangents of K1's
    outputs are ``g_out4`` [M, 4], ``g_trans``, ``g_dx``, ``g_dy`` [M], any
    of them None for zero.  JAX's ``custom_root`` rule: the cotangent of
    the shifted sensor point ``(x + dx s, y + dy s, dx, dy)`` through pt
    (trans's where its raw value is <= 0 masked, as ``relu_nan``'s),
    carried with ``g_dx, g_dy`` onto the direction ``h``; ``J^T l = h``
    with ap's 2x2 Jacobian in (dx, dy) at the solution (the determinant
    floored at 1e-12); ``-l^T d ap / d theta`` for ap's coefficients and
    the rays, ``l`` for the aperture point.  The Newton's start gets no
    gradient, as in JAX.

    Returns (d pt.coeffs, d ap.coeffs) in the rays' dtype and, with
    ``need_inputs``, the cotangents of ``x, y, ax, ay`` after them."""
    dt = x.dtype
    if all(g is None for g in (g_out4, g_trans, g_dx, g_dy)):
        zeros = [torch.zeros(c.shape, dtype=dt, device=x.device)
                 for c in (lens.pt.coeffs, lens.ap.coeffs)]
        return (*zeros, *([torch.zeros_like(x)] * 4 if need_inputs else []))
    with torch.enable_grad():
        pt_c = lens.pt.coeffs.detach().to(dt).requires_grad_(True)
        xy = [t.detach().requires_grad_(need_inputs) for t in (x, y)]
        d = torch.stack([dx, dy], -1).detach().requires_grad_(True)
        lam = torch.full_like(x, lam_um)
        out = poly_eval(lens.pt, torch.stack(
            [xy[0] + d[:, 0] * sensor_shift, xy[1] + d[:, 1] * sensor_shift,
             d[:, 0], d[:, 1], lam], -1), pt_c)
        raw = out[:, 4]
        terms = [(g_out4, out[:, :4]),
                 (g_trans, torch.where(raw > 0.0, raw, 0.0)),
                 (g_dx, d[:, 0]), (g_dy, d[:, 1])]
        loss = sum((g * v).sum() for g, v in terms if g is not None)
        h, g_pt, *g_direct = _grads(loss, [d, pt_c,
                                           *(xy if need_inputs else [])])
    zero = torch.zeros_like(x)
    g_s5, g_target, g_ap = aperture_solve_vjp(
        lens.ap, lens.ap.coeffs.detach().to(dt),
        torch.stack([x, y, zero, zero, lam], -1), torch.stack([ax, ay], -1),
        d.detach(), h, (need_inputs, need_inputs, True))
    if not need_inputs:
        return g_pt, g_ap
    return (g_pt, g_ap, g_s5[:, 0] + g_direct[0], g_s5[:, 1] + g_direct[1],
            g_target[:, 0], g_target[:, 1])


def _unfold_index(lens: PolyLens, lam_um: float, device) -> list:
    """Per polynomial (pt, ap): each term's index in :data:`BASIS` and its
    conditioned wavelength power ``ul ** e_4`` (float64), on ``device``;
    kept in the lens's fold cache, so a backward pass reads nothing from
    the card after the first."""
    def index():
        _, _, ul = _fold_conditioning(lens, lam_um, device)
        out = []
        for fn in (lens.pt, lens.ap):
            pos = _basis_positions(lens, fn)
            trace.host_write(device)
            out.append((torch.tensor(pos, device=device),
                        ul ** fn.exponents[:, 4].to(device, torch.float64)))
        return out
    return _cached(lens, ("unfold", float(lam_um), str(device)), index)


def unfold_forward_grads(lens: PolyLens, G_ap, G_pt, lam_um: float):
    """Cotangents on K1's folded basis (``G_ap`` [2, 126], ``G_pt`` [5,
    126]: what K1v sums) mapped back to the fit's terms, the transpose of
    :func:`_fold_rows`: ``d c[r, t] = G[r, pos(t)] * ul ** e_4(t)``.  A row
    the fold does not read gets zero.  Returns (d pt.coeffs, d ap.coeffs)
    float64 on ``G_pt``'s device."""
    out = []
    for fn, G, (pos, lam_pow) in zip(
            (lens.pt, lens.ap), (G_pt, G_ap),
            _unfold_index(lens, lam_um, G_pt.device)):
        g = torch.zeros(fn.coeffs.shape, dtype=torch.float64,
                        device=G.device)
        g[:G.shape[0]] = G.double()[:, pos] * lam_pow
        out.append(g)
    return tuple(out)


# K1v's folded cotangent rows (ap's two, then pt's five) and sums
VJP_SUMS = (FWD_AP_ROWS + FWD_PT_ROWS) * len(BASIS)


def _unfold_table(lens: PolyLens, lam_um: float, device) -> tuple:
    """:func:`unfold_forward_grads` as K1v's finishing kernel reads it, on
    ``device``: an int32 index (per polynomial, pt then ap, the offsets of
    each monomial's terms in the term list that follows, ``len(BASIS) + 1``
    each; then pt's term indices and ap's, each monomial's together in
    term order) and each term's conditioned wavelength power (float64, pt's
    then ap's).  :func:`po_forward_vjp` keeps it in the lens's fold cache
    beside K1's table."""
    starts, terms, pows = [], [], []
    for pos, lam_pow in _unfold_index(lens, lam_um, device):
        trace.host_read(pos)
        pos = pos.tolist()
        counts = [0] * len(BASIS)
        for p in pos:
            counts[p] += 1
        starts += [len(terms) + c for c in
                   itertools.accumulate(counts, initial=0)]
        terms += sorted(range(len(pos)), key=lambda t: (pos[t], t))
        pows.append(lam_pow)
    trace.host_write(device)
    return (torch.tensor(starts + terms, dtype=torch.int32, device=device),
            torch.cat(pows))


def _vjp_tables(lens: PolyLens, lam_um: float, device) -> tuple:
    """K1v's tables at ``lam_um`` (um) on ``device``: K1's folded table
    (:func:`fold_forward_tables`) and :func:`_unfold_table`'s index and
    powers, one look into the lens's fold cache a launch."""
    return _cached(lens, ("forward_vjp", float(lam_um), str(device)),
                   lambda: (_folded_table(lens, "forward", (lam_um,), device),
                            *_unfold_table(lens, lam_um, device)))


# K1v's scratch per (device, stream): the queue of live candidates [>= M]
# int32 and the blocks' partial rows [>= blocks, 882] f32, grown to the
# largest launch and kept for the life of the process; launches on one
# stream run in order, so they may share it
_VJP_SCRATCH: dict = {}


def _vjp_scratch(device, stream: int, m: int, blocks: int) -> tuple:
    key = (str(device), stream)
    queue, partials = _VJP_SCRATCH.get(key, (None, None))
    if queue is None or queue.shape[0] < m:
        queue = torch.empty((max(m, 1),), dtype=torch.int32, device=device)
    if partials is None or partials.shape[0] < blocks:
        partials = torch.empty((max(blocks, 1), VJP_SUMS),
                               dtype=torch.float32, device=device)
    _VJP_SCRATCH[key] = (queue, partials)
    return queue, partials


@span("pota.k1v")
def po_forward_vjp(lens: PolyLens, x, y, ax, ay, dx, dy, g_out4, g_trans,
                   g_dx, g_dy, lam_um: float, sensor_shift: float,
                   need_inputs: bool = False):
    """K1v wrapper: the VJP of K1 (:func:`po_forward`) at its solution
    ``dx, dy``, as :func:`po_forward_vjp_plain` takes and returns it; the
    plain version on the CPU.  On the card two kernels
    (``csrc/po_forward_vjp.cu``) read K1's folded table, sum the
    cotangents of the folded coefficients of the candidates that carry one
    in a fixed order (two runs give the same bits) and write them onto the
    fit's terms (:func:`unfold_forward_grads`' map, :func:`_unfold_table`);
    the wrapper runs no torch op beyond allocating the outputs (the queue
    of live candidates and the blocks' partial rows are scratch kept per
    device and stream, :data:`_VJP_SCRATCH`, resident once allocated).
    Rays, solution and cotangents f32 contiguous on the lens's device
    (``g_out4`` [M, 4], 16-byte aligned, the rest [M]), the lens's
    coefficients f32; ``ax, ay`` enter only their own cotangent (``l``),
    which the kernel writes without reading them."""
    _refuse_grad("po_forward_vjp", x, y, ax, ay, dx, dy, g_out4, g_trans,
                 g_dx, g_dy, lens=lens)
    dev = x.device
    m = x.shape[0]
    for name, t in (("x", x), ("y", y), ("ax", ax), ("ay", ay), ("dx", dx),
                    ("dy", dy), ("g_trans", g_trans), ("g_dx", g_dx),
                    ("g_dy", g_dy)):
        if t is not None:
            _check(name, t, torch.float32, dev, (m,))
    if g_out4 is not None:
        _check("g_out4", g_out4, torch.float32, dev, (m, 4))
    if lens.device != dev:
        raise ValueError(f"lens on {lens.device}, rays on {dev}")
    if dev.type == "cpu":
        return po_forward_vjp_plain(lens, x, y, ax, ay, dx, dy, g_out4,
                                    g_trans, g_dx, g_dy, lam_um,
                                    sensor_shift, need_inputs)
    _check_vjp_coeffs("po_forward_vjp", lens)
    if g_out4 is not None and g_out4.data_ptr() % 16:
        raise ValueError("g_out4: must be 16-byte aligned")
    lib = _build.lib()
    blocks = lib.pota_po_forward_vjp_blocks(m)
    g_in = ([torch.empty((m,), dtype=torch.float32, device=dev)
             for _ in range(4)] if need_inputs else [])
    ptr = lambda t: None if t is None else t.data_ptr()
    return _launch_vjp(
        "po_forward_vjp", lens, lam_um, m, blocks,
        lambda table, scratch, grads, live, stream: lib.pota_po_forward_vjp(
            x.data_ptr(), y.data_ptr(), dx.data_ptr(), dy.data_ptr(),
            ptr(g_out4), ptr(g_trans), ptr(g_dx), ptr(g_dy), m, table,
            float(sensor_shift), *scratch, *grads,
            *(ptr(t) for t in (g_in or [None] * 4)), live,
            stream)) + tuple(g_in)


def _check_vjp_coeffs(name: str, lens: PolyLens) -> None:
    """K1v's refusals of the lens on the card: float32 coefficients, and
    pt's and ap's rows K1's."""
    coeffs = (lens.pt.coeffs, lens.ap.coeffs)
    if any(c.dtype != torch.float32 for c in coeffs):
        raise TypeError(f"{name}: the lens's coefficients must be "
                        "float32 on the card")
    if (coeffs[0].shape[0], coeffs[1].shape[0]) != (FWD_PT_ROWS,
                                                    FWD_AP_ROWS):
        raise ValueError(f"{name}: pt and ap must have K1's rows "
                         f"({FWD_PT_ROWS}, {FWD_AP_ROWS})")


def _launch_vjp(name: str, lens: PolyLens, lam_um: float, m: int,
                blocks: int, launch) -> tuple:
    """One K1v launch of either mode on the card over ``m`` candidates in
    ``blocks`` blocks: its tables, the coefficients' cotangents, the
    scratch, the live count while a profiler records; ``launch(table,
    (queue, partials, blocks, index, lam_pow), (g_pt, t_pt, g_ap, t_ap),
    live)`` calls the C entry with those pointers and its stream last.
    Counts one ``po_forward_vjp`` launch and, traced, ``k1v.candidates``
    and ``k1v.live``.  Returns (d pt.coeffs, d ap.coeffs)."""
    dev = lens.device
    table, index, lam_pow = _vjp_tables(lens, lam_um, dev)
    g_pt, g_ap = (torch.empty(c.shape, dtype=torch.float32, device=dev)
                  for c in (lens.pt.coeffs, lens.ap.coeffs))
    stream = _stream(dev)
    queue, partials = _vjp_scratch(dev, stream, m, blocks)
    # the live candidates' count, made only while a profiler records
    live = (torch.empty((1,), dtype=torch.int32, device=dev)
            if trace.recording() else None)
    err = launch(table.data_ptr(),
                 (queue.data_ptr(), partials.data_ptr(), blocks,
                  index.data_ptr(), lam_pow.data_ptr()),
                 (g_pt.data_ptr(), g_pt.shape[1], g_ap.data_ptr(),
                  g_ap.shape[1]),
                 None if live is None else live.data_ptr(), stream)
    _build.check(err, name)
    _build.LAUNCHES["po_forward_vjp"] += 1
    if live is not None:
        trace.count("k1v.candidates", m)
        trace.count("k1v.live", live)
    return g_pt, g_ap


def _normalize_vjp(v, lo: float, g):
    """The VJP of ``v / sqrt(clamp(|v|^2, min=lo))`` ([..., 3]) for the
    cotangent ``g``: ``(g - m (g . y) y) / s``, y the result, s its
    divisor, m where the floor let ``|v|^2`` through."""
    n2 = torch.sum(v * v, -1, keepdim=True)
    s = torch.sqrt(torch.clamp(n2, min=lo))
    gy = torch.where(n2 >= lo, torch.sum(g * v, -1, keepdim=True) / (s * s),
                     0.0)
    return (g - gy * v) / s


def chart_rays_vjp(lens: PolyLens, out4, g_origin, g_direction,
                   scale: float):
    """The VJP of :func:`chart_rays` at the charts ``out4`` [N, 4] for the
    rays' cotangents ``g_origin``, ``g_direction`` [N, 3] (None: zero): the
    formulas of ``csrc/po_chart.cuh`` ``chart_ray_vjp``, in torch and in
    the charts' dtype with the lens's constants unrounded, with the
    gradients autograd takes through the epilogue's guards (none through
    a ``safe_sqrt`` at or below its floor, none through a normalisation's
    floor below it).  Returns the charts' cotangents [N, 4]."""
    R = lens.outer_pupil_curvature_radius
    chart, R2, inv_R, inv_absR = (CHARTS.index(lens.outer_chart), R ** 2,
                                  1.0 / R, 1.0 / abs(R))
    lo = 1e-24
    o0, o1, o2, o3 = out4.unbind(-1)
    zero = torch.zeros_like(o0)
    g_org = zero[:, None].expand(-1, 3) if g_origin is None else g_origin
    g_dir = zero[:, None].expand(-1, 3) if g_direction is None else g_direction
    sphere, cyl_y = chart == CHARTS.index("sphere"), chart == CHARTS.index(
        "cyl-y")
    if sphere:
        a, n0, n1 = R2 - (o0 * o0 + o1 * o1), o0 * inv_R, o1 * inv_R
    elif cyl_y:
        a, n0, n1 = R2 - o0 * o0, o0 * inv_R, zero
    else:
        a, n0, n1 = R2 - o1 * o1, zero, o1 * inv_R
    root = lambda v: torch.where(v > 1e-20,
                                 torch.sqrt(torch.clamp(v, min=1e-20)), 0.0)
    # safe_sqrt's VJP: none at and below its floor, whatever the cotangent
    root_vjp = lambda v, g: torch.where(
        v > 1e-20, g * (0.5 / torch.sqrt(torch.clamp(v, min=1e-20))), 0.0)
    nz = root(a) * inv_absR
    b = 1.0 - (o2 * o2 + o3 * o3)
    t0, t1, t2 = o2[:, None], o3[:, None], root(b)[:, None]
    n = torch.stack([n0, n1, nz], -1)
    w = torch.stack([nz, zero, -n0], -1)
    ex = w / torch.sqrt(torch.clamp(torch.sum(w * w, -1, keepdim=True),
                                    min=lo))
    c = torch.linalg.cross(n, ex, dim=-1)
    ey = c if sphere else c / torch.sqrt(torch.clamp(
        torch.sum(c * c, -1, keepdim=True), min=lo))
    D = (t0 * ex + t1 * ey + t2 * n) * scale
    # the direction's normalisation and scale, onto the frame's sum
    g_od = _normalize_vjp(D, lo, g_dir) * scale
    g_t0, g_t1, g_t2 = (torch.sum(g_od * e, -1) for e in (ex, ey, n))
    g_n, g_ex, g_c = t2 * g_od, t0 * g_od, t1 * g_od
    if not sphere:
        g_c = _normalize_vjp(c, lo, g_c)
    # c = n x ex
    g_n = g_n + torch.linalg.cross(ex, g_c, dim=-1)
    g_ex = g_ex + torch.linalg.cross(g_c, n, dim=-1)
    g_w = _normalize_vjp(w, lo, g_ex)
    g_nz = g_n[:, 2] + g_w[:, 0] + g_org[:, 2] * (scale * R)
    g_n0 = g_n[:, 0] - g_w[:, 2]
    g_a = root_vjp(a, g_nz * inv_absR)
    g_o0, g_o1 = g_org[:, 0] * scale, g_org[:, 1] * scale
    if sphere or cyl_y:
        g_o0 = g_o0 + g_n0 * inv_R - 2.0 * o0 * g_a
    if not cyl_y:
        g_o1 = g_o1 + g_n[:, 1] * inv_R - 2.0 * o1 * g_a
    g_b = root_vjp(b, g_t2)
    return torch.stack([g_o0, g_o1, g_t0 - 2.0 * o2 * g_b,
                        g_t1 - 2.0 * o3 * g_b], -1)


def po_forward_vjp_selected_plain(lens: PolyLens, x, y, dx, dy, out4,
                                  g_origin, g_direction, lam_um: float,
                                  sensor_shift: float, scale: float):
    """Plain K1v select mode: the charts' cotangents by
    :func:`chart_rays_vjp`, zero on the rays whose cotangents are all zero
    (which the kernel does not walk), then :func:`po_forward_vjp_plain` at
    the selected candidates (x, y, dx, dy [N]).  Returns (d pt.coeffs, d
    ap.coeffs) in the rays' dtype."""
    live = torch.zeros_like(x, dtype=torch.bool)
    for g in (g_origin, g_direction):
        if g is not None:
            live |= (g != 0).any(-1)
    g_out4 = torch.where(live[:, None], chart_rays_vjp(
        lens, out4, g_origin, g_direction, scale), 0.0)
    zero = torch.zeros_like(x)
    return po_forward_vjp_plain(lens, x, y, zero, zero, dx, dy, g_out4, None,
                                None, None, lam_um, sensor_shift)


@span("pota.k1v")
def po_forward_vjp_selected(lens: PolyLens, x, y, dx, dy, out4, g_origin,
                            g_direction, lam_um: float, sensor_shift: float,
                            scale: float):
    """K1v in its select mode: the VJP of K1's select mode
    (:func:`po_forward_selected`) at the selected candidates it saved (x,
    y, dx, dy f32 [N], their charts ``out4`` [N, 4], 16-byte aligned) for
    the rays' cotangents ``g_origin``, ``g_direction`` [N, 3] (None:
    zero), as :func:`po_forward_vjp_selected_plain` takes and returns it;
    the plain version on the CPU.  On the card the kernel
    (``csrc/po_forward_vjp.cu``, ``po_forward_vjp_kernel<true>``) queues
    the rays whose cotangents are not all zero, takes each through the
    chart's VJP (``csrc/po_chart.cuh``) onto its out4 and walks it as K1v
    walks a candidate; the sums' order is fixed as in
    :func:`po_forward_vjp`.  Counts one ``po_forward_vjp`` launch and, while
    a profiler records, N in ``k1v.candidates`` and the live rays in
    ``k1v.live``.  Returns (d pt.coeffs, d ap.coeffs)."""
    _refuse_grad("po_forward_vjp_selected", x, y, dx, dy, out4, g_origin,
                 g_direction, lens=lens)
    dev = x.device
    n = x.shape[0]
    for name, t in (("x", x), ("y", y), ("dx", dx), ("dy", dy)):
        _check(name, t, torch.float32, dev, (n,))
    _check("out4", out4, torch.float32, dev, (n, 4))
    for name, t in (("g_origin", g_origin), ("g_direction", g_direction)):
        if t is not None:
            _check(name, t, torch.float32, dev, (n, 3))
    if lens.device != dev:
        raise ValueError(f"lens on {lens.device}, rays on {dev}")
    if dev.type == "cpu":
        return po_forward_vjp_selected_plain(
            lens, x, y, dx, dy, out4, g_origin, g_direction, lam_um,
            sensor_shift, scale)
    _check_vjp_coeffs("po_forward_vjp_selected", lens)
    if out4.data_ptr() % 16:
        raise ValueError("out4: must be 16-byte aligned")
    lib = _build.lib()
    blocks = lib.pota_po_forward_vjp_selected_blocks(n)
    ptr = lambda t: None if t is None else t.data_ptr()
    return _launch_vjp(
        "po_forward_vjp_selected", lens, lam_um, n, blocks,
        lambda table, scratch, grads, live, stream:
        lib.pota_po_forward_vjp_selected(
            x.data_ptr(), y.data_ptr(), dx.data_ptr(), dy.data_ptr(),
            out4.data_ptr(), ptr(g_origin), ptr(g_direction), n, table,
            float(sensor_shift), *_pupil_select(lens, scale)[:7], *scratch,
            *grads, live, stream))


# ------------------------------------------ K1j: the JVP of K1's function


def _basis_partials(u) -> list:
    """The partials of every monomial of :data:`BASIS` along each of the
    four conditioned variables ``u`` ([N] each): four [N, 126] tensors,
    from the powers ``u_v ** e``."""
    exps = torch.tensor(BASIS, device=u[0].device)
    one, zero = torch.ones_like(u[0]), torch.zeros_like(u[0])
    pw = [torch.stack([one] + [v ** e for e in range(1, BASIS_DEGREE + 1)],
                      -1)[:, exps[:, i]] for i, v in enumerate(u)]
    dpw = [torch.stack([zero, one] + [e * v ** (e - 1)
                                      for e in range(2, BASIS_DEGREE + 1)],
                       -1)[:, exps[:, i]] for i, v in enumerate(u)]
    return [dpw[v] * math.prod(pw[w] for w in range(4) if w != v)
            for v in range(4)]


def po_forward_jvp_plain(lens: PolyLens, x, y, ax, ay, lam_um: float,
                         sensor_shift: float, iterations: int = 3):
    """Plain K1j: :func:`po_forward_plain`'s primal (K1's rounding, bit for
    bit), then JAX's ``custom_root`` tangent at its solution on the same
    folded table (:func:`fold_forward_tables` at ``lam_um``, um): ap's
    Jacobian J in (x, y, dx, dy) at u = (x, y, dx, dy), ``D = d(dx, dy) /
    d(x, y) = -J_d^-1 J_xy`` (``_solve2``: the determinant floored at
    1e-12), the tangents of the shifted point ``(x + dx s, y + dy s, dx,
    dy)`` along x and y, and pt's rows o0..o3 along them; the monomials'
    partials from powers (:func:`_basis_partials`).  A fit outside the
    basis raises ``ValueError`` (:func:`check_basis`), as on the card; its
    differentials take the term trace's ``torch.func.jvp``.  Rays are f32
    [M].  Returns (out4 [M, 4], trans [M] >= 0, dx [M], dy [M], jac [M,
    4, 2]: d out4 / d (x, y))."""
    check_basis(lens)
    out4, trans, dx, dy = po_forward_plain(lens, x, y, ax, ay, lam_um,
                                           sensor_shift, iterations)
    t = _folded_table(lens, "forward", (lam_um,), x.device)
    scale, shift = t[:4], t[4:8]
    ap = t[FWD_AP:FWD_PT].view(-1, 2)
    pt_o = t[FWD_PT:FWD_TRANS].view(-1, 4)
    cond = lambda v, i: (v - shift[i]) * scale[i]
    dm = _basis_partials([cond(x, 0), cond(y, 1), cond(dx, 2), cond(dy, 3)])
    J = [[(dm[v] @ ap[:, i]) * scale[v] for v in range(4)] for i in range(2)]
    s = torch.tensor(sensor_shift, dtype=x.dtype, device=x.device)
    dmp = _basis_partials([cond(_fma(dx, s, x), 0), cond(_fma(dy, s, y), 1),
                           cond(dx, 2), cond(dy, 3)])
    P = [dmp[v] @ pt_o for v in range(4)]
    cols = []
    for c in range(2):
        d0, d1 = _solve2(J[0][2], J[0][3], J[1][2], J[1][3], -J[0][c],
                         -J[1][c])
        raw = (d0 * s + (1.0 if c == 0 else 0.0),
               d1 * s + (1.0 if c == 1 else 0.0), d0, d1)
        cols.append(sum(P[v] * (raw[v] * scale[v])[:, None]
                        for v in range(4)))
    return out4, trans, dx, dy, torch.stack(cols, -1)


@span("pota.k1j")
def po_forward_jvp(lens: PolyLens, x, y, ax, ay, lam_um: float,
                   sensor_shift: float, iterations: int = 3):
    """K1j wrapper: :func:`po_forward_jvp_plain` on the CPU, the CUDA
    kernel (``csrc/po_forward_jvp.cu``) on the card, one launch for both
    screen axes.  Rays are f32 [M] contiguous on the lens's device (any
    other dtype raises); ``lam_um`` is the frame's wavelength (um).
    Returns K1's (out4, trans, dx, dy), bit for bit as :func:`po_forward`
    gives them, and out4's Jacobian in (x, y) [M, 4, 2]."""
    _refuse_grad("po_forward_jvp", x, y, ax, ay, lens=lens)
    dev = x.device
    m = x.shape[0]
    for name, t in (("x", x), ("y", y), ("ax", ax), ("ay", ay)):
        _check(name, t, torch.float32, dev, (m,))
    if lens.device != dev:
        raise ValueError(f"lens on {lens.device}, rays on {dev}")
    if dev.type == "cpu":
        return po_forward_jvp_plain(lens, x, y, ax, ay, lam_um,
                                    sensor_shift, iterations)
    table = _folded_table(lens, "forward", (lam_um,), dev)
    out4 = torch.empty((m, 4), dtype=torch.float32, device=dev)
    trans, dx, dy = (torch.empty((m,), dtype=torch.float32, device=dev)
                     for _ in range(3))
    jac = torch.empty((m, 4, 2), dtype=torch.float32, device=dev)
    err = _build.lib().pota_po_forward_jvp(
        x.data_ptr(), y.data_ptr(), ax.data_ptr(), ay.data_ptr(), m,
        table.data_ptr(), 1.0 / lens.aperture_z, float(sensor_shift),
        int(iterations), out4.data_ptr(), trans.data_ptr(), dx.data_ptr(),
        dy.data_ptr(), jac.data_ptr(), _stream(dev))
    _build.check(err, "po_forward_jvp")
    _build.LAUNCHES["po_forward_jvp"] += 1
    return out4, trans, dx, dy, jac


class ForwardFn(torch.autograd.Function):
    """K1 with a gradient: ``ForwardFn.apply(x, y, ax, ay, pt_coeffs,
    ap_coeffs, lens, lam_um, sensor_shift, iterations, ops)`` returns
    K1's (out4, trans, dx, dy), with ``pt_coeffs`` / ``ap_coeffs`` the
    lens's own coefficient tensors, passed so that they get their
    gradients.  On the card the forward is ``ops.po_forward`` (K1, or in
    :data:`~pota_tpu_torch.ops.PLAIN` its plain version, K1's rounding);
    on the CPU it is K1's function on the fit's term set
    (:func:`_po_forward_terms`), the rounding of JAX's pure path, to which
    the CPU tests hold the differentiable frame (K1's rounding moves the
    splat decisions of a few sources, and so the loss's differences).

    It saves the rays and the solution ``dx, dy`` only.  The backward is
    ``ops.po_forward_vjp`` (K1v on the card), JAX's ``custom_root`` rule
    for the aperture solve (``pota_tpu/optics/polynomial.py:256-324``)
    through pt; JAX differentiates its pure path, since a ``pallas_call``
    has no VJP.  Inputs that require grad get their cotangents; the
    Newton's start gets none, as in JAX."""

    @staticmethod
    def forward(ctx, x, y, ax, ay, pt_coeffs, ap_coeffs, lens, lam_um,
                sensor_shift, iterations, ops):
        forward = (_po_forward_terms if x.device.type == "cpu"
                   else ops.po_forward)
        out4, trans, dx, dy = forward(lens, x, y, ax, ay, lam_um,
                                      sensor_shift, iterations)
        ctx.save_for_backward(x, y, ax, ay, dx, dy)
        ctx.args = (lens, lam_um, sensor_shift, ops)
        ctx.set_materialize_grads(False)
        return out4, trans, dx, dy

    @staticmethod
    def backward(ctx, g_out4, g_trans, g_dx, g_dy):
        need = ctx.needs_input_grad
        cts = [None if g is None else g.contiguous()
               for g in (g_out4, g_trans, g_dx, g_dy)]
        if all(g is None for g in cts) or not any(need[:6]):
            return (None,) * 11
        lens, lam_um, sensor_shift, ops = ctx.args
        g_pt, g_ap, *g_rays = ops.po_forward_vjp(
            lens, *ctx.saved_tensors, *cts, lam_um, sensor_shift,
            any(need[:4]))
        grads = [g if n else None for g, n in zip((*(g_rays or [None] * 4),
                                                   g_pt, g_ap), need)]
        return (*grads, None, None, None, None, None)


class SelectFn(torch.autograd.Function):
    """K1's select mode with a gradient: ``SelectFn.apply(sx, sy, r1, r2,
    key, pt_coeffs, ap_coeffs, lens, draw, lam_um, sensor_shift,
    iterations, select, ops)`` with ``draw`` = (tries, radius, blades) and
    ``select`` = (hsw, scale) returns the rays' (origin, direction, weight,
    tries), as :func:`po_forward_selected` gives them.  On the card the
    forward is ``ops.po_forward_selected``; on the CPU the candidates are
    drawn in torch (:func:`drawn_rays`) and traced on the fit's term set
    (:func:`_po_forward_terms`, as :class:`ForwardFn` traces them), then
    selected by :func:`select_rays`.

    It saves the selected candidate of each ray (its sensor point,
    solution and chart: 32 bytes a ray), and its backward is K1v in its
    select mode (``ops.po_forward_vjp_selected``): the rays' cotangents
    through the chart's VJP, then K1's VJP at the selected candidate, the
    gradient the torch epilogue's autograd and K1v gave (the candidates not
    selected carry none).  ``weight`` and ``tries`` carry no gradient; nor
    do the screen points, uniforms and keys (the screen points may not
    require one)."""

    @staticmethod
    def forward(ctx, sx, sy, r1, r2, key, pt_coeffs, ap_coeffs, lens, draw,
                lam_um, sensor_shift, iterations, select, ops):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise ValueError("SelectFn: the screen points take no gradient")
        hsw, scale = select
        tries = draw[0]
        if sx.device.type == "cpu":
            x, y = sx * hsw, sy * hsw
            cand = _po_forward_terms(lens, *drawn_rays(x, y, r1, r2, key,
                                                       *draw),
                                     lam_um, sensor_shift, iterations)
            out = _select_candidates(lens, x, y, cand, tries, sensor_shift,
                                     scale, True)
        else:
            out = ops.po_forward_selected(lens, sx, sy, hsw, r1, r2, key,
                                          *draw, lam_um, sensor_shift,
                                          scale, iterations, True)
        origin, direction, weight, tries_out, *saved = out
        ctx.save_for_backward(*saved)
        ctx.args = (lens, lam_um, sensor_shift, scale, ops)
        ctx.mark_non_differentiable(weight, tries_out)
        ctx.set_materialize_grads(False)
        return origin, direction, weight, tries_out

    @staticmethod
    def backward(ctx, g_origin, g_direction, _g_weight, _g_tries):
        need_pt, need_ap = ctx.needs_input_grad[5:7]
        g_pt = g_ap = None
        if (need_pt or need_ap) and not (g_origin is None
                                         and g_direction is None):
            lens, lam_um, sensor_shift, scale, ops = ctx.args
            g_pt, g_ap = ops.po_forward_vjp_selected(
                lens, *ctx.saved_tensors,
                *(None if g is None else g.contiguous()
                  for g in (g_origin, g_direction)),
                lam_um, sensor_shift, scale)
        return ((None,) * 5 + (g_pt if need_pt else None,
                               g_ap if need_ap else None) + (None,) * 7)


def _check_po_splat(lens, slots, params, spheres,
                    external: bool = False) -> torch.device:
    """Check the per-slot tensors of K3 or K3b, in C order: the camera and
    world points f32, (seed, ctr) int32 or, ``external``, the aperture
    point (ax, ay) f32, and sky f32, all [S]; ``params`` and ``spheres``.
    Returns their device."""
    dev = slots[0].device
    s = slots[0].shape[0]
    names = ("pcx", "pcy", "pcz", "pwx", "pwy", "pwz",
             *(("ax", "ay") if external else ("seed", "ctr")), "sky")
    for nm, t in zip(names, slots, strict=True):
        dtype = torch.int32 if nm in ("seed", "ctr") else torch.float32
        _check(nm, t, dtype, dev, (s,))
    _check("params", params, torch.float32, dev, (SPLAT_PARAM_COUNT,))
    _check("spheres", spheres, torch.float32, dev, (spheres.shape[0], 4))
    if lens.device != dev:
        raise ValueError(f"lens on {lens.device}, slots on {dev}")
    return dev


def _launch_po_splat(name, lens, slots, lam_idx, tables, n_tables, params,
                     spheres, iterations):
    """Launch K3 (``name`` ``po_splat``) or K3b on ``n_tables`` folded
    solve tables ``tables`` with the per-slot table index ``lam_idx`` (or
    None); every entry point takes the same C arguments."""
    dev = slots[0].device
    s = slots[0].shape[0]
    lin = torch.empty((s,), dtype=torch.int32, device=dev)
    ok = torch.empty((s,), dtype=torch.bool, device=dev)
    lensc = _splat_lens_consts(lens, dev)
    idx = None if lam_idx is None else lam_idx.data_ptr()
    err = getattr(_build.lib(), f"pota_{name}")(
        *(t.data_ptr() for t in slots[:8]), idx, slots[8].data_ptr(), s,
        tables.data_ptr(), n_tables, lensc.data_ptr(),
        CHARTS.index(lens.outer_chart), int(iterations), params.data_ptr(),
        spheres.data_ptr(), spheres.shape[0], lin.data_ptr(), ok.data_ptr(),
        _stream(dev))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return lin, ok


@span("pota.k3")
def po_splat(lens: PolyLens, pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, sky,
             params, spheres, lam_um: float, iterations: int = 3):
    """K3 wrapper.  Per-slot inputs are f32 [S] (camera-space point, world
    point, sky flag) and int32 [S] (seed, counter: uint32 bits);
    ``params`` is :func:`splat_kernel_params`, ``spheres`` f32 [n, 4];
    ``lam_um`` is the frame's wavelength (um), a Python float, the one
    ``params`` carries, at which the kernel's solve table is folded
    (:func:`fold_solve_tables`).  ``ValueError`` if ``params`` carries
    another wavelength: checked on every call on the CPU, and on the card
    when the table is folded (the check reads the card).
    Returns (lin int32 [S], ok bool [S])."""
    slots = (pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, sky)
    _refuse_grad("po_splat", *slots, params, spheres, lens=lens)
    dev = _check_po_splat(lens, slots, params, spheres)

    def check_lambda():
        lam_f32 = torch.tensor(float(lam_um), dtype=torch.float32).item()
        trace.host_read(params)
        if float(params[SP_LAMBDA]) != lam_f32:
            raise ValueError(
                f"lam_um {lam_um} is not the wavelength of params "
                f"({float(params[SP_LAMBDA])})")

    if dev.type == "cpu":
        check_lambda()
        return po_splat_plain(lens, *slots, params, spheres, lam_um,
                              iterations)
    table = _folded_table(lens, "solve", (lam_um,), dev, on_fold=check_lambda)
    return _launch_po_splat("po_splat", lens, slots, None, table, 1, params,
                            spheres, iterations)


def _po_splat_k3b(name, plain, lens, slots, lams, lam_idx, params, spheres,
                  iterations):
    """K3b: its plain version for CPU tensors, its kernel for CUDA tensors
    on one folded solve table a wavelength of ``lams`` (cached, so a frame
    reads nothing back from the card), ``lam_idx`` picking each slot's."""
    _refuse_grad(name, *slots, lam_idx, params, spheres, lens=lens)
    dev = _check_po_splat(lens, slots, params, spheres,
                          external=name == "po_splat_ext")
    lams = _check_lams(lams, lam_idx, dev, slots[0].shape[0])
    if dev.type == "cpu":
        return plain(lens, *slots[:8], lams, lam_idx, slots[8], params,
                     spheres, iterations)
    return _launch_po_splat(name, lens, slots, lam_idx,
                            _folded_table(lens, "solve", lams, dev),
                            len(lams), params, spheres, iterations)


@span("pota.k3b")
def po_splat_lam(lens: PolyLens, pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr,
                 lams, lam_idx, sky, params, spheres, iterations: int = 3):
    """K3b ``lam_input`` wrapper (the chromatic splat): as :func:`po_splat`,
    with the wavelengths (um) ``lams`` a tuple of one and ``lam_idx`` None,
    or of up to :data:`MAX_SOLVE_TABLES` and ``lam_idx`` int32 [S] in
    ``[0, len(lams))`` (the chroma channel); slot ``i`` is solved at
    ``lams[lam_idx[i]]``."""
    return _po_splat_k3b(
        "po_splat_lam", po_splat_lam_plain, lens,
        (pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, sky), lams, lam_idx,
        params, spheres, iterations)


@span("pota.k3b")
def po_splat_ext(lens: PolyLens, pcx, pcy, pcz, pwx, pwy, pwz, ax, ay, lams,
                 lam_idx, sky, params, spheres, iterations: int = 3):
    """K3b external-aperture wrapper (image bokeh, blade apertures): the
    aperture point ``ax, ay`` f32 [S] (mm) comes per slot; ``lams`` and
    ``lam_idx`` as :func:`po_splat_lam` takes them."""
    return _po_splat_k3b(
        "po_splat_ext", po_splat_ext_plain, lens,
        (pcx, pcy, pcz, pwx, pwy, pwz, ax, ay, sky), lams, lam_idx, params,
        spheres, iterations)


# ---------------------------------------------------- K6: PO backward solve


def po_backward_plain(lens: PolyLens, px, py, pz, ax, ay, lams, lam_idx,
                      iterations: int = 3):
    """Plain K6: ``lt_sample_aperture`` (which carries the kernel's
    chief-ray guard) for targets ``(px, py, pz)`` in lens-space mm
    (-10 * p_cam) and aperture points ``(ax, ay)`` (mm), f32 [S].  Item
    ``i`` has the wavelength ``lams[lam_idx[i]]`` (um), or ``lams[0]``
    when ``lam_idx`` is None, formed in the targets' dtype.
    Returns (sx, sy, sdx, sdy, trans); ``trans`` is >= 0 and cropped by the
    outer pupil."""
    sensor5, _, trans = lt_sample_aperture(
        lens, torch.stack([px, py, pz], -1), torch.stack([ax, ay], -1),
        _lam_per_item(lams, lam_idx, px), iterations=iterations)
    return (*(sensor5[..., k].contiguous() for k in range(4)), trans)


@span("pota.k6")
def po_backward(lens: PolyLens, px, py, pz, ax, ay, lams, lam_idx,
                iterations: int = 3):
    """K6 wrapper: the PO backward solve of JAX's decomposed splat branch
    (``po_pallas.py::build_po_backward_kernel``).  Inputs as
    :func:`po_backward_plain` takes them, contiguous, on the lens's device:
    ``lams`` a tuple of one wavelength (um) and ``lam_idx`` None, or of up
    to :data:`MAX_SOLVE_TABLES` with ``lam_idx`` int32 [S] in
    ``[0, len(lams))``.  The plain version on the CPU, the CUDA kernel on
    the card, on one folded solve table a wavelength
    (:func:`fold_solve_tables`)."""
    _refuse_grad("po_backward", px, py, pz, ax, ay, lens=lens)
    dev = px.device
    n = px.shape[0]
    for name, t in (("px", px), ("py", py), ("pz", pz), ("ax", ax),
                    ("ay", ay)):
        _check(name, t, torch.float32, dev, (n,))
    lams = _check_lams(lams, lam_idx, dev, n)
    if lens.device != dev:
        raise ValueError(f"lens on {lens.device}, items on {dev}")
    if dev.type == "cpu":
        return po_backward_plain(lens, px, py, pz, ax, ay, lams, lam_idx,
                                 iterations)
    tables = _folded_table(lens, "solve", lams, dev)
    lensc = _splat_lens_consts(lens, dev)
    outs = [torch.empty((n,), dtype=torch.float32, device=dev)
            for _ in range(5)]
    err = _build.lib().pota_po_backward(
        px.data_ptr(), py.data_ptr(), pz.data_ptr(), ax.data_ptr(),
        ay.data_ptr(), None if lam_idx is None else lam_idx.data_ptr(), n,
        tables.data_ptr(), len(lams), lensc.data_ptr(),
        CHARTS.index(lens.outer_chart), int(iterations),
        *(t.data_ptr() for t in outs), _stream(dev))
    _build.check(err, "po_backward")
    _build.LAUNCHES["po_backward"] += 1
    return tuple(outs)


# ------------------------------------------------------- K5: thin-lens splat


def _aberrated_disk(seed, ctr, abb_spherical: float, circle_to_square: float):
    """Concentric disk point of the (seed, counter) stream with the
    spherical-aberration bias and the squircle lerp, in the closed form of
    ``po_pallas.py::_tea_concentric_disk_aberrated``."""
    u = prng.uniforms(seed.to(torch.int64) & prng.MASK32,
                      ctr.to(torch.int64) & prng.MASK32, 2)
    r, phi, a, b = samplers.concentric_polar(u[..., 0], u[..., 1])
    if abb_spherical != 0.5:
        expo = math.log(abb_spherical) / math.log(0.5)
        r = torch.sign(r) * torch.exp(
            torch.log(torch.clamp(torch.abs(r), min=1e-30)) * expo)
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    if circle_to_square > 0.0:
        x = x + circle_to_square * (a - x)
        y = y + circle_to_square * (b - y)
    both_zero = (a == 0.0) & (b == 0.0)
    return torch.where(both_zero, 0.0, x), torch.where(both_zero, 0.0, y)


def tl_splat_plain(pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, sky, params,
                   spheres, abb_spherical: float = 0.5,
                   circle_to_square: float = 0.01):
    """Plain K5: aberrated disk sample, anamorphic squeeze, thin-lens
    backward projection to the sensor, pixel map and occlusion probe from
    the world lens point.  Returns (lin int32 [S], ok bool [S])."""
    p = params
    ux, uy = _aberrated_disk(seed, ctr, abb_spherical, circle_to_square)
    ux = ux * p[SP_TL_ANAM]
    lx = ux * p[SP_TL_APR]
    ly = uy * p[SP_TL_APR]

    f, idfd = p[SP_TL_F], p[SP_TL_IDFD]
    # image distance of the sample depth (ref src/lentil.h:665-671)
    ids = (-f * pcz) / (-f + pcz)
    pn = torch.sqrt(torch.clamp(pcx * pcx + pcy * pcy + pcz * pcz,
                                min=1e-24))
    dfcz = pcz / pn
    t_sp = torch.abs(ids / dfcz)
    dlx = (pcx / pn) * t_sp - lx
    dly = (pcy / pn) * t_sp - ly
    dlz = dfcz * t_sp
    # focus-plane point lens + dl * |idfd / dlz| (the norms of dl cancel)
    s = torch.abs(idfd / torch.where(torch.abs(dlz) < 1e-12, 1e-12, dlz))
    fipx = lx + dlx * s
    fipy = ly + dly * s
    fipz = dlz * s
    sens = -f / p[SP_HSW]
    fipz_safe = torch.where(torch.abs(fipz) < 1e-12, 1e-12, fipz)
    sx = fipx / fipz_safe * sens
    sy = fipy / fipz_safe * sens * p[SP_ASPECT]
    pixel_x = (sx + 1.0) * 0.5 * p[SP_XRES] - p[SP_RMINX]
    pixel_y = (-sy + 1.0) * 0.5 * p[SP_YRES] - p[SP_RMINY]
    lin, ok = _pixel_lin(pixel_x, pixel_y, p)

    inv_unit = p[SP_INV_UNIT]
    cw = _lens_point_ws(lx * inv_unit, ly * inv_unit, p)
    occ = _occlude_spheres(pwx, pwy, pwz, *cw, spheres)
    ok &= ~(occ & (sky < 0.5))
    return lin, ok


@span("pota.k5")
def tl_splat(pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, sky, params, spheres,
             abb_spherical: float = 0.5, circle_to_square: float = 0.01):
    """K5 wrapper.  Per-slot inputs as :func:`po_splat` takes them;
    ``abb_spherical`` and ``circle_to_square`` are the camera's effective
    strengths (runtime scalars of the kernel).  Returns (lin int32 [S],
    ok bool [S])."""
    _refuse_grad("tl_splat", pcx, pcy, pcz, pwx, pwy, pwz, sky, params,
                 spheres)
    dev = pcx.device
    s = pcx.shape[0]
    for name, t in (("pcx", pcx), ("pcy", pcy), ("pcz", pcz), ("pwx", pwx),
                    ("pwy", pwy), ("pwz", pwz), ("sky", sky)):
        _check(name, t, torch.float32, dev, (s,))
    _check("seed", seed, torch.int32, dev, (s,))
    _check("ctr", ctr, torch.int32, dev, (s,))
    _check("params", params, torch.float32, dev, (SPLAT_PARAM_COUNT,))
    _check("spheres", spheres, torch.float32, dev, (spheres.shape[0], 4))
    if dev.type == "cpu":
        return tl_splat_plain(pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, sky,
                              params, spheres, abb_spherical,
                              circle_to_square)
    bias = abb_spherical != 0.5
    expo = math.log(abb_spherical) / math.log(0.5) if bias else 1.0
    lin = torch.empty((s,), dtype=torch.int32, device=dev)
    ok = torch.empty((s,), dtype=torch.bool, device=dev)
    err = _build.lib().pota_tl_splat(
        pcx.data_ptr(), pcy.data_ptr(), pcz.data_ptr(), pwx.data_ptr(),
        pwy.data_ptr(), pwz.data_ptr(), seed.data_ptr(), ctr.data_ptr(),
        sky.data_ptr(), s, int(bias), float(expo), float(circle_to_square),
        params.data_ptr(), spheres.data_ptr(), spheres.shape[0],
        lin.data_ptr(), ok.data_ptr(), _stream(dev))
    _build.check(err, "tl_splat")
    _build.LAUNCHES["tl_splat"] += 1
    return lin, ok
