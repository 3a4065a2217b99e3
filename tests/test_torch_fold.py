"""The folded tables of the card's PO kernels on the CPU: the backward-solve
table of K3, K3b and K6 (``pota_tpu_torch.ops.po_kernels.fold_solve_tables``;
below, with a float32 emulation of the whole solve, ``po_basis_solve``,
held to a float64 solve across and beyond the sensor), K1's forward table
(``fold_forward_tables``, read by ``csrc/po_forward_basis.cuh``: below, with
a float64 emulation of the whole K1 algorithm), the fold cache, and the
basis check that refuses a fit before a frame starts on the card.

The solve table is evaluated here in float64, as ``csrc/po_solve_basis.cuh``
walks it in float32, and held against the lens's own polynomial: the six
Newton rows (apx, apy, o0..o3) and the transmittance through
``poly_eval``, the rows' derivatives along the raw unknowns (x, y, dx, dy)
through autograd, both in float64, at a few thousand seeded points spread
over the conditioned domain.  Tolerance: the table is float32 (its entries
are formed in float64 and rounded once), so each value is held to 5e-7 of
its row's largest magnitude over the points (measured at most 7.2e-9) and
each derivative to 5e-7 of its row's largest derivative (measured at most
3.5e-8).
"""
import copy
import glob
import os
import re

import numpy as np
import pytest
import torch

from pota_tpu_torch.ops import po_kernels as pk
from pota_tpu_torch.optics.fit import LENS_DIR, load_poly_lens
from pota_tpu_torch.optics.polynomial import poly_eval

torch.set_num_threads(2)

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
ANAMORPHIC = "unknown__anamorphic__1960__50mm"
HEADER = os.path.join(os.path.dirname(pk.__file__), os.pardir, "csrc",
                      "po_solve_basis.cuh")
TOL = 5e-7
CASES = [(FLAGSHIP, 5, 0.55), (FLAGSHIP, 5, 0.45), (FLAGSHIP, 3, 0.55),
         (ANAMORPHIC, 5, 0.65)]


def eval_table(table, s):
    """Rows apx, apy, o0..o3, trans [N, 7] and the Newton rows' derivatives
    [N, 6, 4] of the folded ``table`` at raw unknowns ``s`` [N, 4], in
    float64, in the kernel's layout."""
    t = table.double()
    u = (s - t[4:8]) * t[:4]
    exps = torch.tensor(pk.BASIS, dtype=torch.float64)
    mono = torch.prod(u[:, None, :] ** exps, -1)                 # [N, 126]
    off = pk._BLOCK_OFF
    vals = torch.stack([t[o:o + 8] for o in off])[:, list(pk.FOLD_SLOTS)]
    der = torch.stack([t[off[i] + 8:off[i] + 32] for i in pk._LOW])
    return mono @ vals, torch.einsum("nm,mrv->nrv", mono[:, pk._LOW],
                                     der.reshape(-1, 6, 4))


def lens_rows(lens, s, lam_um):
    """The same rows and derivatives from the lens's polynomial (float64
    copies of its float32 fit)."""
    ap, pt_ = lens.ap.double(), lens.pt.double()
    s = s.clone().requires_grad_(True)
    s5 = torch.cat([s, torch.full_like(s[:, :1], lam_um)], -1)
    rows = torch.cat([poly_eval(ap, s5)[:, :2], poly_eval(pt_, s5)[:, :5]], -1)
    der = torch.stack([torch.autograd.grad(rows[:, r].sum(), s,
                                           retain_graph=True)[0]
                       for r in range(6)], 1)
    return rows.detach(), der


def scaled_err(got, want, dims):
    scale = want.abs().amax(dims).clamp(min=1e-30)
    return float(((got - want).abs().amax(dims) / scale).max())


@pytest.mark.parametrize("name, degree, lam_um", CASES)
def test_folded_table_matches_lens(name, degree, lam_um):
    lens = load_poly_lens(name, degree=degree, device="cpu")
    table = pk.fold_solve_tables(lens, lam_um, "cpu")
    assert table.dtype == torch.float32
    assert table.shape == (pk.FOLD_TABLE_FLOATS,)
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.uniform(-1.0, 1.0, (4000, 4)))
    scale = lens.pt.in_scale[:4].double()
    shift = lens.pt.in_shift[:4].double()
    s = shift + u / scale
    got_v, got_d = eval_table(table, s)
    want_v, want_d = lens_rows(lens, s, lam_um)
    assert scaled_err(got_v, want_v, 0) < TOL
    assert scaled_err(got_d, want_d, (0, 2)) < TOL


def test_all_committed_fits_fold_into_the_basis():
    paths = sorted(glob.glob(os.path.join(LENS_DIR, "*.npz")))
    assert len(paths) == 46
    counts = {}
    for path in paths:
        lens = load_poly_lens("", path=path, device="cpu")
        table = pk.fold_solve_tables(lens, 0.55, "cpu")
        assert bool(torch.isfinite(table).all()), path
        counts[os.path.basename(path)] = len(
            {tuple(e[:4]) for e in lens.pt.exponents.tolist()})
    assert max(counts.values()) <= len(pk.BASIS) == 126
    assert counts[f"{FLAGSHIP}__deg5.npz"] == 113


def test_fold_refuses_a_monomial_outside_the_basis():
    lens = load_poly_lens(FLAGSHIP, degree=3, device="cpu")
    for fn in (lens.pt, lens.ap):
        fn.exponents[-1] = torch.tensor([6, 0, 0, 0, 0])
    with pytest.raises(ValueError, match="outside the degree-5 basis"):
        pk.fold_solve_tables(lens, 0.55, "cpu")


def test_basis_order_matches_the_cuda_header():
    with open(HEADER) as f:
        text = f.read()
    body = re.search(r"kExps\[kMonomials\]\[4\] = \{(.*?)\};", text, re.S)
    got = tuple(tuple(int(v) for v in m.split(","))
                for m in re.findall(r"\{(\d+, \d+, \d+, \d+)\}", body.group(1)))
    assert got == pk.BASIS
    assert len(got) == int(re.search(r"kMonomials = (\d+);", text).group(1))
    size = int(re.search(r"kTableFloats == (\d+)", text).group(1))
    assert size == pk.FOLD_TABLE_FLOATS
    for name, want in (("kHeader", pk.FOLD_HEADER),
                       ("kLowStride", pk.FOLD_LOW_STRIDE),
                       ("kHighStride", pk.FOLD_HIGH_STRIDE)):
        assert int(re.search(rf"{name} = (\d+);", text).group(1)) == want


def _params(lam_um):
    """Splat parameters that carry only the wavelength ``lam_um``."""
    p = torch.zeros(pk.SPLAT_PARAM_COUNT)
    p[pk.SP_LAMBDA] = lam_um
    return p


def test_folded_table_is_cached_per_lens_and_wavelength():
    lens = load_poly_lens(FLAGSHIP, degree=3, device="cpu")
    a = pk._folded_table(lens, "solve", (0.55,), "cpu")
    assert pk._folded_table(lens, "solve", (0.55,), "cpu") is a
    b = pk._folded_table(lens, "solve", (0.45,), "cpu")
    assert b is not a and not torch.equal(a, b)
    fwd = pk._folded_table(lens, "forward", (0.45,), "cpu")
    assert fwd.shape == (pk.FWD_TABLE_FLOATS,)
    assert pk._folded_table(lens, "forward", (0.45,), "cpu") is fwd
    # K6 under chroma: three tables, one after another
    three = pk._folded_table(lens, "solve", (0.45, 0.55, 0.65), "cpu")
    assert torch.equal(three, torch.cat(
        [b, a, pk.fold_solve_tables(lens, 0.65, "cpu")]))
    with torch.no_grad():
        lens.pt.coeffs[0, 0] += 1.0
    c = pk._folded_table(lens, "solve", (0.45,), "cpu")
    assert c is not b
    assert torch.equal(c, pk.fold_solve_tables(lens, 0.45, "cpu"))
    assert pk._folded_table(lens, "forward", (0.45,), "cpu") is not fwd


def test_fold_refuses_a_wavelength_params_do_not_carry():
    """``po_splat``'s wavelength must be the one ``params`` carries: on the
    CPU it checks every call, on the card when it folds its table."""
    lens = load_poly_lens(FLAGSHIP, degree=3, device="cpu")
    f = torch.zeros(4)
    i = torch.zeros(4, dtype=torch.int32)
    slots = (f, f, f - 100.0, f, f, f - 100.0, i, i, f)
    with pytest.raises(ValueError, match="not the wavelength of params"):
        pk.po_splat(lens, *slots, _params(0.45), torch.zeros(0, 4), 0.55, 3)
    lin, ok = pk.po_splat(lens, *slots, _params(0.55), torch.zeros(0, 4),
                          0.55, 3)
    assert lin.shape == ok.shape == (4,)
    folds = []
    pk._folded_table(lens, "solve", (0.6,), "cpu",
                     on_fold=lambda: folds.append(1))
    pk._folded_table(lens, "solve", (0.6,), "cpu",
                     on_fold=lambda: folds.append(1))
    assert folds == [1]


# ------------------------------- the folded solve in float32 (K3, K3b, K6)


class D4:
    """A float32 value [N] and its tangents [N, 4] along the unknowns, with
    the arithmetic of ``csrc/common.cuh``'s ``D4``."""

    def __init__(self, v, d):
        self.v, self.d = v, d

    def __add__(self, o):
        o = o if isinstance(o, D4) else D4(o, 0.0)
        return D4(self.v + o.v, self.d + o.d)

    def __sub__(self, o):
        o = o if isinstance(o, D4) else D4(o, 0.0)
        return D4(self.v - o.v, self.d - o.d)

    def __rsub__(self, c):
        return D4(c - self.v, -self.d)

    def __neg__(self):
        return D4(-self.v, -self.d)

    def __mul__(self, o):
        if not isinstance(o, D4):
            return D4(self.v * o, self.d * o)
        return D4(self.v * o.v, self.d * o.v[:, None] + self.v[:, None] * o.d)

    def __truediv__(self, o):
        if not isinstance(o, D4):
            return D4(self.v / o, self.d / o)
        v = self.v / o.v
        return D4(v, (self.d - v[:, None] * o.d) / o.v[:, None])


def _d4_safe_sqrt(a, eps=1e-20):
    """``dsafe_sqrt``: zero value and tangent where ``v <= eps``."""
    keep = a.v > eps
    v = torch.where(keep, torch.sqrt(torch.clamp(a.v, min=eps)), 0.0)
    g = torch.where(keep, 0.5 / v, 0.0)
    return D4(v, g[:, None] * a.d)


def _d4_recip_sqrt_floor(a, eps):
    """``recip(dsqrt_floor(a, eps))``."""
    r = torch.sqrt(torch.clamp(a.v, min=eps))
    g = torch.where(a.v > eps, 0.5 / r, 0.0)
    v = 1.0 / r
    return D4(v, -(v * v)[:, None] * (g[:, None] * a.d))


def exit_ray_f32(chart, lc, o0, o1, o2, o3):
    """``exit_ray`` of ``csrc/po_solve.cuh`` on D4 rows: (qz, d0, d1, d2)."""
    R, R2, absR = lc[0], lc[1], lc[2]
    tz = _d4_safe_sqrt(1.0 - (o2 * o2 + o3 * o3))
    if chart == "sphere":
        nz = _d4_safe_sqrt(R2 - (o0 * o0 + o1 * o1)) / absR
        n0, n1 = o0 / R, o1 / R
        inv_exn = _d4_recip_sqrt_floor(nz * nz + n0 * n0, 1e-24)
        e0, e2 = nz * inv_exn, -n0 * inv_exn
        f0, f1, f2 = n1 * e2, nz * e0 - n0 * e2, -n1 * e0
        d0 = o2 * e0 + o3 * f0 + tz * n0
        d1 = o3 * f1 + tz * n1
        d2 = o2 * e2 + o3 * f2 + tz * nz
    elif chart == "cyl-y":
        nz = _d4_safe_sqrt(R2 - o0 * o0) / absR
        n0 = o0 / R
        d0, d1, d2 = o2 * nz + tz * n0, o3, -o2 * n0 + tz * nz
    else:
        nz = _d4_safe_sqrt(R2 - o1 * o1) / absR
        n1 = o1 / R
        d0, d1, d2 = o2, o3 * nz + tz * n1, -o3 * n1 + tz * nz
    return nz * R - R, d0, d1, d2


def solve4_f32(J, r):
    """``solve4``: the blocked 4x4 solve in its operation order (J rows of
    [N, 4] tensors, r a list of four [N])."""
    a, b, c, d = J[0][:, 0], J[0][:, 1], J[1][:, 0], J[1][:, 1]
    det_a = a * d - b * c
    det_a = torch.where(det_a.abs() < 1e-12, 1e-12, det_a)
    i00, i01, i10, i11 = d / det_a, -b / det_a, -c / det_a, a / det_a
    B00, B01, B10, B11 = J[0][:, 2], J[0][:, 3], J[1][:, 2], J[1][:, 3]
    C00, C01, C10, C11 = J[2][:, 0], J[2][:, 1], J[3][:, 0], J[3][:, 1]
    ab00, ab01 = i00 * B00 + i01 * B10, i00 * B01 + i01 * B11
    ab10, ab11 = i10 * B00 + i11 * B10, i10 * B01 + i11 * B11
    s00 = J[2][:, 2] - (C00 * ab00 + C01 * ab10)
    s01 = J[2][:, 3] - (C00 * ab01 + C01 * ab11)
    s10 = J[3][:, 2] - (C10 * ab00 + C11 * ab10)
    s11 = J[3][:, 3] - (C10 * ab01 + C11 * ab11)
    av0, av1 = i00 * r[0] + i01 * r[1], i10 * r[0] + i11 * r[1]
    rh0 = r[2] - (C00 * av0 + C01 * av1)
    rh1 = r[3] - (C10 * av0 + C11 * av1)
    det_s = s00 * s11 - s01 * s10
    det_s = torch.where(det_s.abs() < 1e-12, 1e-12, det_s)
    x2, x3 = (s11 * rh0 - s01 * rh1) / det_s, (-s10 * rh0 + s00 * rh1) / det_s
    t0 = r[0] - (B00 * x2 + B01 * x3)
    t1 = r[1] - (B10 * x2 + B11 * x3)
    return [i00 * t0 + i01 * t1, i10 * t0 + i11 * t1, x2, x3]


_ROWS6 = [3, 4, 0, 1, 5, 6]       # apx, apy, o0..o3 in a block's values


def basis_solve_f32(table, lens, px, py, pz, ax, ay, iterations=3):
    """``po_basis_solve`` (``csrc/po_solve_basis.cuh``) in float32 on the
    folded ``table``: the chief-ray guess, per Newton iteration the
    conditioning, the walk in ``kExps`` order with running products and
    each sum's ``fmaf`` rounded once (``po_kernels._fma``), the six rows
    and their Jacobian, ``exit_ray``, the residual and ``solve4``; then the
    final walk, relu and the outer-pupil crop.  The D4 chart and the solve
    take one rounding per operation, where the kernel's compiler may fuse
    a product and a sum: those differ by an ulp.  Returns (sx, sy, sdx,
    sdy, trans)."""
    lc = pk._splat_lens_consts(lens, "cpu")
    R_outer2, front_z, bfl, inv_ap_z = lc[3], lc[4], lc[5], lc[6]
    scale, shift = table[:4], table[4:8]
    pz_safe = torch.where(pz.abs() < 1e-6, 1e-6, pz)
    s = [-px * bfl / pz_safe, -py * bfl / pz_safe]
    s += [(ax - s[0]) * inv_ap_z, (ay - s[1]) * inv_ap_z]

    def walk(u, low_too):
        n = px.shape[0]
        v = torch.zeros(n, 6 if low_too else 3)
        d = torch.zeros(n, 24)
        for k, _, _, mono in pk._basis_walk(u):
            off = pk._BLOCK_OFF[k]
            rows = table[off + torch.tensor(_ROWS6)] if low_too \
                else table[off:off + 3]
            v = pk._fma(rows[None, :], mono[:, None], v)
            if low_too and sum(pk.BASIS[k]) < pk.BASIS_DEGREE:
                d = pk._fma(table[off + 8:off + 32][None, :], mono[:, None],
                            d)
        return v, d.view(n, 6, 4)

    for _ in range(iterations):
        u = [(s[k] - shift[k]) * scale[k] for k in range(4)]
        v, d = walk(u, True)
        o = [D4(v[:, r], d[:, r]) for r in range(6)]
        qz, d0, d1, d2 = exit_ray_f32(lens.outer_chart, lc, *o[2:])
        small = d2.v.abs() < 1e-9
        dz = D4(torch.where(small, 1e-9, d2.v),
                torch.where(small[:, None], 0.0, d2.d))
        t = (pz - (qz + front_z)) / dz
        r2 = o[2] + t * d0 - px
        r3 = o[3] + t * d1 - py
        dxs = solve4_f32([o[0].d, o[1].d, r2.d, r3.d],
                         [o[0].v - ax, o[1].v - ay, r2.v, r3.v])
        s = [s[k] - dxs[k] for k in range(4)]
    v, _ = walk([(s[k] - shift[k]) * scale[k] for k in range(4)], False)
    tr = torch.where(torch.isnan(v[:, 2]), v[:, 2], v[:, 2].clamp(min=0.0))
    tr = torch.where(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] > R_outer2, 0.0, tr)
    return (*s, tr)


SENSOR_HALF = (18.0, 12.0)        # a 36 x 24 mm sensor (mm)


def _targets(n=20000):
    """Seeded targets (lens-space mm) up to 600 mm off axis, 600-4000 mm
    away, as the card's K6 test draws them, and aperture points within 0.7
    of the flagship's f/2.8 radius."""
    rng = np.random.default_rng(7)
    pc = np.stack([rng.uniform(-60, 60, n), rng.uniform(-35, 35, n),
                   rng.uniform(-400, -60, n)], 0).astype(np.float32)
    ap = rng.uniform(-1, 1, (2, n)).astype(np.float32) * 4.672678 * 0.7
    return [torch.as_tensor(-10.0 * p) for p in pc] + [
        torch.as_tensor(a) for a in ap]


def solve_error_figures(out, ref64):
    """How far a float32 solve's (sx, sy) lies from the float64 solve's
    (mm), on the items both keep, inside and outside the sensor: counts,
    99.9% quantile, maximum and the shares beyond 1e-4 and 1e-3 mm; and
    the share of all items whose ``trans > 0`` agrees."""
    keep, keep_w = out[4] > 0, ref64[4] > 0
    dist = torch.maximum((out[0].double() - ref64[0]).abs(),
                         (out[1].double() - ref64[1]).abs())
    inside = ((ref64[0].abs() <= SENSOR_HALF[0])
              & (ref64[1].abs() <= SENSOR_HALF[1]))
    fig = {"keep_agree": float((keep == keep_w).double().mean())}
    for where, m in (("inside", keep & keep_w & inside),
                     ("outside", keep & keep_w & ~inside)):
        d = dist[m]
        fig[where] = dict(n=int(d.numel()), q999=float(d.quantile(0.999)),
                          max=float(d.max()),
                          over_1e4=float((d > 1e-4).double().mean()),
                          over_1e3=float((d > 1e-3).double().mean()))
    return fig


@pytest.mark.parametrize("degree", [5, 3])
@pytest.mark.parametrize("lam_um", [0.43, 0.55, 0.73])
def test_folded_solve_f32_against_float64(degree, lam_um):
    """The card's backward solve on the folded table, emulated in float32
    (:func:`basis_solve_f32`), against ``lt_sample_aperture`` in float64 on
    the fit's own terms (the same 3 Newton iterations from the same guess),
    for the flagship's fits at config 3's chroma wavelengths (0.55 um also
    the frame's), over 20,000 seeded targets across and beyond the sensor;
    the runtime-term float32 solve (the plain versions') beside it.
    ``trans > 0`` agrees on >= 99.9% of items (measured: all but 0-1).  On
    the items both keep that land inside the 36 x 24 mm sensor, (sx, sy)
    lie within 1e-4 mm of the float64 solve on >= 99.9% (measured: all but
    0-2 of ~17,200, items the runtime-term solve misses as far, whose
    Newton has not converged in 3 iterations) and their 99.9% quantile
    within 5e-5 mm (measured at most 2.7e-5 mm, deg 5 at 0.43 um; the
    runtime-term solve 1.8e-5).  Outside the sensor (printed; ~1,700-2,000
    items a case) the folded walk's 99.9% quantile reaches 7.1e-4 mm and
    its maximum 1.2e-3 mm (deg 5 at 0.55 um), where the runtime-term
    solve's reach 6.3e-4 and 1.35e-3 mm."""
    lens = load_poly_lens(FLAGSHIP, degree=degree, device="cpu")
    px, py, pz, ax, ay = _targets()
    got = basis_solve_f32(pk.fold_solve_tables(lens, lam_um, "cpu"), lens,
                          px, py, pz, ax, ay)
    ref64 = pk.po_backward_plain(
        copy.deepcopy(lens).double(),
        *(t.double() for t in (px, py, pz, ax, ay)), (lam_um,), None)
    plain = pk.po_backward_plain(lens, px, py, pz, ax, ay, (lam_um,), None)
    f = solve_error_figures(got, ref64)
    print(f"deg {degree} lam {lam_um}: folded f32 {f}; runtime-term f32 "
          f"{solve_error_figures(plain, ref64)}")
    assert f["inside"]["n"] > 15000 and f["outside"]["n"] > 1500
    assert f["keep_agree"] >= 0.999
    assert f["inside"]["over_1e4"] <= 1e-3
    assert f["inside"]["q999"] < 5e-5


# ------------------------------------------ K1's folded forward table
FWD_HEADER = os.path.join(os.path.dirname(HEADER), "po_forward_basis.cuh")
# the 21 monomials dx^c dy^d of the collapsed ap rows, c outer (fwd::kPairs)
PAIRS = [(c, d) for c in range(6) for d in range(6 - c)]
PAIR_OF = {cd: j for j, cd in enumerate(PAIRS)}
FWD_TOL = 5e-7
K1_TOL = 4e-6
FITS = sorted(glob.glob(os.path.join(LENS_DIR, "*.npz")))


def collapse(table, x, y):
    """The coefficients A_cd(x, y) [N, 2, 21] of ap's rows apx, apy as a
    polynomial in the conditioned (dx, dy), summed as ``fwd::Collapse``
    sums them, in float64."""
    t = table.double()
    ux = (x - t[4]) * t[0]
    uy = (y - t[5]) * t[1]
    ap = t[pk.FWD_AP:pk.FWD_PT].reshape(len(pk.BASIS), 2)
    A = torch.zeros(x.shape[0], 2, len(PAIRS), dtype=torch.float64)
    for k, (a, b, c, d) in enumerate(pk.BASIS):
        A[:, :, PAIR_OF[(c, d)]] += ap[k] * (ux ** a * uy ** b)[:, None]
    return A


def pair_poly(A, u, v):
    """``fwd::pair_poly``: the value of sum A_cd u^c v^d and its partials
    along u and v, by the kernel's nested Horner (A [N, 21])."""
    p = A[:, PAIR_OF[(0, 5)]]
    pu = pv = torch.zeros_like(p)
    for d in range(4, -1, -1):
        top = 5 - d
        q, qu = A[:, PAIR_OF[(top, d)]], torch.zeros_like(p)
        for c in range(top - 1, -1, -1):
            qu = q if c == top - 1 else qu * u + q
            q = q * u + A[:, PAIR_OF[(c, d)]]
        pv = p if d == 4 else pv * v + p
        pu = qu if d == 4 else pu * v + qu
        p = p * v + q
    return p, pu, pv


def pt_walk(table, s):
    """pt's rows o0..o3, trans [N, 5] over the 126 monomials of the raw
    unknowns ``s`` [N, 4], as ``fwd::PtSums`` walks them, in float64."""
    t = table.double()
    u = (s - t[4:8]) * t[:4]
    mono = torch.prod(u[:, None, :] ** torch.tensor(pk.BASIS,
                                                    dtype=torch.float64), -1)
    n = len(pk.BASIS)
    rows = torch.cat([t[pk.FWD_PT:pk.FWD_TRANS].reshape(n, 4),
                      t[pk.FWD_TRANS:pk.FWD_TRANS + n, None]], 1)
    return mono @ rows


def ap_rows(table, s):
    """ap's rows [N, 2] and their derivatives [N, 2, 2] along the raw
    (dx, dy) at ``s`` [N, 4]: the collapse, then the Horner rows."""
    t = table.double()
    A = collapse(t, s[:, 0], s[:, 1])
    udx = (s[:, 2] - t[6]) * t[2]
    udy = (s[:, 3] - t[7]) * t[3]
    rows = [pair_poly(A[:, r], udx, udy) for r in range(2)]
    vals = torch.stack([r[0] for r in rows], -1)
    der = torch.stack([torch.stack([r[1] * t[2], r[2] * t[3]], -1)
                       for r in rows], 1)
    return vals, der


def k1_emulation(table, x, y, ax, ay, inv_ap_z, sensor_shift, iterations):
    """``po_forward_trace`` (csrc/po_forward_basis.cuh) in float64 on the
    float32 ``table``: collapse, the 2x2 Newton on the Horner rows with the
    kernel's det guard and update, the sensor shift, the pt walk.
    Returns (out4 [N, 4], trans [N] >= 0, dx, dy)."""
    t = table.double()
    A = collapse(t, x, y)
    dx = (ax - x) * inv_ap_z
    dy = (ay - y) * inv_ap_z
    for _ in range(iterations):
        udx = (dx - t[6]) * t[2]
        udy = (dy - t[7]) * t[3]
        apx, j00, j01 = pair_poly(A[:, 0], udx, udy)
        apy, j10, j11 = pair_poly(A[:, 1], udx, udy)
        j00, j10, j01, j11 = j00 * t[2], j10 * t[2], j01 * t[3], j11 * t[3]
        r0, r1 = apx - ax, apy - ay
        det = j00 * j11 - j01 * j10
        det = torch.where(det.abs() < 1e-12, 1e-12, det)
        dx = dx - (j11 * r0 - j01 * r1) / det
        dy = dy - (-j10 * r0 + j00 * r1) / det
    s = torch.stack([x + dx * sensor_shift, y + dy * sensor_shift, dx, dy],
                    -1)
    out = pt_walk(t, s)
    return out[:, :4], torch.clamp(out[:, 4], min=0.0), dx, dy


@pytest.mark.parametrize("name, degree, lam_um", CASES)
def test_forward_table_matches_lens(name, degree, lam_um):
    """K1's table read the kernel's way (ap collapsed and evaluated by
    Horner with both partials, pt walked over the basis) against
    ``poly_eval`` and the autograd Jacobian of the lens.  Tolerance as the
    solve table's, 5e-7 of each row's scale (measured at most 6.4e-9 on
    values, 1.5e-9 on derivatives)."""
    lens = load_poly_lens(name, degree=degree, device="cpu")
    table = pk.fold_forward_tables(lens, lam_um, "cpu")
    assert table.dtype == torch.float32
    assert table.shape == (pk.FWD_TABLE_FLOATS,)
    rng = np.random.default_rng(4)
    u = torch.as_tensor(rng.uniform(-1.0, 1.0, (4000, 4)))
    s = lens.pt.in_shift[:4].double() + u / lens.pt.in_scale[:4].double()
    got_ap, got_der = ap_rows(table, s)
    got_pt = pt_walk(table, s)

    s_g = s.clone().requires_grad_(True)
    s5 = torch.cat([s_g, torch.full_like(s[:, :1], lam_um)], -1)
    want_ap = poly_eval(lens.ap.double(), s5)[:, :2]
    want_der = torch.stack([torch.autograd.grad(
        want_ap[:, r].sum(), s_g, retain_graph=True)[0][:, 2:]
        for r in range(2)], 1)
    want_pt = poly_eval(lens.pt.double(), s5)[:, :5].detach()
    assert scaled_err(got_ap, want_ap.detach(), 0) < FWD_TOL
    assert scaled_err(got_der, want_der, (0, 2)) < FWD_TOL
    assert scaled_err(got_pt, want_pt, 0) < FWD_TOL


def _rays(lens, n=4000):
    """Seeded sensor points (mm) and aperture points within 0.6 of the
    housing radius, f32."""
    rng = np.random.default_rng(8)
    x, y = (torch.as_tensor(rng.uniform(-14, 14, n).astype(np.float32))
            for _ in range(2))
    r = lens.aperture_housing_radius * 0.6
    ax, ay = (torch.as_tensor(rng.uniform(-r, r, n).astype(np.float32))
              for _ in range(2))
    return x, y, ax, ay


def _assert_traces_agree(got, want, tol):
    keep_g, keep_w = got[1] > 0, want[1] > 0
    assert 0.2 < float(keep_w.double().mean())
    assert float((keep_g == keep_w).double().mean()) >= 0.999
    both = keep_g & keep_w
    for g, w in zip(got, want):
        assert scaled_err(g[both].double(), w[both].double(), 0) < tol


@pytest.mark.parametrize("name, degree, lam_um", CASES)
def test_k1_emulation_matches_plain(name, degree, lam_um):
    """The whole K1 algorithm in float64 on the folded table against
    ``po_forward_plain`` (the same algorithm in float32) on seeded rays:
    ``trans > 0`` agrees on >= 99.9% of rays (measured: all) and every
    output on the rays both keep to 4e-6 of its scale (measured at most
    1.9e-6, trans at 0.45 um: float32 rounding of the sums, whose terms
    cancel to ~1e-5 mm of a ~10 mm pupil point)."""
    lens = load_poly_lens(name, degree=degree, device="cpu")
    table = pk.fold_forward_tables(lens, lam_um, "cpu")
    x, y, ax, ay = _rays(lens)
    shift = 2.0
    got = k1_emulation(table, x.double(), y.double(), ax.double(),
                       ay.double(), 1.0 / lens.aperture_z, shift, 3)
    _assert_traces_agree(
        got, pk.po_forward_plain(lens, x, y, ax, ay, lam_um, shift, 3),
        K1_TOL)


@pytest.mark.parametrize("name, degree, lam_um", CASES)
def test_k1_plain_matches_the_term_trace(name, degree, lam_um):
    """``po_forward_plain`` (the kernel's arithmetic on the folded table)
    computes K1's function: against ``pt_sample_aperture`` then
    ``pt_evaluate`` on the fit's own terms (both float32), ``trans > 0``
    agrees on >= 99.9% of rays (measured: all) and every output on the
    rays both keep lies within 1e-5 of its scale (measured at most
    2.9e-6)."""
    lens = load_poly_lens(name, degree=degree, device="cpu")
    x, y, ax, ay = _rays(lens)
    _assert_traces_agree(
        pk.po_forward_plain(lens, x, y, ax, ay, lam_um, 2.0, 3),
        pk._po_forward_terms(lens, x, y, ax, ay, lam_um, 2.0, 3), 1e-5)


@pytest.mark.parametrize("path", FITS, ids=os.path.basename)
def test_committed_fit_folds_forward_and_passes_the_basis_check(path):
    lens = load_poly_lens("", path=path, device="cpu")
    pk.check_basis(lens)
    table = pk.fold_forward_tables(lens, 0.55, "cpu")
    assert bool(torch.isfinite(table).all())
    assert not bool(table[pk.FWD_TRANS + len(pk.BASIS):].any())   # padding


def test_forward_layout_matches_the_cuda_header():
    """The offsets of ``csrc/po_forward_basis.cuh`` (evaluated from its
    constexpr expressions) are the Python ones; so is the most solve tables
    K3b and K6 take."""
    with open(FWD_HEADER) as f:
        text = f.read()
    env = {"kMonomials": len(pk.BASIS), "kDegree": pk.BASIS_DEGREE}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", text):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    assert env["kHeader"] == pk.FWD_HEADER
    assert env["kAp"] == pk.FWD_AP
    assert env["kPt"] == pk.FWD_PT
    assert env["kTrans"] == pk.FWD_TRANS
    assert env["kTableFloats"] == pk.FWD_TABLE_FLOATS
    assert env["kPairs"] == len(PAIRS)
    size = int(re.search(r"kTableFloats == (\d+)", text).group(1))
    assert size == pk.FWD_TABLE_FLOATS
    with open(HEADER) as f:
        n_tab = re.search(r"kMaxSolveTables = (\d+);", f.read()).group(1)
    assert int(n_tab) == pk.MAX_SOLVE_TABLES


# ------------------------------------------- the basis check before a frame


def _outside_basis_lens():
    lens = load_poly_lens(FLAGSHIP, degree=3, device="cpu")
    for fn in (lens.pt, lens.ap):
        fn.exponents[-1] = torch.tensor([6, 0, 0, 0, 0])
        fn.max_degree = 6
    return lens


def test_check_basis_refuses_a_monomial_outside_the_basis():
    lens = _outside_basis_lens()
    with pytest.raises(ValueError, match="outside the degree-5 basis"):
        pk.check_basis(lens)
    with pytest.raises(ValueError, match="outside the degree-5 basis"):
        pk.fold_forward_tables(lens, 0.55, "cpu")


def test_fit_outside_the_basis_renders_on_the_cpu():
    """Only the card's folded kernels need the basis: on the CPU the plain
    versions render such a fit, as JAX does."""
    import pota_tpu_torch as pt
    from pota_tpu_torch.optics.focus import setup_po_camera
    from pota_tpu_torch.render import scene as sc
    from pota_tpu_torch.render.renderer import check_supported, look_at
    from pota_tpu_torch.render.renderer import render_frame

    lens = _outside_basis_lens()
    cfg = pt.CameraConfig(camera_type=pt.CameraType.POLYNOMIAL_OPTICS,
                          fstop=2.8, focus_distance=20.0,
                          vignetting_retries=1, splat_queue_mult=2)
    rc = pt.RenderConfig(xres=8, yres=8, spp=1)
    check_supported(cfg, rc, po_lens=lens)
    img, fb = render_frame(cfg, rc, sc.lightgrid_scene(n=2, z=-150.0,
                                                       device="cpu"),
                           look_at([0, 0, 0], [0, 0, -1], device="cpu"),
                           po_lens=lens, po_state=setup_po_camera(lens, cfg))
    assert img.shape == (8, 8, 4) and bool(torch.isfinite(img).all())
