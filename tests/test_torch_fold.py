"""The folded backward-solve table of K3's flagship instantiation
(``pota_tpu_torch.ops.po_kernels.fold_solve_tables``) on the CPU.

The table is evaluated here in float64, as ``csrc/po_solve_basis.cuh``
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
    a = pk._folded_table(lens, 0.55, _params(0.55))
    assert pk._folded_table(lens, 0.55, _params(0.55)) is a
    b = pk._folded_table(lens, 0.45, _params(0.45))
    assert b is not a and not torch.equal(a, b)
    with torch.no_grad():
        lens.pt.coeffs[0, 0] += 1.0
    c = pk._folded_table(lens, 0.45, _params(0.45))
    assert c is not b
    assert torch.equal(c, pk.fold_solve_tables(lens, 0.45, "cpu"))


def test_fold_refuses_a_wavelength_params_do_not_carry():
    lens = load_poly_lens(FLAGSHIP, degree=3, device="cpu")
    with pytest.raises(ValueError, match="not the wavelength of params"):
        pk._folded_table(lens, 0.55, _params(0.45))
