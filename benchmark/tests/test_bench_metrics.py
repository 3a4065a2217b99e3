"""The trace arithmetic, the metric readers and the roofline counts on
hand-made inputs."""
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest

from harness import readers, solve_count, trace
from harness.loop import Record


def events():
    """A window 0-100 us: two units; kernels launched inside named
    ranges; a copy; a kernel outside the window."""
    ann = lambda n, a, b: {"cat": "user_annotation", "name": n, "ts": a,
                           "dur": b - a}
    launch = lambda c, t: {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": t, "dur": 1, "args": {"correlation": c}}
    kern = lambda c, n, a, d, cat="kernel": {
        "cat": cat, "name": n, "ts": a, "dur": d, "args": {"correlation": c}}
    return [
        ann(trace.WINDOW, 0, 100), ann(trace.UNIT, 0, 50),
        ann(trace.UNIT, 50, 100), ann("render_sample_stream", 0, 20),
        ann("splat_frame", 20, 45), ann("render_sample_stream", 50, 70),
        launch(1, 5), kern(1, "po_forward_kernel", 10, 10),
        launch(2, 25), kern(2, "void po_splat_kernel<0>(float*)", 25, 20),
        # overlaps the last: the union counts 40-50 once
        launch(3, 30), kern(3, "Memcpy DtoD", 40, 10, "gpu_memcpy"),
        launch(4, 55), kern(4, "po_forward_kernel", 60, 10),
        launch(5, 95), kern(5, "late", 95, 20),
    ]


def test_busy_idle_and_ranges():
    s = trace.Summary(events())
    assert s.window == (0, 100) and s.units == 2
    assert s.window_s == pytest.approx(100e-6)
    # union inside the window: 10-20, 25-50, 60-70, 95-100
    assert s.busy_s == pytest.approx(50e-6)
    assert s.busy_in("render_sample_stream") == pytest.approx(20e-6)
    assert s.busy_in("splat_frame") == pytest.approx(30e-6)
    assert s.kernel_time("po_splat_kernel") == (pytest.approx(20e-6), 1)
    assert len(s.kernels()) == 4        # copies are no kernels
    b = s.breakdown()
    ops = dict(b["device_ops"])
    assert ops["po_forward_kernel"] == pytest.approx(20e-6)
    assert ops["Memcpy DtoD"] == pytest.approx(10e-6)
    gaps = dict(b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(50e-6)
    # each gap named by the innermost range open where it begins: 0-10
    # and 50-60 render_sample_stream, 20-25 splat_frame, 70-95 the unit
    assert gaps["render_sample_stream"] == pytest.approx(20e-6)
    assert gaps["splat_frame"] == pytest.approx(5e-6)
    assert gaps[trace.UNIT] == pytest.approx(25e-6)


def test_readers_on_a_record():
    s = trace.Summary(events())
    rec = Record(kind="frame", trace=s)
    assert readers.idle_pct(rec, "frame") == pytest.approx(50.0)
    assert readers.idle_pct(rec, "step") is None
    assert readers.launches(rec, "frame") == pytest.approx(2.0)
    assert readers.busy_ms(rec, "frame", ("render_sample_stream",)) == \
        pytest.approx(0.01)
    assert readers.busy_ms(rec, "frame", ("nothing",)) is None
    win = Record(kind="frame", units=4, window_s=0.4,
                 unit_s=[0.1, 0.1, 0.1, 0.1])
    assert readers.mean_unit_ms(win, "frame") == pytest.approx(100.0)
    assert readers.p95_unit_ms(win, "frame") == pytest.approx(100.0)
    assert readers.mean_unit_ms(win, "step") is None
    win.unit_s = [i / 1000 for i in range(1, 101)]
    # the inclusive 95th percentile of 1..100 ms
    assert readers.p95_unit_ms(win, "frame") == pytest.approx(95.05)


def tiny_fit(path):
    """A fit of two terms a row: 1 and x (exponents of x, y, dx, dy, and
    the wavelength), the second also as x * lambda, which folds onto x."""
    exps = np.array([[0, 0, 0, 0, 0], [1, 0, 0, 0, 0], [1, 0, 0, 0, 1]],
                    np.int32)
    np.savez(path, pt_exponents=exps, ap_exponents=exps,
             pt_coeffs=np.ones((5, 3), np.float32),
             ap_coeffs=np.ones((2, 3), np.float32))
    return path


def test_solve_count_by_hand(tmp_path):
    path = tiny_fit(os.path.join(tmp_path, "fit.npz"))
    rows = solve_count.row_monomials(path)
    assert rows["apx"] == {(0, 0, 0, 0), (1, 0, 0, 0)}
    # per iteration: monomials 1 and x (the partial of x along x is 1):
    # 2 multiplies; values 6 rows x 2 coefficients; Jacobian 6 rows x 1
    # term (x along x): 18 multiply-adds; 60 for the solve
    per_iter = 2 + 2 * 18 + 60
    # final: 2 monomials, 4 rows x 2 coefficients
    final = 2 + 2 * 8
    assert solve_count.solve_flops(path, 3) == 3 * per_iter + final


def test_roofline_share(tmp_path):
    path = tiny_fit(os.path.join(tmp_path, "fit.npz"))
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = trace.Summary(events())
    # 10 ** 9 queue slots: 8 a sample
    world = SimpleNamespace(
        fit=path, cfg=SimpleNamespace(splat_queue_mult=8,
                                      lt_newton_iterations=3),
        rc=SimpleNamespace(xres_region=125_000, yres_region=1_000, spp=1))
    rec = Record(kind="frame", trace=s, base=base, world=world)
    flops = 10 ** 9 * solve_count.solve_flops(path, 3)
    n_bytes = 10 ** 9 * 41
    least = max(flops / readers.F32_FLOPS_PER_S,
                n_bytes / readers.HBM_BYTES_PER_S)
    got = readers.roofline_pct(rec, "frame", "po_splat", "po_splat_kernel")
    assert got == pytest.approx(100.0 * least / 20e-6)
    assert readers.roofline_pct(rec, "frame", "po_backward",
                                "po_backward_kernel") is None
    assert math.isfinite(got)
