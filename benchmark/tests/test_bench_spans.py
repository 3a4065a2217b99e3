"""The readers of the program's spans and counters (``harness/spans.py``)
on hand-made trace events and counters, and in a traced run of a cell cut
to a CPU test's size."""
import time

import pytest
import torch

from conftest import small
from harness import report, spans, spec, trace
from harness import world as wd
from harness.loop import Record

SEED = 2 ** 33 + 23


def events(with_spans: bool = True):
    """A window 0-200 us, one step: the forward's chunk 10-40 (two kernels,
    a copy), ``loss.backward`` 100-190 holding the recompute's chunk
    110-130 (one kernel), K1v's span 140-150 (one kernel) and two kernels
    of autograd's own nodes; without ``with_spans`` the same launches with
    no ``pota.*`` range (the parent of the spans)."""
    ann = lambda n, a, b: {"cat": "user_annotation", "name": n, "ts": a,
                           "dur": b - a}
    launch = lambda c, t: {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": t, "dur": 1, "args": {"correlation": c}}
    kern = lambda c, n, a, d, cat="kernel": {
        "cat": cat, "name": n, "ts": a, "dur": d, "args": {"correlation": c}}
    out = [ann(trace.WINDOW, 0, 200), ann(trace.UNIT, 0, 200),
           ann(trace.BACKWARD, 100, 190)]
    if with_spans:
        out += [ann(spans.CHUNK, 10, 40), ann("pota.k1", 20, 30),
                ann(spans.CHUNK, 110, 130), ann("pota.k1v", 140, 150)]
    return out + [
        # the forward chunk: busy 15-20 and 30-35 of 10-40
        launch(1, 12), kern(1, "elementwise", 15, 5),
        launch(2, 22), kern(2, "po_forward_kernel", 30, 5),
        launch(3, 25), kern(3, "Memcpy DtoD", 33, 2, "gpu_memcpy"),
        # the recompute: busy 115-125 of 110-130
        launch(4, 112), kern(4, "po_forward_kernel", 115, 10),
        launch(5, 141), kern(5, "po_forward_vjp_kernel", 150, 8),
        # autograd's own nodes, inside the backward and no pota span
        launch(6, 160), kern(6, "indexing_backward_kernel", 161, 12),
        launch(7, 175), kern(7, "Memset (Device)", 176, 3, "gpu_memset"),
        # after the backward: the descent
        launch(8, 192), kern(8, "mul", 193, 4),
    ]


def record(with_spans=True, kind="step"):
    return Record(kind=kind, trace=trace.Summary(events(with_spans)))


def test_span_readers():
    rec = record()
    # kernels launched in the chunks: two forward, one recompute (no copy)
    assert spans.chunk_launches(rec, "step") == 3
    # idle in the chunks: 30 - 10 (+ the copy inside) and 20 - 10
    assert spans.chunk_idle_ms(rec, "step") == pytest.approx(0.030)
    # inside the backward, outside pota.*: the gather VJP and the memset
    assert spans.backward_glue_ms(rec, "step") == pytest.approx(0.015)
    assert spans.chunk_launches(rec, "frame") is None


def test_span_readers_find_nothing_without_the_programs_spans():
    rec = record(with_spans=False)
    for read in (spans.chunk_launches, spans.chunk_idle_ms,
                 spans.backward_glue_ms):
        assert read(rec, "step") is None


def test_counter_readers(monkeypatch):
    from pota_tpu_torch.utils import trace as counters

    rec = record()
    rec.trace.units = 2
    counts = {"folds.basis": 2, "folds.solve": 2, "host_reads": 30,
              "splat.queue_slots": 400, "splat.issued_slots": 300,
              "splat.valid_splats": 75, "k1v.candidates": 1000,
              "k1v.live": 64}
    monkeypatch.setattr(counters, "snapshot", lambda: counts)
    assert spans.per_unit(rec, "step", ("folds.",)) == 2.0
    assert spans.per_unit(rec, "step", ("host_reads",)) == 15.0
    assert spans.per_unit(rec, "step", ("nothing",)) == 0.0
    assert spans.share_pct(rec, "step", "splat.issued_slots",
                           "splat.queue_slots") == pytest.approx(75.0)
    assert spans.share_pct(rec, "step", "k1v.live",
                           "k1v.candidates") == pytest.approx(6.4)
    assert spans.share_pct(rec, "step", "a", "unknown") is None
    assert spans.per_unit(rec, "frame", ("host_reads",)) is None
    assert spans.per_unit(Record(kind="step"), "step", ("x",)) is None


def test_counter_readers_without_the_programs_counters(monkeypatch):
    """A program without ``utils/trace.py`` gives no counter metric."""
    monkeypatch.setattr(wd, "PROGRAM", "no_such_program_package")
    rec = record()
    assert spans.counters(rec) is None
    assert spans.per_unit(rec, "step", ("folds.",)) is None
    assert spans.share_pct(rec, "step", "k1v.live", "k1v.candidates") is None


def test_a_traced_fit_reads_the_new_metrics():
    """A traced run of the fit cell cut to 16x16 on the CPU reports every
    new metric that the CPU's plain path has something for."""
    from pota_tpu_torch.utils import trace as counters

    counters.reset()
    cell = small(spec.load_cell("po_grad_4k.fit"), (16, 16))
    cell.traffic["trace_units"] = 1
    out = report.run_cell(cell, SEED, 0.2, True, torch.device("cpu"),
                          time.perf_counter())
    counters.reset()
    assert out["correct"]
    got = out["metrics"]
    # no kernel on the CPU: the chunks' launches are none, their time idle
    assert got["trace_launches.step"]["value"] == 0.0
    assert got["trace_idle_ms.step"]["value"] > 0
    # the plain differentiable path folds no table and reads no device
    assert got["folds.step"]["value"] == 0.0
    assert got["host_reads.step"]["value"] == 0.0
    assert 0 < got["queue_fill_pct.step"]["value"] <= 100
    assert 0 <= got["splat_valid_pct.step"]["value"] <= 100
    assert "k1v_live_pct.step" not in got
