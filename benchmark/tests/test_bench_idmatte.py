"""The ``po_bidir_1080p.idmatte`` cell on the CPU at a small size: its
configuration's scene, the program against the plain reference, the
reference's ``crypto_topk`` against the program's, the control and the
faults of its kind, and the id-matte metrics on hand-made trace events."""
import dataclasses
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import small
from harness import check, report, spec
from harness import trace as htrace
from harness import world as wd
from harness.loop import Record

CELL = "po_bidir_1080p.idmatte"
SEED = 2 ** 31 + 2 ** 21 + 5
CPU = torch.device("cpu")


def cell(size=(48, 32)):
    return small(spec.load_cell(CELL), size)


def run(c, seed=SEED, traced=False):
    return report.run_cell(c, seed, 0.2, traced, CPU, time.perf_counter())


def test_the_configurations_scene_is_the_glass_teapot():
    """The configuration's scene is ``teapot_scene()`` with thin glass of
    grey 0.5 on spheres 0 and 1 (``chip_smoke.py::glass_teapot``), bit for
    bit, on both sides."""
    c = spec.load_cell(CELL)
    assert c.config["render"]["enable_id_matte"] is True
    assert len(c.config["id_names"]) == 8
    for pkg in (wd.PROGRAM, wd.REFERENCE):
        got = wd.build(pkg, c.config, c.traffic, CPU).scene
        sc = __import__(f"{pkg}.render.scene", fromlist=["x"])
        want = sc.teapot_scene(device=CPU)
        trans = torch.zeros((want.n_objects, 3))
        trans[:2] = 0.5
        want = dataclasses.replace(want, transmission=trans)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a.dtype == b.dtype and torch.equal(a, b), (pkg, f.name)


def test_the_program_against_the_reference():
    """The CPU runs the kernels' plain versions, of which the reference is
    a frozen copy; its id-matte ranks by other means (``torch.unique`` and
    float64 ``index_add_``): every number reads 0."""
    out = run(cell())
    assert out["correct"] and out["failed"] == 0
    assert set(out["checks"]) == {"rgba_l1", "aov_off", "crypto_off"}
    assert all(c["value"] == 0.0 for c in out["checks"].values()), out


def _topk_pair(pix, oid, w, npix, k=6):
    from pota_tpu_torch.render import crypto as program
    from reference.render import crypto as ref

    args = (torch.as_tensor(pix), torch.as_tensor(oid), torch.as_tensor(w))
    return program.crypto_topk(*args, npix, k=k), ref.crypto_topk(
        *args, npix, k=k)


def _tied_stream(seed, n=20000, npix=256, n_ids=40):
    """``tests/test_torch_crypto.py``'s tie cases: seeded records whose
    weights are multiples of 1/8 (exact float32 sums, so equal coverages
    tie), with dead records mixed in."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, npix, n), rng.integers(-1, n_ids, n),
            (rng.integers(0, 9, n) / 8.0).astype(np.float32), npix)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_topk_on_exact_ties(seed):
    """Exact ties break by ascending id on both sides: the same ids, the
    same coverages and totals."""
    got, ref = _topk_pair(*_tied_stream(seed))
    tied = (ref[1][:, 1:] == ref[1][:, :-1]) & (ref[1][:, 1:] > 0)
    assert tied.sum() > 50
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_reference_topk_tie_order():
    pix = np.array([3, 3, 3, 3, 3, 3, 0, 0, 9, 3], np.int64)
    oid = np.array([7, 2, 5, 2, 9, -1, 4, 1, 1, 11], np.int64)
    w = np.array([0.5, 0.25, 0.5, 0.25, 0.5, 4.0, 0.0, 1.0, 1.0, 0.125],
                 np.float32)
    got, ref = _topk_pair(pix, oid, w, 4, k=3)
    assert ref[0][3].tolist() == [2, 5, 7] == got[0][3].tolist()
    assert ref[0][0].tolist() == [1, -1, -1]


def test_near_ties_held_as_the_kind_holds_them():
    """Weights off the float32 grid: float64 coverages a rounding apart may
    rank either way round (the program ranks the rounded values, the
    reference the float64 sums); the kind's ``crypto_off`` reads the packed
    layers' ids only where the coverages are apart, so it reads 0, while
    a swapped pair of apart ranks reads off."""
    kind = spec.load_cell(CELL).kind
    from pota_tpu_torch.render import crypto as program
    from reference.render import crypto as ref

    rng = np.random.default_rng(5)
    npix, n = 64, 4000
    pix = rng.integers(0, npix, n)
    oid = rng.integers(0, 12, n)
    w = rng.uniform(0.0, 1.0, n).astype(np.float32)
    # two ids of pixel 0 whose sums differ by far less than a float32 ulp
    pix = np.concatenate([pix, [0, 0, 0]])
    oid = np.concatenate([oid, [20, 21, 21]])
    w = np.concatenate([w, np.float32([30.0, 15.0]),
                        [np.nextafter(np.float32(15), np.float32(16))]])
    (gi, gw, gt), (ri, rw, rt) = _topk_pair(pix, oid, w, npix)
    assert gi[0, :2].tolist() == [20, 21] and ri[0, :2].tolist() == [21, 20]
    hashes = program.id_hash_table([f"sphere_{i:03d}" for i in range(22)],
                                   device=CPU)
    shape = lambda layers: [t.reshape(8, 8, 4) for t in layers]
    g = shape(program.pack_layers(gi, gw, gt, ranks=3, id_hashes=hashes))
    r = shape(ref.pack_layers(ri, rw, rt, ranks=3, id_hashes=hashes))
    assert kind.crypto_off(g, r) == 0.0
    swapped = [t.clone() for t in g]
    ids = [(p, q) for p in range(8) for q in range(8)
           if abs(float(r[0][p, q, 1] - r[0][p, q, 3])) > 1e-3
           and float(r[0][p, q, 3]) > 0]
    p, q = ids[0]
    swapped[0][p, q, [0, 2]] = swapped[0][p, q, [2, 0]]
    assert kind.crypto_off(swapped, r) == pytest.approx(1 / 64)


def test_control_is_not_correct():
    import calibrate

    c = cell()
    got = calibrate.program_answer(c, SEED, CPU)
    ref = check.reference_answer(c, CPU, SEED, got)
    ctl = check.reference_answer(c, CPU, SEED, got, control=True)
    judged = check.judged(check.numbers(c, ctl, ref), c.check["limits"])
    assert not all(j["ok"] for j in judged.values()), judged


def caught_faults():
    kind = spec.load_cell(CELL).traffic["kind"]
    faults = {f: spec.load_fault(f) for f in spec.fault_names()}
    return [f for f, mod in faults.items()
            if kind in mod.KINDS and getattr(mod, "CAUGHT", True)]


def test_the_kinds_faults():
    assert caught_faults() == ["crypto_one_layer", "crypto_sources_only"]


@pytest.mark.parametrize("fault", caught_faults())
def test_a_fault_under_the_timed_path_is_caught(fault):
    """Each fault moves the matte alone: the beauty and the AOVs read 0,
    ``crypto_off`` fails."""
    with spec.load_fault(fault).planted():
        out = run(cell())
    assert not out["correct"], out["checks"]
    checks = out["checks"]
    assert checks["rgba_l1"]["value"] == 0.0
    assert checks["crypto_off"]["value"] > checks["crypto_off"]["limit"]


def test_a_traced_run_files_a_frame_and_reads_the_id_matte():
    """Traced on the CPU the record is a frame's, the id-matte's spans are
    found (no device operation: busy 0, no roofline), and the counters
    read."""
    from pota_tpu_torch.utils import trace as counters

    counters.reset()
    c = cell((32, 24))
    c.traffic["trace_units"] = 1
    out = run(c, traced=True)
    counters.reset()
    assert out["correct"]
    got = out["metrics"]
    assert got["idmatte_busy_ms.frame"]["value"] == 0.0
    assert got["idmatte_idle_ms.frame"]["value"] > 0
    assert "idmatte_roofline_pct.frame" not in got
    assert 0 < got["queue_fill_pct.frame"]["value"] <= 100


def events():
    """A window 0-300 us, one frame: the splat 20-200 holding the id-matte
    stage 100-180 (two kernels, a copy), a kernel of the splat outside it,
    ``resolve_crypto`` 220-260 (one kernel)."""
    ann = lambda n, a, b: {"cat": "user_annotation", "name": n, "ts": a,
                           "dur": b - a}
    launch = lambda c, t: {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": t, "dur": 1, "args": {"correlation": c}}
    kern = lambda c, n, a, d, cat="kernel": {
        "cat": cat, "name": n, "ts": a, "dur": d, "args": {"correlation": c}}
    return [
        ann(htrace.WINDOW, 0, 300), ann(htrace.UNIT, 0, 300),
        ann("pota.splat", 20, 200), ann("pota.splat.idmatte", 100, 180),
        ann("pota.resolve", 200, 215), ann("pota.resolve.crypto", 220, 260),
        launch(1, 30), kern(1, "po_splat_kernel", 40, 50),
        # the stage: busy 105-125 and 150-170 of 100-180
        launch(2, 102), kern(2, "radixSort", 105, 20),
        launch(3, 130), kern(3, "Memcpy DtoH", 150, 5, "gpu_memcpy"),
        launch(4, 160), kern(4, "scatter", 155, 15),
        # resolve_crypto: busy 230-240 of 220-260
        launch(5, 225), kern(5, "pack", 230, 10),
    ]


def test_idmatte_metrics_read_a_synthetic_trace():
    """Busy: the stage's and resolve's operations (20 + 5 + 15 + 10 us);
    idle: 80 - 40 and 40 - 10 us; the roofline: the world's bytes at the
    HBM peak over the busy time; nothing where the run is not a frame's or
    holds no id-matte span."""
    rec = Record(kind="frame", trace=htrace.Summary(events()),
                 base=spec.HERE)
    read = lambda name: spec.load_module(
        os.path.join(spec.HERE, "metrics", f"{name}.py"),
        f"test_{name.replace('.', '_')}").read
    busy, idle, roof = (read(f"idmatte_{m}.frame")
                        for m in ("busy_ms", "idle_ms", "roofline_pct"))
    assert busy(rec) == pytest.approx(0.050)
    assert idle(rec) == pytest.approx(0.070)
    assert roof(rec) is None                  # no world to count on
    w = SimpleNamespace(
        rc=SimpleNamespace(xres_region=4, yres_region=2, spp=1),
        cfg=SimpleNamespace(splat_queue_mult=8),
        scene=SimpleNamespace(transmission=torch.zeros(3, 3)))
    rec.world = w
    # (8 * 8 + 8) writers, 2 layers, 16 bytes; 8 pixels of 52 bytes
    n_bytes = 72 * 2 * 16 + 8 * 52
    from harness.readers import HBM_BYTES_PER_S

    assert spec.roofline_count(spec.HERE, "idmatte")(w) == (0.0, n_bytes)
    assert roof(rec) == pytest.approx(
        100.0 * n_bytes / HBM_BYTES_PER_S / 50e-6)
    assert busy(Record(kind="step", trace=rec.trace)) is None
    bare = [e for e in events() if not e["name"].startswith("pota.")]
    assert busy(Record(kind="frame", trace=htrace.Summary(bare))) is None
    assert idle(Record(kind="frame", trace=htrace.Summary(bare))) is None
