"""The port's spans and counters (``pota_tpu_torch/utils/trace.py``).

Without a profiler a span records nothing and a count keeps nothing.
Under ``torch.profiler`` (the CPU here) a frame and a differentiable step
show the layers' ``pota.*`` ranges where they run, the backward's own
spans inside ``loss.backward``, the fold cache's misses by key and the
splat queue's counts, equal to what ``with_diagnostics`` returns; a glass
frame with the id-matte shows its stage's span and ``resolve_crypto``'s,
its ``crypto.*`` counts equal to the records' counted by hand, one host
read a boolean index of ``crypto_topk``, and the untraced frame's bits.

The ``cuda`` cases run on the card (this file imports no JAX, so they run
there without the suite's conftest):

    python -m pytest tests/test_torch_trace.py --noconftest -q

They hold ``host_reads`` and ``host_writes`` together to the synchronising
calls of the program that ``torch.cuda.set_sync_debug_mode("warn")``
reports over a small fit step and over an id-matte frame,
K1v's ``k1v.live`` to the plain predicate's count, and K1v's gradients to
the same bits with and without its count.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import pota_tpu_torch as pt
from pota_tpu_torch.ops import po_kernels as pk
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import POState
from pota_tpu_torch.render import renderer
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render import splat as splat_mod
from pota_tpu_torch.render.crypto import crypto_topk
from pota_tpu_torch.render.renderer import look_at, render_frame
from pota_tpu_torch.render.splat import (resolve_aovs, resolve_crypto,
                                         splat_frame)
from pota_tpu_torch.utils import trace

torch.set_num_threads(2)

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
CFG = pt.CameraConfig(
    camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
    fstop=2.8, focus_distance=20.0, vignetting_retries=2, splat_queue_mult=4,
    trace_chunks=4)
STATE = POState(aperture_radius=4.672678708153359,
                sensor_shift=15.091056449990935, focus_distance=200.0,
                tan_fov=0.36734693877551)
RC = pt.RenderConfig(xres=32, yres=32, spp=1)
SPLAT_STAGES = ("camera_space", "gates", "queue", "source_table", "weights",
                "payload", "accum", "sort")
# the decomposed route's own stages (the camera trucked across the shutter)
DECOMPOSED_STAGES = ("project", "occlusion")


@pytest.fixture(autouse=True)
def fresh_counters():
    trace.reset()
    yield
    trace.reset()


def ranges(prof, tmp_path) -> list:
    """The profile's ``record_function`` ranges as (name, start, end)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"]


def named(rs, name) -> list:
    return [r for r in rs if r[0] == name]


def within(r, outer) -> bool:
    return outer[1] <= r[1] and r[2] <= outer[2]


def frame_world(truck: float):
    scene = sc.lightgrid_scene(n=3, spacing=10.0, z=-120.0, radius=1.0,
                               intensity=30.0, device="cpu")
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    m = look_at([0, 0, 0], [0, 0, -1], device="cpu")
    m_end = (look_at([truck, 0, 0], [truck, 0, -1], device="cpu") if truck
             else None)
    return scene, lens, m, m_end


def splatted_frame(scene, lens, m, m_end):
    """The frame's sample stream, splat with its diagnostics, resolve."""
    with torch.no_grad():
        stream = renderer.render_sample_stream(
            CFG, RC, scene, m, seed=7, po_lens=lens, po_state=STATE,
            cam_to_world_end=m_end)
        fb = splat_frame(CFG, RC, scene, stream, m, po_lens=lens,
                         po_state=STATE, cam_to_world_end=m_end,
                         with_diagnostics=True)
        resolve_aovs(RC, fb)
    return fb


def test_no_profiler_no_spans_no_counts():
    """With no profiler recording, a span opens no range and a count keeps
    nothing, on a whole frame too."""
    assert not trace.recording()
    with trace.span("pota.test"):
        trace.count("x", 3)
        trace.count("y", torch.ones(4)[0])
    assert trace.span("pota.test")(lambda a: a + 1)(1) == 2
    splatted_frame(*frame_world(0.0))
    assert trace.COUNTERS == {} and trace.snapshot() == {}


@pytest.mark.parametrize("truck", [0.0, 2.0], ids=["k3", "decomposed"])
def test_frame_spans_and_splat_counts(tmp_path, truck):
    """A 32x32 PO frame under the profiler: ``pota.sample_stream`` (the
    samples, the trace, the shade inside it), ``pota.splat`` holding each
    of its stage spans and the route's kernel spans, ``pota.resolve``; the
    splat's counts equal ``with_diagnostics``' values."""
    world = frame_world(truck)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fb = splatted_frame(*world)
    rs = ranges(prof, tmp_path)
    (stream,) = named(rs, "pota.sample_stream")
    for inner in ("pota.samples", "pota.trace", "pota.shade", "pota.k1"):
        assert [within(r, stream) for r in named(rs, inner)] == [True]
    (splat,) = named(rs, "pota.splat")
    stages = SPLAT_STAGES + (DECOMPOSED_STAGES if truck else ())
    kernels = ("pota.k2", "pota.k6" if truck else "pota.k3", "pota.k4")
    for inner in [f"pota.splat.{s}" for s in stages] + list(kernels):
        got = named(rs, inner)
        assert got and all(within(r, splat) for r in got), inner
    assert not named(rs, "pota.k3" if truck else "pota.k6")
    assert len(named(rs, "pota.resolve")) == 1
    c = trace.snapshot()
    assert c["splat.valid_splats"] == int(fb["_n_valid_splats"]) > 0
    assert c["splat.issued_slots"] == int(fb["_n_issued_slots"]) > 0
    assert c["splat.queue_slots"] == CFG.splat_queue_mult * 32 * 32
    # a CPU tensor is neither read from nor copied to a device; a frame
    # without a gradient builds no slot ranges for ExpandFn's backward
    assert "host_reads" not in c and "host_writes" not in c
    assert "expand.vjp_dead_slots" not in c


def test_step_spans_forward_and_backward(tmp_path):
    """A 32x32 differentiable step with 4 trace chunks: 4
    ``pota.trace.chunk`` spans outside ``loss.backward`` and 4 inside it
    (the checkpoint's recompute), with K1v's, K2's, K4's and the source
    table's VJP spans, and the queue's slots past its live end counted."""
    scene = sc.teapot_scene(device="cpu")
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    for c in (lens.pt.coeffs, lens.ap.coeffs):
        c.requires_grad_(True)
    m = look_at([0, 0, 0], [0, 0, -1], device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        img, _ = render_frame(CFG, RC, scene, m, seed=3, po_lens=lens,
                              po_state=STATE, differentiable=True)
        with torch.profiler.record_function("loss.backward"):
            img[..., :3].mean().backward()
    assert float(lens.pt.coeffs.grad.norm()) > 0
    rs = ranges(prof, tmp_path)
    (back,) = named(rs, "loss.backward")
    chunks = named(rs, "pota.trace.chunk")
    assert sum(within(r, back) for r in chunks) == 4
    assert sum(not within(r, back) for r in chunks) == 4
    for vjp in ("pota.k1v", "pota.expand.vjp", "pota.accum.vjp",
                "pota.source_table.vjp"):
        got = named(rs, vjp)
        assert got and all(within(r, back) for r in got), vjp
    c = trace.snapshot()
    assert c["expand.vjp_dead_slots"] == (c["splat.queue_slots"]
                                          - c["splat.issued_slots"])
    (frame,) = named(rs, "pota.frame")
    assert frame[2] <= back[1]


def lookups(lens, lam):
    """Every look-up of the fold cache: the basis check, K1's and K3's
    tables, K1v's (which looks up K1's table and the unfold's index)."""
    pk.check_basis(lens)
    pk._folded_table(lens, "forward", (lam,), "cpu")
    pk._folded_table(lens, "solve", (lam,), "cpu")
    pk._vjp_tables(lens, lam, "cpu")


def test_folds_count_one_miss_per_key(tmp_path):
    """After an in-place change of the coefficients every key of the fold
    cache misses once, in a ``pota.fold`` span; a repeat misses none; a
    cache pinned as ``benchmark/faults/stale.py`` pins it folds nothing."""
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    lookups(lens, 0.55)
    with torch.no_grad():
        lens.pt.coeffs.mul_(1.0 + 1e-6)
    keys = ("basis", "forward", "solve", "forward_vjp", "unfold")
    want = {f"folds.{k}": 1 for k in keys}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        lookups(lens, 0.55)
        assert trace.snapshot() == want
        lookups(lens, 0.55)
        assert trace.snapshot() == want
    assert len(named(ranges(prof, tmp_path), "pota.fold")) == len(keys)
    pinned = pk._fold_cache(lens)
    fold_cache = pk._fold_cache
    pk._fold_cache = lambda _lens: pinned
    try:
        with torch.no_grad():
            lens.ap.coeffs.mul_(1.0 + 1e-6)
        trace.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            lookups(lens, 0.55)
        assert trace.snapshot() == {}
    finally:
        pk._fold_cache = fold_cache


def test_count_keeps_a_copy_capped_when_read():
    """A device value is kept as a one-element copy of the same dtype (not
    a view of its tensor), added up at the snapshot, capped by ``most``."""
    offs = torch.tensor([3, 9, 14])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        trace.count("tail", offs[-1], most=12)
        trace.count("tail", offs[0], most=12)
        trace.count("n", 5)
    (kept, _, _), _ = trace.COUNTERS["tail"]
    assert kept.shape == (1,) and kept.dtype == offs.dtype
    assert kept.untyped_storage().data_ptr() != offs.untyped_storage(
    ).data_ptr()
    offs[-1] = 0
    assert trace.snapshot() == {"tail": 15, "n": 5}


def test_count_of_a_size_keeps_the_rest():
    """With ``of``, a count is what its value, capped by ``most``, leaves
    of that size: the queue's slots past its live end."""
    offs = torch.tensor([3, 9, 14])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        trace.count("dead", offs[-1], most=20, of=20)
        trace.count("dead", offs[-1], most=12, of=12)
    assert trace.snapshot() == {"dead": 6}


# ------------------------------------------------------------ the id-matte

IDMATTE_RC = pt.RenderConfig(xres=32, yres=24, spp=1, enable_id_matte=True)


def glass_world(dev):
    """``teapot_scene()`` with thin glass of grey 0.5 on spheres 0 and 1
    (the ``po_bidir_1080p.idmatte`` cell's scene), the fit, the camera."""
    scene = sc.teapot_scene(device=dev)
    trans = torch.zeros((scene.n_objects, 3), device=dev)
    trans[:2] = 0.5
    scene = dataclasses.replace(scene, transmission=trans)
    return (scene, load_poly_lens(FLAGSHIP, device=dev),
            look_at([0, 0, 0], [0, 0, -1], device=dev))


def idmatte_frame(scene, lens, m, rc=IDMATTE_RC):
    """An id-matte frame's framebuffer, resolved planes and Cryptomatte
    layers."""
    with torch.no_grad():
        _, fb = render_frame(CFG, rc, scene, m, seed=11, po_lens=lens,
                             po_state=STATE)
        planes = resolve_aovs(rc, fb)
        layers = resolve_crypto(fb, ranks=3)
    return fb, planes, layers


@pytest.fixture
def id_records(monkeypatch):
    """The (pixel, id, weight) records of each id-matte frame rendered."""
    captured = []
    records = splat_mod.id_matte_records

    def capture(*a):
        captured.append(records(*a))
        return captured[-1]

    monkeypatch.setattr(splat_mod, "id_matte_records", capture)
    return captured


def test_idmatte_spans_and_counts(tmp_path, id_records):
    """A glass-teapot frame with the id-matte under the profiler: one
    ``pota.splat.idmatte`` inside ``pota.splat`` and one
    ``pota.resolve.crypto``; ``crypto.records``, ``.live``, ``.runs`` and
    ``.ranked`` equal what the frame's records give counted by hand; the
    planes and layers the untraced frame's bits."""
    world = glass_world("cpu")
    fb0, planes0, layers0 = idmatte_frame(*world)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fb1, planes1, layers1 = idmatte_frame(*world)
    rs = ranges(prof, tmp_path)
    (splat,) = named(rs, "pota.splat")
    (stage,) = named(rs, "pota.splat.idmatte")
    assert within(stage, splat)
    assert len(named(rs, "pota.resolve.crypto")) == 1
    for k in fb0:
        assert torch.equal(fb0[k], fb1[k]), k
    for k in planes0:
        assert torch.equal(planes0[k], planes1[k]), k
    assert all(torch.equal(a, b) for a, b in zip(layers0, layers1))

    (pix, ids, w) = id_records[-1]
    npix = IDMATTE_RC.xres * IDMATTE_RC.yres
    n = npix * IDMATTE_RC.spp
    live = (w > 0) & (ids >= 0) & (pix >= 0) & (pix < npix)
    runs, inv = torch.unique((pix[live].long() << 32) | ids[live].long(),
                             return_inverse=True)
    run_w = torch.zeros(runs.shape[0], dtype=torch.float64).index_add_(
        0, inv, w[live].double())
    per_pixel = torch.bincount(runs[run_w.float() > 0] >> 32,
                               minlength=npix)
    c = trace.snapshot()
    assert {k: c[k] for k in c if k.startswith("crypto.")} == {
        "crypto.records": (CFG.splat_queue_mult + 1) * n * 2,
        "crypto.live": int(live.sum()),
        "crypto.runs": runs.shape[0],
        "crypto.ranked": int(per_pixel.clamp(max=6).sum())}
    assert 0 < runs.shape[0] < int(live.sum())


def test_idmatte_host_reads_are_its_boolean_indexes(monkeypatch,
                                                     id_records):
    """``crypto_topk`` counts one host read a boolean index it makes (each
    reads the count of its True entries from the device): the reads it
    counts equal the boolean indexes the dispatcher sees."""
    from torch.utils._python_dispatch import TorchDispatchMode

    idmatte_frame(*glass_world("cpu"))

    class BoolIndexes(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.index.Tensor and any(
                    i is not None and i.dtype == torch.bool
                    for i in args[1]):
                self.n += 1
            return func(*args, **(kwargs or {}))

    reads = []
    monkeypatch.setattr(trace, "host_read",
                        lambda t, n=1: reads.append(n))
    npix = IDMATTE_RC.xres * IDMATTE_RC.yres
    with BoolIndexes() as seen:
        crypto_topk(*id_records[0], npix, k=6)
    assert seen.n > 0 and sum(reads) == seen.n


# ------------------------------------------------------------ on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def fit_world(dev):
    scene = sc.teapot_scene(device=dev)
    lens = load_poly_lens(FLAGSHIP, device=dev)
    for c in (lens.pt.coeffs, lens.ap.coeffs):
        c.requires_grad_(True)
    return scene, lens, look_at([0, 0, 0], [0, 0, -1], device=dev)


def fit_step(scene, lens, m, target, rc):
    for c in (lens.pt.coeffs, lens.ap.coeffs):
        c.grad = None
    img, _ = render_frame(CFG, rc, scene, m, seed=5, po_lens=lens,
                          po_state=STATE, differentiable=True)
    ((img - target) ** 2).mean().backward()


@pytest.mark.cuda
def test_host_reads_and_writes_are_the_syncs_of_a_fit_step(dev):
    """Over one traced fit step after a descent (so every table refolds),
    ``host_reads`` (device data read to the host) and ``host_writes``
    (blocking copies of host data to the card) add up to the synchronising
    calls in the program's files that the sync debug mode reports."""
    rc = pt.RenderConfig(xres=96, yres=64, spp=1)
    scene, lens, m = fit_world(dev)
    target = torch.zeros((64, 96, 4), device=dev)
    fit_step(scene, lens, m, target, rc)
    with torch.no_grad():
        for c in (lens.pt.coeffs, lens.ap.coeffs):
            c.sub_(c.grad * 1e-9)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fit_step(scene, lens, m, target, rc)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    syncs = [w for w in caught if "synchronizing" in str(w.message)
             and "pota_tpu_torch" in w.filename]
    c = trace.snapshot()
    assert c["host_reads"] > 0 and c["host_writes"] > 0
    assert c["host_reads"] + c["host_writes"] == len(syncs)


@pytest.mark.cuda
def test_k1v_live_count_and_bits(dev):
    """K1v's ``k1v.live`` equals the count of candidates with a non-zero
    cotangent (config 5's 6.4% share, scattered); its gradients are the
    same bits with the count's pointer set (traced) and null."""
    n = 300_001
    lens = load_poly_lens(FLAGSHIP, device=dev)
    rng = np.random.default_rng(2)
    r = lens.aperture_housing_radius * 0.6
    rays = [torch.as_tensor(a.astype(np.float32), device=dev) for a in (
        rng.uniform(-14, 14, n), rng.uniform(-14, 14, n),
        rng.uniform(-r, r, n), rng.uniform(-r, r, n))]
    with torch.no_grad():
        _, _, dx, dy = pk.po_forward(lens, *rays, 0.55, STATE.sensor_shift, 3)
        live = torch.as_tensor(rng.uniform(size=n) < 0.064, device=dev)
        g4 = torch.where(live[:, None],
                         torch.randn((n, 4), device=dev), 0.0).contiguous()
        args = (lens, *rays, dx, dy, g4, None, None, None, 0.55,
                STATE.sensor_shift, False)
        plain = pk.po_forward_vjp(*args)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            counted = pk.po_forward_vjp(*args)
            torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(plain, counted))
    c = trace.snapshot()
    assert c["k1v.candidates"] == n
    assert c["k1v.live"] == int((g4 != 0).any(1).sum()) > 0


@pytest.mark.cuda
def test_host_reads_and_writes_are_the_syncs_of_an_idmatte_frame(dev):
    """Over one traced glass-teapot frame with the id-matte (a warm frame
    first), ``host_reads`` and ``host_writes`` add up to the synchronising
    calls in the program's files that the sync debug mode reports: each
    of ``crypto_topk``'s boolean indexes is one."""
    rc = pt.RenderConfig(xres=96, yres=64, spp=1, enable_id_matte=True)
    world = glass_world(dev)
    idmatte_frame(*world, rc=rc)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                idmatte_frame(*world, rc=rc)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    syncs = [w for w in caught if "synchronizing" in str(w.message)
             and "pota_tpu_torch" in w.filename]
    c = trace.snapshot()
    in_crypto = [w for w in syncs if w.filename.endswith("crypto.py")]
    assert len(in_crypto) == 14
    assert c["host_reads"] + c["host_writes"] == len(syncs)
