"""The port's multi-device frame and lens step
(``pota_tpu_torch/parallel/sharded.py``) on the CPU, ranks joined by gloo,
against the port's single-process frame and step and against the JAX
package's ``sharded.py``.

Each case starts its ranks as spawned processes (one a rank, joined through
a ``file://`` store under ``tmp_path``, so parallel test workers never race
for a port); every rank writes its results to an ``.npz`` that the test
reads.  The cases mirror ``tests/test_sharded.py`` (JAX's, all ``-m slow``
on an 8-device virtual mesh):

* the thin-lens lightgrid frames of ``tests/test_sharded.py:12-17`` at
  16x16 @ 2 spp, 48x48 @ 1 spp (on-frame discs) and the 24x24 @ 2 spp
  "loose" case, sharded over 4 ranks, against the port's ``render_frame``
  and, through the rows the ranks do not divide (16x18), the all-reduce
  merge: every plane bit for bit, as JAX asserts for the first two.  K4
  sums each rank's writers in its own order, so equal bits are not given;
  they were measured on all four (the 24x24 case also holds JAX's 4%
  energy and 3% pixel limits, trivially);
* the PO frame with the default AOVs of ``tests/test_sharded.py:60-108``,
  8 ranks (tile 4 rows, halo 5 rows: the exchange takes two hops), merged
  by the reduce-scatter and by the halo exchange: bit for bit on every
  plane;
* the tie rule on crafted framebuffers: equal depths on several ranks go
  to the lowest rank, in both merges and the all-reduce merge;
* ``train_step_sharded`` on 2 ranks at 16x16 against the one-process
  step (loss and gradients to 1e-5 relative; measured: the loss equal,
  the gradients 9.1e-8 ``pt`` and 4.3e-8 ``ap`` apart, the two ranks'
  sums in another order), the same with a gaussian ``P`` plane besides
  RGBA (to 1e-6), and on one rank against JAX's on a one-device mesh (see
  the test).

``splat_halo_rows`` and ``merge_traffic_bytes`` are held to JAX's.

BASELINE config 5 as published runs on four ranks (the benchmark's cell
``po_grad_4k.sharded4``): the ``fit4`` cases run that step at 16x16 on 4
gloo ranks, built from the benchmark's own configuration by its harness
(``benchmark/harness/world.py``), against the one-process plain reference
(``benchmark/reference/``): the plate and the first beauty gathered from
the bands (``gather_rows``), the loss and gradients of
``train_step_sharded``, and two steps of the harness's descent; the
``merge.bytes`` counter against the analytic count; the merge's spans.
The ``cuda`` case runs the step at 64x64 on four cards over NCCL against
the same computation on one card without a process group, and against
four gloo ranks:

    python -m pytest tests/test_torch_sharded.py --noconftest -q -k nccl
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import pota_tpu_torch as pt
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import setup_po_camera
from pota_tpu_torch.parallel import sharded as sh
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render.aov import DEFAULT_AOVS, GAUSSIAN, AOVSpec
from pota_tpu_torch.render.renderer import look_at, render_frame

torch.set_num_threads(2)

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
# tests/test_sharded.py:12-17
CFG = pt.CameraConfig(focal_length=65.0, fstop=1.8, focus_distance=150.0,
                      vignetting_retries=1, max_bidir_samples=4)
# the lightgrid frames of tests/test_sharded.py (name: rc, scene kwargs)
FRAMES = {
    "16x16": ((16, 16, 2), dict(n=2, spacing=14.0)),
    "48x48": ((48, 48, 1), dict(n=2, spacing=10.0)),
    "24x24": ((24, 24, 2), dict(n=3, spacing=30.0)),
    # 18 rows do not divide by 4 ranks: the all-reduce merge
    "16x18": ((16, 18, 2), dict(n=2, spacing=14.0)),
}
# tests/test_sharded.py:60-108: the PO frame merged two ways
PO_CFG = pt.CameraConfig(
    camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
    fstop=5.6, focus_distance=100.0, vignetting_retries=1,
    max_bidir_samples=4, splat_queue_mult=4, enable_skydome=False)
PO_RC = pt.RenderConfig(xres=32, yres=32, spp=1)
# BASELINE config 5's route (tests/test_torch_grad.py) at 16x16
STEP_CFG = pt.CameraConfig(
    camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
    fstop=2.8, focus_distance=20.0, vignetting_retries=2, splat_queue_mult=4)
STEP_RC = pt.RenderConfig(xres=16, yres=16, spp=1)
STEP_TOL = 1e-5
# a gaussian plane besides RGBA (the port's ROADMAP Q1.8b): the step's
# merge carries nine gaussian columns
STEP_AOVS = list(DEFAULT_AOVS) + [AOVSpec("P_gauss", "VECTOR", GAUSSIAN, "P")]
STEP_AOVS_TOL = 1e-6


def _m():
    return look_at([0, 0, 0], [0, 0, -1], device="cpu")


def _frame_case(name):
    (w, h, spp), kw = FRAMES[name]
    scene = sc.lightgrid_scene(z=-400.0, radius=3.0, intensity=40.0,
                               device="cpu", **kw)
    return pt.RenderConfig(xres=w, yres=h, spp=spp), scene


def _po_case():
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    scene = sc.lightgrid_scene(n=2, spacing=6.0, z=-120.0, radius=0.5,
                               intensity=40.0, device="cpu")
    return lens, setup_po_camera(lens, PO_CFG), scene


def _perturbed(c, seed):
    rng = np.random.default_rng(seed)
    c = np.asarray(c, np.float32)
    return (c * (1.0 + 1e-3 * rng.standard_normal(c.shape))).astype(
        np.float32)


def _step_case():
    """The flagship fit at seeded 1e-3 perturbed coefficients, its camera
    set up from the fit's own, the teapot, and the target: the frame at
    the fit's coefficients."""
    fit = load_poly_lens(FLAGSHIP, device="cpu")
    state = setup_po_camera(fit, STEP_CFG)
    scene = sc.teapot_scene(device="cpu")
    target, _ = render_frame(STEP_CFG, STEP_RC, scene, _m(), po_lens=fit,
                             po_state=state)
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    with torch.no_grad():
        lens.pt.coeffs.copy_(torch.as_tensor(_perturbed(fit.pt.coeffs, 1)))
        lens.ap.coeffs.copy_(torch.as_tensor(_perturbed(fit.ap.coeffs, 2)))
    return lens, state, scene, target


# ------------------------------------------------------------- the ranks


def _job_frames(mesh):
    out = {}
    for name in FRAMES:
        rc, scene = _frame_case(name)
        img, fb = sh.render_frame_sharded(CFG, rc, scene, _m(), mesh, seed=0)
        if rc.yres % mesh.size == 0:
            img = sh.gather_rows(img, mesh)
            fb = {k: sh.gather_rows(v, mesh) for k, v in fb.items()}
        out[f"{name}/image"] = img
        out.update({f"{name}/{k}": v for k, v in fb.items()})
    return out


def _job_halo(mesh):
    lens, state, scene = _po_case()
    halo = sh.splat_halo_rows(PO_CFG, PO_RC, scene, po_state=state)
    out = {"halo": torch.tensor(halo)}
    for label, rows in (("rs", None), ("halo", halo)):
        img, fb = sh.render_frame_sharded(PO_CFG, PO_RC, scene, _m(), mesh,
                                          seed=0, po_lens=lens,
                                          po_state=state, halo_rows=rows)
        out[f"{label}/image"] = img
        out.update({f"{label}/{k}": v for k, v in fb.items()})
    return out


TIE_H, TIE_W, TIE_HALO = 16, 3, 5


def _tie_fb(rank: int) -> dict:
    """Rank ``rank``'s crafted partial framebuffer (16x3, 4 ranks of 4
    rows): seeded gaussian planes inside its reach (its rows and 5 more
    each way), no closest winner elsewhere (``zmin`` 3e38, zeros), and
    three depth ties: row 7 (rank 1's tile) at depth 5 on ranks 0, 1 and
    2; row 8 (rank 2's) at 5 on ranks 1 and 3, 6 on rank 2; row 4 (rank
    1's) at 5 on ranks 2 and 3 only."""
    rng = np.random.default_rng(100 + rank)
    lo, hi = max(rank * 4 - TIE_HALO, 0), min((rank + 1) * 4 + TIE_HALO,
                                               TIE_H)
    rgba = np.zeros((TIE_H, TIE_W, 4), np.float32)
    rgba[lo:hi] = rng.uniform(0.0, 1.0, (hi - lo, TIE_W, 4))
    weight = np.zeros((TIE_H, TIE_W), np.float32)
    weight[lo:hi] = rng.uniform(0.5, 1.0, (hi - lo, TIE_W))
    zmin = np.full((TIE_H, TIE_W), 3e38, np.float32)
    closest = {s.name: np.zeros((TIE_H, TIE_W, 4), np.float32)
               for s in DEFAULT_AOVS[1:]}
    for row, depth in ((7, {0: 5.0, 1: 5.0, 2: 5.0}),
                       (8, {1: 5.0, 2: 6.0, 3: 5.0}),
                       (4, {2: 5.0, 3: 5.0})):
        if rank in depth:
            zmin[row, 1] = depth[rank]
            for v in closest.values():
                v[row, 1] = 10.0 * (rank + 1)
    fb = {"RGBA": rgba, **closest, "filter_weight": weight, "zmin": zmin}
    return {k: torch.as_tensor(v) for k, v in fb.items()}


def _job_tie(mesh):
    rc = pt.RenderConfig(xres=TIE_W, yres=TIE_H)
    fb = _tie_fb(mesh.rank)
    out = {}
    for label, merged in (
            ("rs", sh._merge(fb, DEFAULT_AOVS, rc, mesh, tiled=True)),
            ("halo", sh._halo_merge(fb, DEFAULT_AOVS, rc, mesh, TIE_HALO)),
            ("all", sh._merge(fb, DEFAULT_AOVS, rc, mesh, tiled=False))):
        if label != "all":
            merged = {k: sh.gather_rows(v, mesh) for k, v in merged.items()}
        out.update({f"{label}/{k}": v for k, v in merged.items()})
    return out


# the benchmark's configuration of config 5, cut to a test's size; a
# descent large enough that the second step's loss moves
FIT4_SIZE = (16, 16)
FIT4_SEED = 2 ** 33 + 5
FIT4_DESCENT = 1e-4
BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
# the spans of the sharded step (utils/trace.py: opened while a profiler
# records)
SHARD_SPANS = ("pota.shard", "pota.merge", "pota.merge.zmin",
               "pota.merge.exchange", "pota.merge.sum", "pota.merge.vjp",
               "pota.shard.grads", "pota.shard.backward")


def _bench():
    """The benchmark's harness and the plain reference on the path; the
    harness's world module and ``kinds/step.py``."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from harness import world as wd
    from harness.spec import load_module

    return wd, load_module(os.path.join(BENCH, "kinds", "step.py"),
                           "bench_kinds_step")


def _fit4_config(size=FIT4_SIZE) -> dict:
    import json

    with open(os.path.join(BENCH, "configs", "po_grad_4k.json")) as f:
        config = json.load(f)
    config["render"].update(xres=size[0], yres=size[1])
    config["camera"]["trace_chunks"] = 4
    return config


def _fit4_traffic() -> dict:
    return {"kind": "sharded_step", "perturbation": 1e-3,
            "descent_step": FIT4_DESCENT}


def _job_fit4(mesh, size=FIT4_SIZE, at=None):
    """Config 5's fit on the ranks of ``mesh``, as the benchmark's sharded
    step runs it: the plate, the perturbation from the seed, two steps
    with the harness's descent; then a frame and a step under a profiler
    (the counters and spans), and a step without one (nothing counted).
    With ``at`` (an ``.npz`` of coefficients ``c0_0``, ``c0_1``), also the
    second step's loss at those coefficients (``loss_at``)."""
    from pota_tpu_torch.utils import trace

    wd, step_kind = _bench()
    w = wd.build(wd.PROGRAM, _fit4_config(size), _fit4_traffic(),
                 mesh.device)
    with torch.no_grad():
        band, _ = sh.render_frame_sharded(
            w.cfg, w.rc, w.scene, w.m, mesh,
            seed=wd.unit_seed(FIT4_SEED, -1), po_lens=w.lens,
            po_state=w.state)
    plate = sh.gather_rows(band, mesh)
    # drawn on the CPU, so that a CPU and a CUDA run start from the same fit
    wd.perturb(w, step_kind.make_noise(w.coeffs, FIT4_SEED, "cpu"), 1e-3)
    out = {"plate": plate, "band": band}
    for k in range(2):
        for c in w.coeffs:
            c.grad = None
        loss, grads, img = sh.train_step_sharded(
            w.cfg, w.rc, w.scene, w.m, mesh, plate, w.lens, w.state,
            seed=wd.unit_seed(FIT4_SEED, k), return_image=True)
        for c, g in zip(w.coeffs, grads):
            c.grad = g
        wd.descend(w, FIT4_DESCENT)
        out.update({f"loss{k}": loss, f"image{k}": sh.gather_rows(img, mesh),
                    **{f"g{k}_{i}": g for i, g in enumerate(grads)},
                    **{f"c{k}_{i}": c.detach().clone()
                       for i, c in enumerate(w.coeffs)}})
    trace.reset()
    with torch.profiler.profile() as prof:
        with torch.no_grad():
            sh.render_frame_sharded(w.cfg, w.rc, w.scene, w.m, mesh,
                                    po_lens=w.lens, po_state=w.state)
        frame = trace.snapshot()
        sh.train_step_sharded(w.cfg, w.rc, w.scene, w.m, mesh, plate,
                              w.lens, w.state)
        step = trace.snapshot()
    names = {e.name for e in prof.events()}
    trace.reset()
    sh.train_step_sharded(w.cfg, w.rc, w.scene, w.m, mesh, plate, w.lens,
                          w.state)
    if at is not None:
        given = np.load(at)
        with torch.no_grad():
            for i, c in enumerate(w.coeffs):
                c.copy_(torch.as_tensor(given[f"c0_{i}"]))
        out["loss_at"] = sh.train_step_sharded(
            w.cfg, w.rc, w.scene, w.m, mesh, plate, w.lens, w.state,
            seed=wd.unit_seed(FIT4_SEED, 1))[0]
    out.update({
        "frame_bytes": torch.tensor(frame["merge.bytes"]),
        "frame_calls": torch.tensor(frame["collectives"]),
        "step_bytes": torch.tensor(step["merge.bytes"]
                                   - frame["merge.bytes"]),
        "step_calls": torch.tensor(step["collectives"]
                                   - frame["collectives"]),
        "spans": torch.tensor([n in names for n in SHARD_SPANS]),
        "unprofiled_counts": torch.tensor(len(trace.COUNTERS))})
    return out


def _job_step(mesh, aovs=None):
    lens, state, scene, target = _step_case()
    loss, grads = sh.train_step_sharded(STEP_CFG, STEP_RC, scene, _m(), mesh,
                                        target, lens, state, aovs=aovs)
    return {"loss": loss, "g_pt": grads[0], "g_ap": grads[1]}


JOBS = {"frames": _job_frames, "halo": _job_halo, "tie": _job_tie,
        "step": _job_step, "fit4": _job_fit4,
        "fit4_64": lambda mesh, at=None: _job_fit4(mesh, (64, 64), at),
        "step_aovs": lambda mesh: _job_step(mesh, STEP_AOVS)}


def _rank_main(rank, world, store, out_dir, job, backend="gloo", arg=None):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = sh.make_mesh(world, backend=backend)
        want = (torch.device("cpu") if backend == "gloo"
                else torch.device("cuda", rank))
        assert (mesh.rank, mesh.size, mesh.device) == (rank, world, want)
        out = JOBS[job](mesh) if arg is None else JOBS[job](mesh, arg)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: v.detach().cpu().numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path, world: int, job: str, backend: str = "gloo",
              arg=None) -> list:
    """Run ``job`` on ``world`` ranks (gloo on the CPU, or NCCL a card a
    rank), with ``arg`` if given; each rank's results."""
    out_dir = tmp_path / f"{job}.{backend}"
    out_dir.mkdir()
    store = str(tmp_path / f"{job}.{backend}.store")
    mp.start_processes(_rank_main,
                       args=(world, store, str(out_dir), job, backend, arg),
                       nprocs=world, start_method="spawn")
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


# ------------------------------------------------------------------ tests


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("frames"), 4, "frames")


@pytest.mark.parametrize("name", list(FRAMES))
def test_sharded_frame_matches_single_process(frames, name):
    """Four ranks against ``render_frame``: the image and every plane
    equal (a tiled frame gathered from the ranks' bands; 16x18 on every
    rank); JAX's loose limits on the 24x24 frame."""
    rc, scene = _frame_case(name)
    img, fb = render_frame(CFG, rc, scene, _m(), seed=0)
    got = frames[0]
    assert np.isfinite(got[f"{name}/image"]).all()
    assert got[f"{name}/image"][..., :3].sum() > 0.0
    np.testing.assert_array_equal(got[f"{name}/image"], img.numpy())
    for k, v in fb.items():
        np.testing.assert_array_equal(got[f"{name}/{k}"], v.numpy(),
                                      err_msg=k)
    if rc.yres % 4:
        for r in range(1, 4):
            for k in fb:
                np.testing.assert_array_equal(frames[r][f"{name}/{k}"],
                                              got[f"{name}/{k}"])
    if name == "24x24":
        a, b = got[f"{name}/image"], img.numpy()
        ea, eb = a[..., :3].sum(), b[..., :3].sum()
        assert abs(ea - eb) <= 0.04 * abs(eb)
        assert (np.abs(a - b).max(-1) > 1e-3).mean() < 0.03


def test_halo_merge_matches_reduce_scatter(tmp_path):
    """The PO frame with the default AOVs on 8 ranks: the halo exchange
    engaged (two hops) and equal to the reduce-scatter merge on every
    plane, and the frame equal to ``render_frame``'s."""
    ranks = run_ranks(tmp_path, 8, "halo")
    halo = int(ranks[0]["halo"])
    assert 0 < 2 * halo < 7 * (PO_RC.yres // 8) and halo > PO_RC.yres // 8
    lens, state, scene = _po_case()
    img, fb = render_frame(PO_CFG, PO_RC, scene, _m(), po_lens=lens,
                           po_state=state)
    assert img[..., :3].sum() > 0.0
    for k in ["image", *fb]:
        rs = np.concatenate([r[f"rs/{k}"] for r in ranks])
        hl = np.concatenate([r[f"halo/{k}"] for r in ranks])
        np.testing.assert_array_equal(hl, rs, err_msg=k)
        want = img if k == "image" else fb[k]
        np.testing.assert_array_equal(rs, want.numpy(), err_msg=k)


def test_ties_go_to_the_lowest_rank(tmp_path):
    """Equal depths on several ranks: the lowest rank's closest values win
    in the reduce-scatter, halo and all-reduce merges; the global minimum
    wins otherwise; gaussian planes are the sums in rank order; the three
    merges agree bit for bit."""
    ranks = run_ranks(tmp_path, 4, "tie")
    fbs = [_tie_fb(r) for r in range(4)]
    for label in ("rs", "halo", "all"):
        got = ranks[0] if label != "all" else ranks[3]
        for row, want_rank, z in ((7, 0, 5.0), (8, 1, 5.0), (4, 2, 5.0)):
            assert got[f"{label}/zmin"][row, 1] == z
            for s in DEFAULT_AOVS[1:]:
                assert (got[f"{label}/{s.name}"][row, 1]
                        == 10.0 * (want_rank + 1)).all(), (label, row)
        z = got[f"{label}/zmin"].copy()
        z[[7, 8, 4], 1] = 3e38
        assert (z == np.float32(3e38)).all()
        acc = np.zeros((TIE_H, TIE_W, 4), np.float32)
        for fb in fbs:
            acc = acc + fb["RGBA"].numpy()
        np.testing.assert_array_equal(got[f"{label}/RGBA"], acc)
        for k in fbs[0]:
            np.testing.assert_array_equal(got[f"{label}/{k}"],
                                          ranks[0][f"rs/{k}"], err_msg=k)


def test_halo_rows_and_traffic_match_jax():
    from pota_tpu import CameraConfig as JCfg, CameraType as JType
    from pota_tpu import RenderConfig as JRc
    from pota_tpu.optics.fit import load_poly_lens as jload
    from pota_tpu.optics.focus import setup_po_camera as jsetup
    from pota_tpu.parallel import sharded as jsh
    from pota_tpu.render import scene as jsc

    lens, state, scene = _po_case()
    jcfg = JCfg(camera_type=JType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
                fstop=5.6, focus_distance=100.0, vignetting_retries=1,
                max_bidir_samples=4, splat_queue_mult=4, enable_skydome=False)
    jrc = JRc(xres=32, yres=32, spp=1)
    jscene = jsc.lightgrid_scene(n=2, spacing=6.0, z=-120.0, radius=0.5,
                                 intensity=40.0)
    jstate = jsetup(jload(FLAGSHIP), jcfg)
    halo = sh.splat_halo_rows(PO_CFG, PO_RC, scene, po_state=state)
    assert halo == jsh.splat_halo_rows(jcfg, jrc, jscene, po_state=jstate)
    # the thin lens, with and without the skydome, at two heights
    for sky in (False, True):
        for h in (24, 1080):
            cfg = dataclasses.replace(CFG, enable_skydome=sky)
            jc = JCfg(focal_length=65.0, fstop=1.8, focus_distance=150.0,
                      vignetting_retries=1, max_bidir_samples=4,
                      enable_skydome=sky)
            rc, scene_t = _frame_case("24x24")
            rc = dataclasses.replace(rc, yres=h)
            js = jsc.lightgrid_scene(n=3, spacing=30.0, z=-400.0, radius=3.0,
                                     intensity=40.0)
            assert sh.splat_halo_rows(cfg, rc, scene_t) == \
                jsh.splat_halo_rows(jc, dataclasses.replace(jrc, yres=h,
                                                            xres=24), js)
    for n, ch, rows in ((4, 26, None), (4, 26, halo), (8, 21, 7),
                        (3, 21, None)):
        rc = pt.RenderConfig(xres=1920, yres=1080)
        assert sh.merge_traffic_bytes(rc, n, ch, rows) == \
            jsh.merge_traffic_bytes(JRc(xres=1920, yres=1080), n, ch, rows)


def _check_step_against_one_process(ranks, tol, aovs=None):
    """Each rank's loss and ``pt`` / ``ap`` gradients against the
    one-process step (``render_frame(differentiable=True)``, JAX's L2 loss,
    ``backward``) to ``tol`` relative; the ranks' gradients equal."""
    lens, state, scene, target = _step_case()
    lens.pt.coeffs.requires_grad_(True)
    lens.ap.coeffs.requires_grad_(True)
    img, _ = render_frame(STEP_CFG, STEP_RC, scene, _m(), po_lens=lens,
                          po_state=state, differentiable=True, aovs=aovs)
    loss = ((img - target) ** 2).mean()
    loss.backward()
    loss = float(loss.detach())
    for r in ranks:
        assert abs(float(r["loss"]) - loss) <= tol * loss
        for key, c in (("g_pt", lens.pt.coeffs), ("g_ap", lens.ap.coeffs)):
            want = c.grad.numpy()
            assert np.isfinite(r[key]).all() and np.linalg.norm(want) > 0
            err = np.linalg.norm(r[key] - want) / np.linalg.norm(want)
            print(f"2-rank step {key}: rel L2 {err:.3e}; loss "
                  f"{float(r['loss'])} / {loss}")
            assert err <= tol, (key, err)
    np.testing.assert_array_equal(ranks[0]["g_pt"], ranks[1]["g_pt"])


def test_train_step_sharded_matches_one_process(tmp_path):
    """``train_step_sharded`` on 2 ranks against the one-process step: the
    loss and the ``pt`` and ``ap`` gradients to 1e-5 relative."""
    _check_step_against_one_process(run_ranks(tmp_path, 2, "step"),
                                    STEP_TOL)


def test_train_step_sharded_with_an_extra_gaussian_plane(tmp_path):
    """The same 2-rank step with a gaussian ``P`` plane besides RGBA (the
    differentiable K3 route with nine payload columns, the reduce-scatter
    merging every gaussian plane): to 1e-6 of the one-process step
    (measured: the loss equal, the gradients 9.1e-8 ``pt`` and 4.3e-8 ``ap``
    apart, as without the plane)."""
    _check_step_against_one_process(run_ranks(tmp_path, 2, "step_aovs"),
                                    STEP_AOVS_TOL, STEP_AOVS)


def test_make_mesh_refuses_what_it_cannot_run():
    """Without CUDA the default (NCCL) mesh raises; an unknown backend
    raises; no process group is left behind."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="gloo"):
            sh.make_mesh()
    with pytest.raises(ValueError, match="backend"):
        sh.make_mesh(backend="mpi")
    assert not dist.is_initialized()


def test_train_step_sharded_world_one_matches_jax(tmp_path):
    """One rank (gloo, in this process) against JAX's ``train_step_sharded``
    on a one-device mesh, both at the fit's own coefficients with a zero
    target (the loss ``mean(img^2)``): the loss to 1e-3 relative, the
    gradients to ``test_torch_grad.py::test_step_gradient_matches_jax``'s
    limits (3e-2 ``pt``, 5e-2 ``ap`` relative L2; measured 5.2e-4 and
    4.0e-4, the loss 2.2e-6 apart)."""
    import torch.distributed as dist
    import jax.numpy as jnp

    from pota_tpu import CameraConfig as JCfg, CameraType as JType
    from pota_tpu import RenderConfig as JRc
    from pota_tpu.optics.fit import load_poly_lens as jload
    from pota_tpu.optics.focus import setup_po_camera as jsetup
    from pota_tpu.parallel import sharded as jsh
    from pota_tpu.render import scene as jsc
    from pota_tpu.render.renderer import look_at as jlook

    jcfg = JCfg(camera_type=JType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
                fstop=2.8, focus_distance=20.0, vignetting_retries=2,
                splat_queue_mult=4)
    jlens = jload(FLAGSHIP, degree=5)
    target = np.zeros((STEP_RC.yres, STEP_RC.xres, 4), np.float32)
    j_loss, j_grads = jsh.train_step_sharded(
        jcfg, JRc(xres=16, yres=16, spp=1), jsc.teapot_scene(),
        jlook([0, 0, 0], [0, 0, -1]), jsh.make_mesh(1), jnp.asarray(target),
        jlens, jsetup(jlens, jcfg))

    lens = load_poly_lens(FLAGSHIP, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        loss, grads = sh.train_step_sharded(
            STEP_CFG, STEP_RC, sc.teapot_scene(device="cpu"), _m(),
            sh.make_mesh(1, backend="gloo"), torch.as_tensor(target), lens,
            setup_po_camera(lens, STEP_CFG))
    finally:
        dist.destroy_process_group()
    assert not lens.pt.coeffs.requires_grad and lens.pt.coeffs.grad is None
    assert abs(float(loss) - float(j_loss)) <= 1e-3 * float(j_loss)
    errs = [np.linalg.norm(g.numpy() - np.asarray(j)) / np.linalg.norm(j)
            for g, j in zip(grads, j_grads)]
    print(f"world-1 step vs JAX: loss {float(loss)} / {float(j_loss)}, "
          f"gradient rel L2 pt {errs[0]:.3e} ap {errs[1]:.3e}")
    assert errs[0] < 3e-2 and errs[1] < 5e-2, errs


# ------------------------------------------- config 5 as published: 4 ranks


@pytest.fixture(scope="module")
def fit4(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("fit4"), 4, "fit4")


@pytest.fixture(scope="module")
def fit4_reference():
    """The one-process plain reference (``benchmark/reference/``) from the
    same perturbation: its plate and two steps (``kinds/step.py``)."""
    wd, step_kind = _bench()
    w = wd.build(wd.REFERENCE, _fit4_config(), _fit4_traffic(),
                 torch.device("cpu"))
    plate = wd.plate(w, wd.unit_seed(FIT4_SEED, -1))
    noise = step_kind.make_noise(w.coeffs, FIT4_SEED, "cpu")
    got = step_kind.fit_steps(w, plate, FIT4_SEED, noise, 2, _fit4_traffic())
    return {"plate": plate.numpy(), **got}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_gather_rows_rebuilds_the_frame(fit4, fit4_reference):
    """``gather_rows`` of the four bands is the ranks' bands in rank order,
    the same on every rank, and the plate is the reference's one-process
    frame to an ulp (on the CPU the program's plain path is the
    reference's; measured: 3 of 1,024 values an ulp apart, where splats
    that cross a band's edge add in rank order, not in one segment sum)."""
    h = FIT4_SIZE[1] // 4
    whole = np.concatenate([r["band"] for r in fit4])
    assert fit4[0]["band"].shape[0] == h
    for r in fit4:
        np.testing.assert_array_equal(r["plate"], whole)
    np.testing.assert_allclose(whole, fit4_reference["plate"], rtol=3e-7,
                               atol=0)
    assert whole[..., :3].sum() > 0.0


def test_four_rank_step_matches_the_reference(fit4, fit4_reference):
    """``train_step_sharded`` on 4 ranks against the reference's one-process
    step: the loss to 1e-6 relative (four band sums added by the
    all-reduce, against one sum), the gradients to 1e-5 relative L2 (as
    the 2-rank step: four partial gradients summed in another order), the
    first beauty to 1e-6 (the differentiable splat's per-rank sums merged
    in rank order); the same loss and gradients on every rank."""
    ref = fit4_reference
    for r in fit4:
        assert abs(float(r["loss0"]) - ref["losses"][0]) \
            <= 1e-6 * ref["losses"][0]
        for i, g in enumerate(ref["grad"]):
            assert np.linalg.norm(g.numpy()) > 0
            assert _rel(r[f"g0_{i}"], g.numpy()) <= 1e-5, i
        np.testing.assert_array_equal(r["g0_0"], fit4[0]["g0_0"])
    assert _rel(fit4[0]["image0"], ref["image"].numpy()) <= 1e-6


def test_four_rank_fit_descends_as_the_reference(fit4, fit4_reference):
    """Two steps with the harness's descent (``harness/world.py::descend``,
    1e-4 of the coefficients' norm a step) on the all-reduced gradients:
    the second loss to 1e-6 relative, each step's change of the
    coefficients to 1e-4 relative L2 of the reference's (the first
    gradients' 1e-5, carried through the second step), every rank's
    coefficients the same bits."""
    ref = fit4_reference
    assert abs(float(fit4[0]["loss1"]) - ref["losses"][1]) \
        <= 1e-6 * ref["losses"][1]
    assert ref["losses"][1] != ref["losses"][0]
    for k in range(2):
        for i, c0 in enumerate(ref["c0"]):
            want = ref["cs"][k][i].double() - c0.double()
            got = fit4[0][f"c{k}_{i}"] - c0.double().numpy()
            assert np.linalg.norm(want.numpy()) > 0
            assert _rel(got, want.numpy()) <= 1e-4, (k, i)
            for r in fit4[1:]:
                np.testing.assert_array_equal(r[f"c{k}_{i}"],
                                              fit4[0][f"c{k}_{i}"])


def test_merge_bytes_is_the_analytic_count(fit4):
    """Under a profiler ``merge.bytes`` counts what each collective sends:
    a frame's merge the all-to-all (``merge_traffic_bytes``: 3/4 of the
    25-channel packed frame) and two ``MIN`` all-reduces of an [H, W]
    plane (3/2 of it each, as a ring sends); a step adds its backward's
    all-gather (three bands) and the loss's and gradients' all-reduces."""
    w, h = FIT4_SIZE
    channels = 4 * len(DEFAULT_AOVS) + 1
    rc = pt.RenderConfig(xres=w, yres=h)
    ring = lambda nbytes: int(2 * 3 * nbytes / 4)
    frame = sh.merge_traffic_bytes(rc, 4, channels, None) \
        + 2 * ring(h * w * 4)
    step = frame + 3 * (h // 4) * w * channels * 4 \
        + ring(4) + ring(5 * 160 * 4) + ring(2 * 160 * 4)
    for r in fit4:
        assert int(r["frame_bytes"]) == frame
        assert int(r["step_bytes"]) == step
        assert int(r["frame_calls"]) == 3 and int(r["step_calls"]) == 7


def test_shard_spans_open_under_a_profiler(fit4):
    """The frame's, merge's and step's spans are in a profiled step's
    events; a step without a profiler counts nothing."""
    for r in fit4:
        assert r["spans"].all(), dict(zip(SHARD_SPANS, r["spans"]))
        assert int(r["unprofiled_counts"]) == 0


@pytest.mark.slow
def test_four_rank_step_matches_jax(fit4, fit4_reference):
    """The port's four-rank step against JAX's ``train_step_sharded`` on a
    four-device mesh (virtual CPU devices), from the same perturbed
    coefficients, toward the same plate (the port's, gathered from the
    bands), at the same step seed: the loss to 1e-4 relative and the
    gradients to 1e-3 relative L2 (measured: 2.9e-6, and 4.0e-5 ``pt``,
    4.6e-5 ``ap``; at this size no sample's splat decision differs between
    the two packages' float32 forward values, which is what puts the
    world-1 step above and ``test_torch_grad.py`` at 3e-2)."""
    import jax
    import jax.numpy as jnp

    from pota_tpu import CameraConfig as JCfg, CameraType as JType
    from pota_tpu import RenderConfig as JRc
    from pota_tpu.optics.fit import load_poly_lens as jload
    from pota_tpu.optics.focus import setup_po_camera as jsetup
    from pota_tpu.parallel import sharded as jsh
    from pota_tpu.render import scene as jsc
    from pota_tpu.render.renderer import look_at as jlook

    if len(jax.devices()) < 4:
        pytest.skip("needs four JAX devices")
    wd, _ = _bench()
    config = _fit4_config()
    cam = dict(config["camera"], camera_type=JType.POLYNOMIAL_OPTICS)
    jcfg = JCfg(**cam)
    jlens = jload(config["lens"]["name"], degree=config["lens"]["degree"])
    jstate = jsetup(jlens, jcfg)
    c0 = [c.numpy() for c in fit4_reference["c0"]]
    jlens = dataclasses.replace(
        jlens, pt=dataclasses.replace(jlens.pt, coeffs=jnp.asarray(c0[0])),
        ap=dataclasses.replace(jlens.ap, coeffs=jnp.asarray(c0[1])))
    j_loss, j_grads = jsh.train_step_sharded(
        jcfg, JRc(**config["render"]), jsc.teapot_scene(),
        jlook(*config["camera_pose"]), jsh.make_mesh(4),
        jnp.asarray(fit4[0]["plate"]), jlens, jstate,
        seed=wd.unit_seed(FIT4_SEED, 0))
    loss = float(fit4[0]["loss0"])
    errs = [_rel(fit4[0][f"g0_{i}"], np.asarray(j)) for i, j in
            enumerate(j_grads)]
    print(f"four-rank step vs JAX: loss {loss} / {float(j_loss)}, "
          f"gradient rel L2 pt {errs[0]:.3e} ap {errs[1]:.3e}")
    assert abs(loss - float(j_loss)) <= 1e-4 * float(j_loss)
    assert errs[0] < 1e-3 and errs[1] < 1e-3, errs


def _banded_fit(device, size) -> dict:
    """The fit of ``_job_fit4`` in one process on ``device``, no process
    group: each frame rendered as four ranks render it, band by band of
    the sample stream, merged in rank order
    (``benchmark/kinds/sharded_step.py::_banded_frame``, on the program's
    kernels), the plate, the perturbation, two steps with the descent."""
    from harness.spec import load_module

    wd, step_kind = _bench()
    kind = load_module(os.path.join(BENCH, "kinds", "sharded_step.py"),
                       "bench_kinds_sharded_step")
    w = wd.build(wd.PROGRAM, _fit4_config(size), _fit4_traffic(), device)
    plate = kind._banded_frame(w, wd.unit_seed(FIT4_SEED, -1), 4)
    wd.perturb(w, step_kind.make_noise(w.coeffs, FIT4_SEED, "cpu"), 1e-3)
    out = {"cinit": [c.detach().cpu().numpy().copy() for c in w.coeffs]}
    for k in range(2):
        for c in w.coeffs:
            c.grad = None
        img = kind._banded_frame(w, wd.unit_seed(FIT4_SEED, k), 4,
                                 differentiable=True)
        loss = ((img - plate) ** 2).mean()
        loss.backward()
        wd.descend(w, FIT4_DESCENT)
        out.update({f"loss{k}": float(loss.detach()),
                    f"image{k}": img.detach().cpu().numpy(),
                    **{f"g{k}_{i}": c.grad.cpu().numpy().copy()
                       for i, c in enumerate(w.coeffs)},
                    **{f"c{k}_{i}": c.detach().cpu().numpy().copy()
                       for i, c in enumerate(w.coeffs)}})
    return out


def _cos(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.cuda
def test_nccl_step_matches_gloo(tmp_path):
    """Config 5's sharded step at 64x64 on four cards over NCCL, two steps
    with a 1e-4 descent, against (a) the same computation on one card with
    no process group (``_banded_fit``: the same kernels, each band of the
    sample stream rendered alone and the partials summed in rank order)
    and (b) the same step on four gloo ranks on the CPU, from the same
    perturbation (drawn on the CPU).

    (a) holds the collectives: the losses to 1e-5 relative (the loss's and
    the gradients' sums over ranks in NCCL's order), the first beauty to
    1e-6 relative L1, the first gradients to 1e-4 relative L2 (the
    splat's backward adds with atomics), the coefficients after the first
    descent to 1e-4 relative L2 of their change, and the second step's
    loss to the cell's ``loss_gap``: after the descent a coefficient may
    round an ulp apart, and a K3 slot flips at 1e-11 of the coefficients
    (``tests/test_torch_descent.py``).

    (b) holds what the two devices' float32 arithmetic keeps at this
    size: the first loss, and the second step's loss at the same
    coefficients (gloo's ranks evaluate it at NCCL's), each to the
    benchmark's ``loss_gap`` for config 5 on four ranks
    (``benchmark/checks/po_grad_4k.sharded4.json``); the first change of
    the coefficients by its ``change_gap`` (the benchmark's norm gap); the
    first beauty to 2e-2 relative L1 and the first gradients to a cosine
    of 0.9.  At 64x64 a few highlight samples carry the frame, the loss
    and its gradient, and the card (K1's folded table, K3's slot solve)
    and the CPU (the fit's own terms in the differentiable trace) send
    some of their splats to other pixels.  Measured on one card against
    the CPU (the same banded fit, no process group): losses 0.409991 and
    0.409858, first beauty 9.5e-3 apart, first gradients 0.87 (``pt``)
    and 1.43 (``ap``) apart in relative L2 at cosines 0.973 and 0.932, so
    second losses of 0.0605 and 0.4220 after each side's own descent; at
    the same coefficients the two devices give 0.4286 and 0.4220 (gloo's),
    0.0605 and 0.0604 (the card's).  The CPU alone shows the same: the fit
    traced once on its terms and once with K1's arithmetic
    (``po_forward_plain``) gives first gradients 0.31 and 0.48 apart in
    norm and second losses of 0.4220 and 0.0687.  So neither the
    gradients' ``grad_gap`` nor the second loss after each side's own
    descent measures the collectives here; (a) does.  Every NCCL
    rank holds the same losses and coefficients, bit for bit."""
    import json

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from harness.check import norm_gap

    nccl = run_ranks(tmp_path, 4, "fit4_64", backend="nccl")
    at = tmp_path / "nccl_c0.npz"
    np.savez(at, **{f"c0_{i}": nccl[0][f"c0_{i}"] for i in range(2)})
    gloo = run_ranks(tmp_path, 4, "fit4_64", arg=str(at))
    card = _banded_fit(torch.device("cuda", 0), (64, 64))
    with open(os.path.join(BENCH, "checks",
                           "po_grad_4k.sharded4.json")) as f:
        limits = json.load(f)["limits"]
    n, g = nccl[0], gloo[0]
    for r in nccl[1:]:
        for k in range(2):
            assert float(r[f"loss{k}"]) == float(n[f"loss{k}"])
            for i in range(2):
                np.testing.assert_array_equal(r[f"c{k}_{i}"], n[f"c{k}_{i}"])
    change = lambda d: [torch.as_tensor(d[f"c0_{i}"]).double()
                        - torch.as_tensor(card["cinit"][i]).double()
                        for i in range(2)]
    l1 = lambda a, b: float(np.abs(a - b).sum() / np.abs(b).sum())
    gap = lambda a, b: abs(a - b) / abs(b)

    # (a) NCCL against one card without a process group
    print("NCCL / one card: losses "
          f"{float(n['loss0'])} / {card['loss0']}, "
          f"{float(n['loss1'])} / {card['loss1']}; first beauty rel L1 "
          f"{l1(n['image0'], card['image0']):.3e}; first gradients rel L2 "
          + ", ".join(f"{_rel(n[f'g0_{i}'], card[f'g0_{i}']):.3e}"
                      for i in range(2))
          + "; first change rel L2 "
          + ", ".join(f"{_rel(a.numpy(), b.numpy()):.3e}"
                      for a, b in zip(change(n), change(card))))
    assert gap(float(n["loss0"]), card["loss0"]) <= 1e-5
    assert l1(n["image0"], card["image0"]) <= 1e-6
    for i in range(2):
        assert np.linalg.norm(card[f"g0_{i}"]) > 0
        assert _rel(n[f"g0_{i}"], card[f"g0_{i}"]) <= 1e-4, i
    for a, b in zip(change(n), change(card)):
        assert _rel(a.numpy(), b.numpy()) <= 1e-4
    assert gap(float(n["loss1"]), card["loss1"]) <= limits["loss_gap"]

    # (b) NCCL against gloo
    cosines = [_cos(n[f"g0_{i}"], g[f"g0_{i}"]) for i in range(2)]
    grads = lambda d: [torch.as_tensor(d[f"g0_{i}"]).double()
                       for i in range(2)]
    print("NCCL / gloo: first loss "
          f"{float(n['loss0'])} / {float(g['loss0'])}; first beauty rel L1 "
          f"{l1(n['image0'], g['image0']):.3e}; change_gap "
          f"{norm_gap(change(n), change(g)):.3e}; second loss at NCCL's "
          f"coefficients {float(n['loss1'])} / {float(g['loss_at'])} "
          f"(gloo's own {float(g['loss1'])}); first gradients: norm gap "
          f"{norm_gap(grads(n), grads(g)):.3e}, cosines {cosines}")
    assert gap(float(n["loss0"]), float(g["loss0"])) <= limits["loss_gap"]
    assert l1(n["image0"], g["image0"]) <= 2e-2
    assert norm_gap(change(n), change(g)) <= limits["change_gap"]
    assert gap(float(n["loss1"]), float(g["loss_at"])) \
        <= limits["loss_gap"]
    assert min(cosines) >= 0.9, cosines
