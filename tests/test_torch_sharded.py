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
"""
import dataclasses
import os

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


def _gather_rows(mesh, tile):
    """The whole frame from every rank's band of rows."""
    full = tile.new_empty((tile.shape[0] * mesh.size,) + tile.shape[1:])
    sh._all_gather_single(full, tile.contiguous(), mesh.group)
    return full


def _job_frames(mesh):
    out = {}
    for name in FRAMES:
        rc, scene = _frame_case(name)
        img, fb = sh.render_frame_sharded(CFG, rc, scene, _m(), mesh, seed=0)
        if rc.yres % mesh.size == 0:
            img = _gather_rows(mesh, img)
            fb = {k: _gather_rows(mesh, v) for k, v in fb.items()}
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
            merged = {k: _gather_rows(mesh, v) for k, v in merged.items()}
        out.update({f"{label}/{k}": v for k, v in merged.items()})
    return out


def _job_step(mesh, aovs=None):
    lens, state, scene, target = _step_case()
    loss, grads = sh.train_step_sharded(STEP_CFG, STEP_RC, scene, _m(), mesh,
                                        target, lens, state, aovs=aovs)
    return {"loss": loss, "g_pt": grads[0], "g_ap": grads[1]}


JOBS = {"frames": _job_frames, "halo": _job_halo, "tie": _job_tie,
        "step": _job_step,
        "step_aovs": lambda mesh: _job_step(mesh, STEP_AOVS)}


def _rank_main(rank, world, store, out_dir, job):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = sh.make_mesh(world, backend="gloo")
        assert (mesh.rank, mesh.size, mesh.device) == (rank, world,
                                                       torch.device("cpu"))
        out = JOBS[job](mesh)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: v.detach().numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path, world: int, job: str) -> list:
    """Run ``job`` on ``world`` gloo ranks; each rank's results."""
    out_dir = tmp_path / job
    out_dir.mkdir()
    mp.start_processes(_rank_main, args=(world, str(tmp_path / f"{job}.store"),
                                         str(out_dir), job),
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
