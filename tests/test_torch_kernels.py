"""The plain versions of the port's four kernels against the JAX package's
Pallas kernels (interpret mode on the CPU), plus the gate chain and the
queue they feed.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold each one against these plain versions.
"""
import copy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pota_tpu import CameraConfig, CameraType, RenderConfig
from pota_tpu.ops import po_pallas
from pota_tpu.ops.splat_accum import BAND_PX, CHUNK, accumulate_sorted
from pota_tpu.optics.focus import POState
from pota_tpu.render import splat as jsplat

from pota_tpu_torch.ops import po_kernels as pk
from pota_tpu_torch.ops import splat_accum as tacc
from pota_tpu_torch.optics.polynomial import lt_sample_aperture
from pota_tpu_torch.render import splat as tsplat

from tests.test_po_pallas import synthetic_lens  # noqa: F401 (fixture)
from tests.test_torch_optics import scaled_err, to_torch_lens
from tests.test_torch_slice import to_port

torch.set_num_threads(2)

CFG = CameraConfig(
    camera_type=CameraType.POLYNOMIAL_OPTICS,
    lens_model="synthetic_test_lens", fstop=2.0, focus_distance=30.0,
    vignetting_retries=2, max_bidir_samples=16, splat_queue_mult=6,
)
STATE = POState(aperture_radius=8.0, sensor_shift=2.0, focus_distance=300.0,
                tan_fov=0.36)
RC = RenderConfig(xres=48, yres=40, spp=2)


# ------------------------------------------------------------- K1 forward


def test_po_forward_plain_matches_pallas(synthetic_lens):
    lens = synthetic_lens
    rng = np.random.default_rng(7)
    n = 1500
    x, y = (rng.uniform(-15, 15, n).astype(np.float32) for _ in range(2))
    ax, ay = (rng.uniform(-8, 8, n).astype(np.float32) for _ in range(2))
    # the port's K1 takes the frame's one wavelength; the Pallas kernel one
    # per ray
    lam_um = 0.47
    lam = np.full(n, lam_um, np.float32)
    kern = po_pallas.build_po_forward_kernel(lens, 1.5, newton_iterations=3,
                                             interpret=True)
    want = kern(*(jnp.asarray(a) for a in (x, y, ax, ay, lam)))
    got = pk.po_forward(to_torch_lens(lens),
                        *(torch.as_tensor(a) for a in (x, y, ax, ay)),
                        lam_um, 1.5, 3)
    # float32 rounding only: measured 1.9e-7 scale-relative
    for g, w in zip(got, want):
        assert scaled_err(g, w) < 1e-6


# -------------------------------------------------------------- K2 expand


def test_expand_plain_matches_pallas():
    rng = np.random.default_rng(3)
    n = 700
    budget = rng.integers(0, 9, n).astype(np.int32)
    redis = rng.uniform(size=n) < 0.4
    s_cap = 4096
    src, slot_on, granted = jsplat.splat_queue_compact(
        jnp.asarray(budget), jnp.asarray(redis), s_cap)
    tf = rng.normal(size=(pk.TF_ROWS, n)).astype(np.float32)
    ti = rng.integers(0, 1 << 20, (pk.TI_ROWS, n)).astype(np.int32)
    # the TPU kernel carries every row as f32 in one [17, nt] table
    nt = -(-n // po_pallas._TS_CHUNK) * po_pallas._TS_CHUNK
    table17 = np.zeros((po_pallas.TBL_ROWS, nt), np.float32)
    table17[:pk.TF_ROWS, :n] = tf
    table17[pk.TF_ROWS:pk.TF_ROWS + pk.TI_ROWS, :n] = ti
    tb = (src[::po_pallas._TS_CHUNK] // po_pallas._TS_CHUNK).astype(jnp.int32)
    want = np.asarray(po_pallas.build_expand_kernel(interpret=True)(
        src.astype(jnp.float32), jnp.asarray(table17), tb))
    ef, ei = pk.expand(torch.as_tensor(np.asarray(src)).to(torch.int32),
                       torch.as_tensor(tf), torch.as_tensor(ti))
    on = np.asarray(slot_on)
    np.testing.assert_array_equal(ef.numpy()[:, on], want[:pk.TF_ROWS, on])
    np.testing.assert_array_equal(
        ei.numpy()[:, on],
        want[pk.TF_ROWS:pk.TF_ROWS + pk.TI_ROWS, on].astype(np.int32))


# --------------------------------------------------------------- K3 splat


def _splat_inputs(n, seed):
    rng = np.random.default_rng(seed)
    pc = np.stack([rng.uniform(-110, 110, n), rng.uniform(-110, 110, n),
                   rng.uniform(-500, -100, n)], 0).astype(np.float32)
    pw = pc.copy()
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    ctr = rng.integers(0, 40, n).astype(np.uint32)
    sky = (rng.uniform(size=n) < 0.05).astype(np.float32)
    spheres = np.array([[x, y, -300.0, 12.0] for x in (-40.0, 40.0)
                        for y in (-40.0, 40.0)], np.float32)
    return pc, pw, seeds, ctr, sky, spheres


def test_splat_params_match():
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [1.0, -2.0, 3.0]
    want = np.asarray(po_pallas.splat_kernel_params(CFG, RC, STATE,
                                                    jnp.asarray(m)))[0]
    got = pk.splat_kernel_params(to_port(CFG), to_port(RC), STATE,
                                 torch.as_tensor(m)).numpy()
    np.testing.assert_array_equal(got, want)


def test_po_splat_plain_matches_pallas(synthetic_lens):
    lens = synthetic_lens
    n = 6000
    pc, pw, seeds, ctr, sky, spheres = _splat_inputs(n, 11)
    params = po_pallas.splat_kernel_params(CFG, RC, STATE,
                                           jnp.eye(4, dtype=jnp.float32))
    kern = po_pallas.build_po_splat_kernel(lens, 3, spheres.shape[0],
                                           interpret=True,
                                           sample_aperture=True)
    want_lin, want_ok = kern(
        *(jnp.asarray(a) for a in (*pc, *pw)), jnp.asarray(seeds),
        jnp.asarray(ctr), jnp.zeros((1, 1), jnp.float32), jnp.asarray(sky),
        params, jnp.asarray(spheres))
    t = torch.as_tensor
    got_lin, got_ok = pk.po_splat(
        to_torch_lens(lens), *(t(a) for a in (*pc, *pw)),
        t(seeds.astype(np.int64)).to(torch.int32),
        t(ctr.astype(np.int64)).to(torch.int32), t(sky),
        t(np.asarray(params)[0]), t(spheres), CFG.lambda_um, 3)
    want_lin, want_ok = np.asarray(want_lin), np.asarray(want_ok)
    got_lin, got_ok = got_lin.numpy(), got_ok.numpy()
    assert 0.2 < want_ok.mean() < 0.95     # the inputs exercise both sides
    # float32 rounding can move a slot across a pixel edge or the pupil
    # rim: agreement on >= 99.9% of slots (measured: all)
    ok_agree = (got_ok == want_ok).mean()
    both = got_ok & want_ok
    lin_agree = (got_lin[both] == want_lin[both]).mean()
    assert ok_agree >= 0.999, ok_agree
    assert lin_agree >= 0.999, lin_agree


def test_po_splat_plain_runs_in_float64(synthetic_lens):
    """The float64 reference solve that ``chip_smoke.py`` holds K3 to: the
    plain version on a float64 copy of the lens and of the float inputs
    solves in float64 with the wavelength unrounded, and agrees with the
    float32 plain version on >= 99.9% of slots (measured: all)."""
    lens = to_torch_lens(synthetic_lens)
    lens64 = copy.deepcopy(lens).double()
    assert lens.pt.coeffs.dtype == torch.float32
    n = 4000
    pc, pw, seeds, ctr, sky, spheres = _splat_inputs(n, 12)
    params = pk.splat_kernel_params(to_port(CFG), to_port(RC), STATE,
                                    torch.eye(4))
    t = torch.as_tensor
    ints = (t(seeds.astype(np.int64)).to(torch.int32),
            t(ctr.astype(np.int64)).to(torch.int32))
    lin32, ok32 = pk.po_splat_plain(lens, *(t(a) for a in (*pc, *pw)), *ints,
                                    t(sky), params, t(spheres), 0.55, 3)
    lin64, ok64 = pk.po_splat_plain(
        lens64, *(t(a).double() for a in (*pc, *pw)), *ints,
        t(sky).double(), params.double(), t(spheres).double(), 0.55, 3)
    sensor5, _, _ = lt_sample_aperture(
        lens64, t(pc.T).double() * -10.0,
        torch.zeros(n, 2, dtype=torch.float64), 0.55)
    assert sensor5.dtype == torch.float64
    assert bool((sensor5[:, 4] == 0.55).all())
    assert 0.2 < float(ok64.double().mean()) < 0.95
    assert float((ok32 == ok64).double().mean()) >= 0.999
    both = ok32 & ok64
    assert float((lin32[both] == lin64[both]).double().mean()) >= 0.999


# --------------------------------------------------------- K4 accumulator


ACCUM_CASES = ("dense", "multi_band", "depth_ties", "hotspot", "all_dead")


def _accum_case(name):
    rng = np.random.default_rng(ACCUM_CASES.index(name))
    if name == "hotspot":
        n, npix = 3 * CHUNK + 11, BAND_PX + 5
        pix = np.full(n, 7, np.int32)
        depth = rng.uniform(1.0, 9.0, n).astype(np.float32)
        return pix, depth, rng.normal(size=(n, 5)).astype(np.float32), \
            np.arange(n, dtype=np.int32), npix
    if name == "all_dead":
        n, npix = 100, 600
        return (np.full(n, npix, np.int32),
                rng.uniform(1, 2, n).astype(np.float32),
                rng.normal(size=(n, 3)).astype(np.float32),
                np.zeros(n, np.int32), npix)
    npix, n, k, dead_frac, ties = {
        "dense": (500, 4000, 5, 0.2, False),
        "multi_band": (3 * BAND_PX + 17, 900, 5, 0.5, False),
        "depth_ties": (300, 3000, 2, 0.2, True),
    }[name]
    pix = rng.integers(0, npix, n).astype(np.int32)
    pix[rng.uniform(size=n) < dead_frac] = npix
    depth = rng.uniform(1.0, 100.0, n).astype(np.float32)
    if ties:
        depth = np.round(depth)
    payload = rng.normal(size=(n, k)).astype(np.float32)
    sid = rng.integers(0, 1 << 20, n).astype(np.int32)
    return pix, depth, payload, sid, npix


@pytest.mark.parametrize("case", ACCUM_CASES)
def test_segment_accum_plain_matches_pallas(case):
    pix, depth, payload, sid, npix = _accum_case(case)
    want = accumulate_sorted(jnp.asarray(pix), jnp.asarray(depth),
                             jnp.asarray(payload), jnp.asarray(sid), npix,
                             interpret=True)
    got = tacc.accumulate_sorted(torch.as_tensor(pix), torch.as_tensor(depth),
                                 torch.as_tensor(payload),
                                 torch.as_tensor(sid), npix)
    # sums in another order than the MXU's: float32 rounding of up to
    # ~3000-term sums (measured 7.6e-5 absolute on the hotspot's ~|50| sums,
    # <= 4.8e-7 elsewhere)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    has = np.asarray(want[3])
    np.testing.assert_array_equal(got[1].numpy()[has],
                                  np.asarray(want[1])[has])
    np.testing.assert_array_equal(got[2].numpy()[has],
                                  np.asarray(want[2])[has])


# ----------------------------------------------------- gates, budget, queue


def _stream(n, seed):
    rng = np.random.default_rng(seed)
    z = rng.uniform(50, 900, n).astype(np.float32)
    z[rng.uniform(size=n) < 0.05] = 1e30
    P = rng.normal(size=(n, 3)).astype(np.float32) * 100
    P[z >= 1e29] = 0.0
    rgba = np.abs(rng.normal(size=(n, 4))).astype(np.float32) * 6
    raydir = rng.normal(size=(n, 3)).astype(np.float32)
    p_cam = np.stack([rng.uniform(-50, 50, n), rng.uniform(-50, 50, n),
                      -rng.uniform(0.5, 900, n)], -1).astype(np.float32)
    return {"z": z, "P": P, "rgba": rgba, "raydir": raydir}, p_cam


@pytest.mark.parametrize("skydome", [False, True])
def test_gates_and_budget_exact(synthetic_lens, skydome):
    import dataclasses

    cfg = dataclasses.replace(CFG, enable_skydome=skydome,
                              max_bidir_samples=2000)
    stream, p_cam = _stream(5000, 5)
    want = jsplat.compute_gates_and_budget(
        cfg, RC, {k: jnp.asarray(v) for k, v in stream.items()},
        jnp.asarray(p_cam), po_lens=synthetic_lens, po_state=STATE)
    got = tsplat.compute_gates_and_budget(
        to_port(cfg), to_port(RC),
        {k: torch.as_tensor(v) for k, v in stream.items()},
        torch.as_tensor(p_cam), po_lens=to_torch_lens(synthetic_lens),
        po_state=STATE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0.0 < np.asarray(want[0]).mean() < 1.0   # the gates cut
    assert len(np.unique(np.asarray(want[1]))) > 20


@pytest.mark.parametrize("s_cap", [4096, 1500])
def test_splat_queue_compact_exact(s_cap):
    rng = np.random.default_rng(9)
    n = 700
    budget = rng.integers(4, 30, n).astype(np.int32)
    redis = rng.uniform(size=n) < 0.5
    want = jsplat.splat_queue_compact(jnp.asarray(budget), jnp.asarray(redis),
                                      s_cap)
    got = tsplat.splat_queue_compact(torch.as_tensor(budget),
                                     torch.as_tensor(redis), s_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
