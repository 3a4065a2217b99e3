"""The port's small public helpers against the JAX package on the CPU: the
focus search (``logarithmic_focus_search``, ``focus_check``,
``focus_infinity_shift``) and ``setup_po_camera``'s sensor shift,
``aperture_xy``, ``pixel_to_linear``, ``hash_uniform`` and the non-compact
splat queue ``splat_queue``.

Tolerances: integer and hashing helpers, and the queue, bit for bit; the
focus search picks the same float32 candidate shift as JAX's (measured:
the same on every target here); ``focus_check``'s crossing distance and
``aperture_xy`` are float32 polynomial sums in another order than XLA's,
held to 1e-5 of scale as ``test_torch_optics.py`` holds the polynomials.
JAX's own properties of the focus search (``tests/test_focus_infinity.py``)
are asserted on the port too.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pota_tpu.optics import focus as jfocus
from pota_tpu.optics import polynomial as jpoly
from pota_tpu.optics.fit import load_poly_lens as jload
from pota_tpu.render import sampling as jsampling
from pota_tpu.render import splat as jsplat
from pota_tpu.utils import rng as jrng

import pota_tpu_torch as pt
from pota_tpu_torch.optics import focus as tfocus
from pota_tpu_torch.optics import polynomial as tpoly
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.render import sampling as tsampling
from pota_tpu_torch.render import splat as tsplat
from pota_tpu_torch.utils import rng as trng

torch.set_num_threads(2)

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def lenses():
    return load_poly_lens(FLAGSHIP, device="cpu"), jload(FLAGSHIP)


@pytest.mark.parametrize("target", [1000.0, 2000.0, 200.0, 1e7])
def test_logarithmic_focus_search_matches_jax(lenses, target):
    lens, jlens = lenses
    got = tfocus.logarithmic_focus_search(lens, target)
    assert got == jfocus.logarithmic_focus_search(jlens, target)
    assert got == float(np.float32(got))


def test_focus_infinity_shift_matches_jax(lenses):
    lens, jlens = lenses
    got = tfocus.focus_infinity_shift(lens)
    assert got == jfocus.focus_infinity_shift(jlens)
    # JAX's properties (tests/test_focus_infinity.py): the two infinity
    # estimates agree, and a far target approaches the infinity shift
    s_lt = tfocus.camera_set_focus_infinity(lens)
    assert abs(got) < 5.0 and abs(s_lt - got) < 0.5, (s_lt, got)
    s_far = tfocus.logarithmic_focus_search(lens, 1e7)
    s_near = tfocus.logarithmic_focus_search(lens, 1000.0)
    assert abs(s_far - got) < min(0.05, abs(s_near - got))


@pytest.mark.parametrize("target", [2000.0, 500.0])
def test_focus_check_matches_jax(lenses, target):
    lens, jlens = lenses
    shift = tfocus.logarithmic_focus_search(lens, target)
    dist, ok = tfocus.focus_check(lens, shift)
    j_dist, j_ok = jfocus.focus_check(jlens, shift)
    assert ok and ok == j_ok
    assert abs(dist - j_dist) <= REL_TOL * abs(j_dist)
    # the solved shift focuses near the target (ref src/lentil.h:1643-1648)
    assert abs(dist - target) / target < 0.05, (dist, target)


@pytest.mark.parametrize("focus_distance,extra", [(20.0, 0.0), (200.0, 0.0),
                                                  (150.0, 0.25)])
def test_setup_sensor_shift_is_the_search_candidate(lenses, focus_distance,
                                                    extra):
    """``setup_po_camera``'s shift is the float64 value of the candidate
    ``logarithmic_focus_search`` picks (plus the extra shift), bit for bit
    the value of the inline sweep it replaced."""
    lens, _ = lenses
    cfg = pt.CameraConfig(camera_type=pt.CameraType.POLYNOMIAL_OPTICS,
                          lens_model=FLAGSHIP, fstop=2.8,
                          focus_distance=focus_distance,
                          extra_sensor_shift=extra)
    state = tfocus.setup_po_camera(lens, cfg)
    # the sweep as setup_po_camera ran it before the search was shared
    shifts = tfocus.logarithmic_shift_candidates()
    dist, ok = tfocus._axial_probe_distance(
        lens, torch.tensor(shifts, dtype=torch.float32), cfg.lambda_um)
    delta = focus_distance * 10.0 - dist.double().numpy()
    cand = np.where(ok.numpy() & (delta > 0.0), delta, np.inf)
    want = float(shifts[int(np.argmin(cand))]) + extra
    assert state.sensor_shift == want
    search = tfocus.logarithmic_focus_search(lens, focus_distance * 10.0,
                                             cfg.lambda_um)
    assert search == float(np.float32(state.sensor_shift - extra))


def test_aperture_xy_matches_jax(lenses):
    lens, jlens = lenses
    rng = np.random.default_rng(3)
    n = 2000
    sensor5 = np.stack([rng.uniform(-15, 15, n), rng.uniform(-10, 10, n),
                        rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                        np.full(n, 0.55)], -1).astype(np.float32)
    got = tpoly.aperture_xy(lens, torch.as_tensor(sensor5)).numpy()
    want = np.asarray(jpoly.aperture_xy(jlens, jnp.asarray(sensor5)))
    assert got.shape == want.shape == (n, 2)
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
    # JAX's own check (tests/test_polynomial.py:88): the solved sensor
    # direction hits the aperture target
    target = rng.uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    s5 = sensor5.copy()
    s5[:, 2:4] = 0.0
    solved = tpoly.pt_sample_aperture(lens, torch.as_tensor(s5),
                                      torch.as_tensor(target))
    hit = tpoly.aperture_xy(lens, solved).numpy()
    assert np.median(np.abs(hit - target)) < 1e-4


def test_pixel_to_linear_matches_jax():
    rc = pt.RenderConfig(xres=37, yres=23)
    from pota_tpu import RenderConfig

    jrc = RenderConfig(xres=37, yres=23)
    py, px = np.meshgrid(np.arange(23), np.arange(37), indexing="ij")
    got = tsampling.pixel_to_linear(rc, torch.as_tensor(px),
                                    torch.as_tensor(py)).numpy()
    want = np.asarray(jsampling.pixel_to_linear(jrc, jnp.asarray(px),
                                                jnp.asarray(py)))
    np.testing.assert_array_equal(got, want)
    assert sorted(got.ravel().tolist()) == list(range(37 * 23))


def test_hash_uniform_matches_jax():
    rng = np.random.default_rng(4)
    k0 = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64)
    k1 = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64)
    got = trng.hash_uniform(torch.as_tensor(k0.astype(np.int64)),
                            torch.as_tensor(k1.astype(np.int64))).numpy()
    want = np.asarray(jrng.hash_uniform(jnp.asarray(k0, jnp.uint32),
                                        jnp.asarray(k1, jnp.uint32)))
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0.0) & (got < 1.0)).all()


QUEUE_CASES = {
    # tests/test_gates.py:108-146: a big CoC, an overflow, the >= 1-unit
    # clamp, chromatic triples, a gated-out sample
    "big_coc": ([2000, 4, 4, 4], [1, 1, 1, 1], 1, 4096),
    "overflow": ([2000, 1000], [1, 1], 1, 300),
    "clamp": ([2000, 4, 4], [1, 1, 1], 1, 500),
    "chroma": ([2000, 4, 4], [1, 1, 1], 3, 1500),
    "gated_out": ([2000, 4, 4], [1, 0, 1], 1, 500),
    "short": ([4, 0, 7, 5], [1, 1, 0, 1], 1, 40),
}


def _seeded_queue(seed):
    rng = np.random.default_rng(seed)
    n = 300
    budget = rng.integers(4, 60, n)
    budget[rng.uniform(size=n) < 0.1] = 2000
    return budget.tolist(), (rng.uniform(size=n) < 0.8).tolist(), 1, 4000


@pytest.mark.parametrize("case", list(QUEUE_CASES) + ["seeded"])
def test_splat_queue_matches_jax(case):
    """``splat_queue`` against JAX's bit for bit (integer outputs), and its
    slot layout against ``splat_queue_compact``'s: the same slots and live
    slots, the compact ids numbering the same sources."""
    budget, redis, rpc, size = (_seeded_queue(5) if case == "seeded"
                                else QUEUE_CASES[case])
    b = torch.tensor(budget, dtype=torch.int32)
    r = torch.tensor(redis, dtype=torch.bool)
    src, lane, slot_on, slots = tsplat.splat_queue(b, r, rpc, size)
    want = jsplat.splat_queue(jnp.asarray(budget, jnp.int32),
                              jnp.asarray(redis, bool), rpc, size)
    for got, w in zip((src, lane, slot_on, slots), want):
        assert got.dtype in (torch.int64, torch.bool)
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    src_c, slot_on_c, slots_c = tsplat.splat_queue_compact(b, r, size, rpc)
    assert torch.equal(slot_on, slot_on_c) and torch.equal(slots, slots_c)
    owners = torch.nonzero(slots > 0)[:, 0]
    assert torch.equal(src[slot_on], owners[src_c[slot_on]])
    # the lane counts each source's slots from zero
    starts = torch.cumsum(slots, 0) - slots
    assert torch.equal(lane[slot_on], (torch.arange(size) - starts[src])[
        slot_on])
