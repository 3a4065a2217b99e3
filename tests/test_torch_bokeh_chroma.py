"""The port's image bokeh, chromatic PO splat and blade apertures against
the JAX package on the CPU: the bokeh sampler tables and both samplers, the
PO forward trace with image bokeh, the plain versions of K3's two variants
(``po_splat_lam``, ``po_splat_ext``) against the Pallas splat kernel in
interpret mode, and small PO frames on the synthetic lens (chromatic, with
and without a queue rescale, image bokeh, image bokeh + chromatic, blades)
against JAX's expanded branch, run through its interpret-mode kernels, on
the same sample stream, and the wavelength tables and index each frame
hands K3b.

Tolerances, each set from the value measured on these inputs:
- the bokeh tables are the same numpy build, and the samplers integer
  lookups plus the same float ops: exact;
- the forward trace: float32 rounding of the polynomial sums, 1e-5 of
  scale, as ``tests/test_torch_optics.py`` holds ``trace_fw_po`` (measured
  3.0e-7 on the origins, 1.8e-7 on the directions; tries and weights
  exactly);
- the K3 variants' plain versions: ``ok`` and ``lin`` on >= 99.9% of slots,
  as K3 is held (measured: all 6,000 slots agree in every case);
- the frames: at most 2% of pixels off by more than 2e-3 of the plane's
  scale and RGBA energy to 1e-3, the bound the PO slice is held to.
  Measured: no pixel off in any frame, every plane within 1.3e-8 of scale
  and the energies within 2.3e-10, so the planes are also held to 1e-6 of
  scale.  The frames splat 1,344 to 9,156 slots each; ``chroma_rescaled``
  asks for 16,128 slots, is granted 9,156 of a 9,216-slot queue, and 84 of
  its sources hold a slot count that is not a multiple of 3.  Each frame
  also carries the id-matte: ``crypto_total`` to 1e-6 of scale,
  ``crypto_rank_w`` to 1e-4 (JAX's coverages are float32 prefix
  differences over the whole record stream, 2.8e-5 of scale from a float64
  sum on "chroma", where the port's float64 sums round to 2.8e-8) and
  ``crypto_rank_id`` identical away from near-ties
  (``test_torch_slice.assert_crypto_close``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pota_tpu import CameraConfig, CameraType, RenderConfig
from pota_tpu.io.exr import write_exr
from pota_tpu.ops import po_pallas
from pota_tpu.optics.focus import POState as JPOState
from pota_tpu.render import bokeh_image as jbi
from pota_tpu.render import scene as jsc
from pota_tpu.render import splat as jsplat

import golden_configs as gc
from tests.test_po_pallas import synthetic_lens  # noqa: F401 (fixture)
from tests.test_torch_kernels import _splat_inputs
from tests.test_torch_optics import scaled_err, to_torch_lens
from tests.test_torch_slice import (
    CRYPTO_PLANES,
    assert_crypto_close,
    frac_pixels_off,
    to_port,
)

from pota_tpu_torch import ops
from pota_tpu_torch.models import po_camera as tpc
from pota_tpu_torch.ops import po_kernels as pk
from pota_tpu_torch.optics.focus import POState
from pota_tpu_torch.render import bokeh_image as tbi
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render.renderer import look_at
from pota_tpu_torch.render.splat import resolve_aovs, splat_frame

torch.set_num_threads(2)

TRACE_TOL = 1e-5
PIXEL_TOL, MAX_PIXELS_OFF, ENERGY_TOL = 2e-3, 0.02, 1e-3
RC = RenderConfig(xres=48, yres=48, spp=2)
STATE = dict(aperture_radius=8.0, sensor_shift=2.0, focus_distance=300.0,
             tan_fov=0.36)


def _ring(n=32, lo=0.5, hi=0.95, floor=0.0):
    """The procedural ring aperture of bench.py:145-151 (plus a floor)."""
    yy, xx = np.mgrid[0:n, 0:n]
    r = np.sqrt((xx - (n - 1) / 2) ** 2 + (yy - (n - 1) / 2) ** 2) / (n / 2)
    ring = ((r > lo) & (r < hi)).astype(np.float32) + floor
    return np.stack([ring] * 3, -1)


def _tables(bi):
    """The six sampler tables, in ``bokeh_image_from_numpy``'s order."""
    return [np.asarray(getattr(bi, k)) for k in (
        "cdf_row", "row_indices", "cdf_col", "col_indices", "alias_prob",
        "alias_idx")]


# --------------------------------------------------------------- bokeh


@pytest.mark.parametrize("image", ["ring32", "ring16_floor", "noise24_gray"])
def test_build_bokeh_cdf_matches_jax(image):
    if image == "ring32":
        px = _ring()
    elif image == "ring16_floor":
        px = _ring(16, 0.35, 0.95, 0.05)
    else:
        px = np.random.default_rng(2).uniform(0, 1, (24, 24)).astype(
            np.float32)
    want = jbi.build_bokeh_cdf(px)
    got = tbi.build_bokeh_cdf(px, device="cpu")
    assert got.resolution == want.resolution
    for g, w in zip(_tables(got), _tables(want)):
        np.testing.assert_array_equal(g, w.astype(g.dtype))


@pytest.mark.parametrize("sampler", ["bokeh_sample", "bokeh_sample_alias"])
def test_bokeh_samplers_match_jax(sampler):
    jb = jbi.build_bokeh_cdf(_ring(16, 0.35, 0.95, 0.05))
    # the port's tables carried across from JAX's as numpy arrays
    tb = tbi.bokeh_image_from_numpy(*_tables(jb), jb.resolution,
                                    device="cpu")
    rng = np.random.default_rng(4)
    r1, r2 = (rng.uniform(0, 1, (700, 3)).astype(np.float32)
              for _ in range(2))
    r1[0, :] = [0.0, 1.0 - 2 ** -24, 0.5]
    want = np.asarray(getattr(jbi, sampler)(jb, jnp.asarray(r1),
                                            jnp.asarray(r2)))
    got = getattr(tbi, sampler)(tb, torch.as_tensor(r1), torch.as_tensor(r2))
    assert got.shape == want.shape == (700, 3, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_load_bokeh_image_exr(tmp_path):
    px = _ring(16, 0.35, 0.95, 0.05)
    path = str(tmp_path / "ring.exr")
    write_exr(path, {c: px[..., i] for i, c in enumerate("RGB")})
    want = jbi.load_bokeh_image(path)
    got = tbi.load_bokeh_image(path, device="cpu")
    for g, w in zip(_tables(got), _tables(want)):
        np.testing.assert_array_equal(g, w.astype(g.dtype))


@pytest.mark.parametrize("blades", [0, 6])
def test_trace_fw_po_image_bokeh_matches_jax(synthetic_lens, blades):
    from pota_tpu.models.po_camera import trace_fw_po as jtrace

    cfg = CameraConfig(camera_type=CameraType.POLYNOMIAL_OPTICS,
                       lens_model="synthetic_test_lens", fstop=2.0,
                       focus_distance=30.0, vignetting_retries=3,
                       bokeh_enable_image=blades == 0, aperture_blades=blades)
    jb = jbi.build_bokeh_cdf(_ring(16, 0.35, 0.95, 0.05))
    rng = np.random.default_rng(8)
    n = 2000
    sx, sy = (rng.uniform(-0.9, 0.9, n).astype(np.float32) for _ in range(2))
    r1, r2 = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    key = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    want = jtrace(cfg, synthetic_lens, *(jnp.asarray(a) for a in
                                         (sx, sy, r1, r2)),
                  retry_key=jnp.asarray(key), bokeh_cdf=jb,
                  po_state=JPOState(**STATE), use_pallas=False)
    t = torch.as_tensor
    got = tpc.trace_fw_po(to_port(cfg), to_torch_lens(synthetic_lens),
                          *(t(a) for a in (sx, sy, r1, r2)),
                          t(key.astype(np.int64)), POState(**STATE),
                          bokeh_cdf=tbi.bokeh_image_from_numpy(
                              *_tables(jb), jb.resolution, device="cpu"))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0.3 < float(got[2].mean()) < 1.0
    keep = np.asarray(want[2]) > 0
    for g, w in zip(got[:2], want[:2]):
        assert scaled_err(g.numpy()[keep], np.asarray(w)[keep]) < TRACE_TOL


# --------------------------------------------------------- K3 variants


CHROMA = (0.43, 0.55, 0.73)      # chroma_wavelengths at abb_chromatic 0.6


@pytest.mark.parametrize("variant", ["po_splat_lam", "po_splat_ext",
                                     "po_splat_ext_mono"])
def test_po_splat_variant_plain_matches_pallas(synthetic_lens, variant):
    """K3b's plain versions against the Pallas kernel: the port takes the
    wavelengths as a tuple and an int32 index per slot (the chroma three),
    or one wavelength and no index (``po_splat_ext_mono``: non-chromatic
    image bokeh); JAX takes ``lam = lams[idx]`` per slot."""
    lens = synthetic_lens
    n = 6000
    pc, pw, seeds, ctr, sky, spheres = _splat_inputs(n, 13)
    rng = np.random.default_rng(17)
    mono = variant == "po_splat_ext_mono"
    lams = (0.55,) if mono else CHROMA
    idx = rng.integers(0, len(lams), n).astype(np.int32)
    lam = np.asarray(lams, np.float32)[idx]
    cfg = CameraConfig(camera_type=CameraType.POLYNOMIAL_OPTICS,
                       lens_model="synthetic_test_lens", fstop=2.0,
                       focus_distance=30.0, abb_chromatic=0.0 if mono else 0.6)
    rc = RenderConfig(xres=48, yres=40, spp=2)
    params = po_pallas.splat_kernel_params(cfg, rc, JPOState(**STATE),
                                           jnp.eye(4, dtype=jnp.float32))
    ext = variant != "po_splat_lam"
    kern = po_pallas.build_po_splat_kernel(
        lens, 3, spheres.shape[0], interpret=True,
        sample_aperture=not ext, lam_input=True)
    t = torch.as_tensor
    if ext:
        ap = rng.uniform(-1, 1, (2, n)).astype(np.float32) * 7.0
        a_j, b_j = jnp.asarray(ap[0]), jnp.asarray(ap[1])
        a_t, b_t = t(ap[0]), t(ap[1])
    else:
        a_j, b_j = jnp.asarray(seeds), jnp.asarray(ctr)
        a_t = t(seeds.astype(np.int64)).to(torch.int32)
        b_t = t(ctr.astype(np.int64)).to(torch.int32)
    want_lin, want_ok = (np.asarray(a) for a in kern(
        *(jnp.asarray(a) for a in (*pc, *pw)), a_j, b_j, jnp.asarray(lam),
        jnp.asarray(sky), params, jnp.asarray(spheres)))
    got_lin, got_ok = getattr(pk, "po_splat_ext" if ext else variant)(
        to_torch_lens(lens), *(t(a) for a in (*pc, *pw)), a_t, b_t, lams,
        None if mono else t(idx), t(sky), t(np.asarray(params)[0]),
        t(spheres), 3)
    got_lin, got_ok = got_lin.numpy(), got_ok.numpy()
    assert 0.2 < want_ok.mean() < 0.95
    assert (got_ok == want_ok).mean() >= 0.999
    both = got_ok & want_ok
    assert (got_lin[both] == want_lin[both]).mean() >= 0.999


@pytest.mark.parametrize("variant", ["po_splat_lam", "po_splat_ext"])
@pytest.mark.parametrize("case", ["no_index", "four_lams", "index_int64",
                                  "index_on_one_lam"])
def test_po_splat_variant_refuses_bad_wavelengths(synthetic_lens, variant,
                                                  case):
    """K3b takes one wavelength and no index, or up to three and an int32
    index per slot, as K6 does; anything else raises before any work."""
    n = 16
    pc, pw, seeds, ctr, sky, spheres = _splat_inputs(n, 3)
    t = torch.as_tensor
    if variant == "po_splat_ext":
        a = b = torch.zeros(n)
    else:
        a = t(seeds.astype(np.int64)).to(torch.int32)
        b = t(ctr.astype(np.int64)).to(torch.int32)
    idx = torch.zeros(n, dtype=torch.int32)
    lams, lam_idx, err = {
        "no_index": (CHROMA, None, ValueError),
        "four_lams": (CHROMA + (0.6,), idx, ValueError),
        "index_int64": (CHROMA, idx.long(), TypeError),
        "index_on_one_lam": ((0.55,), idx, ValueError),
    }[case]
    with pytest.raises(err, match="lam"):
        getattr(pk, variant)(to_torch_lens(synthetic_lens),
                             *(t(v) for v in (*pc, *pw)), a, b, lams, lam_idx,
                             t(sky), torch.zeros(pk.SPLAT_PARAM_COUNT),
                             t(spheres), 3)


# ---------------------------------------------------------------- frames


FRAMES = {
    "chroma": {"abb_chromatic": 0.6},
    # a queue too small for the budgets: rescaled slot counts that are not
    # multiples of 3 (ROADMAP Queue 3, chroma channel tint)
    "chroma_rescaled": {"abb_chromatic": 0.6, "max_bidir_samples": 64,
                        "splat_queue_mult": 2},
    "bokeh": {"bokeh_enable_image": True},
    "bokeh_chroma": {"bokeh_enable_image": True, "abb_chromatic": 0.6},
    "blades": {"aperture_blades": 5},
}
GRID = dict(n=3, spacing=30.0, z=-150.0, radius=6.0, intensity=40.0)


def _frame_pair(lens, case):
    """Resolved AOVs and raw energy of JAX's expanded branch and of the
    port's splat, on JAX's sample stream of the synthetic lens, the
    port's framebuffer, and the (name, arguments) of every K3b call."""
    from pota_tpu.render.renderer import render_sample_stream as jstream

    kw = {"max_bidir_samples": 16, "splat_queue_mult": 6, **FRAMES[case]}
    cfg = CameraConfig(camera_type=CameraType.POLYNOMIAL_OPTICS,
                       lens_model="synthetic_test_lens", fstop=2.0,
                       focus_distance=30.0, vignetting_retries=2, **kw)
    jscene = jsc.lightgrid_scene(**GRID)
    jcdf = (jbi.build_bokeh_cdf(_ring(16, 0.35, 0.95, 0.05))
            if cfg.bokeh_enable_image else None)
    js = jstream(cfg, RC, jscene, gc.M, 0, po_lens=lens,
                 po_state=JPOState(**STATE), bokeh_cdf=jcdf,
                 use_pallas=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("POTA_SPLAT_INTERPRET", "1")
        po_pallas.prebuild_splat_kernel(lens, cfg.lt_newton_iterations,
                                        jscene.n_objects)
        jfb = jsplat.splat_frame(cfg, RC, jscene, js, gc.M, po_lens=lens,
                                 po_state=JPOState(**STATE), bokeh_cdf=jcdf,
                                 n_crypto_ids=jscene.n_objects,
                                 use_pallas=True, fused_splat=True)
        assert jsplat._LAST_PATH == "expanded"
    want = {k: np.asarray(v) for k, v in jsplat.resolve_aovs(RC, jfb).items()}
    want.update({k: np.asarray(jfb[k]) for k in CRYPTO_PLANES})

    tjs = {k: torch.as_tensor(np.array(v)) for k, v in js.items()}
    for k in ("px", "py", "sid", "key"):
        tjs[k] = tjs[k].to(torch.int64)
    tcdf = (tbi.bokeh_image_from_numpy(*_tables(jcdf), jcdf.resolution,
                                       device="cpu")
            if jcdf is not None else None)
    calls = []

    def recorder(name):
        def call(*args):
            calls.append((name, args))
            return getattr(ops.KERNELS, name)(*args)
        return call

    fb = splat_frame(to_port(cfg), to_port(RC),
                     sc.lightgrid_scene(**GRID, device="cpu"), tjs,
                     look_at([0, 0, 0], [0, 0, -1], device="cpu"),
                     po_lens=to_torch_lens(lens), po_state=POState(**STATE),
                     bokeh_cdf=tcdf, n_crypto_ids=GRID["n"] ** 2,
                     with_diagnostics=True,
                     ops=ops.KERNELS._replace(
                         po_splat_lam=recorder("po_splat_lam"),
                         po_splat_ext=recorder("po_splat_ext")))
    got = {k: v.numpy() for k, v in resolve_aovs(RC, fb).items()}
    got.update({k: fb[k].numpy() for k in CRYPTO_PLANES})
    energy = (float(fb["RGBA"].double().sum()),
              float(np.asarray(jfb["RGBA"], np.float64).sum()))
    return got, want, energy, fb, calls


@pytest.fixture(scope="module")
def frames(synthetic_lens):
    return {case: _frame_pair(synthetic_lens, case) for case in FRAMES}


@pytest.mark.parametrize("case", list(FRAMES))
def test_frame_matches_jax_expanded_on_same_stream(frames, case):
    got, want, (e_got, e_want), fb, _ = frames[case]
    assert int(fb["_n_valid_splats"]) > 1000
    # JAX's run sums are float32 prefix differences over the frame's 32,256
    # records (total weight 2,304): 2.8e-5 of scale from a float64 sum of
    # the same records on "chroma", the port 2.8e-8
    assert_crypto_close(got, want, w_tol=1e-4)
    for plane in set(want) - set(CRYPTO_PLANES):
        assert np.isfinite(got[plane]).all(), plane
        assert frac_pixels_off(got[plane], want[plane]) <= MAX_PIXELS_OFF, \
            plane
        assert scaled_err(got[plane], want[plane]) < 1e-6, plane
    assert abs(e_got - e_want) <= ENERGY_TOL * abs(e_want)
    npix = RC.xres * RC.yres
    assert abs(float(fb["filter_weight"].sum()) - npix) <= 1e-5 * npix


@pytest.mark.parametrize("case", list(FRAMES))
def test_k3b_gets_the_frame_wavelengths(frames, case):
    """Each frame hands K3b its wavelengths as Python floats: the chroma
    three and the slots' channel (int32, lane % 3 of the source's range) as
    the index when chromatic, else the frame's one and no index; image
    bokeh and blades take the external-aperture kernel."""
    (name, args), = frames[case][4]
    cfg = CameraConfig(**FRAMES[case])
    ext = cfg.bokeh_enable_image or cfg.aperture_blades > 2
    assert name == ("po_splat_ext" if ext else "po_splat_lam")
    lams, lam_idx = args[9], args[10]
    if cfg.abb_chromatic == 0.0:
        assert lams == (cfg.lambda_um,) and lam_idx is None
        return
    assert lams == CHROMA
    assert lam_idx.dtype == torch.int32 and lam_idx.shape == args[1].shape
    assert set(lam_idx.unique().tolist()) == {0, 1, 2}
