"""Sample-stream capture and replay of the port against JAX's
(``pota_tpu_torch.native``, ``pota_tpu_torch.render.replay``).

Stream files are byte-identical between the packages, and each reads the
other's.  Replays run on tests/test_replay.py's 32x32 lightgrid
configuration (a thin lens) and on the flagship PO lens, from one captured
JAX stream, and are held to JAX's replay with JAX's own limits (energy
within 2%, fewer than 2% of pixels off by more than 1e-3).  A replay
without a scene takes the decomposed route (no spheres for the fused
kernels to probe), as JAX's does.
"""
import numpy as np
import pytest
import torch

from pota_tpu import CameraConfig, CameraType, RenderConfig
from pota_tpu import native as jnative
from pota_tpu.render import replay as jreplay
from pota_tpu.render import scene as jsc
from pota_tpu.render.renderer import look_at as jlook_at
from pota_tpu.render.renderer import render_sample_stream as jax_stream

from tests.test_torch_slice import jax_stream_to_torch, to_port

from pota_tpu_torch import native
from pota_tpu_torch.optics.fit import load_poly_lens
from pota_tpu_torch.optics.focus import setup_po_camera
from pota_tpu_torch.render import replay, splat as tsplat
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render.renderer import look_at, render_sample_stream

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
# tests/test_replay.py's configuration
CFG = CameraConfig(focal_length=65.0, fstop=1.8, focus_distance=150.0,
                   vignetting_retries=1, max_bidir_samples=8)
CFG_PO = CameraConfig(camera_type=CameraType.POLYNOMIAL_OPTICS,
                      lens_model=FLAGSHIP, fstop=2.8, focus_distance=150.0,
                      vignetting_retries=1, max_bidir_samples=8)
RC = RenderConfig(xres=32, yres=32, spp=2)
# JAX's replay limits (tests/test_replay.py)
ENERGY_TOL, PIXEL_TOL, MAX_PIXELS_OFF = 0.02, 1e-3, 0.02
SCENE_KW = dict(n=2, spacing=40.0, z=-400.0, radius=4.0, intensity=30.0)


def test_stream_files_byte_identical(tmp_path, rng_np):
    d = rng_np.normal(size=(5000, 15)).astype(np.float32)
    pj, pt_ = str(tmp_path / "j.pstream"), str(tmp_path / "t.pstream")
    jnative.write_sample_stream(pj, d)
    native.write_sample_stream(pt_, d)
    assert open(pj, "rb").read() == open(pt_, "rb").read()
    np.testing.assert_array_equal(native.read_sample_stream(pj), d)
    np.testing.assert_array_equal(jnative.read_sample_stream(pt_), d)


def test_stream_header_and_refusals(tmp_path):
    p = str(tmp_path / "s.pstream")
    native.write_sample_stream(p, np.zeros((3, 2), np.float32))
    raw = open(p, "rb").read()
    assert raw[:4] == (0x41544F50).to_bytes(4, "little")
    assert len(raw) == 24 + 3 * 2 * 4
    open(p, "wb").write(raw[:-4])
    with pytest.raises(ValueError, match="truncated"):
        native.read_sample_stream(p)
    open(p, "wb").write(b"\0" * 24)
    with pytest.raises(ValueError, match="sample stream"):
        native.read_sample_stream(p)


def test_text_parse(tmp_path):
    p = str(tmp_path / "dump.txt")
    with open(p, "w") as f:
        f.write("1.5 2.25 -3.0\n4.0 5 6e-2\n")
    vals = native.parse_text_samples(p)
    assert vals.dtype == np.float32
    np.testing.assert_allclose(vals, [1.5, 2.25, -3.0, 4.0, 5.0, 0.06])
    np.testing.assert_array_equal(native.parse_text_samples(p, max_floats=4),
                                  vals[:4])


def test_text_parse_matches_jax(tmp_path, rng_np):
    p = str(tmp_path / "dump.txt")
    d = rng_np.normal(size=(400, 13)).astype(np.float32)
    np.savetxt(p, d, fmt="%.9g", delimiter="\t")
    got = native.parse_text_samples(p)
    np.testing.assert_array_equal(got, jnative.parse_text_samples(p))
    np.testing.assert_array_equal(got, d.ravel())


@pytest.fixture(scope="module")
def streams():
    """JAX's captured streams of the thin-lens and PO configurations."""
    from pota_tpu.optics.fit import load_poly_lens as jload
    from pota_tpu.optics.focus import setup_po_camera as jsetup

    jscene = jsc.lightgrid_scene(**SCENE_KW)
    m = jlook_at([0, 0, 0], [0, 0, -1])
    jlens = jload(FLAGSHIP)
    jstate = jsetup(jlens, CFG_PO)
    out = {"thin": (jax_stream(CFG, RC, jscene, m, seed=0), {}),
           "po": (jax_stream(CFG_PO, RC, jscene, m, seed=0,
                             po_lens=jlens, po_state=jstate),
                  dict(po_lens=jlens, po_state=jstate))}
    return jscene, m, out


def test_capture_matches_jax(streams):
    _, _, out = streams
    for js, _ in out.values():
        want = jreplay.capture_stream(js)
        got = replay.capture_stream(jax_stream_to_torch(
            {k: np.asarray(v) for k, v in js.items()}))
        np.testing.assert_array_equal(got, want)


def test_capture_schema_roundtrip():
    cfg = to_port(CFG)
    m = look_at([0, 0, 0], [0, 0, -1], device="cpu")
    stream = render_sample_stream(cfg, to_port(RC), sc.lightgrid_scene(
        device="cpu", **SCENE_KW), m, seed=0)
    back = replay.stream_from_capture(replay.capture_stream(stream),
                                      device="cpu")
    assert back["px"].dtype == torch.int64
    assert back["obj_id"].dtype == torch.int32
    for k in ("px", "py", "obj_id", "rgba", "P", "raydir", "z", "time"):
        torch.testing.assert_close(back[k], stream[k].to(back[k].dtype),
                                   rtol=0, atol=0)
    assert replay.FIELDS == jreplay.FIELDS


def _port_po():
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    return dict(po_lens=lens, po_state=setup_po_camera(lens, to_port(CFG_PO)))


@pytest.mark.parametrize("with_scene", [True, False],
                         ids=["scene", "null_scene"])
@pytest.mark.parametrize("camera", ["thin", "po"])
def test_replay_matches_jax(streams, tmp_path, camera, with_scene):
    """JAX's capture file replayed by both packages."""
    jscene, jm, out = streams
    js, jpo = out[camera]
    p = str(tmp_path / "golden.pstream")
    jreplay.save_capture(p, js)
    cfg = CFG if camera == "thin" else CFG_PO
    want, _ = jreplay.replay_splat(cfg, RC, jreplay.load_capture(p), jm,
                                   scene=jscene if with_scene else None,
                                   **jpo)
    want = np.asarray(want)

    tscene = sc.lightgrid_scene(device="cpu", **SCENE_KW)
    stream = replay.load_capture(p, device="cpu")
    got, fb = replay.replay_splat(
        to_port(cfg), to_port(RC), stream,
        look_at([0, 0, 0], [0, 0, -1], device="cpu"),
        scene=tscene if with_scene else None,
        **(_port_po() if camera == "po" else {}))
    got = got.numpy()
    assert np.isfinite(got).all()
    ea, eb = got[..., :3].sum(), want[..., :3].sum()
    assert eb > 0
    assert abs(ea - eb) <= ENERGY_TOL * abs(eb), (ea, eb)
    frac = (np.abs(got - want).max(-1) > PIXEL_TOL).mean()
    assert frac < MAX_PIXELS_OFF, frac
    if not with_scene:
        assert tsplat.LAST_ROUTE == ("decomposed_tl" if camera == "thin"
                                     else "decomposed_po")


def test_replay_matches_live_render(tmp_path):
    """tests/test_replay.py's check on the port: a saved and reloaded
    stream replayed with its scene reproduces the live frame."""
    from pota_tpu_torch.render.renderer import render_frame

    cfg, rc = to_port(CFG), to_port(RC)
    scene = sc.lightgrid_scene(device="cpu", **SCENE_KW)
    m = look_at([0, 0, 0], [0, 0, -1], device="cpu")
    live, _ = render_frame(cfg, rc, scene, m, seed=0)
    route = tsplat.LAST_ROUTE
    with torch.no_grad():
        stream = render_sample_stream(cfg, rc, scene, m, seed=0)
    p = str(tmp_path / "live.pstream")
    replay.save_capture(p, stream)
    img, _ = replay.replay_splat(cfg, rc, replay.load_capture(p, device="cpu"),
                                 m, scene=scene)
    assert tsplat.LAST_ROUTE == route == "k5"
    # the same stream through the same route: the same bits
    assert torch.equal(img, live)


def test_null_scene():
    null = replay.NullScene()
    p = torch.zeros(7, 3)
    occ = null.occluded(p, p + 1.0)
    assert occ.dtype == torch.bool and occ.shape == (7,)
    assert not bool(occ.any())
    assert null.n_objects == 0
    assert not hasattr(null, "centers")
