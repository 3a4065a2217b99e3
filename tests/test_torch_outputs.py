"""The port's output surface against the JAX package on the CPU: the EXR
and PPM writers, the Arnold-style output strings, the FFT glare imager and
the command line (``python -m pota_tpu_torch.cli``).

Tolerances (measured values in brackets):
* the writers: byte for byte JAX's files; JAX's ``read_exr`` reads the
  port's file back exactly;
* output strings: the same tokens, rebuilt strings and ``AOVSpec`` fields,
  and the same ``ValueError``;
* glare at 64x64 (blades 0 and 6, chroma 0 and 0.5): the mask identical,
  the PSF and the glared frame within 1e-5 of scale [PSF at most 9.2e-7,
  frame 3.0e-7: two FFT libraries' float32 rounding];
* the command line at 16x16 @ 2 spp with ``--aovs --id-matte``, thin lens
  and PO, and the thin lens with a region, glare and a 6-blade iris: the
  EXR holds JAX's channel names and shape, and the beauty is within the
  port's frame rule (at most 2% of pixels off by 2e-3 of scale,
  ``test_torch_slice.frac_pixels_off``) [no pixel off in any; largest
  difference 1.6e-5, 6.0e-5 and 1.0e-5 of scale].
"""
import os

import numpy as np
import pytest
import torch

from pota_tpu.io import exr as jexr
from pota_tpu.render import aov as jaov
from pota_tpu.render import glare as jglare

from pota_tpu_torch import cli
from pota_tpu_torch.io import exr as texr
from pota_tpu_torch.render import aov as taov
from pota_tpu_torch.render import glare as tglare
from test_torch_optics import scaled_err
from test_torch_slice import frac_pixels_off

torch.set_num_threads(2)


# ---------------------------------------------------------------- writers


def _channels(seed=0, h=7, w=13):
    rng = np.random.default_rng(seed)
    names = ["R", "G", "B", "A", "Z", "P.R", "crypto00.A", "lentil_debug.R"]
    planes = {n: rng.standard_normal((h, w)).astype(np.float32)
              for n in names}
    planes["Z"][0, 0] = np.inf
    planes["Z"][-1, -1] = -0.0
    return planes


@pytest.mark.parametrize("shape", [(7, 13), (1, 1), (64, 3)])
def test_write_exr_is_byte_identical(tmp_path, shape):
    planes = _channels(h=shape[0], w=shape[1])
    texr.write_exr(str(tmp_path / "port.exr"), planes)
    jexr.write_exr(str(tmp_path / "jax.exr"), planes)
    got = (tmp_path / "port.exr").read_bytes()
    assert got == (tmp_path / "jax.exr").read_bytes()
    back = jexr.read_exr(str(tmp_path / "port.exr"))
    assert set(back) == set(planes)
    for n, p in planes.items():
        np.testing.assert_array_equal(back[n], p)
    # and the port reads it back too
    for n, p in texr.read_exr(str(tmp_path / "port.exr")).items():
        np.testing.assert_array_equal(p, planes[n])


def test_write_exr_refuses_mismatched_planes(tmp_path):
    with pytest.raises(ValueError, match="shape"):
        texr.write_exr(str(tmp_path / "bad.exr"),
                       {"R": np.zeros((4, 4)), "G": np.zeros((4, 5))})


@pytest.mark.parametrize("gamma", [2.2, 1.0])
def test_write_ppm_is_byte_identical(tmp_path, gamma):
    rgb = np.random.default_rng(1).uniform(-0.5, 3.0, (9, 11, 3)).astype(
        np.float32)
    texr.write_ppm(str(tmp_path / "port.ppm"), rgb, gamma=gamma)
    jexr.write_ppm(str(tmp_path / "jax.ppm"), rgb, gamma=gamma)
    assert ((tmp_path / "port.ppm").read_bytes()
            == (tmp_path / "jax.ppm").read_bytes())


# --------------------------------------------------------- output strings


OUTPUTS = [
    "RGBA RGBA gaussian_filter exr_driver",
    "persp_cam Z FLOAT closest_filter exr_driver HALF",
    "P VECTOR closest_filter exr_driver",
    "persp_cam lentil_raydir rgb gaussian_filter d HALF",
    "RGBA RGBA box_filter other_driver",          # a duplicate name
    "N vec blackman_harris_filter d",
    "lentil_time flt closest_filter d",
    "custom_aov UNKNOWN_TYPE gaussian_filter d",  # unknown type: RGBA
    "Z FLOAT gaussian_filter d",                  # a duplicate of Z
]


@pytest.mark.parametrize("s", OUTPUTS)
def test_tokenizer_matches_jax(s):
    got, want = taov.TokenizedOutput.parse(s), jaov.TokenizedOutput.parse(s)
    assert vars(got) == vars(want)
    assert got.rebuild() == want.rebuild()


@pytest.mark.parametrize("source_map", [None, {"N": "normals", "Z": "depth"}])
def test_specs_from_output_strings_match_jax(source_map):
    got = taov.specs_from_output_strings(OUTPUTS, source_map)
    want = jaov.specs_from_output_strings(OUTPUTS, source_map)
    fields = ("name", "type", "filter", "source", "redistribute")
    assert [tuple(getattr(g, f) for f in fields) for g in got] == [
        tuple(getattr(w, f) for f in fields) for w in want]
    assert len(got) == 7
    assert taov._TYPE_MAP == jaov._TYPE_MAP


@pytest.mark.parametrize("s", ["RGBA RGBA gaussian_filter",
                               "a b c d e f", "", "HALF"])
def test_unparsable_output_string_raises_in_both(s):
    for mod in (taov, jaov):
        with pytest.raises(ValueError, match="unparsable"):
            mod.TokenizedOutput.parse(s)


# ------------------------------------------------------------------ glare


@pytest.mark.parametrize("blades", [0, 6])
@pytest.mark.parametrize("chroma", [0.0, 0.5])
def test_glare_matches_jax(blades, chroma):
    import jax.numpy as jnp

    mask = tglare.aperture_mask(32, blades, device="cpu")
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jglare.aperture_mask(32, blades)))
    psf = tglare.diffraction_psf(mask, chroma=chroma)
    jpsf = np.asarray(jglare.diffraction_psf(jnp.asarray(mask.numpy()),
                                             chroma=chroma))
    assert psf.shape == (32, 32, 3)
    assert scaled_err(psf, jpsf) < 1e-5
    rng = np.random.default_rng(blades + int(10 * chroma))
    img = rng.uniform(0.0, 0.5, (64, 64, 4)).astype(np.float32)
    img[20:23, 30:33, :3] = 40.0  # highlights above the threshold
    got = tglare.resolve_with_glare(torch.as_tensor(img), blades=blades,
                                    intensity=0.3, chroma=chroma,
                                    psf_size=32)
    want = np.asarray(jglare.resolve_with_glare(
        jnp.asarray(img), blades=blades, intensity=0.3, chroma=chroma,
        psf_size=32))
    assert got.shape == (64, 64, 4)
    assert scaled_err(got, want) < 1e-5
    # glare moves energy: the frame's total is kept to float32 rounding
    assert abs(float(got[..., :3].double().sum()) - img[..., :3].sum(
        dtype=np.float64)) < 1e-3 * img[..., :3].sum()


def test_glare_is_differentiable():
    img = torch.zeros((24, 24, 3), dtype=torch.float32)
    img[12, 12] = 5.0
    img.requires_grad_(True)
    out = tglare.resolve_with_glare(img, blades=5, intensity=0.5,
                                    psf_size=16)
    out[12, 14].sum().backward()
    assert torch.isfinite(img.grad).all() and float(img.grad.abs().sum()) > 0


# ---------------------------------------------------------- command line


def test_list_lenses_matches_jax(capsys):
    from pota_tpu.lens.database import lens_names

    assert cli.main(["--list-lenses"]) == 0
    names = capsys.readouterr().out.split()
    assert names == lens_names()
    assert len(names) == 45


def test_unfitted_lens_names_the_fitting_item(tmp_path, monkeypatch):
    """A lens without a committed fit takes the fitting path (JAX's
    ``cli.py:131-135``): a base design is fitted (here at 20,000 samples),
    cached outside ``data/lenses/`` and rendered; an unknown name raises
    the catalog's KeyError."""
    from pota_tpu_torch.optics import fit as tfit

    before = sorted(os.listdir(tfit.LENS_DIR))
    monkeypatch.setattr(tfit, "FIT_CACHE_DIR", str(tmp_path / "fits"))
    fit = tfit.fit_lens
    monkeypatch.setattr(tfit, "fit_lens",
                        lambda *a, **kw: fit(*a, n_samples=20_000, **kw))
    out = str(tmp_path / "dg.exr")
    assert cli.main(["--cpu", "--camera", "po", "--lens", "double_gauss",
                     "--scene", "lightgrid", "--res", "8", "--spp", "1",
                     "--out", out]) == 0
    assert (tmp_path / "fits" / "double_gauss__deg5.npz").exists()
    assert all(np.isfinite(v).all() for v in texr.read_exr(out).values())
    assert sorted(os.listdir(tfit.LENS_DIR)) == before
    with pytest.raises(KeyError, match="unknown lens"):
        cli.main(["--cpu", "--camera", "po", "--lens", "no_such_lens",
                  "--res", "8", "--spp", "1",
                  "--out", str(tmp_path / "x.exr")])


def test_cli_refuses_the_card_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command renders there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--res", "8", "--spp", "1",
                  "--out", str(tmp_path / "x.exr")])


@pytest.mark.parametrize("camera, extra", [
    ("thinlens", []), ("po", []),
    ("thinlens", ["--region", "2", "3", "11", "13", "--glare", "0.5",
                  "--aperture-blades", "6", "--exposure", "4"])],
    ids=["thinlens", "po", "thinlens_region_glare"])
def test_cli_matches_jax(tmp_path, camera, extra):
    from pota_tpu import cli as jcli

    args = ["--cpu", "--camera", camera, "--res", "16", "--spp", "2",
            "--aovs", "--id-matte"] + extra
    out, jout = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    assert cli.main(args + ["--out", out]) == 0
    assert jcli.main(args + ["--out", jout]) == 0
    got, want = texr.read_exr(out), jexr.read_exr(jout)
    assert set(got) == set(want)
    assert got["R"].shape == want["R"].shape
    assert {f"crypto0{r}.{c}" for r in range(3) for c in "RGBA"} <= set(got)
    for ch in got.values():
        assert np.isfinite(ch).all()
    beauty = [np.stack([d[c] for c in "RGBA"], -1) for d in (got, want)]
    assert float(np.abs(beauty[1]).max()) > 1e-3
    assert frac_pixels_off(*beauty) <= 0.02


# ------------------------------------------------------ forward-only frame


def test_render_frame_simple_matches_jax():
    """The forward-only render (no redistribution) of the glass teapot on
    the thin lens: the port's ``render_frame_simple`` against JAX's jitted
    one, within 1e-4 of scale (measured 3.0e-5: XLA fuses the jitted
    frame's float32 arithmetic, torch runs it op by op)."""
    from pota_tpu import CameraConfig, RenderConfig
    from pota_tpu.render.renderer import render_frame_simple as jsimple

    from golden_configs import M
    from pota_tpu_torch.render.renderer import look_at, render_frame_simple
    from test_torch_slice import glass_teapots, to_port

    jscene, tscene = glass_teapots()
    jcfg = CameraConfig(focal_length=50.0, fstop=1.4, focus_distance=150.0,
                        vignetting_retries=2)
    jrc = RenderConfig(xres=24, yres=16, spp=2)
    want = np.asarray(jsimple(jcfg, jrc, jscene, M, seed=0))
    got = render_frame_simple(to_port(jcfg), to_port(jrc), tscene,
                              look_at([0, 0, 0], [0, 0, -1], device="cpu"),
                              seed=0)
    assert got.shape == (16, 24, 4) and float(np.abs(want).max()) > 1e-3
    assert scaled_err(got, want) < 1e-4
