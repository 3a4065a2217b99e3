"""The port's id-matte and thin-glass transmission against the JAX package
on the CPU, module by module: the Cryptomatte name hashes, ``crypto_topk``
(against JAX's on tied streams, against a float64 oracle at 2^21 records),
``pack_layers``, ``SphereScene.shade`` with thin glass; and end to end in
the port alone: the glass coverage split, a 500-id scene and the
``bidir_aovs`` golden.  The id-matte of ``splat_frame`` on each route, the
transmitted-energy gate and the gradient of a glass frame against JAX are
in ``test_torch_glass.py``.

Tolerances (measured values in brackets):
* hashes, ids and manifests equal; ``crypto_topk`` on streams whose
  weights are multiples of 1/8 (every float32 sum exact, so JAX's prefix
  differences are exact too): ``rank_id`` identical, ties included;
  ``rank_w`` and ``total`` 1e-6 relative [exact];
* at 2^21 records of uniform weights, every kept rank weight and every
  pixel total within 1e-6 relative of a float64 oracle [5.96e-8: one
  float32 rounding].  JAX's float32 prefix differences on the same stream
  are printed (``-s``), not asserted [median 2.3e-3, 99th percentile
  2.0e-2, max 0.38 relative];
* ``shade`` on the same rays: rgba, transmission and coverage weights 1e-6
  of scale [exact], ids identical;
* the glass split 0.5 / 0.5 within 0.02, as JAX's own
  ``test_aov.py::test_opacity_weighted_crypto_layers``;
* the golden: at most 2% of pixels off by more than 2e-3 of scale, the
  port's golden rule (``test_torch_slice.frac_pixels_off``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import golden_configs as gc
from pota_tpu.io.exr import read_exr
from pota_tpu.render import crypto as jcrypto

import pota_tpu_torch as pt
from pota_tpu_torch.render import crypto as tcrypto
from pota_tpu_torch.render import scene as sc
from pota_tpu_torch.render.renderer import look_at, render_frame
from pota_tpu_torch.render.splat import resolve_crypto
from test_torch_optics import scaled_err
from test_torch_slice import frac_pixels_off, glass_teapots

torch.set_num_threads(2)

NAMES = ["", "a", "bunny", "sphere_000", "x" * 41, "café", "球体",
         "сфера/стекло",
         "emoji_\U0001f600", "hello, world"]


def _cpu_m():
    return look_at([0, 0, 0], [0, 0, -1], device="cpu")


# ---------------------------------------------------------------- hashes


def test_name_hashes_match_jax():
    for name in NAMES:
        data = name.encode("utf-8")
        for seed in (0, 0x9747B28C):
            assert tcrypto.murmur3_32(data, seed) == jcrypto.murmur3_32(
                data, seed), name
        got, want = tcrypto.name_hash_float(name), jcrypto.name_hash_float(
            name)
        assert np.float32(got).tobytes() == np.float32(want).tobytes(), name
    assert tcrypto.manifest(NAMES) == jcrypto.manifest(NAMES)
    table = tcrypto.id_hash_table(NAMES, device="cpu")
    assert table.dtype == torch.float32
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(jcrypto.id_hash_table(NAMES)))


# ------------------------------------------------------------ crypto_topk


def _tied_stream(seed, w_total=20000, npix=256, n_ids=40):
    """Seeded records whose weights are multiples of 1/8 (exact float32
    sums, so equal coverages tie), with dead records mixed in."""
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, npix, w_total)
    oid = rng.integers(-1, n_ids, w_total)
    w = (rng.integers(0, 9, w_total) / 8.0).astype(np.float32)
    return pix, oid, w, npix


def _both_topk(pix, oid, w, npix, k=6):
    import jax.numpy as jnp

    want = jcrypto.crypto_topk(jnp.asarray(pix, jnp.int32),
                               jnp.asarray(oid, jnp.int32), jnp.asarray(w),
                               npix, k=k)
    got = tcrypto.crypto_topk(torch.as_tensor(pix), torch.as_tensor(oid),
                              torch.as_tensor(w), npix, k=k)
    return [g.numpy() for g in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crypto_topk_matches_jax(seed):
    (rid, rw, tot), (jid, jw, jtot) = _both_topk(*_tied_stream(seed))
    assert rid.dtype == np.int32 and rid.shape == jid.shape == (256, 6)
    # ties occur, and JAX breaks them by ascending id as the port does
    tied = (jw[:, 1:] == jw[:, :-1]) & (jw[:, 1:] > 0)
    assert tied.sum() > 50
    np.testing.assert_array_equal(rid, jid)
    np.testing.assert_allclose(rw, jw, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tot, jtot, rtol=1e-6, atol=0)


def test_crypto_topk_tie_order():
    """Equal coverages of one pixel rank by ascending id; a larger one
    first; dead records (zero weight, id -1, pixel outside) are dropped."""
    pix = np.array([3, 3, 3, 3, 3, 3, 0, 0, 9, 3], np.int64)
    oid = np.array([7, 2, 5, 2, 9, -1, 4, 1, 1, 11], np.int64)
    w = np.array([0.5, 0.25, 0.5, 0.25, 0.5, 4.0, 0.0, 1.0, 1.0, 0.125],
                 np.float32)
    (rid, rw, tot), (jid, jw, jtot) = _both_topk(pix, oid, w, 4, k=3)
    # pixel 3: ids 2 (0.25 + 0.25), 5, 7 and 9 tie at 0.5, 11 has 0.125
    np.testing.assert_array_equal(rid[3], [2, 5, 7])
    np.testing.assert_array_equal(rw[3], [0.5, 0.5, 0.5])
    np.testing.assert_array_equal(rid[0], [1, -1, -1])
    np.testing.assert_array_equal(rid[1], [-1, -1, -1])
    np.testing.assert_allclose(tot, [1.0, 0.0, 0.0, 2.125])
    np.testing.assert_array_equal(rid, jid)
    np.testing.assert_array_equal(rw, jw)


def _f64_oracle(pix, oid, w, npix, k):
    """Float64 coverages of every live (pixel, id) run ranked per pixel
    (descending weight, then id), and the pixel totals."""
    live = (w > 0) & (oid >= 0) & (pix >= 0) & (pix < npix)
    key = pix[live] * (1 << 32) + oid[live]
    runs, inv = np.unique(key, return_inverse=True)
    run_w = np.bincount(inv, weights=w[live].astype(np.float64))
    run_pix = runs >> 32
    order = np.lexsort((runs & 0xFFFFFFFF, -run_w, run_pix))
    rpix = run_pix[order]
    first = np.r_[True, rpix[1:] != rpix[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(rpix)), 0))
    rank = np.arange(len(rpix)) - start
    keep = rank < k
    rank_id = np.full((npix, k), -1, np.int64)
    rank_w = np.zeros((npix, k))
    rank_id[rpix[keep], rank[keep]] = (runs & 0xFFFFFFFF)[order][keep]
    rank_w[rpix[keep], rank[keep]] = run_w[order][keep]
    total = np.bincount(pix[live], weights=w[live].astype(np.float64),
                        minlength=npix)
    return rank_id, rank_w, total


def test_crypto_topk_float64_oracle_at_2_21_records():
    """2^21 records of uniform weights on 65,536 pixels and 3 ids (runs of
    ~11 records): the port's coverages and totals are float64 sums rounded
    once.  JAX's float32 prefix differences are measured and printed."""
    import jax.numpy as jnp

    rng = np.random.default_rng(21)
    w_total, npix, k = 1 << 21, 1 << 16, 6
    pix = np.sort(rng.integers(0, npix, w_total))
    oid = rng.integers(0, 3, w_total)
    w = rng.uniform(0.0, 1.0, w_total).astype(np.float32)
    o_id, o_w, o_tot = _f64_oracle(pix, oid, w, npix, k)
    rid, rw, tot = (g.numpy() for g in tcrypto.crypto_topk(
        torch.as_tensor(pix), torch.as_tensor(oid), torch.as_tensor(w), npix,
        k=k))
    kept = o_w > 0
    assert kept.sum() > 3 * npix // 2
    rel = np.abs(rw[kept] - o_w[kept]) / o_w[kept]
    assert rel.max() < 1e-6, rel.max()
    assert (rw[~kept] == 0).all()
    # ids wherever the oracle's neighbouring ranks are apart
    gap = np.ones(o_w.shape, bool)
    close = np.abs(o_w[:, 1:] - o_w[:, :-1]) <= 1e-5 * o_w[:, :-1]
    gap[:, 1:] &= ~close
    gap[:, :-1] &= ~close
    np.testing.assert_array_equal(rid[gap], o_id[gap])
    assert (np.abs(tot - o_tot) / np.maximum(o_tot, 1e-30)).max() < 1e-6
    _, jw, jtot = (np.asarray(x) for x in jcrypto.crypto_topk(
        jnp.asarray(pix, jnp.int32), jnp.asarray(oid, jnp.int32),
        jnp.asarray(w), npix, k=k))
    jrel = np.abs(jw[kept] - o_w[kept]) / o_w[kept]
    print(f"\nport: rank_w max rel {rel.max():.3e}; JAX's float32 prefix "
          f"differences: median {np.median(jrel):.3e}, 99th percentile "
          f"{np.quantile(jrel, 0.99):.3e}, max {jrel.max():.3e}; JAX total "
          f"max rel {(np.abs(jtot - o_tot) / o_tot).max():.3e}")


@pytest.mark.parametrize("hashes", [False, True])
def test_pack_layers_matches_jax(hashes):
    import jax.numpy as jnp

    pix, oid, w, npix = _tied_stream(5, n_ids=4)
    got = tcrypto.crypto_topk(torch.as_tensor(pix), torch.as_tensor(oid),
                              torch.as_tensor(w), npix, k=5)
    names = [f"obj_{i}" for i in range(4)]
    layers = tcrypto.pack_layers(
        *got, ranks=3,
        id_hashes=tcrypto.id_hash_table(names, device="cpu") if hashes
        else None)
    want = jcrypto.pack_layers(
        *(jnp.asarray(g.numpy()) for g in got), ranks=3,
        id_hashes=jcrypto.id_hash_table(names) if hashes else None)
    assert len(layers) == len(want) == 3
    for g, j in zip(layers, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert float(layers[0][:, 1].max()) > 0   # coverage present
    assert float(layers[2][:, 3].abs().max()) == 0  # rank 5 of k = 5


# ------------------------------------------------------------ thin glass


def test_shade_transmission_matches_jax():
    """The same rays through JAX's and the port's glass teapot."""
    import jax.numpy as jnp

    jscene, tscene = glass_teapots()
    rng = np.random.default_rng(4)
    n = 4000
    orig = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.2, 0.2, n),
                  -np.ones(n)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    want = {k: np.asarray(v) for k, v in jscene.shade(
        jnp.asarray(orig), jnp.asarray(d)).items()}
    got = {k: v.numpy() for k, v in tscene.shade(
        torch.as_tensor(orig), torch.as_tensor(d)).items()}
    assert set(got) == set(want)
    # rays through glass, with something and nothing behind it
    front = want["crypto_ids"][:, 0]
    assert ((front == 0) | (front == 1)).sum() > 100
    assert (want["transmission"].max(-1) > 0).sum() > 100
    for k in ("crypto_ids", "obj_id", "hit"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("rgba", "transmission", "crypto_weights"):
        assert scaled_err(got[k], want[k]) < 1e-6, k


def _two_sphere_glass():
    """``test_aov.py::test_opacity_weighted_crypto_layers``'s scene: 50%
    glass in front of an opaque emitter."""
    return sc.sphere_scene_from_numpy(
        centers=[[0.0, 0.0, -100.0], [0.0, 0.0, -300.0]], radii=[40.0, 60.0],
        emission=[[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]], albedo=np.zeros((2, 3)),
        sky_color=np.zeros(3), light_dir=[0.0, 1.0, 0.0],
        light_color=np.zeros(3), transmission=[[0.5] * 3, [0.0] * 3],
        device="cpu")


def test_opacity_weighted_crypto_layers():
    """The glass splits its pixels' coverage by opacity: 1 - grey(tint) to
    the front surface, the rest to the hit behind (src/lentil.h:780-811)."""
    cfg = pt.CameraConfig(focal_length=65.0, fstop=1.8, focus_distance=150.0,
                          vignetting_retries=1, max_bidir_samples=8)
    rc = pt.RenderConfig(xres=16, yres=16, spp=4, enable_id_matte=True)
    _, fb = render_frame(cfg, rc, _two_sphere_glass(), _cpu_m(), seed=0)
    rank_id = fb["crypto_rank_id"].numpy()
    rank_w = fb["crypto_rank_w"].numpy()
    total = fb["crypto_total"].numpy()
    cov = np.stack([(rank_w * (rank_id == i)).sum(-1)
                    / np.maximum(total, 1e-12) for i in range(2)], -1)
    c = cov[6:10, 6:10]
    np.testing.assert_allclose(c[..., 0], 0.5, atol=0.02)
    np.testing.assert_allclose(c[..., 1], 0.5, atol=0.02)
    # the resolved layers: the first pair's coverage never exceeds 1
    layers = resolve_crypto(fb)
    assert len(layers) == 3 and layers[0].shape == (16, 16, 4)
    assert float(layers[0][..., 1].max()) <= 1.0 + 1e-5


def test_500_id_scene_end_to_end():
    """A 500-object scene renders ranked id-matte planes with spec hash
    ids (``test_crypto.py::test_500_id_scene_end_to_end`` on the port)."""
    rng = np.random.default_rng(3)
    n = 500
    centers = np.stack([rng.uniform(-60, 60, n), rng.uniform(-60, 60, n),
                        rng.uniform(-420, -180, n)], -1)
    scene = sc.sphere_scene_from_numpy(
        centers=centers, radii=np.full((n,), 3.0),
        emission=rng.uniform(0.5, 8.0, (n, 3)), albedo=np.zeros((n, 3)),
        sky_color=np.zeros(3), light_dir=[0.0, 1.0, 0.0],
        light_color=np.zeros(3), device="cpu")
    cfg = pt.CameraConfig(focal_length=65.0, fstop=1.8, focus_distance=150.0,
                          vignetting_retries=1, max_bidir_samples=8,
                          splat_queue_mult=4)
    rc = pt.RenderConfig(xres=64, yres=64, spp=2, enable_id_matte=True)
    _, fb = render_frame(cfg, rc, scene, _cpu_m(), seed=0)
    assert fb["crypto_rank_id"].shape == (64, 64, 6)
    hashes = tcrypto.id_hash_table([f"sphere_{i:03d}" for i in range(n)],
                                   device="cpu")
    l0 = resolve_crypto(fb, ranks=3, id_hashes=hashes)[0].numpy()
    assert np.isfinite(l0).all()
    covered = l0[..., 1] > 0
    assert covered.any()
    assert np.isin(np.unique(l0[..., 0][covered]), hashes.numpy()).all()
    assert (l0[..., 1] <= 1.0 + 1e-5).all()
    # many ids are ranked somewhere
    assert len(np.unique(fb["crypto_rank_id"].numpy())) > 50


def test_bidir_aovs_golden():
    """The ``bidir_aovs`` golden (``golden_configs.py:103-114``: thin lens,
    teapot, id-matte, 48x48 @ 4 spp) by the port's own render."""
    cfg = pt.CameraConfig(focal_length=50.0, fstop=1.4, focus_distance=150.0,
                          vignetting_retries=2, splat_queue_mult=6)
    rc = pt.RenderConfig(xres=48, yres=48, spp=4, enable_id_matte=True)
    img, fb = render_frame(cfg, rc, sc.teapot_scene(device="cpu"), _cpu_m(),
                           seed=0)
    golden = read_exr(gc.golden_path("bidir_aovs"))
    planes = {
        "rgba": (img.numpy(),
                 np.stack([golden[f"rgba.{c}"] for c in "RGBA"], -1)),
        "Z": (fb["Z"][..., 0].numpy(), golden["Z"]),
        "debug": (fb["lentil_debug"][..., 0].numpy(), golden["debug"]),
        "crypto_total": (fb["crypto_total"].numpy(), golden["crypto_total"]),
    }
    for name, (got, want) in planes.items():
        assert np.isfinite(got).all(), name
        if got.ndim == 2:
            got, want = got[..., None], want[..., None]
        assert frac_pixels_off(got, want) <= 0.02, name
    assert float(golden["crypto_total"].max()) > 0


