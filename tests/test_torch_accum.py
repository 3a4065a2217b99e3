"""K4's tile-and-carry partition, emulated in torch, against the plain
version and the JAX package's accumulator.

``csrc/segment_accum.cu`` cuts the sorted writer rows into tiles of
``threads x rows`` consecutive rows: each thread sums its rows in order, a
segmented scan over the threads (Kogge-Stone within a warp, then the warp
totals in order) carries sums across threads, and the first and last
segment of each tile go to a carry buffer that a second kernel walks in
tile order.  :func:`tiled_segment_accum` repeats that partition and its
order of float32 additions on the CPU, with the tile as parameters: here
with tiles of 8 and 32 rows, so that segments span many tiles, and on the
card (``tests/test_torch_cuda.py``) at the kernel's own tile, where it must
match the kernel bit for bit.

This module imports no JAX at the top, so the card's tests can import the
emulation; the comparison with JAX imports it inside the test.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pota_tpu_torch.ops import splat_accum as tacc

CSRC = Path(__file__).resolve().parents[1] / "pota_tpu_torch" / "csrc"
torch.set_num_threads(2)


def _shift(t, d, dim, fill):
    """t moved d places up along ``dim`` (lane l gets lane l - d); the
    first d places hold ``fill``."""
    pad = torch.full_like(t.narrow(dim, 0, d), fill)
    return torch.cat([pad, t.narrow(dim, 0, t.shape[dim] - d)], dim)


def tiled_segment_accum(keys_sorted, perm, payload, sample_id, npix: int,
                        threads: int = tacc.TILE_THREADS,
                        rows: int = tacc.THREAD_ROWS, warp: int = 32):
    """K4 in float32, with its tile of ``threads`` x ``rows`` rows and its
    order of additions (``csrc/segment_accum.cu``).  Returns the kernel's
    (accum, winner_depth, winner_sample, has_winner)."""
    w, k = payload.shape[0], payload.shape[1]
    tile = threads * rows
    n_warps = threads // warp
    n_tiles = -(-w // tile)
    total = n_tiles * tile
    f32 = torch.float32
    accum = torch.zeros((npix, k), dtype=f32)
    pix = torch.full((total,), npix, dtype=torch.int64)
    pix[:w] = torch.clamp(keys_sorted >> 32, max=npix)
    live = pix < npix
    x = torch.zeros((total, k), dtype=f32)
    x[:w][live[:w]] = payload[perm[live[:w]]]
    prev = torch.cat([torch.tensor([-1]), pix[:-1]])[:total]
    head = pix != prev

    # winners at the live heads (the segment's first row)
    win = head[:w] & live[:w]
    wp = pix[:w][win]
    winner_depth = torch.zeros((npix,), dtype=f32)
    winner_depth[wp] = (keys_sorted[win] & 0xFFFFFFFF).to(
        torch.int32).view(f32)
    winner_sample = torch.zeros((npix,), dtype=torch.int32)
    winner_sample[wp] = sample_id[perm[win]]
    has_winner = torch.zeros((npix,), dtype=torch.bool)
    has_winner[wp] = True

    P = pix.view(n_tiles, threads, rows)
    PREV = prev.view(n_tiles, threads, rows)
    H = head.view(n_tiles, threads, rows)
    X = x.view(n_tiles, threads, rows, k)
    hs = H.any(-1)
    first_head = torch.where(hs, H.to(torch.int8).argmax(-1), rows)
    # 2. each thread's rows in order
    run = torch.zeros((n_tiles, threads, k), dtype=f32)
    head_sum = torch.zeros_like(run)
    for j in range(rows):
        h = H[..., j]
        inner = h & (first_head < j)
        accum[PREV[..., j][inner]] = run[inner]
        head_sum = torch.where((h & (first_head == j))[..., None], run,
                               head_sum)
        run = torch.where(h[..., None], 0.0, run)
        run = torch.where((P[..., j] < npix)[..., None], run + X[..., j, :],
                          run)
    # 3. segmented scan over the threads: within each warp, then the warps
    f = hs.view(n_tiles, n_warps, warp)
    v = run.view(n_tiles, n_warps, warp, k)
    d = 1
    while d < warp:
        g = _shift(f, d, 2, False)
        u = _shift(v, d, 2, 0.0)
        lane = torch.arange(warp) >= d
        v = torch.where((lane & ~f)[..., None], u + v, v)
        f = f | (lane & g)
        d *= 2
    wf, wv = f[..., -1], v[..., -1, :]
    ef = _shift(f, 1, 2, False)
    ev = _shift(v, 1, 2, 0.0)
    pf = torch.zeros((n_tiles, n_warps), dtype=torch.bool)
    pv = torch.zeros((n_tiles, n_warps, k), dtype=f32)
    cur_f = torch.zeros((n_tiles,), dtype=torch.bool)
    cur_v = torch.zeros((n_tiles, k), dtype=f32)
    for wi in range(n_warps):
        pf[:, wi], pv[:, wi] = cur_f, cur_v
        cur_v = torch.where(wf[:, wi, None], wv[:, wi], cur_v + wv[:, wi])
        cur_f = cur_f | wf[:, wi]
    F = (pf[..., None] | ef).view(n_tiles, threads)
    C = torch.where(ef[..., None], ev, pv[:, :, None] + ev).view(
        n_tiles, threads, k)
    closing = C + head_sum
    dead_tile = P[:, 0, 0] >= npix
    # the segment each thread's first head closes
    p_close = torch.gather(PREV, 2, first_head.clamp(max=rows - 1)[..., None])
    p_close = p_close[..., 0]
    wr = hs & F & (p_close < npix) & ~dead_tile[:, None]
    accum[p_close[wr]] = closing[wr]
    # 4. the carry buffer: each tile's first segment, and its last
    lead = torch.zeros((n_tiles, k), dtype=f32)
    first_thread = hs & ~F
    tiles_with = first_thread.any(1)
    t_idx = first_thread.to(torch.int8).argmax(1)
    lead[tiles_with] = closing[tiles_with, t_idx[tiles_with]]
    fi = F[:, -1] | hs[:, -1]
    vi = torch.where(hs[:, -1, None], run[:, -1], C[:, -1] + run[:, -1])
    trail = torch.where(fi[:, None], vi, 0.0)
    lead = torch.where(fi[:, None], lead, vi)
    tail_pix = torch.where(fi, P[:, -1, -1], -1)
    lead[dead_tile] = 0.0
    tail_pix[dead_tile] = npix
    # the carry kernel: a tile's last segment plus the first segments of
    # the tiles after it, up to the next tile that holds a head
    for b in range(n_tiles):
        p = int(tail_pix[b])
        if not 0 <= p < npix:
            continue
        acc = trail[b].clone()
        t = b + 1
        while t < n_tiles:
            acc = acc + lead[t]
            if int(tail_pix[t]) >= 0:
                break
            t += 1
        accum[p] = acc
    return accum, winner_depth, winner_sample, has_winner


def tiles_spanned(keys_sorted, npix: int, tile: int) -> int:
    """The most tiles of ``tile`` rows that one live segment touches."""
    pix = keys_sorted >> 32
    n = int((pix < npix).sum())
    if n == 0:
        return 0
    starts = torch.nonzero(torch.cat([torch.tensor([True]),
                                      pix[1:n] != pix[:n - 1]]))[:, 0]
    ends = torch.cat([starts[1:], torch.tensor([n])]) - 1
    return int((ends // tile - starts // tile + 1).max())


def accum_stream(case: str, seed: int = 0, k: int = 5):
    """A seeded writer stream (pix, depth, payload, sample_id, npix) in
    writer order; dead writers carry ``npix``."""
    rng = np.random.default_rng(seed)
    npix, n = 400, 3000
    if case == "empty":
        n = 0
    pix = rng.integers(0, npix, n)
    if case == "long_segments":        # few pixels: every segment spans tiles
        pix = rng.integers(0, 12, n) * 31
    elif case == "hot_pixel":          # one pixel holds a third of the rows
        pix[rng.uniform(size=n) < 1 / 3] = 77
    elif case == "all_dead":
        pix[:] = npix
    elif case == "no_writer":          # most pixels keep no writer
        pix = rng.integers(0, npix // 8, n) * 8
    if case not in ("all_dead", "empty"):
        pix[rng.uniform(size=n) < 0.25] = npix      # dead writers
    depth = rng.uniform(1.0, 60.0, n).astype(np.float32)
    if case in ("hot_pixel", "ties", "long_segments"):
        depth = np.round(depth)                     # depth ties
    payload = rng.normal(size=(n, k)).astype(np.float32)
    sid = rng.integers(0, 1 << 20, n).astype(np.int32)
    return pix.astype(np.int32), depth, payload, sid, npix


def head_on_tile_edge(tile: int, k: int = 5):
    """A sorted-order stream whose segment heads fall exactly on every tile
    edge (and one segment spans two tiles exactly): pixel i // tile for the
    first tiles, then one pixel over two whole tiles, then dead rows from a
    tile edge on."""
    rng = np.random.default_rng(11)
    n = 6 * tile
    pix = np.concatenate([np.repeat(np.arange(3), tile),
                          np.full(2 * tile, 5), np.full(tile, 40)])
    depth = rng.uniform(1.0, 9.0, n).astype(np.float32)
    payload = rng.normal(size=(n, k)).astype(np.float32)
    sid = np.arange(n, dtype=np.int32)
    return pix.astype(np.int32), depth, payload, sid, 40


def _sorted_args(pix, depth, payload, sid, npix):
    keys, perm = tacc.sort_writers(torch.as_tensor(pix),
                                   torch.as_tensor(depth))
    return keys, perm, torch.as_tensor(payload), torch.as_tensor(sid), npix


def assert_same_accum(got, want, rel: float = 1e-5):
    """Sums within ``rel`` of their scale (another order of float32
    additions), winners exact."""
    if want[0].numel():
        scale = max(float(want[0].abs().max()), 1.0)
        assert float((got[0] - want[0]).abs().max()) <= rel * scale
    assert torch.equal(got[3], want[3])
    assert torch.equal(got[1][got[3]], want[1][want[3]])
    assert torch.equal(got[2][got[3]], want[2][want[3]])


CASES = ["long_segments", "hot_pixel", "ties", "all_dead", "no_writer",
         "empty"]
TILES = [(4, 2, 2), (8, 4, 4), (tacc.TILE_THREADS, tacc.THREAD_ROWS, 32)]


@pytest.mark.parametrize("threads, rows, warp", TILES)
@pytest.mark.parametrize("case", CASES)
def test_tiled_accum_matches_plain(case, threads, rows, warp):
    """The tile-and-carry partition against the plain version (sums in
    sorted order): sums to 1e-5 of scale (measured: <= 4.4e-7 of scale on
    these streams), winners identical."""
    args = _sorted_args(*accum_stream(case))
    got = tiled_segment_accum(*args, threads=threads, rows=rows, warp=warp)
    assert_same_accum(got, tacc.segment_accum_plain(*args))
    if case in ("long_segments", "hot_pixel") and threads * rows <= 32:
        # segments cross several tiles
        assert tiles_spanned(args[0], args[4], threads * rows) > 4


@pytest.mark.parametrize("threads, rows, warp", TILES[:2])
def test_tiled_accum_head_on_tile_edge(threads, rows, warp):
    args = _sorted_args(*head_on_tile_edge(threads * rows))
    got = tiled_segment_accum(*args, threads=threads, rows=rows, warp=warp)
    assert tiles_spanned(args[0], args[4], threads * rows) == 2
    assert_same_accum(got, tacc.segment_accum_plain(*args))


@pytest.mark.parametrize("k", [5, 9, 17])
@pytest.mark.parametrize("case", ["long_segments", "hot_pixel", "ties"])
def test_tiled_accum_matches_jax(case, k):
    """The partition against JAX's sorted one-hot accumulator (Pallas,
    interpret mode, as the JAX package's own tests run it), tiles of 8
    rows; payloads of 5, 9 and 17 columns (RGBA + weight, and one or three
    extra gaussian AOVs)."""
    import jax.numpy as jnp

    from pota_tpu.ops.splat_accum import accumulate_sorted

    pix, depth, payload, sid, npix = accum_stream(case, seed=3, k=k)
    want = accumulate_sorted(jnp.asarray(pix), jnp.asarray(depth),
                             jnp.asarray(payload), jnp.asarray(sid), npix,
                             interpret=True)
    want = tuple(torch.as_tensor(np.array(a)) for a in want)
    got = tiled_segment_accum(*_sorted_args(pix, depth, payload, sid, npix),
                              threads=4, rows=2, warp=2)
    assert_same_accum(got, want)


def test_tile_constants_match_the_kernel():
    """The wrapper sizes the carry buffers with the kernel's tile."""
    src = (CSRC / "segment_accum.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kAccThreads") == tacc.TILE_THREADS
    assert const("kAccRows") == tacc.THREAD_ROWS
    assert tacc.TILE_ROWS == tacc.TILE_THREADS * tacc.THREAD_ROWS
