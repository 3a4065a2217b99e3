"""Cryptomatte id-matte machinery (port of :mod:`pota_tpu.render.crypto`).

The reference accumulates per-pixel ``hash -> weight`` maps during the
splat and rank-extracts them in the imager (zpelgrims/pota
``src/lentil.h:780-819``, ``src/lentil_imager.cpp:121-160``); the ids are
float-reinterpreted MurmurHash3 name hashes, per the Cryptomatte spec.

Here the maps are a sparse two-sort rank extraction over the splat's
writer records, O(records + npix * k) in memory whatever the scene's id
count:

1. coalesce: sort the live records by the int64 key ``pixel << 32 | id``;
   each (pixel, id) run's coverage is the difference of two float64 prefix
   sums (off by at most (run length + 2) float64 ulps of the stream's total
   weight), rounded once to float32;
2. rank: sort the runs by ``pixel << 32 | (0x7FFFFFFF - bits(coverage))``,
   that is by pixel and then by descending coverage (coverages are >= 0, so
   their float bits order as the values do), ties by ascending id; the
   first ``k`` runs of each pixel fill dense ``[npix, k]`` planes.

The reference takes each run's coverage as the difference of two float32
prefix sums over the whole sorted stream; at a 1080p frame's 37M records
the prefix's ulp exceeds a run's total, so the port sums in float64.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from .. import resolve_device
from ..utils import trace

# ------------------------------------------------------------ name hashing --


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 (the Cryptomatte spec's name hash)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    rotl = lambda x, r: ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF
    nblocks = len(data) // 4
    for i in range(nblocks):
        k = struct.unpack_from("<I", data, i * 4)[0]
        k = (k * c1) & 0xFFFFFFFF
        k = rotl(k, 15)
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = rotl(h, 13)
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    tail = data[nblocks * 4:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = rotl(k, 15)
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _spec_bits(name: str) -> int:
    """The Murmur3 bits of ``name`` with the exponent nudged off 0 / 255, so
    that the float id is never inf, nan or denormal (the spec's trick)."""
    bits = murmur3_32(name.encode("utf-8"))
    exponent = (bits >> 23) & 0xFF
    if exponent == 0 or exponent == 255:
        bits ^= 1 << 23
    return bits


def name_hash_float(name: str) -> float:
    """Name -> float32 id per the Cryptomatte spec."""
    return float(np.frombuffer(struct.pack("<I", _spec_bits(name)),
                               np.float32)[0])


def manifest(names) -> dict:
    """Cryptomatte sidecar manifest: name -> 8-hex-digit hash string."""
    return {name: f"{_spec_bits(name):08x}" for name in names}


def id_hash_table(names, device=None) -> torch.Tensor:
    """[n] float32 table mapping scene object index -> spec name-hash id, on
    ``device`` (default: the card)."""
    return torch.tensor([name_hash_float(n) for n in names],
                        dtype=torch.float32, device=resolve_device(device))


# -------------------------------------------------------- sparse rank topk --


def _run_last(key):
    """True at the last element of each run of equal values of ``key``."""
    last = torch.ones_like(key, dtype=torch.bool)
    last[:-1] = key[1:] != key[:-1]
    return last


def _diff0(x):
    """``x[i] - x[i - 1]``, with ``x[-1]`` taken as 0."""
    return torch.diff(x, prepend=x.new_zeros(1))


def crypto_topk(pix, obj_id, w, npix: int, k: int = 6):
    """Sparse per-pixel top-k (id, coverage) extraction from writer records.

    Args:
      pix: [W] integer target pixel per record.
      obj_id: [W] integer scene object index per record.
      w: [W] float32 coverage weight per record; a record is live where
        ``w > 0``, ``obj_id >= 0`` and ``0 <= pix < npix``.
      npix: pixel count.
      k: ranks kept per pixel (the reference's cryptomatte depth).

    Returns (rank_id [npix, k] int32 with -1 padding, rank_w [npix, k]
    float32, total [npix] float32).  Each run's coverage and each pixel's
    total are float64 sums of the live weights (prefix differences),
    rounded once to float32; equal coverages of one pixel rank by
    ascending id.  While a profiler records it counts the records
    (``crypto.records``), the live ones (``crypto.live``), the (pixel, id)
    runs (``crypto.runs``), the rank slots written (``crypto.ranked``) and
    its boolean indexes' reads to the host (``host_reads``).
    """
    dev = w.device
    pix = pix.to(torch.int64)
    obj_id = obj_id.to(torch.int64)
    live = (w > 0.0) & (obj_id >= 0) & (pix >= 0) & (pix < npix)
    # each boolean index reads the count of its True entries
    trace.host_read(live, 3)
    key, order = torch.sort((pix[live] << 32) | obj_id[live], stable=True)
    csum = torch.cumsum(w[live][order].to(torch.float64), 0)
    trace.count("crypto.records", pix.shape[0])
    trace.count("crypto.live", key.shape[0])

    # ---- pass 1: each (pixel, id) run's coverage, a float64 sum --------
    last = _run_last(key)
    trace.host_read(last, 2)
    run_key, run_end = key[last], csum[last]
    trace.count("crypto.runs", run_key.shape[0])
    run_w = _diff0(run_end).to(torch.float32)
    run_pix = run_key >> 32
    # the pixel total: the prefix at each pixel's last run, differenced
    pix_last = _run_last(run_pix)
    trace.host_read(pix_last, 2)
    total = torch.zeros((npix,), dtype=torch.float32, device=dev)
    total[run_pix[pix_last]] = _diff0(run_end[pix_last]).to(torch.float32)

    # ---- pass 2: rank each pixel's runs by descending coverage ---------
    on = run_w > 0.0
    trace.host_read(on, 3)
    run_pix, run_id, run_w = run_pix[on], (run_key[on] & 0xFFFFFFFF), run_w[on]
    neg_bits = 0x7FFFFFFF - run_w.view(torch.int32).to(torch.int64)
    key2, order2 = torch.sort((run_pix << 32) | neg_bits, stable=True)
    pix2 = key2 >> 32
    # the rank in the pixel: the distance to the pixel's first run
    rank = (torch.arange(pix2.shape[0], device=dev)
            - torch.searchsorted(pix2, pix2))
    keep = rank < k
    trace.host_read(keep, 4)
    slot = pix2[keep] * k + rank[keep]
    trace.count("crypto.ranked", slot.shape[0])
    rank_id = torch.full((npix * k,), -1, dtype=torch.int32, device=dev)
    rank_w = torch.zeros((npix * k,), dtype=torch.float32, device=dev)
    rank_id[slot] = run_id[order2][keep].to(torch.int32)
    rank_w[slot] = run_w[order2][keep]
    return rank_id.reshape(npix, k), rank_w.reshape(npix, k), total


def pack_layers(rank_id, rank_w, total, ranks: int = 3, id_hashes=None):
    """Pack ranked results into standard cryptomatte RGBA layers.

    Each layer holds two (id, coverage) pairs ranked by weight, coverage
    normalised by the pixel's total weight (the reference imager's rank
    extraction, src/lentil_imager.cpp:121-160).  ``id_hashes`` ([n_objects]
    float32 from :func:`id_hash_table`) maps scene indices to spec float
    hashes; without it the raw scene index rides as a float id.
    """
    npix, k = rank_w.shape
    tot = torch.clamp(total, min=1e-12)[:, None]
    # the clamp of the reference (its run sums and total add in different
    # orders); here both are float64 sums rounded once
    cov = torch.clamp(torch.where(rank_w > 0.0, rank_w / tot, 0.0), max=1.0)
    if id_hashes is not None:
        idf = id_hashes[torch.clamp(rank_id, min=0).to(torch.int64)]
    else:
        idf = rank_id.to(torch.float32)
    idf = torch.where(rank_w > 0.0, idf, 0.0)
    zeros = torch.zeros((npix,), dtype=rank_w.dtype, device=rank_w.device)
    layers = []
    for r in range(ranks):
        i0, i1 = 2 * r, 2 * r + 1
        c0 = cov[:, i0] if i0 < k else zeros
        d0 = idf[:, i0] if i0 < k else zeros
        c1 = cov[:, i1] if i1 < k else zeros
        d1 = idf[:, i1] if i1 < k else zeros
        layers.append(torch.stack([d0, c0, d1, c1], -1))
    return layers
