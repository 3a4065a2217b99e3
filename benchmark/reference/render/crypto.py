"""The id-matte's Cryptomatte machinery, by other means than the program's
(zpelgrims/pota ``src/lentil.h:780-819``, ``src/lentil_imager.cpp:121-160``;
the Cryptomatte spec's MurmurHash3 name hashes).

:func:`crypto_topk` keeps each pixel's ``k`` largest (id, coverage) pairs of
a frame's writer records.  The program coalesces the records by one int64
sort and takes each run's coverage as a difference of float64 prefix sums;
this copy finds the (pixel, id) runs by a ``torch.unique`` inverse, sums
each run and each pixel's total in float64 by ``index_add_``, ranks by two
stable sorts (descending float64 coverage, then pixel: equal coverages keep
ascending id) and rounds to the program's int32 / float32 once, at the end.
So two coverages whose float64 sums differ by less than a float32 rounding
may rank the other way round from the program's, which ranks the rounded
values; the check compares ids only where the coverages are apart.

:func:`pack_layers`, :func:`id_hash_table` and :func:`murmur3_32` are plain
copies of the program's.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from .. import resolve_device


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


def id_hash_table(names, device=None) -> torch.Tensor:
    """[n] float32 table mapping scene object index -> spec name-hash id, on
    ``device`` (default: the card)."""
    return torch.tensor([name_hash_float(n) for n in names],
                        dtype=torch.float32, device=resolve_device(device))


def crypto_topk(pix, obj_id, w, npix: int, k: int = 6):
    """Each pixel's ``k`` largest (id, coverage) pairs of the writer records
    (pixel, id, weight) [W]; a record is live where ``w > 0``, ``obj_id >=
    0`` and ``0 <= pix < npix``.  Returns (rank_id [npix, k] int32 with -1
    padding, rank_w [npix, k] float32, total [npix] float32): float64 sums
    rounded once."""
    dev = w.device
    live = (w > 0) & (obj_id >= 0) & (pix >= 0) & (pix < npix)
    p, w64 = pix[live].long(), w[live].double()
    runs, inv = torch.unique((p << 32) | obj_id[live].long(),
                             return_inverse=True)
    run_w = torch.zeros(runs.shape[0], dtype=torch.float64,
                        device=dev).index_add_(0, inv, w64)
    total = torch.zeros(npix, dtype=torch.float64,
                        device=dev).index_add_(0, p, w64)
    # runs come sorted by (pixel, id): a stable sort by descending coverage,
    # then a stable sort by pixel, leaves equal coverages in ascending id
    order = torch.sort(-run_w, stable=True).indices
    order = order[torch.sort(runs[order] >> 32, stable=True).indices]
    rp, rid, rw = runs[order] >> 32, runs[order] & 0xFFFFFFFF, run_w[order]
    pos = torch.arange(rp.shape[0], device=dev)
    first = torch.ones_like(rp, dtype=torch.bool)
    first[1:] = rp[1:] != rp[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    keep = rank < k
    rank_id = torch.full((npix, k), -1, dtype=torch.int64, device=dev)
    rank_w = torch.zeros((npix, k), dtype=torch.float64, device=dev)
    rank_id[rp[keep], rank[keep]] = rid[keep]
    rank_w[rp[keep], rank[keep]] = rw[keep]
    return (rank_id.to(torch.int32), rank_w.to(torch.float32),
            total.to(torch.float32))


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
