"""Sorted splat accumulator (K4) with its plain PyTorch version.

Port of :mod:`pota_tpu.ops.splat_accum`.  The writer stream is sorted once
(``torch.sort`` with ``stable=True``, as JAX sorts with ``lax.sort`` outside
its kernel) on one int64 key ``pixel << 32 | float_bits(|z|)``: depths are
>= 0, so their bits order like the floats, and equal keys keep writer
order.  Over the sorted stream the accumulator sums the payload per pixel
and takes each pixel's closest winner from its first row.

The kernel (``csrc/segment_accum.cu``) cuts the sorted rows into tiles of
:data:`TILE_THREADS` x :data:`THREAD_ROWS` rows; a segment that crosses a
tile edge is finished from a carry buffer of the tiles' first and last
segments, which the wrapper allocates.

:class:`AccumFn` gives the sorted accumulation the linear gradient JAX
defines for its payload (``_accumulate_sorted_diff``); the wrapper itself,
like the port's other kernel wrappers, refuses a payload that requires grad
while grad mode is on.
"""
from __future__ import annotations

import torch

from ..utils.trace import span
from . import _build
from .po_kernels import _check, _refuse_grad, _stream

# the kernel's tile (csrc/segment_accum.cu kAccThreads, kAccRows)
TILE_THREADS = 256
THREAD_ROWS = 4
TILE_ROWS = TILE_THREADS * THREAD_ROWS


def writer_keys(pix, depth):
    """int64 sort keys ``pixel << 32 | float_bits(depth)`` (depth >= 0)."""
    bits = depth.to(torch.float32).contiguous().view(torch.int32)
    return (pix.to(torch.int64) << 32) | bits.to(torch.int64)


@span("pota.splat.sort")
def sort_writers(pix, depth):
    """The shared stable (pixel, depth) sort.  Returns (sorted keys, perm)."""
    return torch.sort(writer_keys(pix, depth), stable=True)


def segment_accum_plain(keys_sorted, perm, payload, sample_id, npix: int):
    """Plain K4: per-pixel payload sums (summed in sorted order on the CPU)
    and the closest winner of each pixel's segment."""
    pix_s = keys_sorted >> 32
    live = pix_s < npix
    rows = payload[perm]
    acc = torch.zeros((npix + 1, payload.shape[1]), dtype=payload.dtype,
                      device=payload.device)
    acc.index_add_(0, torch.clamp(pix_s, max=npix), rows)
    first = torch.ones_like(live)
    first[1:] = pix_s[1:] != pix_s[:-1]
    first &= live
    win_pix = pix_s[first]
    depth_bits = (keys_sorted[first] & 0xFFFFFFFF).to(torch.int32)
    winner_depth = torch.zeros((npix,), dtype=torch.float32,
                               device=payload.device)
    winner_depth[win_pix] = depth_bits.view(torch.float32)
    winner_sample = torch.zeros((npix,), dtype=torch.int32,
                                device=payload.device)
    winner_sample[win_pix] = sample_id[perm[first]].to(torch.int32)
    has_winner = torch.zeros((npix,), dtype=torch.bool, device=payload.device)
    has_winner[win_pix] = True
    return acc[:npix], winner_depth, winner_sample, has_winner


@span("pota.k4")
def segment_accum(keys_sorted, perm, payload, sample_id, npix: int):
    """K4 wrapper.  ``keys_sorted`` int64 [W] (from :func:`sort_writers`),
    ``perm`` int64 [W], ``payload`` f32 [W, K] and ``sample_id`` int32 [W]
    in writer order.  Returns (accum [npix, K], winner_depth [npix],
    winner_sample int32 [npix], has_winner bool [npix])."""
    _refuse_grad("segment_accum", keys_sorted, perm, payload, sample_id)
    dev = keys_sorted.device
    w = keys_sorted.shape[0]
    k = payload.shape[1]
    _check("keys_sorted", keys_sorted, torch.int64, dev, (w,))
    _check("perm", perm, torch.int64, dev, (w,))
    _check("payload", payload, torch.float32, dev, (w, k))
    _check("sample_id", sample_id, torch.int32, dev, (w,))
    if dev.type == "cpu":
        return segment_accum_plain(keys_sorted, perm, payload, sample_id,
                                   npix)
    if w >= 2 ** 31 or npix >= 2 ** 31:
        raise ValueError(f"segment_accum: {w} writers or {npix} pixels "
                         "exceed the kernel's int32 rows")
    # a pixel no writer touches reads zeros
    accum = torch.zeros((npix, k), dtype=torch.float32, device=dev)
    winner_depth = torch.zeros((npix,), dtype=torch.float32, device=dev)
    winner_sample = torch.zeros((npix,), dtype=torch.int32, device=dev)
    has_winner = torch.zeros((npix,), dtype=torch.bool, device=dev)
    n_tiles = -(-w // TILE_ROWS)
    lead = torch.empty((n_tiles, k), dtype=torch.float32, device=dev)
    trail = torch.empty((n_tiles, k), dtype=torch.float32, device=dev)
    tail_pix = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    err = _build.lib().pota_segment_accum(
        keys_sorted.data_ptr(), perm.data_ptr(), w, payload.data_ptr(), k,
        sample_id.data_ptr(), npix, accum.data_ptr(), winner_depth.data_ptr(),
        winner_sample.data_ptr(), has_winner.data_ptr(), lead.data_ptr(),
        trail.data_ptr(), tail_pix.data_ptr(), _stream(dev))
    _build.check(err, "segment_accum")
    _build.LAUNCHES["segment_accum"] += 1
    return accum, winner_depth, winner_sample, has_winner


class AccumFn(torch.autograd.Function):
    """The shared (pixel, depth) sort and K4 with a gradient for the
    payload: ``AccumFn.apply(payload, pix, depth, sample_id, npix,
    accum_impl)`` returns what :func:`accumulate_sorted` returns, through
    ``accum_impl`` (a kernel set's ``segment_accum``).

    The backward is JAX's (``_accumulate_sorted_diff``,
    ``pota_tpu/render/splat.py:328-376``): the accumulation is a sum by
    target pixel whatever the sort order, so a live writer's payload
    gradient is the accumulator's gradient at its pixel, and a dead
    writer's (``pix == npix``) is 0.  The winner outputs, pixels, depths
    and sample ids get no gradient."""

    @staticmethod
    def forward(ctx, payload, pix, depth, sample_id, npix, accum_impl):
        keys, perm = sort_writers(pix, depth)
        out = accum_impl(keys, perm,
                         payload.detach().to(torch.float32).contiguous(),
                         sample_id.to(torch.int32).contiguous(), npix)
        ctx.save_for_backward(pix)
        ctx.npix = npix
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    @span("pota.accum.vjp")
    def backward(ctx, d_accum, *_):
        (pix,) = ctx.saved_tensors
        live = pix < ctx.npix
        d_payload = d_accum[torch.clamp(pix, max=ctx.npix - 1)]
        return (torch.where(live[:, None], d_payload, 0.0), None, None, None,
                None, None)


@span("pota.splat.accum")
def accumulate_sorted(pix, depth, payload, sample_id, npix: int, ops=None):
    """Segment sum + closest winner over a writer stream (the counterpart of
    ``pota_tpu.ops.splat_accum.accumulate_sorted``).

    ``pix`` [W] target pixel per writer, dead writers carry ``npix``;
    ``depth`` [W] >= 0; ``payload`` [W, K]; ``sample_id`` [W].  Through
    :class:`AccumFn`, so a payload that requires grad gets its gradient."""
    return AccumFn.apply(payload, pix, depth, sample_id, npix,
                         segment_accum if ops is None else ops.segment_accum)
