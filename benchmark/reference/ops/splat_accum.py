"""The sorted splat accumulator (K4) in plain PyTorch (a frozen copy; the
kernel and its launcher are not copied).

The writer stream is sorted once (``torch.sort`` with ``stable=True``) on
one int64 key ``pixel << 32 | float_bits(|z|)``: depths are >= 0, so their
bits order like the floats, and equal keys keep writer order.  Over the
sorted stream the accumulator sums the payload per pixel and takes each
pixel's closest winner from its first row.  :class:`AccumFn` gives it the
linear gradient JAX defines for its payload.
"""
from __future__ import annotations

import torch


def writer_keys(pix, depth):
    """int64 sort keys ``pixel << 32 | float_bits(depth)`` (depth >= 0)."""
    bits = depth.to(torch.float32).contiguous().view(torch.int32)
    return (pix.to(torch.int64) << 32) | bits.to(torch.int64)


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
    def backward(ctx, d_accum, *_):
        (pix,) = ctx.saved_tensors
        live = pix < ctx.npix
        d_payload = d_accum[torch.clamp(pix, max=ctx.npix - 1)]
        return (torch.where(live[:, None], d_payload, 0.0), None, None, None,
                None, None)


def accumulate_sorted(pix, depth, payload, sample_id, npix: int, ops=None):
    """Segment sum + closest winner over a writer stream (the counterpart of
    ``pota_tpu.ops.splat_accum.accumulate_sorted``).

    ``pix`` [W] target pixel per writer, dead writers carry ``npix``;
    ``depth`` [W] >= 0; ``payload`` [W, K]; ``sample_id`` [W].  Through
    :class:`AccumFn`, so a payload that requires grad gets its gradient."""
    return AccumFn.apply(payload, pix, depth, sample_id, npix,
                         segment_accum if ops is None else ops.segment_accum)
