"""The reference's kernel sets: plain PyTorch only.

:data:`KERNELS` (the default of every call in the copy) holds the plain
versions, the per-item ones run in chunks of :data:`CHUNK` items so that a
4K frame's queue fits the card.  :func:`rounded` makes the control: the same
set with every floating input and output of each kernel rounded to
bfloat16.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import po_kernels, splat_accum

CHUNK = 1 << 21


class KernelOps(NamedTuple):
    po_forward: Callable
    expand: Callable
    po_splat: Callable
    segment_accum: Callable
    tl_splat: Callable
    po_splat_lam: Callable
    po_splat_ext: Callable
    po_backward: Callable
    po_forward_vjp: Callable
    po_forward_jvp: Callable


def chunked(fn, items):
    """``fn`` over chunks of :data:`CHUNK` items of the per-item arguments
    at the positions ``items`` (a None there stays None); the outputs
    joined."""
    def call(*args):
        n = args[items[0]].shape[0]
        if n <= CHUNK:
            return fn(*args)
        parts = [fn(*(a[i:i + CHUNK] if k in items and a is not None else a
                      for k, a in enumerate(args)))
                 for i in range(0, n, CHUNK)]
        return tuple(torch.cat(p) for p in zip(*parts))
    return call


PLAIN = KernelOps(
    chunked(po_kernels.po_forward_plain, (1, 2, 3, 4)),
    po_kernels.expand_plain,
    chunked(po_kernels.po_splat_plain, tuple(range(1, 10))),
    splat_accum.segment_accum_plain,
    chunked(po_kernels.tl_splat_plain, tuple(range(0, 9))),
    chunked(po_kernels.po_splat_lam_plain, (1, 2, 3, 4, 5, 6, 7, 8, 10, 11)),
    chunked(po_kernels.po_splat_ext_plain, (1, 2, 3, 4, 5, 6, 7, 8, 10, 11)),
    chunked(po_kernels.po_backward_plain, (1, 2, 3, 4, 5, 7)),
    po_kernels.po_forward_vjp_plain,
    po_kernels.po_forward_jvp_plain)
KERNELS = PLAIN


def _bf16(x):
    """A floating tensor rounded to bfloat16 and back; anything else as
    it is (tuples element by element)."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    if isinstance(x, tuple):
        return tuple(_bf16(v) for v in x)
    return x


def rounded(ops: KernelOps = PLAIN) -> KernelOps:
    """The control's kernel set: each kernel of ``ops`` with its floating
    tensor inputs and outputs rounded to bfloat16 (bfloat16 storage between
    the stages, float32 arithmetic inside them)."""
    def wrap(fn):
        def call(*args):
            return _bf16(fn(*(_bf16(a) for a in args)))
        return call
    return KernelOps(*(wrap(fn) for fn in ops))
