"""Kernel wrappers of the port and their plain versions.

:data:`KERNELS` is the set the render path calls by default: CPU tensors go
to each kernel's plain version, CUDA tensors launch the kernel.
:data:`PLAIN` holds the plain versions themselves, so a check on the card can
render the same frame without the kernels and compare.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from . import po_kernels, splat_accum
from ._build import LAUNCHES, reset_launches


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
    po_forward_selected: Callable
    po_forward_vjp_selected: Callable


KERNELS = KernelOps(po_kernels.po_forward, po_kernels.expand,
                    po_kernels.po_splat, splat_accum.segment_accum,
                    po_kernels.tl_splat, po_kernels.po_splat_lam,
                    po_kernels.po_splat_ext, po_kernels.po_backward,
                    po_kernels.po_forward_vjp, po_kernels.po_forward_jvp,
                    po_kernels.po_forward_selected,
                    po_kernels.po_forward_vjp_selected)
PLAIN = KernelOps(po_kernels.po_forward_plain, po_kernels.expand_plain,
                  po_kernels.po_splat_plain, splat_accum.segment_accum_plain,
                  po_kernels.tl_splat_plain, po_kernels.po_splat_lam_plain,
                  po_kernels.po_splat_ext_plain,
                  po_kernels.po_backward_plain,
                  po_kernels.po_forward_vjp_plain,
                  po_kernels.po_forward_jvp_plain,
                  po_kernels.po_forward_selected_plain,
                  po_kernels.po_forward_vjp_selected_plain)

__all__ = ["KERNELS", "PLAIN", "KernelOps", "LAUNCHES", "reset_launches"]
