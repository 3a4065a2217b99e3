"""K6 (``po_backward``, ``csrc/po_backward.cu``): operations and bytes of
one launch over the frame's queue, on one folded table.

Every slot of the queue runs one solve
(:func:`harness.solve_count.solve_flops`).  Bytes: each slot's inputs read
once (the lens-space target, three float32; the aperture point, two) and
outputs written once (x, y, dx, dy and the transmission, five float32): 40
a slot.
"""
from harness.solve_count import queue_slots, solve_flops

BYTES_PER_SLOT = 5 * 4 + 5 * 4


def count(w) -> tuple:
    """(operations, bytes) of one launch on the world ``w``."""
    s = queue_slots(w)
    return (s * solve_flops(w.fit, w.cfg.lt_newton_iterations),
            s * BYTES_PER_SLOT)
