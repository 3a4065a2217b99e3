"""K3 (``po_splat``, ``csrc/po_splat.cu``): operations and bytes of one
launch over the frame's queue.

Every slot of the queue (``splat_queue_mult`` x samples) runs one solve
(:func:`harness.solve_count.solve_flops`).  Bytes: each slot's inputs read
once (the camera and world points, six float32; seed and counter, two
int32; the sky flag, float32) and outputs written once (the pixel, int32;
``ok``, one byte): 41 a slot.
"""
from harness.solve_count import queue_slots, solve_flops

BYTES_PER_SLOT = 6 * 4 + 2 * 4 + 4 + 4 + 1


def count(w) -> tuple:
    """(operations, bytes) of one launch on the world ``w``."""
    s = queue_slots(w)
    return (s * solve_flops(w.fit, w.cfg.lt_newton_iterations),
            s * BYTES_PER_SLOT)
