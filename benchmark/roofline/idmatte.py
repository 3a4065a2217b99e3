"""The id-matte stage (``render/splat.py``'s ``id_matte_records`` and
``render/crypto.py::crypto_topk``, with ``resolve_crypto``): the bytes a
frame's configuration makes it move, whatever implements it.

Every writer record is read once: (S + N) writers (the queue's S slots and
the N samples' own pixels), each with D coverage layers (two where the
scene has thin glass, else one), a record a pixel int64, an id int32 and a
weight float32 (16 bytes).  The ranked planes are written once:
``crypto_rank_id`` int32 and ``crypto_rank_w`` float32 [npix, 6] and
``crypto_total`` float32 [npix] (52 bytes a pixel).  No operations are
counted: the stage sorts and moves, and its roofline is its bytes.
"""
from harness.solve_count import queue_slots

RECORD_BYTES = 8 + 4 + 4
RANKS = 6
PIXEL_BYTES = 2 * RANKS * 4 + 4


def count(w) -> tuple:
    """(operations, bytes) of one frame's id-matte stage on the world
    ``w``."""
    rc = w.rc
    n = rc.xres_region * rc.yres_region * rc.spp
    layers = 1 if w.scene.transmission is None else 2
    records = (queue_slots(w) + n) * layers
    npix = rc.xres_region * rc.yres_region
    return 0.0, float(records * RECORD_BYTES + npix * PIXEL_BYTES)
