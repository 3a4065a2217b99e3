"""crypto_sources_only: the id-matte's coverage left where each sample hit:
the program's ``id_matte_records`` leaves out the queue slots' records and
gives every sample one record a coverage layer at its own pixel, so the
matte does not follow the bokeh (what lentil's redistribution of the
Cryptomatte coverage is for, ``src/lentil.h:814-819``)."""
import contextlib
import importlib

import torch

from harness import world as wd

KINDS = ("crypto_frame",)


@contextlib.contextmanager
def planted():
    splat = importlib.import_module(f"{wd.PROGRAM}.render.splat")
    records = splat.id_matte_records

    def sources_only(stream, lin_splat, lin_source, oid, w_slot, w_src):
        return records(stream, lin_splat[:0], lin_source, oid[:0],
                       w_slot[:0], torch.ones_like(w_src))

    splat.id_matte_records = sources_only
    try:
        yield
    finally:
        splat.id_matte_records = records
