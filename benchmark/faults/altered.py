"""altered: the answer altered where it is produced: the program's
resolved beauty scaled by 1.01 (``resolve_imager``, which a fit's loss
reads, and ``resolve_aovs``, which a frame's check reads)."""
import contextlib
import importlib

from harness import world as wd

KINDS = ("frame", "step")


@contextlib.contextmanager
def planted():
    splat = importlib.import_module(f"{wd.PROGRAM}.render.splat")
    imager, aovs = splat.resolve_imager, splat.resolve_aovs

    def resolve(rc, fb, *a, **k):
        out = dict(aovs(rc, fb, *a, **k))
        out["RGBA"] = out["RGBA"] * 1.01
        return out

    splat.resolve_imager = lambda rc, fb: imager(rc, fb) * 1.01
    splat.resolve_aovs = resolve
    try:
        yield
    finally:
        splat.resolve_imager, splat.resolve_aovs = imager, aovs
