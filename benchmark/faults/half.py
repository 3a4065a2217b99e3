"""half: half the frame's samples left out, the mean taken over the rest
(every odd sample's radiance zeroed, the even ones' doubled, where the
program's sample stream is produced)."""
import contextlib
import importlib

from harness import world as wd

KINDS = ("frame", "step")


@contextlib.contextmanager
def planted():
    mod = importlib.import_module(f"{wd.PROGRAM}.render.renderer")
    stream = mod.render_sample_stream

    def halved(*a, **k):
        s = stream(*a, **k)
        rgba = s["rgba"].clone()
        rgba[1::2] = 0.0
        rgba[0::2] = rgba[0::2] * 2.0
        return {**s, "rgba": rgba}

    mod.render_sample_stream = halved
    try:
        yield
    finally:
        mod.render_sample_stream = stream
