"""crypto_one_layer: thin glass gives the id-matte only its first coverage
layer (the front surface's opacity), so the objects seen through the glass
drop out of the matte: the program's ``SphereScene.shade`` keeps the first
column of ``crypto_ids`` / ``crypto_weights``."""
import contextlib
import importlib

from harness import world as wd

KINDS = ("crypto_frame",)


@contextlib.contextmanager
def planted():
    cls = importlib.import_module(f"{wd.PROGRAM}.render.scene").SphereScene
    shade = cls.shade

    def first_layer(self, origins, dirs):
        out = shade(self, origins, dirs)
        if "crypto_ids" in out:
            out["crypto_ids"] = out["crypto_ids"][:, :1]
            out["crypto_weights"] = out["crypto_weights"][:, :1]
        return out

    cls.shade = first_layer
    try:
        yield
    finally:
        cls.shade = shade
