"""unchanged: the program's fit step leaves its state as it was (no
descent)."""
import contextlib

from harness import world as wd

KINDS = ("step",)


@contextlib.contextmanager
def planted():
    descend = wd.descend
    wd.descend = lambda w, step: (None if w.pkg == wd.PROGRAM
                                  else descend(w, step))
    try:
        yield
    finally:
        wd.descend = descend
