"""setup_s: from the process start to the first measured frame or step:
imports, the kernels build (first run of a checkout), the scene, the fit,
the PO camera set-up, the warm-up (a fit: its plate and first steps)."""


def read(rec):
    return rec.setup_s if rec.trace is None else None
