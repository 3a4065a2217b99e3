"""backward_glue_ms.step: device ms a step of the operations launched
inside loss.backward() and outside every ``pota.*`` span of the program:
autograd's own nodes (``IndexBackward0``, the shade's and the trace's glue
VJPs), not the recompute, K1v or K2's and K4's VJPs."""
from harness.spans import backward_glue_ms


def read(rec):
    return backward_glue_ms(rec, "step")
