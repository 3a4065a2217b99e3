"""backward_busy_ms.step: device ms a step of the operations launched
inside loss.backward() (the checkpointed trace's recompute, K1v, the
shade's, K2's and K4's VJPs)."""
from harness.readers import busy_ms


def read(rec):
    return busy_ms(rec, "step", ("loss.backward",))
