"""peak_gib: torch.cuda.max_memory_allocated() over the window (reset
after set-up), GiB."""
from harness.readers import positive


def read(rec):
    if rec.trace is not None:
        return None
    return positive(rec.peak_bytes / 2 ** 30)
