"""host_writes.frame: the program's blocking copies of host data to the card
a frame (its ``host_writes`` counter: ``torch.tensor(data, device=...)``
copies from pageable memory and then waits for the device to drain the
work queued before it, as a read does)."""
from harness.spans import per_unit


def read(rec):
    return per_unit(rec, "frame", ("host_writes",))
