"""AOV (arbitrary output variable) specs (port of the spec part of
:mod:`pota_tpu.render.aov`)."""
from __future__ import annotations

import dataclasses

import torch

GAUSSIAN = "gaussian"
CLOSEST = "closest"

_TYPES = ("RGBA", "RGB", "VECTOR", "FLOAT")


@dataclasses.dataclass(frozen=True)
class AOVSpec:
    name: str              # output plane name ("RGBA", "Z", ...)
    type: str              # one of _TYPES
    filter: str            # GAUSSIAN or CLOSEST
    source: str            # stream key providing per-sample values
    redistribute: bool = True

    def __post_init__(self):
        if self.type not in _TYPES:
            raise ValueError(f"unknown AOV type {self.type!r}")
        if self.filter not in (GAUSSIAN, CLOSEST):
            raise ValueError(f"unknown AOV filter {self.filter!r}")


# the filter's required AOVs (ref src/lentil_filter.cpp:16-26)
DEFAULT_AOVS = (
    AOVSpec("RGBA", "RGBA", GAUSSIAN, "rgba"),
    AOVSpec("Z", "FLOAT", CLOSEST, "z"),
    AOVSpec("P", "VECTOR", CLOSEST, "P"),
    AOVSpec("lentil_raydir", "RGB", CLOSEST, "raydir"),
    AOVSpec("lentil_time", "FLOAT", CLOSEST, "time"),
    AOVSpec("lentil_debug", "FLOAT", CLOSEST, "debug", redistribute=False),
)


def aov_value_rgba(stream: dict, spec: AOVSpec):
    """An AOV's per-sample values as RGBA4 (ref src/lentil_filter.cpp:206-234)."""
    v = stream[spec.source]
    if spec.type == "RGBA":
        return v
    if spec.type in ("RGB", "VECTOR"):
        return torch.cat([v, torch.ones_like(v[..., :1])], -1)
    return torch.stack([v, v, v, torch.ones_like(v)], -1)
