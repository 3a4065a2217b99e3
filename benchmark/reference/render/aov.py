"""AOV (arbitrary output variable) specs and Arnold-style output strings
(port of :mod:`pota_tpu.render.aov`).

``TokenizedOutput`` parses output strings (``"[camera] name type filter
driver [HALF]"``) as the reference's TokenizedOutputLentil does
(zpelgrims/pota ``src/aov_data.h:12-110``); ``AOVSpec`` describes one
output plane: its type, its filter class (gaussian accumulation or closest
by depth, ref ``src/lentil.h:823-929``) and the per-sample stream field
that feeds it.
"""
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


# ------------------------------------------------------- output tokenizing --


@dataclasses.dataclass
class TokenizedOutput:
    """Parsed Arnold-style output string (ref src/aov_data.h:30-90)."""

    camera_tok: str = ""
    aov_name_tok: str = ""
    aov_type_tok: str = ""
    filter_tok: str = ""
    driver_tok: str = ""
    half_flag: bool = False

    @classmethod
    def parse(cls, output_string: str) -> "TokenizedOutput":
        toks = output_string.split()
        out = cls()
        if toks and toks[-1] == "HALF":
            out.half_flag = True
            toks = toks[:-1]
        # with a camera prefix there are 5 tokens, without it 4
        if len(toks) == 5:
            out.camera_tok, toks = toks[0], toks[1:]
        if len(toks) != 4:
            raise ValueError(f"unparsable output string: {output_string!r}")
        (out.aov_name_tok, out.aov_type_tok, out.filter_tok,
         out.driver_tok) = toks
        return out

    def rebuild(self) -> str:
        toks = [self.camera_tok] if self.camera_tok else []
        toks += [self.aov_name_tok, self.aov_type_tok, self.filter_tok,
                 self.driver_tok]
        if self.half_flag:
            toks.append("HALF")
        return " ".join(toks)


_TYPE_MAP = {
    "RGBA": "RGBA", "rgba": "RGBA",
    "RGB": "RGB", "rgb": "RGB",
    "VECTOR": "VECTOR", "vector": "VECTOR", "VEC": "VECTOR", "vec": "VECTOR",
    "FLOAT": "FLOAT", "float": "FLOAT", "FLT": "FLOAT", "flt": "FLOAT",
}

_CLOSEST_FILTERS = ("closest_filter",)


def specs_from_output_strings(outputs, source_map=None,
                              replaced_filter="lentil_replaced_filter"):
    """AOVSpecs from Arnold-style output strings: the operator's
    filter-replacement bookkeeping (ref src/lentil_operator.cpp:84-86 and
    sanitize_aov_list, src/aov_data.h:168-176).  Every output's filter is
    swapped for the lentil filter, duplicate names are dropped, and the
    original filter class decides the gaussian or closest resolve; an
    unknown type becomes RGBA."""
    source_map = source_map or {}
    seen = set()
    specs = []
    for s in outputs:
        to = TokenizedOutput.parse(s)
        if to.aov_name_tok in seen:
            continue
        seen.add(to.aov_name_tok)
        filt = CLOSEST if to.filter_tok in _CLOSEST_FILTERS else GAUSSIAN
        to.filter_tok = replaced_filter
        default_source = {"RGBA": "rgba", "Z": "z", "P": "P"}.get(
            to.aov_name_tok, to.aov_name_tok)
        specs.append(AOVSpec(
            name=to.aov_name_tok,
            type=_TYPE_MAP.get(to.aov_type_tok, "RGBA"),
            filter=filt,
            source=source_map.get(to.aov_name_tok, default_source),
        ))
    return tuple(specs)
