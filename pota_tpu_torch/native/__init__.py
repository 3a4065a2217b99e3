"""The sample-stream file format (port of :mod:`pota_tpu.native`'s stream
IO, in numpy).

A stream file is a 24-byte little-endian header ``<IIQII`` (magic
:data:`STREAM_MAGIC`, version 1, rows N, fields F, 0) followed by the
[N, F] float32 rows, row-major: the bytes :mod:`pota_tpu.native` writes for
the same array.  Writing and reading are one array copy each, so the port
keeps no C++ library for them.
"""
from __future__ import annotations

import struct

import numpy as np

STREAM_MAGIC = 0x41544F50
STREAM_VERSION = 1
_HEADER = struct.Struct("<IIQII")

STREAM_FIELDS = (
    "r", "g", "b", "a", "z", "px", "py",
    "Px", "Py", "Pz", "dirx", "diry", "dirz",
)


def write_sample_stream(path: str, data: np.ndarray) -> None:
    """Write an [N, F] float32 sample stream."""
    data = np.ascontiguousarray(data, "<f4")
    if data.ndim != 2:
        raise ValueError(f"a sample stream is [N, F], got {data.shape}")
    with open(path, "wb") as f:
        f.write(_HEADER.pack(STREAM_MAGIC, STREAM_VERSION, data.shape[0],
                             data.shape[1], 0))
        data.tofile(f)


def read_sample_stream(path: str) -> np.ndarray:
    """Read an [N, F] float32 sample stream."""
    with open(path, "rb") as f:
        magic, version, n, nf, _ = _HEADER.unpack(f.read(_HEADER.size))
        if magic != STREAM_MAGIC or version != STREAM_VERSION:
            raise ValueError(f"{path}: not a version-{STREAM_VERSION} "
                             f"sample stream")
        data = np.fromfile(f, "<f4", count=n * nf)
    if data.size != n * nf:
        raise ValueError(f"{path}: truncated ({data.size} of {n * nf} "
                         f"floats)")
    return data.reshape(n, nf)


def parse_text_samples(path: str, max_floats: int = 10_000_000) -> np.ndarray:
    """Parse whitespace-separated float dumps (the reference's
    ``sampledata.txt`` shape) into a flat float32 array, at most
    ``max_floats`` values."""
    vals = np.fromfile(path, np.float32, sep=" ")
    return vals[:max_floats]
