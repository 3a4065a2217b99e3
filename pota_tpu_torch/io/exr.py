"""Reader of uncompressed float32 scanline OpenEXR files (the port's own
copy of ``read_exr`` from :mod:`pota_tpu.io.exr`, which writes them; used
to load aperture images for the image bokeh)."""
from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_COMPRESSION_NONE = 0


def read_exr(path: str) -> dict:
    """Read an uncompressed float32 scanline EXR: channel name -> [H, W]."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        end = data.index(b"\x00", pos)
        name = data[pos:end].decode()
        pos = end + 1
        end = data.index(b"\x00", pos)
        type_ = data[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = (type_, data[pos:pos + size])
        pos += size
    pos += 1  # header terminator

    # channel list: name, NUL, then 16 bytes of pixel type and sampling
    chdata = attrs["channels"][1]
    names = []
    cpos = 0
    while chdata[cpos] != 0:
        cend = chdata.index(b"\x00", cpos)
        names.append(chdata[cpos:cend].decode())
        cpos = cend + 1 + 16
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    (compression,) = struct.unpack("<B", attrs["compression"][1])
    if compression != _COMPRESSION_NONE:
        raise ValueError(f"{path}: only uncompressed EXR is supported")

    pos += 8 * h  # skip the offset table
    planes = {n: np.empty((h, w), dtype=np.float32) for n in names}
    for y in range(h):
        _, nbytes = struct.unpack_from("<ii", data, pos)
        pos += 8
        row = np.frombuffer(data, dtype="<f4", count=w * len(names),
                            offset=pos)
        pos += nbytes
        for i, n in enumerate(names):
            planes[n][y] = row[i * w:(i + 1) * w]
    return planes
