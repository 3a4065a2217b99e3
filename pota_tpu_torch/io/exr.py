"""Uncompressed float32 scanline OpenEXR I/O and a quick-look PPM writer
(the port's own copy of :mod:`pota_tpu.io.exr`): enough of the EXR format
to exchange images with a compositor, and to load aperture images for the
image bokeh.  Given the same channels, :func:`write_exr` writes the same
bytes as the JAX package's."""
from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_VERSION = 2
_PIXELTYPE_FLOAT = 2  # OpenEXR: UINT = 0, HALF = 1, FLOAT = 2
_COMPRESSION_NONE = 0
_LINEORDER_INC_Y = 0


def _attr(name: bytes, type_: bytes, data: bytes) -> bytes:
    return (name + b"\x00" + type_ + b"\x00" + struct.pack("<i", len(data))
            + data)


def write_exr(path: str, channels: dict) -> None:
    """Write named float32 planes to an uncompressed scanline EXR.

    ``channels`` maps a channel name ("R", "G", "B", "A", "Z", ...) to a 2D
    array; every plane has the same shape.
    """
    names = sorted(channels)  # EXR requires alphabetical channel order
    planes = {n: np.asarray(channels[n], dtype="<f4") for n in names}
    h, w = planes[names[0]].shape
    for n in names:
        if planes[n].shape != (h, w):
            raise ValueError(f"channel {n} shape {planes[n].shape} is not "
                             f"{(h, w)}")

    chlist = b"".join(n.encode() + b"\x00"
                      + struct.pack("<iiii", _PIXELTYPE_FLOAT, 0, 1, 1)
                      for n in names) + b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join([
        _attr(b"channels", b"chlist", chlist),
        _attr(b"compression", b"compression",
              struct.pack("<B", _COMPRESSION_NONE)),
        _attr(b"dataWindow", b"box2i", box),
        _attr(b"displayWindow", b"box2i", box),
        _attr(b"lineOrder", b"lineOrder", struct.pack("<B", _LINEORDER_INC_Y)),
        _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
        b"\x00",  # end of header
    ])

    scanline_bytes = 4 * w * len(names)
    data_start = 8 + len(header) + 8 * h
    offsets = [data_start + y * (8 + scanline_bytes) for y in range(h)]
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, _VERSION))
        f.write(header)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, scanline_bytes))
            for n in names:
                f.write(planes[n][y].tobytes())


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


def write_ppm(path: str, rgb, gamma: float = 2.2) -> None:
    """Quick-look 8-bit PPM of an [H, W, 3] image, gamma-encoded."""
    img = np.clip(np.asarray(rgb, np.float32), 0.0, None)
    img = np.clip(img ** (1.0 / gamma), 0.0, 1.0)
    u8 = (img * 255.0 + 0.5).astype(np.uint8)
    h, w = u8.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())
