"""Pixel/sample coordinate generation (port of
:mod:`pota_tpu.render.sampling`, bit-exact with it)."""
from __future__ import annotations

import torch

from .. import resolve_device
from ..config import RenderConfig

from ..utils import rng as prng
from ..utils.trace import span


def screen_coords(rc: RenderConfig, px, py, jx, jy):
    """Pixel indices + jitter in [0, 1) -> screen coords (sx in [-1, 1]; sy
    pre-divided by the frame aspect)."""
    aspect = rc.xres / rc.yres
    screen_x = 2.0 * (px + jx) / rc.xres - 1.0
    screen_y = 1.0 - 2.0 * (py + jy) / rc.yres
    return screen_x, screen_y / aspect


def pixel_to_linear(rc: RenderConfig, px, py):
    """Absolute pixel indices -> the full frame's linear pixel index."""
    return py * rc.xres + px


@span("pota.samples")
def frame_samples(rc: RenderConfig, seed: int, device=None) -> dict:
    """The frame's sample coordinates, flattened to N = H_region * W_region
    * spp, on ``device`` (default: the card).  Integer fields (px, py, sid,
    key) are int64; ``key`` holds the uint32 TEA key."""
    device = resolve_device(device)
    h, w, spp = rc.yres_region, rc.xres_region, rc.spp
    ar = lambda k: torch.arange(k, dtype=torch.int64, device=device)
    px = (rc.region_min_x + ar(w)).view(1, w, 1).expand(h, w, spp)
    py = (rc.region_min_y + ar(h)).view(h, 1, 1).expand(h, w, spp)
    sid = ar(spp).view(1, 1, spp).expand(h, w, spp)

    # seed by absolute pixel so a region render reproduces the full frame's
    linear = pixel_to_linear(rc, px, py)
    key = prng.tea(linear, int(seed) & prng.MASK32)
    u = prng.uniforms(key, sid, 5)
    jx, jy, r1, r2, tu = (u[..., i] for i in range(5))

    sx, sy = screen_coords(rc, px.to(torch.float32), py.to(torch.float32),
                           jx, jy)
    flat = lambda a: a.reshape(-1).contiguous()
    return {
        "px": flat(px),
        "py": flat(py),
        "sid": flat(sid),
        "sx": flat(sx),
        "sy": flat(sy),
        "r1": flat(r1),
        "r2": flat(r2),
        "ox": flat(jx - 0.5),
        "oy": flat(jy - 0.5),
        "key": flat(key),
        "time": flat(tu),
    }
