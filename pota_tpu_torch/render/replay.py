"""Sample-stream capture and replay (port of :mod:`pota_tpu.render.replay`).

The reference's regression fixture is a captured sample dump replayed
through the splat offline (zpelgrims/pota ``tests/cuda/sampledata.txt``,
``src/cuda_prototype/lentil_thin_lens_bokeh_cuda.cu:285-295``): render once,
dump every AA sample, re-splat without the renderer and compare images.
Captures use the stream format of :mod:`pota_tpu_torch.native`, so a file
written by either package replays in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..config import CameraConfig, RenderConfig

# fixed capture schema, one float32 row per AA sample
FIELDS = (
    "px", "py", "r", "g", "b", "a", "z",
    "Px", "Py", "Pz", "dirx", "diry", "dirz", "time", "obj_id",
)


class NullScene:
    """Occlusion-free stand-in scene for offline replay (the CUDA prototype
    has no scene access either: its splats are never occlusion-tested).
    It has no spheres, so :func:`~pota_tpu_torch.render.splat.splat_frame`
    takes the decomposed route for it."""

    def occluded(self, p_from, p_to, t_min=1e-3):
        return torch.zeros(p_from.shape[:-1], dtype=torch.bool,
                           device=p_from.device)

    @property
    def n_objects(self) -> int:
        return 0


def capture_stream(stream: dict) -> np.ndarray:
    """Flatten a renderer sample stream into the [N, 15] capture schema
    (float32; px, py and obj_id are exact below 2^24)."""
    rgba, p, d = stream["rgba"], stream["P"], stream["raydir"]
    n = rgba.shape[0]
    time = stream.get("time")
    obj_id = stream.get("obj_id")
    cols = [
        stream["px"], stream["py"],
        rgba[:, 0], rgba[:, 1], rgba[:, 2], rgba[:, 3],
        stream["z"],
        p[:, 0], p[:, 1], p[:, 2],
        d[:, 0], d[:, 1], d[:, 2],
        torch.zeros(n, device=rgba.device) if time is None else time,
        torch.full((n,), -1, device=rgba.device) if obj_id is None
        else obj_id,
    ]
    out = torch.stack([c.detach().to(torch.float32) for c in cols], -1)
    return out.cpu().numpy()


def stream_from_capture(data, device=None) -> dict:
    """Rebuild a splat-ready sample stream from captured rows [N, 15] on
    ``device`` (default: the card).  Pixel indices are int64 and ``obj_id``
    int32, as the renderer's stream holds them."""
    d = torch.as_tensor(np.asarray(data, np.float32),
                        device=resolve_device(device))
    return {
        "px": d[:, 0].to(torch.int64),
        "py": d[:, 1].to(torch.int64),
        "rgba": d[:, 2:6],
        "z": d[:, 6],
        "P": d[:, 7:10],
        "raydir": d[:, 10:13],
        "time": d[:, 13],
        "obj_id": d[:, 14].to(torch.int32),
    }


def save_capture(path: str, stream: dict) -> None:
    from ..native import write_sample_stream

    write_sample_stream(path, capture_stream(stream))


def load_capture(path: str, device=None) -> dict:
    from ..native import read_sample_stream

    return stream_from_capture(read_sample_stream(path), device=device)


def replay_splat(cfg: CameraConfig, rc: RenderConfig, stream: dict,
                 cam_to_world, scene=None, po_lens=None, po_state=None,
                 ops=None):
    """Re-splat a captured stream into a resolved image (offline imager).
    Returns (image [H, W, 4], framebuffer dict).

    With ``scene=None`` occlusion probes are skipped (prototype-style
    replay, :class:`NullScene`, the decomposed route); pass the original
    scene for a faithful replay of a live render.  ``ops`` picks the kernel
    set (default :data:`pota_tpu_torch.ops.KERNELS`)."""
    from .splat import resolve_imager, splat_frame

    scene = scene if scene is not None else NullScene()
    cam_to_world = cam_to_world.to(stream["rgba"].device, torch.float32)
    with torch.no_grad():
        fb = splat_frame(cfg, rc, scene, stream, cam_to_world,
                         po_lens=po_lens, po_state=po_state, ops=ops)
        return resolve_imager(rc, fb), fb
