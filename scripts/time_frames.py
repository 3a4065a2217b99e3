"""Frame wall times of the port's cells for one checkout of pota_tpu_torch.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/time_frames.py [--root DIR] [--cells flagship ...]
                                   [--runs 5]

``--root`` names the checkout whose ``pota_tpu_torch`` is timed (default:
this one); the cells are this checkout's (``chip_smoke.py``'s cameras,
scenes and frames), so that an older commit unpacked with ``git archive``
under ``build/`` is timed by the same script in the same call: parent,
change, change, parent.  A cell the checkout cannot render (the id-matte
before the port had it) is skipped.  Each cell's frame is run once to warm
up, then ``--runs`` times, each on the host clock around a synchronised
frame: ``render_frame`` + ``resolve_aovs`` under ``no_grad`` (with the
id-matte also ``resolve_crypto``); ``config5`` a differentiable 4K step,
``render_frame(differentiable=True)`` + ``loss.backward()``
(``chip_smoke.Config5.step``); ``grad_mb_1080p`` and ``grad_aovs_1080p``
a step of ``chip_smoke.grad_paths``'s routes; ``derivs_po``
``trace_camera_rays_with_derivs`` of a 1080p frame with config 2's PO
camera (``chip_smoke.py``'s derivs phase).  Each cell also reports its
peak allocated device memory over its runs.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("flagship", "flagship_mb", "config1", "config3", "config3_no_bokeh",
         "flagship_idmatte", "config5", "grad_mb_1080p", "grad_aovs_1080p",
         "derivs_po")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--cells", nargs="+", default=list(CELLS), choices=CELLS)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    # the cells are this checkout's; the package is root's
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    import pota_tpu_torch as pt
    from pota_tpu_torch.optics.fit import load_poly_lens
    from pota_tpu_torch.optics.focus import setup_po_camera
    from pota_tpu_torch.render import scene as sc
    from pota_tpu_torch.render import splat
    from pota_tpu_torch.render.bokeh_image import build_bokeh_cdf
    from pota_tpu_torch.render.renderer import (
        look_at, render_frame, trace_camera_rays_with_derivs)
    from pota_tpu_torch.render.sampling import frame_samples

    if not pt.__file__.startswith(root):
        print(f"FAIL: imported {pt.__file__}, not from {root}", flush=True)
        return 1
    dev = torch.device("cuda", 0)
    cfg = pt.CameraConfig(
        camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=cs.FLAGSHIP,
        fstop=2.8, focus_distance=20.0, vignetting_retries=3,
        splat_queue_mult=8)
    lens = load_poly_lens(cs.FLAGSHIP, device=dev)
    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    rc = pt.RenderConfig(xres=1920, yres=1080, spp=1)
    scene = sc.lightgrid_scene(n=5, spacing=12.0, z=-150.0, radius=0.8,
                               intensity=40.0, device=dev)
    po = dict(po_lens=lens, po_state=setup_po_camera(lens, cfg))
    cfg3 = dataclasses.replace(cfg, abb_chromatic=0.6,
                               bokeh_enable_image=True)
    scene3 = sc.lightgrid_scene(n=4, spacing=14.0, z=-150.0, radius=0.8,
                                intensity=40.0, device=dev)
    po3 = dict(po_lens=lens, po_state=setup_po_camera(lens, cfg3,
                                                      scene=scene3))
    rc3 = pt.RenderConfig(xres=512, yres=512, spp=2)
    scene_g = cs.glass_teapot(dev)
    cells = {
        "flagship": (cfg, rc, scene, po),
        "flagship_mb": (cfg, rc, scene, dict(
            po, cam_to_world_end=look_at([2.0, 0, 0], [2.0, 0, -1],
                                         device=dev))),
        "config1": (pt.CameraConfig(focal_length=50.0, fstop=1.4,
                                    focus_distance=150.0,
                                    vignetting_retries=3, splat_queue_mult=8),
                    pt.RenderConfig(xres=256, yres=256, spp=16),
                    sc.teapot_scene(device=dev), {}),
        "config3": (cfg3, rc3, scene3, dict(
            po3, bokeh_cdf=build_bokeh_cdf(cs.ring_pixels(), device=dev))),
        "config3_no_bokeh": (dataclasses.replace(
            cfg3, bokeh_enable_image=False), rc3, scene3, po3),
        "flagship_idmatte": (cfg, dataclasses.replace(
            rc, enable_id_matte=True), scene_g, dict(
                po_lens=lens, po_state=setup_po_camera(lens, cfg,
                                                       scene=scene_g))),
    }
    out = dict(root=root, card=cs.card_line())
    for cell in args.cells:
        if cell == "config5":
            c5 = cs.Config5(dev, m)
            frame = c5.step
        elif cell.startswith("grad_"):
            frame = cs.grad_paths(dev, m, look_at([2.0, 0, 0], [2.0, 0, -1],
                                                  device=dev))[cell].step
        elif cell == "derivs_po":
            cfg2 = dataclasses.replace(cfg, focus_distance=150.0)
            kw2 = dict(po_lens=lens, po_state=setup_po_camera(lens, cfg2))
            smp = frame_samples(rc, 0, device=dev)

            def frame():
                trace_camera_rays_with_derivs(cfg2, rc, smp, **kw2)
        elif (cell == "flagship_idmatte"
              and not hasattr(splat, "resolve_crypto")):
            out[cell] = "not rendered by this checkout"
            continue
        else:
            cfg_, rc_, scene_, kw = cells[cell]

            def frame():
                with torch.no_grad():
                    _, fb = render_frame(cfg_, rc_, scene_, m, seed=0, **kw)
                    splat.resolve_aovs(rc_, fb)
                    if rc_.enable_id_matte:
                        splat.resolve_crypto(fb)
        torch.cuda.reset_peak_memory_stats()
        frame()
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[cell] = dict(median_ms=statistics.median(walls), ms=walls,
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"{cell}: {out[cell]}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
