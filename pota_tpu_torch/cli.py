"""Command-line render entry point of the port (the flags and output of
:mod:`pota_tpu.cli`).

Renders the built-in scenes with any camera and lens configuration and
writes an EXR (beauty, with ``--aovs`` the AOV planes, with ``--id-matte``
the cryptomatte layers ``crypto00..02``) or a quick-look PPM.  It renders
on the card (``cuda:0``) and raises without one; ``--cpu`` renders on the
CPU through the kernels' plain versions.  A PO lens without a committed
fit in ``data/lenses/`` is fitted from its prescription on the same device
and cached under ``pota_tpu_torch/build/lens_fits/``
(:func:`pota_tpu_torch.optics.fit.get_or_fit_lens`).

Usage examples:
    python -m pota_tpu_torch.cli --scene teapot --camera thinlens \\
        --focal-length 50 --fstop 1.4 --out out.exr
    python -m pota_tpu_torch.cli --scene lightgrid --camera po \\
        --lens angenieux__double_gauss__1953__49mm --fstop 2.8 \\
        --res 256 --spp 8 --aovs --id-matte --out po.exr
    python -m pota_tpu_torch.cli --scene lightgrid --camera po \\
        --lens double_gauss --out dg.exr      # fits the base design first
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pota-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--scene", default="teapot",
                   choices=["teapot", "lightgrid"])
    p.add_argument("--camera", default="thinlens", choices=["thinlens", "po"])
    p.add_argument("--lens", default="angenieux__double_gauss__1953__49mm")
    p.add_argument("--focal-length", type=float, default=50.0)
    p.add_argument("--fstop", type=float, default=2.8)
    p.add_argument("--focus-distance", type=float, default=150.0)
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-bidir", action="store_true",
                   help="disable bidirectional redistribution")
    p.add_argument("--max-bidir-samples", type=int, default=32)
    p.add_argument("--bokeh-image", default=None,
                   help="aperture image for image-based bokeh sampling")
    p.add_argument("--aperture-blades", type=int, default=0)
    p.add_argument("--abb-coma", type=float, default=0.0)
    p.add_argument("--abb-distortion", type=float, default=0.0)
    p.add_argument("--abb-chromatic", type=float, default=0.0)
    p.add_argument("--circle-to-square", type=float, default=0.0)
    p.add_argument("--anamorphic", type=float, default=0.0)
    p.add_argument("--optical-vignetting", type=float, default=0.0)
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--glare", type=float, default=0.0, metavar="INTENSITY",
                   help="FFT aperture-diffraction glare intensity (0 = off)")
    p.add_argument("--glare-threshold", type=float, default=1.0)
    p.add_argument("--out", default="pota_render.exr")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (default: the card)")
    p.add_argument("--aovs", action="store_true",
                   help="write all AOV planes (Z, P, raydir, time, debug) "
                        "into the EXR alongside the beauty")
    p.add_argument("--id-matte", action="store_true",
                   help="redistribute ranked id-matte layers (cryptomatte "
                        "capability) and write them as crypto00..02")
    p.add_argument("--region", type=int, nargs=4, default=None,
                   metavar=("MINX", "MINY", "MAXX", "MAXY"),
                   help="render region (inclusive pixel bounds)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the render to DIR "
                        "(render_trace.json, with the port's pota.* spans) "
                        "and the port's counters over it "
                        "(render_counters.json)")
    p.add_argument("--list-lenses", action="store_true",
                   help="list the lens catalog and exit")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_lenses:
        from .lens.database import lens_names

        for n in lens_names():
            print(n)
        return 0

    import numpy as np
    import torch

    from . import CameraConfig, CameraType, RenderConfig, default_device
    from .io.exr import write_exr, write_ppm
    from .render import scene as sc
    from .render.renderer import look_at, render_frame
    from .utils import trace as counters

    dev = torch.device("cpu") if args.cpu else default_device()
    cfg = CameraConfig(
        camera_type=(CameraType.POLYNOMIAL_OPTICS if args.camera == "po"
                     else CameraType.THIN_LENS),
        lens_model=args.lens,
        focal_length=args.focal_length,
        fstop=args.fstop,
        focus_distance=args.focus_distance,
        aperture_blades=args.aperture_blades,
        abb_coma=args.abb_coma,
        abb_distortion=args.abb_distortion,
        abb_chromatic=args.abb_chromatic,
        circle_to_square=args.circle_to_square,
        bokeh_anamorphic=args.anamorphic,
        optical_vignetting_distance=args.optical_vignetting,
        exposure=args.exposure,
        bokeh_enable_image=args.bokeh_image is not None,
        bokeh_image_path=args.bokeh_image,
        max_bidir_samples=args.max_bidir_samples,
        vignetting_retries=4,
    )
    region = {}
    if args.region:
        region = dict(region_min_x=args.region[0],
                      region_min_y=args.region[1],
                      region_max_x=args.region[2],
                      region_max_y=args.region[3])
    rc = RenderConfig(xres=args.res, yres=args.res, spp=args.spp,
                      enable_redistribution=not args.no_bidir,
                      enable_id_matte=args.id_matte, **region)
    scene = (sc.teapot_scene(device=dev) if args.scene == "teapot"
             else sc.lightgrid_scene(n=5, spacing=20.0, z=-400.0, radius=1.5,
                                     intensity=40.0, device=dev))

    po_lens = po_state = None
    if cfg.camera_type == CameraType.POLYNOMIAL_OPTICS:
        from .optics.fit import get_or_fit_lens
        from .optics.focus import setup_po_camera

        print(f"[pota] loading/fitting lens {cfg.lens_model} ...",
              file=sys.stderr)
        po_lens = get_or_fit_lens(cfg.lens_model, device=dev)
        po_state = setup_po_camera(po_lens, cfg)
        print(f"[pota] camera setup: {po_state}", file=sys.stderr)

    bokeh_cdf = None
    if cfg.bokeh_enable_image:
        from .render.bokeh_image import load_bokeh_image

        bokeh_cdf = load_bokeh_image(cfg.bokeh_image_path, device=dev)

    prof = contextlib.nullcontext()
    if args.profile:
        counters.reset()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
    t0 = time.perf_counter()
    with prof:
        img, fb = render_frame(cfg, rc, scene, look_at([0, 0, 0], [0, 0, -1],
                                                       device=dev),
                               seed=args.seed, po_lens=po_lens,
                               po_state=po_state, bokeh_cdf=bokeh_cdf)
        if args.glare > 0.0:
            from .render.glare import resolve_with_glare

            img = resolve_with_glare(img, blades=args.aperture_blades,
                                     threshold=args.glare_threshold,
                                     intensity=args.glare,
                                     chroma=args.abb_chromatic)
        img = img.cpu().numpy()
    dt = time.perf_counter() - t0
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "render_trace.json")
        prof.export_chrome_trace(trace)
        counts = os.path.join(args.profile, "render_counters.json")
        with open(counts, "w") as f:
            json.dump(counters.snapshot(), f, indent=1, sort_keys=True)
        print(f"[pota] profile trace {trace}, counters {counts}",
              file=sys.stderr)
    rays = rc.xres_region * rc.yres_region * args.spp
    print(f"[pota] rendered {rc.xres_region}x{rc.yres_region}@{args.spp}spp "
          f"in {dt:.2f}s ({rays / dt:.0f} rays/s) on {dev}", file=sys.stderr)

    if args.out.endswith(".ppm"):
        write_ppm(args.out, img[..., :3])
    else:
        channels = {c: img[..., i] for i, c in enumerate("RGBA")}
        if args.aovs and fb:
            from .render.splat import resolve_aovs

            for name, plane in resolve_aovs(rc, fb).items():
                if name == "RGBA":
                    continue
                plane = plane.cpu().numpy()
                for i, suffix in enumerate("RGBA"[:plane.shape[-1]]):
                    channels[f"{name}.{suffix}"] = plane[..., i]
        if args.id_matte and fb and "crypto_rank_id" in fb:
            from .render.splat import resolve_crypto

            for r, layer in enumerate(resolve_crypto(fb, ranks=3)):
                layer = layer.cpu().numpy()
                for i, suffix in enumerate("RGBA"):
                    channels[f"crypto{r:02d}.{suffix}"] = layer[..., i]
        write_exr(args.out, {k: np.asarray(v) for k, v in channels.items()})
    print(f"[pota] wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
