"""Stage profile of one warm frame of the PyTorch / CUDA port
(pota_tpu_torch) on one GPU, per cell.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/profile_torch_frame.py [--cells flagship flagship_mb
                                            config1 config3 config3_no_bokeh
                                            config5 flagship_idmatte
                                            grad_mb_1080p grad_aovs_1080p
                                            grad_config1]

``flagship`` is BASELINE config 4 (bench.py:172-246: 1920x1080 @ 1 spp,
lens angenieux__double_gauss__1953__49mm, fstop 2.8, focus 20, lightgrid
n=5); ``flagship_mb`` the same frame with the camera trucked 2 units across
the shutter (motion blur, the decomposed route with K6); ``config1``
BASELINE config 1 (bench.py:58-83: thin lens, teapot, 256x256 @ 16 spp,
K5 ``tl_splat``); ``config3``
BASELINE config 3 (bench.py:117-169: 512x512 @ 2 spp, abb_chromatic 0.6,
image bokeh through chip_smoke.py's procedural ring, lightgrid n=4, K3b
``po_splat_ext``) and ``config3_no_bokeh`` the same without image bokeh
(K3b ``po_splat_lam``); ``flagship_idmatte`` the flagship's camera on
chip_smoke.py's glass teapot (:func:`glass_teapot`) with the id-matte on,
its frame ending in ``resolve_crypto``; ``config5`` BASELINE config 5
(bench.py:249-297),
the differentiable step: chip_smoke.py's :class:`Config5` at 3840x2160 @ 1
spp, ``render_frame(differentiable=True)``, the mean-RGB loss and
``loss.backward()``, whose kernels are also charged to the step's forward
and backward halves (the kernels launched inside ``loss.backward()``:
the checkpointed trace's recompute, its VJPs (K1v), the shade's, K4's
and K2's; the backward is also split by the port's span that launched
each kernel, the recompute, K1v, K2's and K4's VJPs and autograd's own
nodes, and by autograd node: :func:`backward_parts`); ``grad_mb_1080p``,
``grad_aovs_1080p`` and ``grad_config1`` the differentiable routes'
steps of chip_smoke.py's :func:`grad_paths`, split the same way.  For each
cell it
prints five unprofiled frame wall times, then profiles one warm frame with
``torch.profiler`` (CPU and CUDA activities), reads the kernels from the
exported trace, and splits them into stages at the port's own kernels
(K1 po_forward, K1v po_forward_vjp, K2 expand, K3 / K3b po_splat / K5
tl_splat / K6 po_backward, K4 segment_accum's tile and carry kernels)
and at the first radix-sort kernel after the splat: device busy ms, wall
span ms and kernel count per stage, and the device's idle share of the
frame's kernel span.  It then charges each kernel to the innermost of the
port's own ``pota.*`` spans (``pota_tpu_torch/utils/trace.py``) whose range
holds the kernel's launch, and each idle gap to the innermost span open
where it begins, and prints the device busy ms and idle ms per span, and
the registers, launch shape and the profiler's occupancy estimate of the
port's own kernels.  The traces go to ``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FLAGSHIP = "angenieux__double_gauss__1953__49mm"
OWN = (("po_forward_kernel", "K1 po_forward"),
       ("po_forward_vjp_kernel", "K1v po_forward_vjp"),
       ("po_forward_vjp_finish", "K1v po_forward_vjp (sums, unfold)"),
       ("po_forward_jvp_kernel", "K1j po_forward_jvp"),
       ("expand_kernel", "K2 expand"),
       ("po_splat_kernel", "K3/K3b po_splat"), ("po_backward_kernel",
                                               "K6 po_backward"),
       ("tl_splat_kernel", "K5 tl_splat"),
       ("segment_tile_kernel", "K4 segment_accum tiles"),
       ("segment_carry_kernel", "K4 segment_accum carries"))
# the differentiable routes' steps (chip_smoke.py's grad_paths)
GRAD_CELLS = ("grad_mb_1080p", "grad_aovs_1080p", "grad_config1")
# the port's own spans (pota_tpu_torch/utils/trace.py) and this script's
# halves of a step
PREFIX = "pota."
HALVES = ("forward", "loss.backward")


def _ranges(events, keep):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") == "user_annotation"
            and keep(e["name"])]


def _launch_ts(events):
    return {e["args"]["correlation"]: float(e["ts"]) for e in events
            if e.get("cat") == "cuda_runtime"
            and "correlation" in e.get("args", {})}


def _innermost(ranges, t, outside):
    inside = [r for r in ranges if t is not None and r[0] <= t <= r[1]]
    return min(inside, key=lambda r: r[1] - r[0])[2] if inside else outside


def span_busy(events, keep=lambda n: n.startswith(PREFIX),
              outside="(outside the port's spans)"):
    """Device busy ms and kernels per range: each kernel goes to the
    innermost range that ``keep`` accepts (by default the port's ``pota.*``
    spans) holding its launch call."""
    ranges = _ranges(events, keep)
    launch_ts = _launch_ts(events)
    busy = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        t = launch_ts.get(e["args"].get("correlation"))
        name = _innermost(ranges, t, outside)
        n, ms = busy.get(name, (0, 0.0))
        busy[name] = (n + 1, ms + float(e["dur"]) / 1e3)
    return busy


def span_idle(events):
    """Device idle ms of the frame's kernel span by the innermost
    ``pota.*`` span open on the host where each gap begins."""
    ranges = _ranges(events, lambda n: n.startswith(PREFIX))
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                     "gpu_memset"))
    gaps, end = {}, None
    for a, b in ops:
        if end is not None and a > end:
            name = _innermost(ranges, end, "(outside the port's spans)")
            gaps[name] = gaps.get(name, 0.0) + (a - end) / 1e3
        end = b if end is None else max(end, b)
    return gaps


def backward_parts(events):
    """Device busy ms of a step's ``loss.backward`` by the port's span that
    launched it: the trace chunks' recompute (``pota.trace.chunk``), K1v
    (``pota.k1v``), K2's and K4's VJPs (``pota.expand.vjp``,
    ``pota.accum.vjp``), and autograd's own nodes outside every span; then
    the autograd nodes that launched the most device time.  Returns
    ([(part, kernels, ms)], [(node, kernels, ms)])."""
    back = _ranges(events, lambda n: n == "loss.backward")
    if not back:
        return [], []
    b0, b1 = back[0][:2]
    ours = _ranges(events, lambda n: n.startswith(PREFIX))
    chunks = [r for r in ours if r[2] == "pota.trace.chunk"]
    nodes = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              e["name"].split(": ", 1)[-1]) for e in events
             if e.get("cat") == "cpu_op"
             and e["name"].startswith("autograd::engine::evaluate_function")]
    launch_ts = _launch_ts(events)
    parts, by_node = {}, {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        t = launch_ts.get(e["args"].get("correlation"))
        if t is None or not b0 <= t <= b1:
            continue
        ms = float(e["dur"]) / 1e3
        part = ("pota.trace.chunk (the recompute)"
                if any(r[0] <= t <= r[1] for r in chunks)
                else _innermost(ours, t, "autograd's own nodes"))
        n, b = parts.get(part, (0, 0.0))
        parts[part] = (n + 1, b + ms)
        node = _innermost(nodes, t, "(no autograd node)")
        n, b = by_node.get(node, (0, 0.0))
        by_node[node] = (n + 1, b + ms)
    return ([(k, n, b) for k, (n, b) in parts.items()],
            sorted(((k, n, b) for k, (n, b) in by_node.items()),
                   key=lambda x: -x[2]))


def own_kernel(name: str):
    for key, label in OWN:
        if key in name:
            return label
    return None


def stages(kernels):
    """Split the time-ordered kernels [(name, start_us, dur_us)] at the
    port's kernels and at the first sort kernel between the splat and K4."""
    out, cur, label = [], [], "up to the first of the port's kernels"
    after_splat = after_accum = False
    for k in kernels:
        own = own_kernel(k[0])
        is_sort = (after_splat and not after_accum
                   and "radix" in k[0].lower())
        if own or (is_sort and not label.startswith("sort")):
            if cur:
                out.append((label, cur))
            if own:
                out.append((f"**{own}**", [k]))
                after_splat |= own.startswith(("K3", "K5", "K6"))
                after_accum |= own.startswith("K4")
                cur, label = [], f"after {own.split()[0]}"
                continue
            cur, label = [], "sort (cub radix) and after, up to K4"
        cur.append(k)
    if cur:
        out.append((label, cur))
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", default=["flagship", "flagship_mb"],
                    choices=["flagship", "flagship_mb", "config1", "config3",
                             "config3_no_bokeh", "config5",
                             "flagship_idmatte", *GRAD_CELLS])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    import dataclasses

    import pota_tpu_torch as pt
    from chip_smoke import Config5, glass_teapot, grad_paths, ring_pixels
    from pota_tpu_torch.optics.fit import load_poly_lens
    from pota_tpu_torch.optics.focus import setup_po_camera
    from pota_tpu_torch.render import scene as sc
    from pota_tpu_torch.render import renderer, splat
    from pota_tpu_torch.render.bokeh_image import build_bokeh_cdf
    from pota_tpu_torch.render.renderer import look_at

    dev = torch.device("cuda", 0)
    cfg = pt.CameraConfig(
        camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
        fstop=2.8, focus_distance=20.0, vignetting_retries=3,
        splat_queue_mult=8)
    lens = load_poly_lens(FLAGSHIP, device=dev)
    scene = sc.lightgrid_scene(n=5, spacing=12.0, z=-150.0, radius=0.8,
                               intensity=40.0, device=dev)
    rc = pt.RenderConfig(xres=1920, yres=1080, spp=1)
    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    po = dict(po_lens=lens, po_state=setup_po_camera(lens, cfg))
    # config 3 (chip_smoke.py's cfg3, scene3, rc3, cdf3)
    cfg3 = dataclasses.replace(cfg, abb_chromatic=0.6,
                               bokeh_enable_image=True)
    scene3 = sc.lightgrid_scene(n=4, spacing=14.0, z=-150.0, radius=0.8,
                                intensity=40.0, device=dev)
    po3 = dict(po_lens=lens, po_state=setup_po_camera(lens, cfg3,
                                                      scene=scene3))
    rc3 = pt.RenderConfig(xres=512, yres=512, spp=2)
    # config 1 (chip_smoke.py's cfg1, scene1, rc1)
    cfg1 = pt.CameraConfig(focal_length=50.0, fstop=1.4, focus_distance=150.0,
                           vignetting_retries=3, splat_queue_mult=8)
    cells = {
        "config1": (cfg1, pt.RenderConfig(xres=256, yres=256, spp=16),
                    sc.teapot_scene(device=dev), {}),
        "flagship": (cfg, rc, scene, po),
        "flagship_mb": (cfg, rc, scene, dict(
            po, cam_to_world_end=look_at([2.0, 0, 0], [2.0, 0, -1],
                                         device=dev))),
        "config3": (cfg3, rc3, scene3, dict(
            po3, bokeh_cdf=build_bokeh_cdf(ring_pixels(), device=dev))),
        "config3_no_bokeh": (dataclasses.replace(cfg3,
                                                 bokeh_enable_image=False),
                             rc3, scene3, po3),
    }
    scene_g = glass_teapot(dev)
    cells["flagship_idmatte"] = (
        cfg, dataclasses.replace(rc, enable_id_matte=True), scene_g,
        dict(po_lens=lens, po_state=setup_po_camera(lens, cfg,
                                                    scene=scene_g)))
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)

    steps = ("config5", *GRAD_CELLS)
    grads = None
    for cell in args.cells:
        if cell == "config5":
            c5 = Config5(dev, m)

            def frame():
                with torch.profiler.record_function("forward"):
                    img, _ = c5.render()
                    loss = img[..., :3].mean()
                with torch.profiler.record_function("loss.backward"):
                    loss.backward()
        elif cell in GRAD_CELLS:
            grads = grads or grad_paths(
                dev, m, look_at([2.0, 0, 0], [2.0, 0, -1], device=dev))
            gp = grads[cell]

            def frame():
                with torch.profiler.record_function("forward"):
                    loss = gp.forward()[0]
                with torch.profiler.record_function("loss.backward"):
                    loss.backward()
        else:
            cfg_, rc_, scene_, kw = cells[cell]

            def frame():
                with torch.no_grad():
                    _, fb = renderer.render_frame(cfg_, rc_, scene_, m, **kw)
                    splat.resolve_aovs(rc_, fb)
                    if rc_.enable_id_matte:
                        splat.resolve_crypto(fb)

        frame()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            wall_prof = (time.perf_counter() - t0) * 1e3
        path = os.path.join(out_dir, f"trace_{cell}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        if cell in steps:
            # config 5's ~100,000 kernels: too large to bring back from
            # the card; the other steps' are read here alone too
            os.remove(path)
        kernels = sorted((e["name"], float(e["ts"]), float(e["dur"]))
                         for e in events if e.get("cat") == "kernel")
        kernels.sort(key=lambda k: k[1])
        if not kernels:
            print(f"FAIL: {cell}: the trace holds no kernels", flush=True)
            return 1
        busy = sum(k[2] for k in kernels) / 1e3
        span = (kernels[-1][1] + kernels[-1][2] - kernels[0][1]) / 1e3
        print(f"== {cell} ({card})", flush=True)
        print(f"{cell} frame wall ms without the profiler: "
              f"{' / '.join(f'{w:.2f}' for w in walls)}", flush=True)
        print(f"{cell} under the profiler: {wall_prof:.2f} ms wall, "
              f"{len(kernels)} kernels, device busy {busy:.2f} ms of a "
              f"{span:.2f} ms kernel span (idle {100 * (1 - busy / span):.1f}%)",
              flush=True)
        if cell in steps:
            # a step's trace launches K1 and K1v once or twice a chunk: the
            # port's kernels summed, not a stage each
            own = {}
            for k in kernels:
                label = own_kernel(k[0])
                if label:
                    n, b = own.get(label, (0, 0.0))
                    own[label] = (n + 1, b + k[2] / 1e3)
            print("| the port's kernel | device busy ms | launches |",
                  flush=True)
            for label, (n, b) in own.items():
                print(f"| {label} | {b:.3f} | {n} |", flush=True)
        else:
            print("| stage | device busy ms | wall span ms | kernels |",
                  flush=True)
            for label, ks in stages(kernels):
                b = sum(k[2] for k in ks) / 1e3
                sp = (ks[-1][1] + ks[-1][2] - ks[0][1]) / 1e3
                print(f"| {label} | {b:.2f} | {sp:.2f} | {len(ks)} |",
                      flush=True)
        print("| the port's span (innermost) | device busy ms | kernels |",
              flush=True)
        for name, (n, ms) in sorted(span_busy(events).items(),
                                    key=lambda kv: -kv[1][1]):
            print(f"| {name} | {ms:.2f} | {n} |", flush=True)
        print("| idle gap, by the port's span open | idle ms |", flush=True)
        for name, ms in sorted(span_idle(events).items(),
                               key=lambda kv: -kv[1]):
            print(f"| {name} | {ms:.2f} |", flush=True)
        if cell in steps:
            print("| half of the step | device busy ms | kernels |",
                  flush=True)
            halves = span_busy(events, keep=lambda n: n in HALVES,
                               outside="(outside the halves)")
            for name, (n, ms) in sorted(halves.items(),
                                        key=lambda kv: -kv[1][1]):
                print(f"| {name} | {ms:.2f} | {n} |", flush=True)
            parts, nodes = backward_parts(events)
            print("| loss.backward, by part | device busy ms | kernels |",
                  flush=True)
            for name, n, ms in parts:
                print(f"| {name} | {ms:.2f} | {n} |", flush=True)
            print("| loss.backward, by autograd node (top 12) | device busy "
                  "ms | kernels |", flush=True)
            for name, n, ms in nodes[:12]:
                print(f"| {name} | {ms:.2f} | {n} |", flush=True)
        seen = set()
        for e in events:
            if (e.get("cat") == "kernel" and own_kernel(e["name"])
                    and own_kernel(e["name"]) not in seen):
                seen.add(own_kernel(e["name"]))
                a = e["args"]
                print(f"  {own_kernel(e['name'])}: "
                      f"{a.get('registers per thread')} registers, block "
                      f"{a.get('block')}, grid {a.get('grid')}, profiler's "
                      f"occupancy estimate {a.get('est. achieved occupancy %')}%",
                      flush=True)
        top = {}
        for k in kernels:
            top[k[0]] = top.get(k[0], 0.0) + k[2] / 1e3
        for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  top kernel {ms:8.2f} ms  {name[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
