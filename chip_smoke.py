"""Chip smoke test of the PyTorch / CUDA port (pota_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. device   needs CUDA; prints the card's name and power limit
  2. build    compiles the four kernels from pota_tpu_torch/csrc (nvcc)
  3. kernels  captures each kernel's arguments from one flagship frame,
              then runs kernel and plain PyTorch version on those inputs,
              asserts the tolerances and times both (CUDA events, median
              of 5 after a warm-up)
  4. parity   renders 256x256 @ 1 spp twice, through the kernels and
              through the plain versions on CUDA tensors, and compares
  5. flagship the full 1920x1080 @ 1 spp bidirectional render (BASELINE
              config 4): launch counts, finite planes, valid splats, energy
The last two lines of stdout are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
PLAIN_CHUNK = 1 << 20           # plain K1 / K3 run in 1M-item chunks
PIXEL_TOL, MAX_PIXELS_OFF = 2e-3, 0.02
ENERGY_TOL = 1e-4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 3) -> float:
    """Median wall time of fn() ending in a device synchronise."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def plain_chunked(fn, args, n_items: int):
    """fn(lens, *items, *rest) over 1M-item chunks of the ``n_items``
    per-item tensors after the lens (a whole queue at once would not fit
    the plain versions' intermediates); returns the joined outputs."""
    import torch

    lens, items, rest = args[0], args[1:1 + n_items], args[1 + n_items:]
    parts = [fn(lens, *(t[i:i + PLAIN_CHUNK] for t in items), *rest)
             for i in range(0, items[0].shape[0], PLAIN_CHUNK)]
    return [torch.cat(p) for p in zip(*parts)]


def frac_pixels_off(got, want) -> float:
    import torch

    got = got.reshape(got.shape[0] * got.shape[1], -1).double()
    want = want.reshape(got.shape).double()
    scale = max(float(want.abs().max()), 1.0)
    return float(((got - want).abs().amax(-1) > PIXEL_TOL * scale)
                 .double().mean())


class Recorder:
    """A kernel set that runs the kernels and keeps the arguments of the
    first call of each, so they can be replayed at main-path shapes."""

    def __init__(self, kernels):
        self.args = {}
        for name in kernels._fields:
            setattr(self, name, self._wrap(name, getattr(kernels, name)))

    def _wrap(self, name, fn):
        def call(*args):
            self.args.setdefault(name, args)
            return fn(*args)
        return call


def main() -> int:
    import torch

    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"({card})"

    import pota_tpu_torch as pt
    from pota_tpu_torch import ops
    from pota_tpu_torch.ops import _build, po_kernels as pk, splat_accum
    from pota_tpu_torch.optics.fit import load_poly_lens
    from pota_tpu_torch.optics.focus import setup_po_camera
    from pota_tpu_torch.render import scene as sc
    from pota_tpu_torch.render.renderer import (
        look_at, render_frame, render_sample_stream)
    from pota_tpu_torch.render.splat import resolve_aovs, splat_frame

    phase("build")
    t0 = time.perf_counter()
    _build.lib()
    print(f"build_s {time.perf_counter() - t0:.2f} "
          f"(nvcc {_build.build_info['seconds']:.2f} s, "
          f"cached={_build.build_info['cached']})", flush=True)
    print(_build.ptxas_report(), flush=True)

    # the flagship configuration (bench.py:192-201)
    cfg = pt.CameraConfig(
        camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
        fstop=2.8, focus_distance=20.0, vignetting_retries=3,
        splat_queue_mult=8,
    )
    lens = load_poly_lens(FLAGSHIP, device=dev)
    if lens is None:
        fail(f"lens fit {FLAGSHIP} missing")
    scene = sc.lightgrid_scene(n=5, spacing=12.0, z=-150.0, radius=0.8,
                               intensity=40.0, device=dev)
    m = look_at([0, 0, 0], [0, 0, -1], device=dev)
    t0 = time.perf_counter()
    state = setup_po_camera(lens, cfg)
    print(f"setup_po_camera {state} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    rc_full = pt.RenderConfig(xres=1920, yres=1080, spp=1)

    phase("kernels vs plain versions (main-path inputs)")
    rec = Recorder(ops.KERNELS)
    with torch.no_grad():
        render_frame(cfg, rc_full, scene, m, seed=0, po_lens=lens,
                     po_state=state, ops=rec)
    torch.cuda.synchronize()
    records = []

    with torch.no_grad():
        # K1: PO forward, M = N * K rays
        a1 = rec.args["po_forward"]
        got = pk.po_forward(*a1)
        ref = plain_chunked(pk.po_forward_plain, a1, 5)
        ok_g, ok_p = got[1] > 0, ref[1] > 0
        agree = float((ok_g == ok_p).double().mean())
        both = ok_g & ok_p
        err1 = max(float((g[both] - r[both]).abs().max())
                   for g, r in zip(got, ref))
        print(f"K1 po_forward M={a1[1].shape[0]} trans>0 agree={agree:.6f} "
              f"max_abs_err(valid rays)={err1:.3e} mm", flush=True)
        if agree < 0.999 or err1 > 1e-3:
            fail("K1 po_forward disagrees with its plain version")
        ms = median_ms(lambda: pk.po_forward(*a1))
        plain_ms = median_ms(
            lambda: plain_chunked(pk.po_forward_plain, a1, 5))
        records.append(dict(
            name="po_forward", route="cuda",
            source="pota_tpu_torch/csrc/po_forward.cu",
            replaces="pota_tpu/ops/po_pallas.py:83", max_abs_err=err1,
            ms=ms, plain_ms=plain_ms, n=int(a1[1].shape[0]),
            mask_agree=agree))

        # K2: expand, S slots
        a2 = rec.args["expand"]
        got = pk.expand(*a2)
        ref = pk.expand_plain(*a2)
        err2 = max(float((got[0] - ref[0]).abs().max()),
                   float((got[1] - ref[1]).abs().max()))
        print(f"K2 expand S={a2[0].shape[0]} max_abs_err={err2}", flush=True)
        if err2 != 0:
            fail("K2 expand disagrees with its plain version")
        records.append(dict(
            name="expand", route="cuda",
            source="pota_tpu_torch/csrc/expand.cu",
            replaces="pota_tpu/ops/po_pallas.py:877", max_abs_err=err2,
            ms=median_ms(lambda: pk.expand(*a2)),
            plain_ms=median_ms(lambda: pk.expand_plain(*a2)),
            n=int(a2[0].shape[0])))

        # K3: PO splat, S slots
        a3 = rec.args["po_splat"]
        s = a3[1].shape[0]
        lin_g, ok_g = pk.po_splat(*a3)
        lin_p, ok_p = plain_chunked(pk.po_splat_plain, a3, 9)
        ok_agree = float((ok_g == ok_p).double().mean())
        both = ok_g & ok_p
        lin_agree = float((lin_g[both] == lin_p[both]).double().mean())
        err3 = float((lin_g[both] - lin_p[both]).abs().max())
        print(f"K3 po_splat S={s} ok agree={ok_agree:.6f} lin agree="
              f"{lin_agree:.6f} max_abs_err(lin)={err3} (ok rate "
              f"{float(ok_g.double().mean()):.4f})", flush=True)
        if ok_agree < 0.999 or lin_agree < 0.999:
            fail("K3 po_splat disagrees with its plain version")
        records.append(dict(
            name="po_splat", route="cuda",
            source="pota_tpu_torch/csrc/po_splat.cu",
            replaces="pota_tpu/ops/po_pallas.py:697", max_abs_err=err3,
            ms=median_ms(lambda: pk.po_splat(*a3)),
            plain_ms=median_ms(
                lambda: plain_chunked(pk.po_splat_plain, a3, 9)),
            n=int(s), ok_agree=ok_agree, lin_agree=lin_agree))
        del lin_g, ok_g, lin_p, ok_p, both

        # K4: segment accumulate, W writers
        a4 = rec.args["segment_accum"]
        got = splat_accum.segment_accum(*a4)
        ref = splat_accum.segment_accum_plain(*a4)
        scale = max(float(ref[0].abs().max()), 1.0)
        err4 = float((got[0] - ref[0]).abs().max())
        same_win = (torch.equal(got[3], ref[3])
                    and torch.equal(got[1][got[3]], ref[1][ref[3]])
                    and torch.equal(got[2][got[3]], ref[2][ref[3]]))
        print(f"K4 segment_accum W={a4[0].shape[0]} max_abs_err={err4:.3e} "
              f"(scale {scale:.3e}) winners identical={same_win}", flush=True)
        if err4 > 1e-4 * scale or not same_win:
            fail("K4 segment_accum disagrees with its plain version")
        records.append(dict(
            name="segment_accum", route="cuda",
            source="pota_tpu_torch/csrc/segment_accum.cu",
            replaces="pota_tpu/ops/splat_accum.py:59", max_abs_err=err4,
            ms=median_ms(lambda: splat_accum.segment_accum(*a4)),
            plain_ms=median_ms(lambda: splat_accum.segment_accum_plain(*a4)),
            n=int(a4[0].shape[0])))
    for r in records:
        print(f"{r['name']}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms {tag}", flush=True)
    del rec, a1, a2, a3, a4
    torch.cuda.empty_cache()

    phase("slice parity 256x256 @ 1 spp: kernels vs plain versions")
    rc_small = pt.RenderConfig(xres=256, yres=256, spp=1)
    with torch.no_grad():
        img_k, fb_k = render_frame(cfg, rc_small, scene, m, seed=0,
                                   po_lens=lens, po_state=state)
        img_p, fb_p = render_frame(cfg, rc_small, scene, m, seed=0,
                                   po_lens=lens, po_state=state,
                                   ops=ops.PLAIN)
    aov_k, aov_p = resolve_aovs(rc_small, fb_k), resolve_aovs(rc_small, fb_p)
    for k in aov_p:
        off = frac_pixels_off(aov_k[k], aov_p[k])
        print(f"  {k}: pixels off {off:.5f}", flush=True)
        if not bool(torch.isfinite(aov_k[k]).all()) or off > MAX_PIXELS_OFF:
            fail(f"256x256 parity: plane {k}")
    for k in ("RGBA", "filter_weight"):
        e_k, e_p = float(fb_k[k].double().sum()), float(fb_p[k].double().sum())
        print(f"  energy {k}: kernels {e_k:.6f} plain {e_p:.6f}", flush=True)
        if abs(e_k - e_p) > 2e-3 * abs(e_p):
            fail(f"256x256 parity: energy {k}")
    del img_k, fb_k, img_p, fb_p, aov_k, aov_p

    phase("flagship 1920x1080 @ 1 spp (BASELINE config 4)")
    with torch.no_grad():
        ops.reset_launches()
        img, fb = render_frame(cfg, rc_full, scene, m, seed=0, po_lens=lens,
                               po_state=state)
        aovs = resolve_aovs(rc_full, fb)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        print(f"launches in the flagship run: {launches}", flush=True)
        missing = [k for k, v in launches.items() if v < 1]
        if missing:
            fail(f"kernels not launched on the main path: {missing}")
        for k, v in aovs.items():
            if not bool(torch.isfinite(v).all()):
                fail(f"flagship plane {k} is not finite")
        npix = rc_full.xres * rc_full.yres
        w_sum = float(fb["filter_weight"].double().sum())
        print(f"sum(filter_weight) {w_sum:.4f} vs {npix}", flush=True)
        if abs(w_sum - npix) > ENERGY_TOL * npix:
            fail("energy conservation: sum(filter_weight) != npix")

        def e2e():
            _, fb_ = render_frame(cfg, rc_full, scene, m, seed=0,
                                  po_lens=lens, po_state=state)
            resolve_aovs(rc_full, fb_)

        stream = render_sample_stream(cfg, rc_full, scene, m, 0,
                                      po_lens=lens, po_state=state)

        def splat_resolve():
            fb_ = splat_frame(cfg, rc_full, scene, stream, m, po_lens=lens,
                              po_state=state, with_diagnostics=True)
            resolve_aovs(rc_full, fb_)
            return fb_

        fb_d = splat_resolve()
        n_valid = int(fb_d["_n_valid_splats"])
        n_issued = int(fb_d["_n_issued_slots"])
        del fb_d
        if n_valid <= 0:
            fail("no valid splats")
        frame_ms = host_ms(e2e)
        forward_ms = host_ms(lambda: render_sample_stream(
            cfg, rc_full, scene, m, 0, po_lens=lens, po_state=state))
        splat_ms = host_ms(splat_resolve)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for label, val in (("frame_ms", frame_ms), ("forward_ms", forward_ms),
                       ("splat_resolve_ms", splat_ms),
                       ("issued_slots", n_issued), ("valid_splats", n_valid),
                       ("valid_splats_per_s", n_valid / (splat_ms * 1e-3)),
                       ("peak_device_gb", peak_gb)):
        print(f"{label} {val} {tag}", flush=True)

    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
