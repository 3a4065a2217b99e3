"""Time the layouts of K4's payload gather and the designs of K5 side by side,
each rebuilt from the kept source with one part rewritten.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/time_kernel_variants.py [--rounds 4] [--reps 20]

K4 (``csrc/segment_accum.cu``, its step 2 between the markers ``// 2.``
and ``// 3.``, and ``kAccRows``): how many rows a thread takes
(``rows<r>``: r rows, tiles of 256 r), and how its rows' payload loads are
issued against their use (``seq``: each row's loads behind its head
branch; ``inflight<h>``: the loads of h rows issued before the first is
used; ``lb3``: with ``__launch_bounds__(256, 3)``).  ``kept`` is the
library the render path launches.  Timed on the flagship's captured
stream and on ``chip_smoke.writer_stream``'s uniform and piled-up streams.

K5 (``csrc/tl_splat.cu``): the first port's choices put back one at a time,
on config 1's captured slots.  ``d0`` IEEE division and sine, the probe on
every slot, the full probe (``common.cuh::occluded_spheres``), 8 blocks an
SM; ``d1`` the grid in whole waves; ``d2`` the probe only in bounds and off
sky; ``d3`` the lean probe; ``d4`` approximate division and sine (the kept
source).  ``d4 after plain`` is d4 timed over 5 runs just after its plain
version ran, as the kernel record of chip_smoke.py once timed it.

Every variant is built by nvcc into its own library under
``pota_tpu_torch/build/variants`` (all at once), reports its registers and
spills, and is held to the plain version first (K4: sums within 1e-4 of
scale, winners identical, two runs identical; K5: ``ok`` and ``lin`` agree
on >= 99.9% of slots).  Times: ``rounds`` rounds, the variants in turn, in
reverse order every other round; a round's time is the median of ``reps``
CUDA-event runs after a warm-up.  A variant's line gives the median over
the rounds and the lowest and highest round.  The last line of stdout is
one JSON object of every number printed.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

OUT = os.path.join(ROOT, "pota_tpu_torch", "build", "variants")

# ---------------------------------------------------------------- K4
HEAD = '''if (heads >> j & 1u) {
  if (j > first_head) {
    const int p = s_pix[r];
#pragma unroll
    for (int k = 0; k < kColBlock; ++k)
      if (k < nc) accum[(size_t)p * K + c0 + k] = run[k];
  } else {
#pragma unroll
    for (int k = 0; k < kColBlock; ++k) head_sum[k] = run[k];
  }
#pragma unroll
  for (int k = 0; k < kColBlock; ++k) run[k] = 0.0f;
}
'''
SUMS = '''float run[kColBlock], head_sum[kColBlock];
#pragma unroll
for (int k = 0; k < kColBlock; ++k) run[k] = head_sum[k] = 0.0f;
'''


def k4_seq() -> str:
    """Each row's loads behind its head branch, summed as they arrive."""
    return SUMS + '''#pragma unroll
for (int j = 0; j < kAccRows; ++j) {
  const int r = r0 + j;
''' + HEAD + '''  if (live >> j & 1u) {
    const float* row = payload + (size_t)s_row[r] * K + c0;
#pragma unroll
    for (int k = 0; k < kColBlock; ++k)
      if (k < nc) run[k] += row[k];
  }
}
'''


def k4_inflight(h: int) -> str:
    """The loads of h rows issued before the first of them is used."""
    return SUMS + f'''#pragma unroll
for (int h0 = 0; h0 < kAccRows; h0 += {h}) {{
  float x[{h}][kColBlock];
#pragma unroll
  for (int jj = 0; jj < {h}; ++jj) {{
    const int j = h0 + jj;
    const float* row = payload + (size_t)s_row[r0 + j] * K + c0;
#pragma unroll
    for (int k = 0; k < kColBlock; ++k)
      x[jj][k] = (live >> j & 1u) && k < nc ? row[k] : 0.0f;
  }}
#pragma unroll
  for (int jj = 0; jj < {h}; ++jj) {{
    const int j = h0 + jj;
    const int r = r0 + j;
''' + HEAD + '''    if (live >> j & 1u) {
#pragma unroll
      for (int k = 0; k < kColBlock; ++k) run[k] += x[jj][k];
    }
  }
}
'''


def k4_variants(src: str) -> dict:
    """{name: (source, rows a thread)} from the kept source ``src``."""
    a = src.index("    // 2. ")
    a = src.index("\n", a) + 1
    b = src.index("    // 3. ")

    def with_step2(body, rows, bounds=""):
        out, n = re.subn(r"constexpr int kAccRows = \d+;",
                         f"constexpr int kAccRows = {rows};",
                         src[:a] + body + src[b:])
        if n != 1:
            raise SystemExit("FAIL: no kAccRows in the kept source")
        if bounds:
            out = must_sub(out, "__launch_bounds__(kAccThreads)\n"
                           "segment_tile_kernel",
                           f"__launch_bounds__(kAccThreads, {bounds})\n"
                           "segment_tile_kernel")
        return out, rows

    return {
        "rows8_seq": with_step2(k4_seq(), 8),
        "rows8_inflight2": with_step2(k4_inflight(2), 8),
        "rows8_inflight4": with_step2(k4_inflight(4), 8),
        "rows8_inflight8": with_step2(k4_inflight(8), 8),
        "rows8_inflight8_lb3": with_step2(k4_inflight(8), 8, bounds="3"),
        "rows4_seq": with_step2(k4_seq(), 4),
        "rows4_inflight4": with_step2(k4_inflight(4), 4),
    }


# ---------------------------------------------------------------- K5
def must_sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"FAIL: {old!r} is not in the kept source")
    return src.replace(old, new)


def ieee(src):
    src = must_sub(src, "namespace pota {\n", "namespace pota {\n"
                   "__device__ __forceinline__ float ieee_div(float a, "
                   "float b) { return a / b; }\n")
    for old, new in (("__fdividef(", "ieee_div("), ("__sincosf(", "sincosf("),
                     ("__expf(", "expf(")):
        src = must_sub(src, old, new)
    return src


def full_probe(src):
    return must_sub(src, "occ = occluded_spheres_lean(pwx[i]",
                    "occ = occluded_spheres(pwx[i]")


def every_slot(src):
    src = must_sub(src, "const bool probe = in_bounds && sky[i] < 0.5f;",
                   "const bool probe = true;")
    return must_sub(src, "ok_out[i] = in_bounds && !occ;",
                    "ok_out[i] = in_bounds && !(occ && sky[i] < 0.5f);")


def fixed_grid(src):
    return must_sub(src, "const int per_sm = pota_tl_splat_blocks_per_sm("
                    "n_spheres);", "const int per_sm = 8;")


def k5_variants(src: str) -> dict:
    d3 = ieee(src)
    d2 = full_probe(d3)
    d1 = every_slot(d2)
    return {"d0": fixed_grid(d1), "d1": d1, "d2": d2, "d3": d3, "d4": src}


# ---------------------------------------------------------------- build
def build(jobs: dict) -> dict:
    """{name: source} -> {name: (ctypes library, {entry: registers, spill
    bytes})}, every nvcc at once."""
    from pota_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    nvcc, procs = _build._nvcc(), {}
    for name, src in jobs.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-shared",
             "-o", os.path.join(OUT, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, p in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"FAIL: nvcc {name}\n{out}\n{err}")
        regs, entry = {}, None
        for ln in (out + err).splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill", ln)
            if m and entry:
                regs.setdefault(entry, {})["spill_bytes"] = (
                    int(m.group(1)) + int(m.group(2)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and entry:
                regs.setdefault(entry, {})["registers"] = int(m.group(1))
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        for fn, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, regs)
    return libs


def entry_info(regs: dict, key: str) -> dict:
    found = [v for k, v in regs.items() if key in k]
    if len(found) != 1:
        raise SystemExit(f"FAIL: no ptxas report for {key}")
    return found[0]


def k4_call(lib, rows: int):
    """``segment_accum`` through a variant's library, its carry buffers
    sized for tiles of 256 x ``rows`` rows."""
    import torch

    def seg(keys, perm, payload, sid, npix):
        dev, w, k = keys.device, keys.shape[0], payload.shape[1]
        accum = torch.zeros((npix, k), dtype=torch.float32, device=dev)
        wd = torch.zeros((npix,), dtype=torch.float32, device=dev)
        ws = torch.zeros((npix,), dtype=torch.int32, device=dev)
        hs = torch.zeros((npix,), dtype=torch.bool, device=dev)
        nt = -(-w // (256 * rows))
        lead = torch.empty((nt, k), dtype=torch.float32, device=dev)
        trail = torch.empty((nt, k), dtype=torch.float32, device=dev)
        tail = torch.empty((nt,), dtype=torch.int32, device=dev)
        err = lib.pota_segment_accum(
            keys.data_ptr(), perm.data_ptr(), w, payload.data_ptr(), k,
            sid.data_ptr(), npix, accum.data_ptr(), wd.data_ptr(),
            ws.data_ptr(), hs.data_ptr(), lead.data_ptr(), trail.data_ptr(),
            tail.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"FAIL: segment_accum variant: cudaError {err}")
        return accum, wd, ws, hs
    return seg


def k5_call(lib):
    """``tl_splat`` through a variant's library."""
    import math

    import torch

    def splat(pcx, pcy, pcz, pwx, pwy, pwz, seed, ctr, sky, params, spheres,
              abb=0.5, c2s=0.01):
        s, dev = pcx.shape[0], pcx.device
        bias = abb != 0.5
        expo = math.log(abb) / math.log(0.5) if bias else 1.0
        lin = torch.empty((s,), dtype=torch.int32, device=dev)
        ok = torch.empty((s,), dtype=torch.bool, device=dev)
        err = lib.pota_tl_splat(
            pcx.data_ptr(), pcy.data_ptr(), pcz.data_ptr(), pwx.data_ptr(),
            pwy.data_ptr(), pwz.data_ptr(), seed.data_ptr(), ctr.data_ptr(),
            sky.data_ptr(), s, int(bias), float(expo), float(c2s),
            params.data_ptr(), spheres.data_ptr(), spheres.shape[0],
            lin.data_ptr(), ok.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"FAIL: tl_splat variant: cudaError {err}")
        return lin, ok
    return splat


def rounds_ms(fns: dict, rounds: int, reps: int) -> dict:
    """{name: [round times]}: every fn in turn, reversed every other
    round."""
    times = {name: [] for name in fns}
    names = list(fns)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(cs.median_ms(fns[name], reps))
    return times


def summary(ts: list) -> dict:
    return dict(ms=statistics.median(ts), lo=min(ts), hi=max(ts), rounds=ts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    import pota_tpu_torch as pt
    from pota_tpu_torch import ops
    from pota_tpu_torch.ops import po_kernels as pk, splat_accum as sa
    from pota_tpu_torch.optics.fit import load_poly_lens
    from pota_tpu_torch.optics.focus import setup_po_camera
    from pota_tpu_torch.render import scene as sc
    from pota_tpu_torch.render.renderer import look_at, render_frame

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    with open(os.path.join(ROOT, "pota_tpu_torch/csrc/segment_accum.cu")) as f:
        v4 = k4_variants(f.read())
    with open(os.path.join(ROOT, "pota_tpu_torch/csrc/tl_splat.cu")) as f:
        v5 = k5_variants(f.read())
    libs = build({**{f"k4_{n}": s for n, (s, _) in v4.items()},
                  **{f"k5_{n}": s for n, s in v5.items()}})
    res = dict(card=card, k4={}, k5={})

    def capture(cfg, rc, scene, **kw):
        rec = cs.Recorder(ops.KERNELS)
        with torch.no_grad():
            render_frame(cfg, rc, scene, look_at([0, 0, 0], [0, 0, -1],
                                                 device=dev),
                         seed=0, ops=rec, **kw)
        torch.cuda.synchronize()
        return rec.args

    with torch.no_grad():
        # K5 on config 1's slots
        cfg1 = pt.CameraConfig(focal_length=50.0, fstop=1.4,
                               focus_distance=150.0, vignetting_retries=3,
                               splat_queue_mult=8)
        a5 = capture(cfg1, pt.RenderConfig(xres=256, yres=256, spp=16),
                     sc.teapot_scene(device=dev))["tl_splat"]
        n5, n_sph = int(a5[0].shape[0]), int(a5[10].shape[0])
        lin_p, ok_p = cs.plain_chunked(pk.tl_splat_plain, a5, slice(0, 9))
        fns = {}
        for name in v5:
            lib, regs = libs[f"k5_{name}"]
            fn = k5_call(lib)
            lin_g, ok_g = fn(*a5)
            both = ok_g & ok_p
            rec = dict(ok_agree=float((ok_g == ok_p).double().mean()),
                       lin_agree=float((lin_g[both] == lin_p[both])
                                       .double().mean()),
                       blocks_per_sm=lib.pota_tl_splat_blocks_per_sm(n_sph),
                       **entry_info(regs, "tl_splat_kernel"))
            if min(rec["ok_agree"], rec["lin_agree"]) < cs.MASK_AGREE:
                raise SystemExit(f"FAIL: K5 {name} disagrees with the plain "
                                 "version")
            res["k5"][name] = rec
            fns[name] = (lambda f: lambda: f(*a5))(fn)
        del lin_p, ok_p, lin_g, ok_g, both
        for name, ts in rounds_ms(fns, args.rounds, args.reps).items():
            res["k5"][name].update(summary(ts))
        after = []
        for _ in range(args.rounds):
            cs.plain_chunked(pk.tl_splat_plain, a5, slice(0, 9))
            after.append(cs.median_ms(fns["d4"], 5))
        res["k5"]["d4 after plain"] = summary(after)
        for name, r in res["k5"].items():
            print(f"K5 {name} S={n5}: {r['ms']:.4f} ms (rounds "
                  f"{r['lo']:.4f}-{r['hi']:.4f})"
                  + (f", {r['registers']} registers, {r['spill_bytes']} "
                     f"spill bytes, {r['blocks_per_sm']} blocks an SM, ok "
                     f"agree {r['ok_agree']:.7f}, lin agree "
                     f"{r['lin_agree']:.7f}" if "registers" in r else "")
                  + f" ({card})", flush=True)
        del a5
        torch.cuda.empty_cache()

        # K4 on the flagship's stream and the two seeded streams
        lens = load_poly_lens(cs.FLAGSHIP, device=dev)
        cfg = pt.CameraConfig(
            camera_type=pt.CameraType.POLYNOMIAL_OPTICS,
            lens_model=cs.FLAGSHIP, fstop=2.8, focus_distance=20.0,
            vignetting_retries=3, splat_queue_mult=8)
        a4 = capture(cfg, pt.RenderConfig(xres=1920, yres=1080, spp=1),
                     sc.lightgrid_scene(n=5, spacing=12.0, z=-150.0,
                                        radius=0.8, intensity=40.0,
                                        device=dev),
                     po_lens=lens, po_state=setup_po_camera(lens, cfg))[
                         "segment_accum"]
        w, k, npix = a4[0].shape[0], a4[2].shape[1], a4[4]
        streams = {"flagship": a4}
        for label, hot in (("uniform", 0), ("piled", 64)):
            streams[label] = cs.writer_stream(w, k, npix, hot, dev)
        for sname, a in streams.items():
            fns = {"kept": lambda a=a: sa.segment_accum(*a)}
            for name, (_, rows) in v4.items():
                lib, regs = libs[f"k4_{name}"]
                fn = k4_call(lib, rows)
                cs.check_accum(f"{sname} {name}", fn, sa.segment_accum_plain,
                               a)
                res["k4"].setdefault(name, dict(
                    rows=rows, **entry_info(regs, "segment_tile_kernel")))
                fns[name] = (lambda f: lambda: f(*a))(fn)
            for name, ts in rounds_ms(fns, args.rounds, args.reps).items():
                res["k4"].setdefault(name, {})[sname] = summary(ts)
                r = res["k4"][name]
                print(f"K4 {name} {sname} W={w}: {r[sname]['ms']:.4f} ms "
                      f"(rounds {r[sname]['lo']:.4f}-{r[sname]['hi']:.4f})"
                      + (f", {r['registers']} registers, {r['spill_bytes']} "
                         f"spill bytes" if "registers" in r else "")
                      + f" ({card})", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
