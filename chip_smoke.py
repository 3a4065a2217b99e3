"""Chip smoke test of the PyTorch / CUDA port (pota_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. device    needs CUDA; prints the card's name and power limit
  2. build     compiles the kernels from pota_tpu_torch/csrc (nvcc, one
               process per source) and prints each entry's registers/spills
  3. kernels   captures each kernel's arguments from a full-width frame of
               its own path (K1-K4 the flagship, K5 config 1, K3b's
               per-slot-wavelength instantiation config 3 with image bokeh
               off, K3b's external-aperture instantiation config 3, K6 the
               flagship with camera motion blur), then runs kernel and
               plain PyTorch version on those inputs, asserts the
               tolerances and times both (CUDA events, median after a
               warm-up; the plain K1, K3 and K6 three times, everything
               else five); K6 also on three tables (config 3's chroma
               wavelengths, ``lam_idx = slot % 3``); K3b also on one table
               and in the thread order of the other design
               (:func:`k3b_designs`); K4 also on config 1's and configs
               3's streams and on two seeded 1080p streams, uniform and
               piled up (:func:`writer_stream`), each run twice and held
               to identical bits; K5 with its occupancy and compiled
               instruction mix (:func:`k5_profile`); K4 and K5 timed over
               50 runs, with the spread (:func:`timed_ms`); K1, K2, K3 and
               K4 again on the arguments of config 5's 4K differentiable
               step (records with ``path: "config5"``; K1 on the trace's
               first chunk; the plain K3 on the queue's first
               :data:`CONFIG5_PLAIN_SLOTS` slots), K1v (K1's VJP) on every
               chunk's arguments of that step, held to its plain version
               in float32 and on the first :data:`PLAIN_VJP_F64` candidates
               in float64 (:data:`VJP_TOL`), two runs to identical bits,
               its live candidates, its time through the wrapper and its
               kernels' device time (:func:`device_ms`), its registers and
               blocks an SM (:func:`forward_vjp_record`), and the VJPs of
               K2 and K4
               there (``ExpandFn``, ``AccumFn``) against float64 oracles
               (:func:`config5_vjp_checks`)
  4. parity    renders small frames twice, through the kernels and through
               the plain versions on CUDA tensors, and compares: the
               flagship at 256x256 @ 1 spp, config 1 at 64x64 @ 4 spp,
               config 3 at 128x128 @ 2 spp, config 3 with image bokeh off
               at 128x128 @ 2 spp, the motion-blurred flagship at
               256x256 @ 1 spp with an extra gaussian AOV, config 3 with
               image bokeh off and motion blur (K6 on three tables) at
               128x128 @ 2 spp, and the two
               thin-lens golden configurations (tests/golden_configs.py:
               83-100) at 128x128 @ 4 spp
  5. flagship  the full 1920x1080 @ 1 spp bidirectional render (BASELINE
               config 4): launch counts, finite planes, valid splats, energy
  6. flagship_mb  the same frame with the camera trucked 2 units across the
               shutter (motion blur: JAX's decomposed branch, with K6)
  7. configs   BASELINE config 1 (thin-lens teapot, 256x256 @ 16 spp),
               config 3 with image bokeh off (its chromatic PO path) and
               config 3 (chromatic image-bokeh lightgrid, 512x512 @ 2 spp):
               launch counts, finite planes, energy, frame ms, AA samples/s
  8. config5   BASELINE config 5 (bench.py:249-297), the differentiable
               4K step: ``render_frame(differentiable=True)`` of the
               teapot at 3840x2160 @ 1 spp (``splat_queue_mult`` 4,
               ``trace_chunks`` 32, 3 candidates a ray), loss
               ``mean(img[..., :3])``, ``loss.backward()`` to the flagship
               fit's ``pt`` and ``ap`` coefficients; launch counts (K2, K3,
               K4 once each; the trace through ``SelectFn`` (K1 and K1v in
               their select modes), K1 twice and
               K1v once in each of its 32 checkpointed chunks:
               :func:`want_launches`), one warm-up and three timed steps
               (``config5_step_s``, the median), peak memory, the
               gradient's norm; then three gradient-descent steps of JAX's
               ``train_step_sharded`` L2 loss (one device) from seeded
               1e-3 perturbed coefficients toward the frame of the fit's
               own, each :data:`DESCENT_STEP` of the coefficients' norm,
               printing the first-order prediction beside the measured
               change of the loss and of the loss with the budgets and K3's
               decisions held (no decrease is asserted:
               tests/test_torch_descent.py), the first frame after each
               step folding K3's table again.  There is no 1080p
               fallback: an out-of-memory error fails the run.  Its
               parity frame (phase 4, 256x144 @ 1 spp, ``trace_chunks``
               4) holds the image and the ``pt`` gradient through the
               kernels to the plain versions' (:data:`CONFIG5_GRAD_TOL`)
               and splits the gradient's difference between K1, K1v and
               K3 by mixed kernel sets (printed, not asserted)
  9. flagship_idmatte  BASELINE config 4's camera on ``teapot_scene()``
               with thin glass of grey 0.5 on its spheres 0 and 1
               (:func:`glass_teapot`, the PO state set up on that scene),
               1920x1080 @ 1 spp, ``enable_id_matte=True``: K1-K4 launched
               once each; the frame ms, the id-matte stage's ms (its
               records, two sorts and scatters: ``crypto_topk`` of
               ``id_matte_records``, CUDA events), ``resolve_crypto``'s
               ms, the frame without the id-matte, the peak memory; the
               ranked planes held to a float64 oracle of the same records
               (:func:`crypto_oracle`, :func:`check_id_matte`) and every
               coverage of the resolved layers <= 1 + 1e-5.  Its parity
               frame (phase 4: 256x256 @ 1 spp) compares the id-matte
               planes too
 10. config2   BASELINE config 2 (bench.py:86-114, ``cfg_fw`` of
               bench.py:335-338): ``trace_camera_rays`` of a 1920x1080 @ 1
               spp frame (flagship lens, fstop 2.8, focus 150, 4 candidates
               a ray: K1 on M = 8,294,400), ``po_forward_rays_per_s_1080p``
 11. cli       ``python -m pota_tpu_torch.cli`` on the card (``cli.main``):
               PO lens, 1024x1024 @ 1 spp, ``--aovs --id-matte --glare 0.5
               --aperture-blades 6`` into a temporary EXR, read back: every
               channel finite, ``crypto00..02`` present
 12. fit_catalog  refits the 45 catalog lenses on the card with JAX's
               defaults (degree 5, 200,000 samples, 160 terms, seed 0; one
               lens per base design first, the rest while the fits stay
               under :data:`FIT_BUDGET_S`), holds each to
               tests/test_fit_fidelity.py's thresholds on 20,000 fresh
               held-out rays (seed 987) against the port's own tracer,
               prints seconds, valid fraction, terms, the terms shared
               with the committed fit and the design's singular values;
               folds the fresh flagship fit and renders the 1080p flagship
               frame with it (K1-K4 once each); runs the command line with
               ``--lens double_gauss`` (no committed fit: fitted, cached
               under ``pota_tpu_torch/build/lens_fits/``) and checks that
               ``data/lenses/`` did not change
 13. derivs    ``trace_camera_rays_with_derivs`` at 1920x1080 @ 1 spp with
               config 2's PO camera (K1 for the primary rays and K1j once
               for both axes) and config 1's thin lens: finite
               differentials on live rays, held on 65,536 seeded live rays
               to float64 central differences of the deriv ray's term
               trace (:func:`deriv_check`); ms and peak memory; K1j on the
               frame's arguments against K1 (identical primal) and its
               plain version (:func:`k1j_record`), and the PO
               differentials once by the term trace's ``torch.func.jvp``
               (the route before K1j), its ms and peak memory beside
 14. replay    the flagship's 1080p stream saved (``save_capture``), read
               back onto the card and replayed with the scene (K2, K3, K4
               once each, K1 never; against the live frame) and without
               one (the decomposed route: K2, K6, K4, K3 never); write,
               read and replay ms
 15. sharded   (right after config5) a world-size-1 NCCL group
               (:func:`sharded_phase`): ``render_frame_sharded`` of the
               1080p flagship (K1-K4 once each, K5 and K6 never) and of
               config 1 (K2, K5, K4 once each), every plane and the image
               bit-identical to ``render_frame``'s, frame ms of both; the
               flagship's merge traffic at 4 and 8 ranks
               (``merge_traffic_bytes``, reduce-scatter against halo);
               config 5's 4K step through ``train_step_sharded`` from the
               descent's c1 against c1's single-process step
               (:data:`SHARDED_STEP_TOL`), its seconds and peak memory
 16. grad routes  the three differentiable routes ``check_supported``
               once refused (:func:`grad_routes_phase`), each a counted
               step (its kernels once each), energy, finite planes and
               gradients, a warm-up and three timed steps, peak memory
               and a parity frame (image and every gradient through the
               kernels against the plain versions): ``grad_mb_1080p``
               (camera motion blur: K2, K6, K4), ``grad_aovs_1080p`` (a
               gaussian transmission plane beside RGBA: K2, K3, K4, K4 over
               nine payload columns), ``grad_config1`` (BASELINE config
               1's thin lens: K2, K5, K4) and ``grad_config1_coma`` (coma
               0.5: K2, K4); the PO routes' traces through ``SelectFn``
               (K1 twice and K1v once in each of 8 chunks); K2 on three of
               those steps' arguments, K3, K6, K4 and K5 again on them
               (records with ``path``)
Each kernel record carries ``bound_ms``, the least time the card could take
for the same work: the larger of the bytes the kernel must move (each input
read once, each output written once) over 3.35 TB/s and its f32 operations
over 67 TFLOP/s (an FMA is two; the integer TEA-8 draws are not counted),
counted from the kernel's code and this run's shapes (for the kernels on
the folded degree-5 basis the work they run: :func:`basis_forward_flops`
for K1, :func:`basis_solve_flops` for K3, K3b and K6; for K4 the bytes of
its live writers only, :func:`accum_bound`; for K1v the operations of the
candidates that carry a cotangent, :func:`basis_forward_vjp_flops`; for
K1j :func:`basis_forward_jvp_flops`).
K1's, K3's, K3b's and K6's records
add ``runtime_term_bound_ms`` (the same bound for the runtime-term code each
ran before, :func:`forward_flops` / :func:`solve_flops`, from the fit's
exponent table), their registers and spill bytes; K3's, K3b's
per-slot-wavelength record and K6's add how often they and their plain
versions disagree with a float64 solve of the same items
(:func:`f64_witness`).
``library_ms`` is the time of one PyTorch call computing the same function,
where one exists (K2: ``index_select`` over both tables), else null.
Every record carries the kernel's registers and spill bytes; K5's its
resident blocks an SM, its instructions a slot by kind and the time they
take to issue (``issue_ms``, beside ``bound_ms``).
The last two lines of stdout are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

FLAGSHIP = "angenieux__double_gauss__1953__49mm"
PLAIN_CHUNK = 1 << 20           # plain K1 / K3 run in 1M-item chunks
PIXEL_TOL, MAX_PIXELS_OFF = 2e-3, 0.02
ENERGY_TOL = 1e-4
MASK_AGREE = 0.999
TPU_KERNELS = "pota_tpu/ops/po_pallas.py"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# the kernels each path must launch, and those it must not
PATH_KERNELS = {
    "flagship": ("po_forward", "expand", "po_splat", "segment_accum"),
    "flagship_mb": ("po_forward", "expand", "po_backward", "segment_accum"),
    "config1": ("expand", "tl_splat", "segment_accum"),
    "config3_no_bokeh": ("po_forward", "expand", "po_splat_lam",
                         "segment_accum"),
    "config3": ("po_forward", "expand", "po_splat_ext", "segment_accum"),
    "config5": ("po_forward", "expand", "po_splat", "segment_accum",
                "po_forward_vjp"),
    "flagship_idmatte": ("po_forward", "expand", "po_splat", "segment_accum"),
    "config2": ("po_forward",),
    "flagship_fresh_fit": ("po_forward", "expand", "po_splat",
                           "segment_accum"),
    "derivs_po": ("po_forward", "po_forward_jvp"),
    "derivs_thin": (),
    "replay": ("expand", "po_splat", "segment_accum"),
    "replay_null": ("expand", "po_backward", "segment_accum"),
    "sharded_flagship": ("po_forward", "expand", "po_splat", "segment_accum"),
    "sharded_config1": ("expand", "tl_splat", "segment_accum"),
    "sharded_config5": ("po_forward", "expand", "po_splat", "segment_accum",
                        "po_forward_vjp"),
    "grad_mb_1080p": ("po_forward", "expand", "po_backward", "segment_accum",
                      "po_forward_vjp"),
    "grad_aovs_1080p": ("po_forward", "expand", "po_splat", "segment_accum",
                        "po_forward_vjp"),
    "grad_config1": ("expand", "tl_splat", "segment_accum"),
    "grad_config1_coma": ("expand", "segment_accum"),
}
# tests/test_fit_fidelity.py's gate: rms (position mm, slope, iris mm)
# ceilings of a fit on fresh held-out rays, by the lens's family
FIT_THRESH = (0.12, 0.005, 0.04)
FIT_THRESH_BY_FAMILY = {"fisheye": (0.15, 0.004, 0.02),
                        "retrofocus_wideangle": (0.10, 0.006, 0.04)}
FIT_HELDOUT_SEED, FIT_HELDOUT_RAYS = 987, 20_000
# past this many seconds of fitting, only one lens per base design is fitted
FIT_BUDGET_S = 120.0
# ray differentials against float64 central differences of the deriv-ray
# path (tests/test_derivs.py:57), on a seeded subset of live rays
DERIV_RTOL, DERIV_ATOL = 2e-2, 2e-4
DERIV_CHECK_RAYS = 65_536
DERIV_STEP = 1e-3                  # of a pixel, as tests/test_derivs.py
# a replayed capture against the live frame: relative energy
REPLAY_ENERGY_TOL = 2e-3
# the id-matte's ranked planes against their float64 oracle (relative)
CRYPTO_TOL = 1e-5
# config 5's plain K3 runs on the leading slots of its 33M-slot queue
CONFIG5_PLAIN_SLOTS = 1 << 22
# K1v against a float64 accumulation of its plain version on the leading
# candidates of config 5's step; the plain versions run in chunks of
PLAIN_VJP_F64 = 1 << 22
PLAIN_VJP_CHUNK = 1 << 20
# relative L2 of K1v's coefficient cotangents against its plain version
# (float32, and float64 on the leading candidates)
VJP_TOL = 1e-4
# f32 operations of K1v's select mode beyond K1v's walk, a live ray: the
# chart again (~50) and its VJP (three normalisations' VJPs, two cross
# products, the dot products and the guards: ~130)
CHART_VJP_FLOPS = 180.0
# relative L2 of K1j's Jacobian against its plain version on the rays both
# keep (its primal: K1's bits, and within 1e-5 of the plain version's)
JVP_TOL = 1e-4
# relative L2 of config 5's parity gradient of pt (kernels against the
# plain versions; measured 6.5e-5, ap 6.4e-5, on an NVIDIA H100 80GB HBM3:
# K3 alone among the plain versions gives the same, while K1's forward
# (no trans > 0 decision differs) and K1v move it by 4e-8 at most); the
# images are held by the parity frames' pixel limit
CONFIG5_GRAD_TOL = 1e-3
# config 5's descent step, of the coefficients' norm: the range where the
# loss with K3's decisions held follows the gradient on the CPU
# (tests/test_torch_descent.py: 1e-9 and 3e-9)
DESCENT_STEP = 1e-9
# the world-size-1 sharded 4K step against the single-process step
SHARDED_STEP_TOL = 1e-6


def trace_chunks_of(cfg, rc) -> int:
    """The checkpointed chunks of a differentiable frame's trace
    (``trace_chunk_count`` of the renderer, on the frame's samples)."""
    from pota_tpu_torch.render.renderer import trace_chunk_count

    return trace_chunk_count(cfg, rc.xres_region * rc.yres_region * rc.spp)


def want_launches(path: str, chunks: int = 1) -> dict:
    """The launches of one run of ``path``: each of its kernels once; on a
    differentiable PO path, whose trace runs in ``chunks`` checkpointed
    chunks, K1 twice a chunk (the forward and the backward's recompute;
    once without chunks) and K1v once a chunk."""
    want = {k: 1 for k in PATH_KERNELS[path]}
    if "po_forward_vjp" in want:
        want.update(po_forward=2 * chunks if chunks > 1 else 1,
                    po_forward_vjp=chunks)
    return want


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


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take for the work, and what sets it."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_b, t_f),
                bound_by="bytes" if t_b >= t_f else "operations")


def solve_flops(exps, iterations: int) -> float:
    """f32 operations of one PO backward solve on the runtime term list the
    kernels ran before the folded basis, for the exponent table ``exps``
    [T, 5]: per Newton iteration and term the
    powers and their derivatives, the monomial, four tangents and six
    output rows of five FMAs; about 400 for the chart, residual and 4x4
    solve; then the final three-row evaluation."""
    e = exps.to("cpu").numpy().astype(np.int64)
    per_term = (np.maximum(e[:, :4] - 1, 0).sum(1) + 8 + e[:, 4] + 18 + 60)
    final = e.sum(1) + 10
    return float(iterations * (per_term.sum() + 400) + final.sum())


def basis_solve_flops(iterations: int) -> float:
    """f32 operations of one backward solve on the folded table
    (``csrc/po_solve_basis.cuh``): per Newton iteration 2,436 FMAs over the
    126-monomial basis and its 70 Jacobian monomials, 125 multiplies for
    the monomials, 8 for the conditioning and about 400 for the chart,
    residual and 4x4 solve; then the final three-row evaluation (378 FMAs,
    125 multiplies, 8 for the conditioning)."""
    return float(iterations * (2 * 2436 + 125 + 8 + 400)
                 + 2 * 378 + 125 + 8)


def forward_flops(ap_exps, pt_exps, iterations: int) -> float:
    """f32 operations of one K1 ray on the runtime-term code K1 ran before
    the folded basis: per 2x2 Newton iteration and aperture term the
    powers, the monomial, two tangents and six FMAs; then the five-row pt
    evaluation."""
    a = ap_exps.to("cpu").numpy().astype(np.int64)
    p = pt_exps.to("cpu").numpy().astype(np.int64)
    return float(iterations * ((a.sum(1) + 24).sum() + 20)
                 + (p.sum(1) + 14).sum() + 30)


def basis_forward_flops(iterations: int) -> float:
    """f32 operations of one K1 ray on the folded table
    (``csrc/po_forward_basis.cuh``): conditioning x, y (4); the collapse of
    ap to its 21 (dx, dy) coefficients, 20 multiplies for x^a y^b and 252
    FMAs (524); the Newton's start (4); per iteration the conditioning (4),
    two Horner rows of 38 FMAs with both partials (152), the chain rule
    (4), the residual (2), the determinant (3) and the update (10); then
    the shift and conditioning (12), the 126 monomials (125 multiplies),
    pt's five rows (630 FMAs) and the clamp (1)."""
    return float(4 + 524 + 4 + iterations * 175 + 12 + 125 + 1260 + 1)


def basis_forward_vjp_flops(with_trans: bool) -> float:
    """f32 operations of one K1v candidate that carries a cotangent
    (``csrc/po_forward_vjp.cu``): the conditioning of u and u' (14); two
    walks of 125 monomial products with four tangents (6 each: 1500); at
    u' per monomial the weighted coefficient (a multiply, four FMAs) and
    the four tangent FMAs (17 x 126); at u ap's eight Jacobian FMAs (16 x
    126); the chain rule, the transposed 2x2 solve and the rays'
    cotangents (40); the staged powers (40); per monomial the two staged
    products (6) and the seven weighted sums (14: 20 x 126).  With a
    cotangent of trans, its raw value first: 125 multiplies and pt's five
    rows (1,260)."""
    return float(14 + 1500 + 17 * 126 + 16 * 126 + 40 + 40 + 20 * 126
                 + (125 + 1260 if with_trans else 0))


def basis_forward_jvp_flops(iterations: int) -> float:
    """f32 operations of one K1j ray (``csrc/po_forward_jvp.cu``): K1's
    trace (:func:`basis_forward_flops`); the conditioning of u (8); ap's
    D4 walk, 125 steps of a multiply and four tangents (6 each: 750) and
    eight Jacobian FMAs a monomial (16 x 126), the chain rule (8); D (2 x
    2 columns: 20 with the determinant); u' and its two tangents (24);
    pt's walk with two directional tangents, 125 steps of a multiply and
    two (multiply, FMA) pairs (7 each: 875) and eight FMAs a monomial (16
    x 126)."""
    return float(basis_forward_flops(iterations) + 8 + 750 + 16 * 126 + 8
                 + 20 + 24 + 875 + 16 * 126)


def device_ms(fn, names, reps: int = 3, tries: int = 3) -> dict:
    """Device time a call of ``fn`` of the kernels whose names hold each of
    ``names``, from a ``torch.profiler`` trace of ``reps`` calls (the
    trace's ``kernel`` events; None where it shows none).  A trace that
    shows none of a name's kernels is taken again, up to ``tries`` traces
    (the card's tracer now and then returns a trace without them)."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kernels = [(e["name"], float(e["dur"])) for e in events
                   if e.get("cat") == "kernel"]
        for n in names:
            durs = [d for k, d in kernels if n in k]
            if out.get(n) is None:
                out[n] = sum(durs) / 1e3 / reps if durs else None
        if None not in out.values():
            break
    return out


def accum_bound(args) -> dict:
    """K4's live writers, live segments (heads) and bound on ``args``: the
    key, permutation entry and payload row of each live writer, the sample
    id of each head, and every output once (each pixel's K sums, depth,
    sample id and has-winner byte, zeroed or written); one add per live
    writer and column."""
    keys, perm, payload, sid, npix = args
    pix = keys >> 32
    live = int((pix < npix).sum())
    heads = int(((pix[1:] != pix[:-1]) & (pix[1:] < npix)).sum()) + (
        1 if live else 0)
    k = payload.shape[1]
    return dict(live_writers=live, heads=heads, **bound(
        live * (16.0 + 4.0 * k) + 4.0 * heads + npix * (4.0 * k + 9.0),
        float(live * k)))


def row_gather_ms(args) -> float:
    """Time of ``payload.index_select(0, perm[:live])``: the live writers'
    payload rows gathered alone, in sorted order, as K4 gathers them (a
    yardstick of its random reads, not the same function)."""
    keys, perm, payload, _, npix = args
    rows = perm[:int(((keys >> 32) < npix).sum())].contiguous()
    return median_ms(lambda: payload.index_select(0, rows))


def writer_stream(w: int, k: int, npix: int, hot: int, device, seed: int = 7):
    """A seeded writer stream for K4 (``torch.Generator``), sorted as the
    splat sorts it: a quarter of the writers dead, and with ``hot`` > 0
    half of the live writers on ``hot`` pixels, the rest uniform over the
    frame; depths rounded to whole units, so that pixels hold ties."""
    import torch

    from pota_tpu_torch.ops.splat_accum import sort_writers

    g = torch.Generator(device=device).manual_seed(seed)
    pix = torch.randint(0, npix, (w,), generator=g, device=device)
    u = torch.rand(w, generator=g, device=device)
    if hot:
        hot_pix = torch.randint(0, npix, (hot,), generator=g, device=device)
        pick = torch.randint(0, hot, (w,), generator=g, device=device)
        pix = torch.where(u >= 0.625, pix, hot_pix[pick])
    pix = torch.where(u < 0.25, npix, pix)
    depth = torch.round(torch.rand(w, generator=g, device=device) * 100 + 1)
    payload = torch.randn(w, k, generator=g, device=device)
    sid = torch.randint(0, 1 << 30, (w,), generator=g, device=device,
                        dtype=torch.int32)
    keys, perm = sort_writers(pix, depth)
    del pix, u, depth
    return keys, perm, payload, sid, npix


def check_accum(label, kern, plain, args) -> float:
    """K4 against its plain version on ``args``: sums within 1e-4 of their
    scale, winners identical, two runs identical bit for bit.  Returns the
    largest sum error."""
    import torch

    got = kern(*args)
    again = kern(*args)
    ref = plain(*args)
    scale = max(float(ref[0].abs().max()), 1.0)
    err = float((got[0] - ref[0]).abs().max())
    same_win = (torch.equal(got[3], ref[3])
                and torch.equal(got[1][got[3]], ref[1][ref[3]])
                and torch.equal(got[2][got[3]], ref[2][ref[3]]))
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"K4 segment_accum ({label}) W={args[0].shape[0]} "
          f"K={args[2].shape[1]} max_abs_err={err:.3e} (scale {scale:.3e}) "
          f"winners identical={same_win} two runs identical={same_bits}",
          flush=True)
    if err > 1e-4 * scale or not same_win or not same_bits:
        fail(f"K4 segment_accum ({label}) disagrees with its plain version "
             "or with itself")
    return err


SASS_KINDS = {
    "MUFU": "mufu",
    **{op: "memory" for op in (
        "LDG", "STG", "LDS", "STS", "LDL", "STL", "LD", "ST", "LDC", "ATOM",
        "ATOMS", "ATOMG", "RED", "LDSM", "LDGSTS")},
    **{op: "fp32" for op in (
        "FADD", "FMUL", "FFMA", "FSETP", "FSET", "FMNMX", "FSEL", "FCHK",
        "FSWZADD")},
    **{op: "integer" for op in (
        "IADD3", "IMAD", "IMUL", "LOP3", "SHF", "LEA", "ISETP", "IABS",
        "IMNMX", "PRMT", "POPC", "FLO", "BREV", "SGXT", "BMSK", "IADD",
        "SHL", "SHR", "LOP", "IDP", "VIADD", "VIMNMX")},
    **{op: "conversion" for op in ("I2F", "F2I", "F2F", "I2I", "F2FP",
                                   "I2FP", "F2IP", "FRND")},
    **{op: "control" for op in (
        "BRA", "EXIT", "BSSY", "BSYNC", "CALL", "RET", "BAR", "WARPSYNC",
        "NOP", "YIELD", "JMP", "BRX", "BPT", "BREAK")},
}


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` text -> {mangled name: [(address, opcode, branch
    target or None, opcode with its modifiers, predicated)]}."""
    import re

    funcs, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)\s*([^;]*);", ln)
        if m and cur is not None:
            op = m.group(3).split(".")[0]
            tgt = re.search(r"0x([0-9a-f]+)", m.group(4)) if op in (
                "BRA", "JMP") else None
            pred = m.group(2) is not None and "PT" not in m.group(2)
            cur.append((int(m.group(1), 16), op,
                        int(tgt.group(1), 16) if tgt else None, m.group(3),
                        pred))
    return funcs


def sass_kind(op: str) -> str:
    base = op[1:] if op.startswith("U") and op[1:] in SASS_KINDS else op
    return SASS_KINDS.get(base, "other")


def sass_loops(instrs) -> list:
    """The loops of a function: (head address, back-edge address) of each
    backward branch, outermost (longest) first."""
    loops = [(x[2], x[0]) for x in instrs if x[2] is not None and x[2] <= x[0]]
    return sorted(loops, key=lambda lp: lp[0] - lp[1])


def shared_bytes(instrs) -> int:
    """Bytes the shared-memory loads of ``instrs`` read (LDS 4, .64 8,
    .128 16)."""
    return sum(16 if ".128" in x[3] else 8 if ".64" in x[3] else 4
               for x in instrs if x[1] == "LDS")


def path_mix(instrs, lo: int, hi: int, loops: dict, force: bool) -> dict:
    """The instructions, by kind, on the cheapest path from address ``lo``
    to the one after ``hi``: straight-line code and forward branches (a
    predicated branch may fall through; a CALL, which goes to a slow path,
    costs 1,000), each loop of ``loops`` {head: (back edge, passes, kinds
    of one pass)} taken whole where the path meets its head, and with
    ``force`` every such loop the path can reach taken."""
    step = 16
    end = hi + step
    at = {x[0]: x for x in instrs if lo <= x[0] <= hi}
    best = {lo: (0.0, {})}

    def relax(to, cost, mix):
        if to <= end and (to not in best or cost < best[to][0]):
            best[to] = (cost, mix)

    for a in sorted(at):
        if a not in best:
            continue
        cost, mix = best[a]
        if a in loops:
            back, passes, one = loops[a]
            add = {k: mix.get(k, 0.0) + passes * one.get(k, 0.0)
                   for k in set(mix) | set(one)}
            n = passes * sum(one.values())
            relax(back + step, cost + n - (1e9 if force else 0.0), add)
            continue
        _, op, tgt, _, pred = at[a]
        nmix = dict(mix)
        nmix[sass_kind(op)] = nmix.get(sass_kind(op), 0.0) + 1.0
        ncost = cost + (1000.0 if op == "CALL" else 1.0)
        if op in ("BRA", "JMP") and tgt is not None and tgt > a:
            relax(tgt, ncost, nmix)
        if op in ("BRA", "JMP", "EXIT", "RET") and not pred:
            continue
        relax(a + step, ncost, nmix)
    if end not in best:
        fail("no path through K5's compiled loop")
    return best[end][1]


def per_slot_sass(instrs, n_sph: int, probed: float) -> dict:
    """The instructions K5 issues for one slot, by kind, from its compiled
    code (:func:`path_mix`): one pass of the grid-stride loop (its
    outermost backward branch) on its cheapest path, the slow paths and
    rare branches skipped, with each sphere loop (an inner loop that reads
    the sphere table from shared memory, ``b`` bytes a pass) taken
    ``16 n_sph / b`` times, each pass on its own cheapest path (a ray that
    misses every sphere); the share ``probed`` of the slots takes the
    probe, the rest the cheapest path without it."""
    loops = sass_loops(instrs)
    if not loops:
        fail("no grid-stride loop in K5's compiled code")
    head, back = loops[0]
    sphere = {}
    for h, e in loops[1:]:
        if head <= h and e <= back:
            body = [x for x in instrs if h <= x[0] <= e]
            b = shared_bytes(body)
            if b:
                sphere[h] = (e, 16.0 * n_sph / b,
                             path_mix(instrs, h, e, {}, False))
    on = path_mix(instrs, head, back, sphere, True)
    off = path_mix(instrs, head, back, sphere, False)
    out = {k: probed * on.get(k, 0.0) + (1 - probed) * off.get(k, 0.0)
           for k in set(on) | set(off)}
    out["total"] = sum(out.values())
    return out


def sm_clock_mhz() -> int:
    """The card's top SM clock (MHz), as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return int(out.stdout.split()[0])


def k5_profile(args, n: int) -> dict:
    """K5's resident blocks an SM (the occupancy its grid is sized from),
    its compiled instructions a slot by kind (:func:`per_slot_sass`) and
    the time they take to issue at the card's top SM clock (132 SMs x 4
    schedulers x 32 lanes, an instruction a cycle each)."""
    from pota_tpu_torch.ops import _build, po_kernels as pk

    n_sph = int(args[10].shape[0])
    # the slots whose ok the probe can change: in bounds (the plain
    # version without spheres) and off sky
    _, inb = plain_chunked(pk.tl_splat_plain,
                           (*args[:10], args[10][:0], *args[11:]),
                           slice(0, 9))
    probed = float((inb & (args[8] < 0.5)).double().mean())
    found = [v for k, v in sass_functions(_build.sass_text()).items()
             if "tl_splat_kernel" in k]
    if len(found) != 1:
        fail("no compiled code for K5")
    sass = per_slot_sass(found[0], n_sph, probed)
    clock = sm_clock_mhz()
    blocks = _build.lib().pota_tl_splat_blocks_per_sm(n_sph)
    if blocks < 1:
        fail(f"K5's occupancy query failed ({blocks})")
    return dict(blocks_per_sm=blocks, probed_share=probed,
                sass_per_slot=sass, clock_mhz=clock,
                issue_ms=sass["total"] * n / (132 * 4 * 32 * clock * 1e6)
                * 1e3)


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


def timed_ms(fn, reps: int = 50) -> dict:
    """CUDA-event time of fn() after a warm-up: the median of ``reps`` runs
    (``ms``) and their 10th and 90th percentiles (``ms_spread``)."""
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
    q = statistics.quantiles(times, n=10)
    return dict(ms=statistics.median(times), ms_spread=[q[0], q[-1]])


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


def plain_chunked(fn, args, items):
    """fn(*args) over 1M-item chunks of the per-item tensors args[items]
    (a slice or the positions; a None there stays None): a whole queue at
    once would not fit the plain versions' intermediates.  Returns the
    joined outputs."""
    import torch

    idx = set(range(len(args))[items] if isinstance(items, slice) else items)
    n = args[min(idx)].shape[0]
    parts = [fn(*(a[i:i + PLAIN_CHUNK] if k in idx and a is not None else a
                  for k, a in enumerate(args)))
             for i in range(0, n, PLAIN_CHUNK)]
    return [torch.cat(p) for p in zip(*parts)]


def frac_pixels_off(got, want) -> float:
    got = got.reshape(got.shape[0] * got.shape[1], -1).double()
    want = want.reshape(got.shape).double()
    scale = max(float(want.abs().max()), 1.0)
    return float(((got - want).abs().amax(-1) > PIXEL_TOL * scale)
                 .double().mean())


def glass_teapot(device):
    """The ``flagship_idmatte`` scene: ``teapot_scene()`` with thin glass of
    grey 0.5 on its two nearest diffuse spheres (indices 0 and 1)."""
    import torch

    from pota_tpu_torch.render import scene as sc

    scene = sc.teapot_scene(device=device)
    trans = torch.zeros((scene.n_objects, 3), device=device)
    trans[:2] = 0.5
    return dataclasses.replace(scene, transmission=trans)


def crypto_oracle(pix, ids, w, npix: int, k: int):
    """``crypto_topk`` in float64 by other means: the (pixel, id) runs by a
    ``torch.unique`` inverse, their coverages and the pixel totals by
    float64 ``index_add_``, the ranks by two stable sorts (descending
    coverage, then pixel; ties keep ascending id).  Returns (rank_id
    [npix, k] int64, rank_w [npix, k] float64, total [npix] float64)."""
    import torch

    live = (w > 0) & (ids >= 0) & (pix >= 0) & (pix < npix)
    p, w64 = pix[live].long(), w[live].double()
    runs, inv = torch.unique((p << 32) | ids[live].long(),
                             return_inverse=True)
    run_w = torch.zeros(runs.shape[0], dtype=torch.float64,
                        device=w.device).index_add_(0, inv, w64)
    total = torch.zeros(npix, dtype=torch.float64,
                        device=w.device).index_add_(0, p, w64)
    order = torch.sort(-run_w, stable=True).indices
    order = order[torch.sort(runs[order] >> 32, stable=True).indices]
    rp, rid, rw = runs[order] >> 32, runs[order] & 0xFFFFFFFF, run_w[order]
    pos = torch.arange(rp.shape[0], device=w.device)
    first = torch.ones_like(rp, dtype=torch.bool)
    first[1:] = rp[1:] != rp[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    keep = rank < k
    rank_id = torch.full((npix, k), -1, dtype=torch.int64, device=w.device)
    rank_w = torch.zeros((npix, k), dtype=torch.float64, device=w.device)
    rank_id[rp[keep], rank[keep]] = rid[keep]
    rank_w[rp[keep], rank[keep]] = rw[keep]
    return rank_id, rank_w, total


def check_id_matte(label, fb, records, layers, npix: int) -> dict:
    """A frame's id-matte planes against :func:`crypto_oracle` of its
    records: every kept coverage and every pixel total within
    :data:`CRYPTO_TOL` relative, ``rank_id`` identical wherever the
    oracle's neighbouring coverages differ by more than that, and every
    coverage of the resolved layers at most 1 + 1e-5.  Fails the run on a
    miss; returns the measured figures."""
    import torch

    o_id, o_w, o_tot = crypto_oracle(*records, npix, 6)
    rid = fb["crypto_rank_id"].reshape(npix, -1).long()
    rw = fb["crypto_rank_w"].reshape(npix, -1).double()
    tot = fb["crypto_total"].reshape(-1).double()
    kept = o_w > 0
    w_err = float(((rw - o_w).abs()[kept] / o_w[kept]).max())
    if bool((rw[~kept] != 0).any()) or not w_err <= CRYPTO_TOL:
        fail(f"{label}: rank weights off the float64 oracle ({w_err:.3e})")
    on = o_tot > 0
    t_err = float(((tot - o_tot).abs()[on] / o_tot[on]).max())
    if bool((tot[~on] != 0).any()) or not t_err <= CRYPTO_TOL:
        fail(f"{label}: pixel totals off the float64 oracle ({t_err:.3e})")
    apart = torch.ones_like(kept)
    close = (((o_w[:, :-1] - o_w[:, 1:]).abs() <= CRYPTO_TOL * o_w[:, :-1])
             & (o_w[:, :-1] > 0))
    apart[:, 1:] &= ~close
    apart[:, :-1] &= ~close
    id_off = int((rid != o_id)[apart].sum())
    if id_off:
        fail(f"{label}: {id_off} rank ids differ from the oracle's order")
    cov = max(float(layer[..., c].max()) for layer in layers for c in (1, 3))
    if cov > 1.0 + 1e-5:
        fail(f"{label}: a coverage of {cov} > 1")
    out = dict(records=int(records[0].shape[0]),
               live_records=int(((records[2] > 0) & (records[1] >= 0))
                                .sum()),
               ranked=int(kept.sum()), rank_w_max_rel_err=w_err,
               total_max_rel_err=t_err, near_ties=int((~apart).sum()),
               max_coverage=cov)
    print(f"{label} id-matte against the float64 oracle: {out}", flush=True)
    return out


class Recorder:
    """A kernel set that runs the kernels and keeps the arguments of the
    first call of each, so they can be replayed at main-path shapes.  Its
    wrappers hold the ``args`` dict, not the Recorder: a reference cycle
    would keep a frame's arguments on the card until a garbage collection
    (and in the next phase's peak memory)."""

    def __init__(self, kernels):
        self.args = {}
        for name in kernels._fields:
            setattr(self, name, self._wrap(self.args, name,
                                           getattr(kernels, name)))

    @staticmethod
    def _wrap(seen, name, fn):
        def call(*args):
            seen.setdefault(name, args)
            return fn(*args)
        return call


def ring_pixels(n: int = 32, lo: float = 0.5) -> np.ndarray:
    """The procedural 32x32 ring aperture config 3 falls back to
    (bench.py:145-151); the golden configs' ring starts at 0.55."""
    yy, xx = np.mgrid[0:n, 0:n]
    r = np.sqrt((xx - (n - 1) / 2) ** 2 + (yy - (n - 1) / 2) ** 2) / (n / 2)
    ring = ((r > lo) & (r < 0.95)).astype(np.float32)
    return np.stack([ring] * 3, -1)


def f64_witness(plain, args, items):
    """A kernel's function in float64 on its captured arguments: its plain
    version ``plain`` on float64 copies of the lens and of the float
    inputs, at the frame's wavelengths unrounded (K3's aperture point is
    drawn in float32, as kernel and plain version draw it)."""
    import torch

    lens64 = copy.deepcopy(args[0]).double()
    rest = [t.double() if torch.is_tensor(t) and t.is_floating_point() else t
            for t in args[1:]]
    return plain_chunked(plain, (lens64, *rest), items)


def channel_order(n: int, device):
    """The slot each thread of a chromatic K3b takes (``csrc/po_splat.cu``):
    thread t takes 96 * (t // 96) + 3 * (t % 32) + (t // 32) % 3, so each
    warp's 32 slots are one channel where the queue's channel is slot % 3;
    for the first n - n % 96 threads, int64."""
    import torch

    t = torch.arange(n - n % 96, device=device)
    return t // 96 * 96 + 3 * (t % 32) + (t // 32) % 3


def k3b_designs(kern, args, items) -> dict:
    """K3b's two thread orders on its captured arguments, cut to whole
    channel groups: the kernel as it is (channel-uniform warps) and on the
    slots permuted so that thread t meets slot t (an index per slot, K6's
    order: a chromatic warp then reads all three tables), which must give
    the same (lin, ok) permuted; and the same slots on one table (the green
    channel's wavelength, no index).  Times (ms) and the share of warps
    whose 32 slots are of one channel."""
    import torch

    idx = args[10]
    q = channel_order(idx.shape[0], idx.device)
    inv = torch.empty_like(q)
    inv[q] = torch.arange(q.shape[0], device=q.device)

    def on(perm, over=None):
        over = over or {}
        return [over[k] if k in over else a[perm] if k in items else a
                for k, a in enumerate(args)]

    own = on(slice(0, q.shape[0]))
    slot_index = on(inv)
    one_table = on(slice(0, q.shape[0]), {9: args[9][1:2], 10: None})
    lin_o, ok_o = kern(*own)
    lin_s, ok_s = kern(*slot_index)
    if not (torch.equal(lin_s, lin_o[inv]) and torch.equal(ok_s, ok_o[inv])):
        fail("K3b's thread order changes its result")
    warps = idx[q].view(-1, 32)
    return dict(
        n=int(q.shape[0]),
        uniform_warp_share=float((warps == warps[:, :1]).all(1)
                                 .double().mean()),
        channel_uniform_ms=median_ms(lambda: kern(*own)),
        slot_index_ms=median_ms(lambda: kern(*slot_index)),
        one_table_ms=median_ms(lambda: kern(*one_table)))


def share_far(got, ref, both) -> float:
    """Share of the items ``both`` keep whose sensor point (sx, sy) lies
    more than 1e-3 mm apart in the two K6 outputs."""
    return float(((got[0][both] - ref[0][both]).abs()
                  .maximum((got[1][both] - ref[1][both]).abs()) > 1e-3)
                 .double().mean())


def k6_disagreement(out, witness) -> dict:
    """How far K6's outputs ``out`` fall from the float64 solve: the share
    of items whose ``trans > 0`` differs, and of the items both keep, the
    share > 1e-3 mm apart and the largest distance of (sx, sy) (mm)."""
    keep, keep_w = out[4] > 0, witness[4] > 0
    both = keep & keep_w
    return dict(keep=float((keep != keep_w).double().mean()),
                far=share_far(out, witness, both),
                max_mm=float((out[0][both] - witness[0][both]).abs().maximum(
                    (out[1][both] - witness[1][both]).abs()).max()))


def disagreement(lin, ok, lin_w, ok_w) -> dict:
    """Shares of slots on which (lin, ok) disagrees with a witness: ``ok``
    over all slots, ``lin`` over the slots both keep."""
    both = ok & ok_w
    return dict(ok=float((ok != ok_w).double().mean()),
                lin=float((lin[both] != lin_w[both]).double().mean()))


def leading(args, items, n: int):
    """``args`` with the per-item tensors ``args[items]`` cut to their
    first ``n`` items."""
    idx = set(range(len(args))[items] if isinstance(items, slice) else items)
    return tuple(a[:n] if k in idx and a is not None else a
                 for k, a in enumerate(args))


def check_splat_kernel(name, kern, plain, args, items, source, replaces,
                       bytes_per_slot, flops_per_slot, plain_reps=5,
                       witness=None, plain_n=None):
    """Hold a splat kernel (K3, its variants, K5) to its plain version on
    captured main-path arguments; return its record.  ``witness``, if
    given, takes the kernel's and the plain version's (lin, ok) and returns
    more fields for the record.  With ``plain_n`` the plain version runs
    (and is timed) on the first ``plain_n`` slots only, and the kernel's
    output there is held to it."""
    lin_g, ok_g = kern(*args)
    s = lin_g.shape[0]
    pargs = args if plain_n is None else leading(args, items, plain_n)
    lin_p, ok_p = plain_chunked(plain, pargs, items)
    lin_g, ok_g = lin_g[:lin_p.shape[0]], ok_g[:lin_p.shape[0]]
    ok_agree = float((ok_g == ok_p).double().mean())
    both = ok_g & ok_p
    lin_agree = float((lin_g[both] == lin_p[both]).double().mean())
    err = float((lin_g[both] - lin_p[both]).abs().max())
    print(f"{name} S={s} ok agree={ok_agree:.6f} lin agree={lin_agree:.6f} "
          f"max_abs_err(lin)={err} (ok rate "
          f"{float(ok_g.double().mean()):.4f}; plain version on "
          f"{lin_p.shape[0]} slots)", flush=True)
    if ok_agree < MASK_AGREE or lin_agree < MASK_AGREE:
        fail(f"{name} disagrees with its plain version")
    extra = witness(lin_g, ok_g, lin_p, ok_p) if witness else {}
    del lin_g, ok_g, lin_p, ok_p, both
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=median_ms(lambda: kern(*args)),
                plain_ms=median_ms(lambda: plain_chunked(plain, pargs, items),
                                   plain_reps),
                **bound(bytes_per_slot * s, flops_per_slot * s),
                library_ms=None, n=int(s), plain_n=int(pargs[1].shape[0]),
                ok_agree=ok_agree, lin_agree=lin_agree, **extra)


def config5_vjp_checks(fn_args, accum_args) -> dict:
    """The VJPs of config 5's K2 and K4 on the 4K step's own arguments,
    each against a float64 oracle, with a seeded cotangent: ``ExpandFn``'s
    table gradient (the float64 range sums of ``d_ex`` over each source's
    live slots, rounded once) against a float64 ``index_add_`` by source,
    and twice for identical bits, and ``AccumFn``'s payload
    gradient (the accumulator's gradient gathered at each live writer's
    pixel) against the float64 gather.  Errors are the largest absolute
    error over the oracle's largest magnitude; times are the backward
    alone (CUDA events)."""
    import torch

    with torch.enable_grad():
        return _config5_vjp_checks(fn_args, accum_args)


def _config5_vjp_checks(fn_args, accum_args) -> dict:
    import torch

    from pota_tpu_torch.ops import po_kernels as pk, splat_accum

    table_f, src, table_i, bounds = fn_args
    dev = table_f.device
    g = torch.Generator(device=dev).manual_seed(11)
    d_ex = torch.randn((table_f.shape[0], src.shape[0]), generator=g,
                       device=dev)
    t = table_f.detach().clone().requires_grad_(True)
    ex_f, _ = pk.ExpandFn.apply(t, src, table_i, bounds, pk.expand)

    def expand_bwd():
        return torch.autograd.grad(ex_f, t, d_ex, retain_graph=True)[0]

    got = expand_bwd()
    n = table_f.shape[1]
    live = int(bounds[1].max())
    col = torch.where(torch.arange(src.shape[0], device=dev) < live,
                      src.long(), n)
    oracle = torch.zeros((table_f.shape[0], n + 1), dtype=torch.float64,
                         device=dev).index_add_(1, col, d_ex.double())[:, :n]
    out = dict(expand_rel_err=float((got.double() - oracle).abs().max()
                                    / oracle.abs().max()),
               expand_same_bits=bool(torch.equal(got, expand_bwd())),
               expand_backward_ms=median_ms(expand_bwd),
               live_slots=live, slots=int(src.shape[0]))
    del d_ex, t, ex_f, got, col, oracle

    keys, perm, payload, sid, npix = accum_args
    pix = torch.empty_like(keys)
    pix[perm] = keys >> 32
    depth = torch.empty(keys.shape, dtype=torch.float32, device=dev)
    depth[perm] = (keys & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    p = payload.detach().clone().requires_grad_(True)
    acc = splat_accum.AccumFn.apply(p, pix, depth, sid, npix,
                                    splat_accum.segment_accum)[0]
    d_acc = torch.randn(acc.shape, generator=g, device=dev)

    def accum_bwd():
        return torch.autograd.grad(acc, p, d_acc, retain_graph=True)[0]

    got = accum_bwd()
    live = pix < npix
    oracle = torch.where(live[:, None],
                         d_acc.double()[torch.clamp(pix, max=npix - 1)], 0.0)
    out.update(accum_rel_err=float((got.double() - oracle).abs().max()
                                   / oracle.abs().max()),
               accum_backward_ms=median_ms(accum_bwd),
               writers=int(keys.shape[0]))
    print(f"config 5 VJPs: ExpandFn backward vs float64 segment sums "
          f"max rel err {out['expand_rel_err']:.3e} ({out['live_slots']} live "
          f"of {out['slots']} slots, {out['expand_backward_ms']:.3f} ms); "
          f"AccumFn backward vs float64 gather max rel err "
          f"{out['accum_rel_err']:.3e} ({out['writers']} writers, "
          f"{out['accum_backward_ms']:.3f} ms)", flush=True)
    if out["expand_rel_err"] > 1e-5 or out["accum_rel_err"] != 0.0:
        fail("config 5: a VJP disagrees with its float64 oracle")
    if not out["expand_same_bits"]:
        fail("config 5: ExpandFn's backward gave other bits on a second run")
    return out


def drawn_candidates(a) -> tuple:
    """K1's arguments in its candidate mode (``po_forward``) on the
    candidates that the select-mode call ``a`` (``po_forward_selected``'s
    arguments) draws, drawn in torch (``drawn_rays``) at the sensor points
    ``sx * hsw, sy * hsw``: the torch draw that the select mode
    replaced."""
    from pota_tpu_torch.ops import po_kernels as pk

    lens, sx, sy, hsw = a[:4]
    return (lens, *pk.drawn_rays(sx * hsw, sy * hsw, *a[4:10]), *a[10:12],
            a[13])


def draw_and_select(a, need_rays=False) -> tuple:
    """The route K1's select mode replaced, on the select-mode call ``a``:
    the candidates drawn in torch (:func:`drawn_candidates`), K1's
    candidate mode on them, then the torch epilogue (``select_rays``)."""
    from pota_tpu_torch.ops import po_kernels as pk

    lens, sx, sy, hsw, tries, shift, scale = a[0], a[1], a[2], a[3], a[7], \
        a[11], a[12]
    cand = pk.po_forward(*drawn_candidates(a))
    return pk._select_candidates(lens, sx * hsw, sy * hsw, cand, tries, shift,
                                 scale, need_rays)


def selected_plain_chunked(a) -> list:
    """K1's plain select mode on the call ``a`` in 1M-ray chunks."""
    from pota_tpu_torch.ops import po_kernels as pk

    return plain_chunked(pk.po_forward_selected_plain, a[:14],
                         (1, 2, 4, 5, 6))


def k1_record(a, ptxas, tag, path=None) -> dict:
    """K1 in its select mode on the captured arguments ``a`` of the path's
    ``po_forward_selected`` call: origin, direction, weight, tries and the
    selected candidate's sensor point, solution and chart bit for bit those of
    the torch draw, K1's candidate mode and the torch epilogue (the route it
    replaced); against the plain version (in 1M-ray chunks): the rays'
    selections (``tries``) and the largest error on the rays both take alike;
    its record (``path`` None: the flagship's), timed as the path calls it
    (``ms``: CUDA events round the wrapper; ``device_ms``: the kernel alone,
    from the profiler), beside the route it replaced (``chain_ms``,
    ``chain_device_ms``), K1's candidate mode alone on the torch draw's
    candidates (``candidate_ms``), and the candidates each ray traced."""
    import torch

    from pota_tpu_torch.ops import po_kernels as pk

    sx, tries = a[1], a[7]
    need_rays = len(a) > 14 and bool(a[14])
    got = pk.po_forward_selected(*a[:14], True)
    chain = draw_and_select(a, True)
    if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, chain)):
        fail("K1's select mode and the torch draw, K1's candidate mode and "
             "the torch select differ")
    del chain
    ref = selected_plain_chunked(a)
    same = got[3] == ref[3]
    agree = float(same.double().mean())
    alike = same & (got[2] > 0) & (ref[2] > 0)
    err = max(float((g[alike] - r[alike]).abs().max())
              for g, r in zip(got[:2], ref[:2]))
    # the candidates a ray traced: up to its first success, K when none
    traced = int(torch.clamp(got[3].long() + 1, max=tries).sum())
    weight1 = float((got[2] > 0).double().mean())
    n_rays = int(sx.shape[0])
    where = f" ({path})" if path else ""
    print(f"K1 po_forward_selected{where} N={n_rays} K={tries}: rays and "
          f"the selected candidates the torch chain's bits;"
          f" tries agree with the plain version on {agree:.6f}, "
          f"max_abs_err(rays both take alike)={err:.3e}; weight 1 on "
          f"{weight1:.4f}; {traced} candidates traced of {n_rays * tries}",
          flush=True)
    if agree < MASK_AGREE or err > 1e-3:
        fail(f"K1 po_forward_selected{where} disagrees with its plain "
             "version")
    del got, ref, same, alike
    # 24 bytes a ray in (sx, sy, r1, r2, the key); 32 out (origin,
    # direction, weight, tries), 32 more where the path asks for the
    # selected candidate; the operations of the candidates traced (the
    # epilogue's ~100 a ray left out)
    n_bytes = (24.0 + (64.0 if need_rays else 32.0)) * n_rays
    a1 = drawn_candidates(a)
    kernel = ["po_forward_select_kernel"]
    rec = dict(
        name="po_forward", mode="select", route="cuda",
        source="pota_tpu_torch/csrc/po_forward.cu",
        replaces=f"{TPU_KERNELS}:83", max_abs_err=err,
        ms=median_ms(lambda: pk.po_forward_selected(*a)),
        device_ms=(device_ms(lambda: pk.po_forward_selected(*a), kernel)
                   [kernel[0]]),
        chain_ms=median_ms(lambda: draw_and_select(a, need_rays)),
        chain_device_ms=device_ms(lambda: draw_and_select(a, need_rays),
                                  [""])[""],
        candidate_ms=median_ms(lambda: pk.po_forward(*a1)),
        plain_ms=median_ms(lambda: selected_plain_chunked(a), 3),
        **bound(n_bytes, traced * basis_forward_flops(a[13])),
        **ptxas["po_forward_selected"],
        candidate_registers=ptxas["po_forward"]["registers"],
        library_ms=None, n=n_rays, tries=tries, traced=traced,
        rays_out=need_rays, tries_agree=agree, weight1=weight1)
    if path:
        rec["path"] = path
    dev_ms = lambda v: "not measured" if v is None else f"{v:.3f} ms"
    print(f"po_forward_selected{where} (the select mode): {rec['ms']:.3f} "
          f"ms, device {dev_ms(rec['device_ms'])}; the torch draw, K1's "
          f"candidate mode and the torch select {rec['chain_ms']:.3f} ms "
          f"(device {dev_ms(rec['chain_device_ms'])}); K1 on the "
          f"candidates alone {rec['candidate_ms']:.3f} ms; bound "
          f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), "
          f"{rec['registers']} registers "
          f"({rec['candidate_registers']} in the candidate mode), "
          f"{rec['spill_bytes']} spill bytes {tag}", flush=True)
    return rec


def k2_record(a2, ptxas, path) -> dict:
    """K2 against its plain version (exactly) on the captured arguments
    ``a2`` of ``path``, and its record; the library yardstick is
    ``index_select`` on both tables."""
    from pota_tpu_torch.ops import po_kernels as pk

    got = pk.expand(*a2)
    ref = pk.expand_plain(*a2)
    err = max(float((got[0] - ref[0]).abs().max()),
              float((got[1] - ref[1]).abs().max()))
    print(f"K2 expand ({path}) S={a2[0].shape[0]} max_abs_err={err}",
          flush=True)
    if err != 0:
        fail(f"K2 expand disagrees with its plain version on {path}")
    del got, ref
    s2, n2 = a2[0].shape[0], a2[1].shape[1]
    rows = a2[1].shape[0] + a2[2].shape[0]
    return dict(
        name="expand", path=path, route="cuda",
        source="pota_tpu_torch/csrc/expand.cu",
        replaces=f"{TPU_KERNELS}:877", max_abs_err=err,
        ms=median_ms(lambda: pk.expand(*a2)),
        plain_ms=median_ms(lambda: pk.expand_plain(*a2)),
        **bound(4.0 * (s2 + rows * (s2 + n2)), 0.0),
        library_ms=median_ms(lambda: (a2[1].index_select(1, a2[0]),
                                      a2[2].index_select(1, a2[0]))),
        n=int(s2), **ptxas["expand"])


def _vjp_slice(args, lo: int, hi: int, dtype=None) -> tuple:
    """K1v's select-mode arguments (lens, the selected candidates' x, y,
    dx, dy, out4, the rays' cotangents, lam, shift, scale) cut to rays
    [lo, hi), the tensors in ``dtype``."""
    cut = [None if t is None else
           (t[lo:hi] if dtype is None else t[lo:hi].to(dtype)).contiguous()
           for t in args[1:8]]
    return (args[0], *cut, *args[8:])


def vjp_plain_sum(args, dtype) -> tuple:
    """K1v's plain select mode over ``args``'s rays in chunks of
    :data:`PLAIN_VJP_CHUNK`, the inputs in ``dtype``, the chunks' (pt, ap)
    cotangents summed in float64."""
    from pota_tpu_torch.ops import po_kernels as pk

    m = args[1].shape[0]
    total = None
    for lo in range(0, m, PLAIN_VJP_CHUNK):
        part = pk.po_forward_vjp_selected_plain(
            *_vjp_slice(args, lo, min(lo + PLAIN_VJP_CHUNK, m), dtype))
        part = [p.double() for p in part]
        total = part if total is None else [a + b
                                            for a, b in zip(total, part)]
    return total


def forward_vjp_record(calls, ptxas, tag, path) -> dict:
    """K1v in its select mode on the arguments of every launch of one step
    of ``path`` (the trace's checkpointed chunks, ``calls``: each chunk's
    selected candidates and its rays' cotangents): on all of them in one
    launch against its plain version (float32, chunks summed in float64)
    and, on the first :data:`PLAIN_VJP_F64` rays, against the plain
    version in float64, both by :data:`VJP_TOL` relative L2 of the ``pt``
    and ``ap`` cotangents; two runs give the same bits.  ``ms``,
    ``plain_ms`` and ``bound_ms`` are per launch: the step's launches run
    back to back, over their count; ``all_ms`` the whole step's rays in one
    launch.  The bound counts the operations of the rays that carry a
    cotangent (:func:`basis_forward_vjp_flops` and the chart's VJP) and the
    bytes the function needs: the cotangents for every ray, the selected
    candidate (x, y, dx, dy, out4) for those that carry one, the sums."""
    import torch

    from pota_tpu_torch.ops import _build, po_kernels as pk

    one = calls[0]
    cat = [None if one[i] is None else torch.cat([c[i] for c in calls])
           for i in range(1, 8)]
    full = (one[0], *cat, *one[8:])
    m_all, m1 = int(cat[0].shape[0]), int(one[1].shape[0])
    got = pk.po_forward_vjp_selected(*full)
    again = pk.po_forward_vjp_selected(*full)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    rel = lambda g, r: float((g.double() - r).norm() / r.norm())
    ref = vjp_plain_sum(full, torch.float32)
    err = [rel(g, r) for g, r in zip(got, ref)]
    abs_err = max(float((g.double() - r).abs().max())
                  for g, r in zip(got, ref))
    n64 = min(m_all, PLAIN_VJP_F64)
    head = _vjp_slice(full, 0, n64)
    got64 = pk.po_forward_vjp_selected(*head)
    ref64 = vjp_plain_sum(head, torch.float64)
    err64 = [rel(g, r) for g, r in zip(got64, ref64)]
    plain64 = [rel(g, r) for g, r in zip(vjp_plain_sum(head, torch.float32),
                                         ref64)]
    del got, again, ref, got64, ref64, head
    cts = [t for t in cat[5:7] if t is not None]
    live = torch.zeros(m_all, dtype=torch.bool, device=cts[0].device)
    for t in cts:
        live |= (t != 0).any(1)
    active = int(live.sum())
    n_bytes = (sum(4.0 * t.numel() for t in cts) + 32.0 * active
               + 8.0 * pk.VJP_SUMS * len(calls))
    per_launch = lambda fn: lambda: [fn(*c) for c in calls]
    names = ("po_forward_vjp_kernel", "po_forward_vjp_finish")
    dev_ms = device_ms(per_launch(pk.po_forward_vjp_selected), names)
    kernel_ms = (None if None in dev_ms.values()
                 else sum(dev_ms.values()) / len(calls))
    # the first launch's kernel time with no ray live (the scan alone), as
    # given, and every ray live (seeded normal cotangents)
    g_d, by_live = one[7], {}
    if g_d is not None:
        dense = torch.randn(g_d.shape, device=g_d.device, generator=(
            torch.Generator(g_d.device).manual_seed(5)))
        for label, g in (("none", torch.zeros_like(g_d)), ("given", g_d),
                         ("all", dense)):
            a = (*one[:6], None if label == "none" else one[6], g, *one[8:])
            by_live[label] = device_ms(
                lambda: pk.po_forward_vjp_selected(*a),
                names)["po_forward_vjp_kernel"]
        del dense
    print(f"K1v po_forward_vjp_selected ({path}) on {len(calls)} launches' "
          f"{m_all} rays: rel L2 pt {err[0]:.3e} ap {err[1]:.3e} against "
          f"the plain version; on the first {n64} against float64 pt "
          f"{err64[0]:.3e} ap {err64[1]:.3e} (the float32 plain version "
          f"{plain64[0]:.3e} / {plain64[1]:.3e}); two runs identical bits "
          f"{same}", flush=True)
    if max(err + err64) > VJP_TOL or not same:
        fail(f"K1v po_forward_vjp_selected ({path}) disagrees with its "
             "plain version or is not reproducible")
    rec = dict(
        name="po_forward_vjp", mode="select", path=path, route="cuda",
        source="pota_tpu_torch/csrc/po_forward_vjp.cu",
        replaces=f"{TPU_KERNELS}:83",
        role="K1's backward; no TPU kernel: JAX differentiates its pure "
             "path (pota_tpu/optics/polynomial.py:256-324)",
        max_abs_err=abs_err, rel_l2=dict(pt=err[0], ap=err[1]),
        f64_rel_l2=dict(pt=err64[0], ap=err64[1], n=n64,
                        plain_f32_pt=plain64[0], plain_f32_ap=plain64[1]),
        identical_bits=same,
        ms=median_ms(per_launch(pk.po_forward_vjp_selected)) / len(calls),
        plain_ms=median_ms(per_launch(pk.po_forward_vjp_selected_plain), 3)
        / len(calls),
        all_ms=median_ms(lambda: pk.po_forward_vjp_selected(*full)),
        **bound(n_bytes / len(calls), active / len(calls)
                * (basis_forward_vjp_flops(False) + CHART_VJP_FLOPS)),
        bytes_ms=n_bytes / len(calls) / HBM_BYTES_PER_S * 1e3,
        kernel_ms=kernel_ms,
        kernel_parts_ms={k: (None if v is None else v / len(calls))
                         for k, v in dev_ms.items()},
        kernel_ms_by_live=by_live,
        library_ms=None, n=m1, n_all=m_all, active=active,
        blocks_per_sm=(
            _build.lib().pota_po_forward_vjp_selected_blocks_per_sm()),
        **ptxas["po_forward_vjp_selected"],
        candidate_mode_registers=ptxas["po_forward_vjp"]["registers"])
    k_ms = "not measured" if kernel_ms is None else f"{kernel_ms:.4f} ms"
    print(f"po_forward_vjp_selected ({path}): {rec['ms']:.3f} ms a launch "
          f"through the wrapper at N={m1} ({len(calls)} launches, {active} "
          f"of {m_all} rays carry a cotangent), the kernels alone "
          f"{k_ms} a launch ({rec['kernel_parts_ms']}; the first launch's "
          f"main kernel with none, its own and every ray live "
          f"{by_live}), all in one launch "
          f"{rec['all_ms']:.3f} ms, plain "
          f"{rec['plain_ms']:.3f} ms a launch, bound {rec['bound_ms']:.4f} "
          f"ms a launch ({rec['bound_by']}; bytes {rec['bytes_ms']:.4f}), "
          f"{rec['registers']} registers ({rec['candidate_mode_registers']} "
          f"in the candidate mode), {rec['spill_bytes']} spill bytes, "
          f"{rec['blocks_per_sm']} blocks of 128 an SM {tag}", flush=True)
    return rec


class Config5:
    """BASELINE config 5 (bench.py:249-297), the differentiable 4K step:
    the flagship fit (its own copy, whose ``pt`` and ``ap`` coefficients
    require grad), fstop 2.8, focus 20, 3 candidates a ray,
    ``splat_queue_mult`` 4, ``trace_chunks`` 32, ``teapot_scene()``,
    3840x2160 @ 1 spp (``rc``); bench.py's ``splat_chunks`` only chunks
    the TPU's memory (same output).  ``parity_rc`` is the parity frame."""

    def __init__(self, dev, m, rc=(3840, 2160), parity_rc=(256, 144)):
        import pota_tpu_torch as pt
        from pota_tpu_torch.optics.fit import load_poly_lens
        from pota_tpu_torch.optics.focus import setup_po_camera
        from pota_tpu_torch.render import scene as sc

        self.dev, self.m = dev, m
        self.cfg = pt.CameraConfig(
            camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
            fstop=2.8, focus_distance=20.0, vignetting_retries=2,
            splat_queue_mult=4, trace_chunks=32)
        self.scene = sc.teapot_scene(device=dev)
        self.lens = load_poly_lens(FLAGSHIP, device=dev)
        self.state = setup_po_camera(self.lens, self.cfg, scene=self.scene)
        self.coeffs = (self.lens.pt.coeffs.requires_grad_(True),
                       self.lens.ap.coeffs.requires_grad_(True))
        self.rc = pt.RenderConfig(xres=rc[0], yres=rc[1], spp=1)
        self.parity_rc = pt.RenderConfig(xres=parity_rc[0],
                                         yres=parity_rc[1], spp=1)

    def render(self, rc=None, cfg=None, ops=None):
        """The differentiable frame: (image, framebuffer)."""
        from pota_tpu_torch.render.renderer import render_frame

        return render_frame(cfg or self.cfg, rc or self.rc, self.scene,
                            self.m, seed=0, po_lens=self.lens,
                            po_state=self.state, differentiable=True,
                            ops=ops)

    def step(self, rc=None, cfg=None, target=None, ops=None):
        """One step: the differentiable frame, its loss (the mean of RGB,
        or with ``target`` the L2 loss of JAX's ``train_step_sharded``)
        and ``loss.backward()`` into the coefficients' ``grad``,
        synchronised.  Returns (loss, image, framebuffer)."""
        import torch

        for c in self.coeffs:
            c.grad = None
        img, fb = self.render(rc, cfg, ops)
        loss = (img[..., :3].mean() if target is None
                else ((img - target) ** 2).mean())
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), img.detach(), fb

    def kernel_records(self, ptxas, tag) -> list:
        """K1, K2, K3, K4 and K1v on the arguments of one 4K step
        (``path: "config5"``; K1 on the trace's first chunk, K1v on every
        chunk's (:func:`forward_vjp_record`); the plain K3 on the queue's
        first :data:`CONFIG5_PLAIN_SLOTS` slots), and the VJPs of K2 and K4
        on them (:func:`config5_vjp_checks`, in K4's record)."""
        import torch

        from pota_tpu_torch import ops
        from pota_tpu_torch.ops import po_kernels as pk, splat_accum

        rec = Recorder(ops.KERNELS)
        vjp_calls = []

        def recording_vjp(*a):
            vjp_calls.append(a)
            return ops.KERNELS.po_forward_vjp_selected(*a)

        rec.po_forward_vjp_selected = recording_vjp
        fn_args = {}
        expand_apply = pk.ExpandFn.apply

        def recording_apply(*a):
            fn_args.setdefault("expand_fn", (a[0].detach(), *a[1:4]))
            return expand_apply(*a)

        pk.ExpandFn.apply = recording_apply
        try:
            with torch.enable_grad():
                self.step(ops=rec)
        finally:
            del pk.ExpandFn.apply
        for c in self.coeffs:
            c.grad = None
        torch.cuda.synchronize()
        chunks = trace_chunks_of(self.cfg, self.rc)
        if len(vjp_calls) != chunks:
            fail(f"config 5: K1v ran {len(vjp_calls)} times, not once a "
                 f"chunk ({chunks})")
        records = [k1_record(rec.args["po_forward_selected"], ptxas, tag,
                             "config5"),
                   forward_vjp_record(vjp_calls, ptxas, tag, "config5")]
        vjp_calls.clear()
        torch.cuda.empty_cache()
        records.append(k2_record(rec.args["expand"], ptxas, "config5"))
        a3 = rec.args["po_splat"]
        k3 = check_splat_kernel(
            "po_splat", pk.po_splat, pk.po_splat_plain, a3, slice(1, 10),
            "pota_tpu_torch/csrc/po_splat.cu", f"{TPU_KERNELS}:697", 41.0,
            basis_solve_flops(a3[13]) + 60 + 20 * self.scene.n_objects + 20,
            plain_reps=3, plain_n=CONFIG5_PLAIN_SLOTS)
        k3.update(path="config5", **ptxas["po_splat"])
        records.append(k3)
        del a3
        seg = splat_accum.segment_accum
        seg_plain = splat_accum.segment_accum_plain
        a4 = rec.args["segment_accum"]
        err4 = check_accum("config 5", seg, seg_plain, a4)
        records.append(dict(
            name="segment_accum", path="config5", route="cuda",
            source="pota_tpu_torch/csrc/segment_accum.cu",
            replaces="pota_tpu/ops/splat_accum.py:59", max_abs_err=err4,
            **timed_ms(lambda: seg(*a4)),
            plain_ms=median_ms(lambda: seg_plain(*a4)),
            **accum_bound(a4), row_gather_ms=row_gather_ms(a4),
            library_ms=None, n=int(a4[0].shape[0]),
            **ptxas["segment_accum"],
            config5_vjp=config5_vjp_checks(fn_args["expand_fn"], a4)))
        for r in records:
            print(f"{r['name']} (config 5): kernel {r['ms']:.3f} ms, plain "
                  f"{r['plain_ms']:.3f} ms (on {r.get('plain_n', r['n'])} "
                  f"items), bound {r['bound_ms']:.3f} ms ({r['bound_by']}) "
                  f"{tag}", flush=True)
        return records

    def parity(self) -> None:
        """The parity frame (``trace_chunks`` 4) through the kernels and
        through the plain versions: the image by the parity frames' pixel
        limit, the ``pt`` gradient by :data:`CONFIG5_GRAD_TOL`.  Mixed
        sets split the gradient's difference: K1's forward, K1v (each with
        K2, K3 and K4 as in the kernel set), and K3 alone among the plain
        versions; K1's ``trans > 0`` decisions on the frame's forward
        chunks are counted against its plain version's."""
        import torch

        from pota_tpu_torch import ops
        from pota_tpu_torch.ops import po_kernels as pk

        rc = self.parity_rc
        phase(f"parity config 5 {rc.xres}x{rc.yres} @ 1 spp, "
              "differentiable: kernels vs plain versions")
        cfg = dataclasses.replace(self.cfg, trace_chunks=4)
        k1_calls = []

        def recording_k1(*a):
            k1_calls.append(a)
            return ops.KERNELS.po_forward_selected(*a)

        sets = (("kernels",
                 ops.KERNELS._replace(po_forward_selected=recording_k1)),
                ("plain", ops.PLAIN),
                ("K1 with plain K1v", ops.KERNELS._replace(
                    po_forward_vjp_selected=(
                        ops.PLAIN.po_forward_vjp_selected))),
                ("plain K1 with K1v", ops.KERNELS._replace(
                    po_forward_selected=ops.PLAIN.po_forward_selected)),
                ("K3 alone", ops.PLAIN._replace(
                    po_splat=ops.KERNELS.po_splat)))
        res = {}
        for label, kset in sets:
            _, img, fb = self.step(rc, cfg, ops=kset)
            res[label] = (img, float(fb["RGBA"].detach().double().sum()),
                          *(c.grad.clone() for c in self.coeffs))
        rel = lambda a, i: float((res[a][i] - res["plain"][i]).norm()
                                 / res["plain"][i].norm())
        off = frac_pixels_off(res["kernels"][0], res["plain"][0])
        g_err = [rel("kernels", i) for i in (2, 3)]
        print(f"  RGBA: pixels off {off:.5f}; energy kernels "
              f"{res['kernels'][1]:.6f} plain {res['plain'][1]:.6f}; "
              f"gradient rel L2 pt {g_err[0]:.3e} ap {g_err[1]:.3e}",
              flush=True)
        for label, _ in sets[2:]:
            print(f"  {label} against the plain versions: pixels off "
                  f"{frac_pixels_off(res[label][0], res['plain'][0]):.5f}; "
                  f"gradient rel L2 pt {rel(label, 2):.3e} ap "
                  f"{rel(label, 3):.3e}", flush=True)
        # the forward's chunks come first, the backward's recompute after
        chunks = trace_chunks_of(cfg, rc)
        flips = n_k1 = 0
        d_err = 0.0
        for a in k1_calls[:chunks]:
            with torch.no_grad():
                got = pk.po_forward_selected(*a[:14])
                ref = pk.po_forward_selected_plain(*a[:14])
            alike = (got[3] == ref[3]) & (got[2] > 0) & (ref[2] > 0)
            flips += int((got[3] != ref[3]).sum())
            n_k1 += int(got[3].numel())
            if bool(alike.any()):
                d_err = max([d_err] + [
                    float((g[alike] - r[alike]).abs().max())
                    for g, r in zip(got[:2], ref[:2])])
        print(f"  K1 against its plain version on the frame's {n_k1} rays: "
              f"the candidate selected differs on {flips}; origin and "
              f"direction max abs difference {d_err:.3e} where both take "
              "the same", flush=True)
        del k1_calls
        if (off > MAX_PIXELS_OFF or g_err[0] > CONFIG5_GRAD_TOL
                or abs(res["kernels"][1] - res["plain"][1])
                > 2e-3 * abs(res["plain"][1])
                or not all(bool(torch.isfinite(res["kernels"][i]).all())
                           for i in (0, 2, 3))):
            fail("config 5 parity: image, energy or gradient")

    def run(self, tag) -> dict:
        """The config 5 phase: one step with the launch counters set to 0
        just before it and read just after (K2, K3, K4 once each, K1 twice
        and K1v once a trace chunk, nothing else: :func:`want_launches`),
        its peak memory, energy, planes and gradient norms; a warm-up and
        three timed steps; three descent steps.  Returns the launches."""
        import torch

        from pota_tpu_torch import ops
        from pota_tpu_torch.ops import po_kernels as pk
        from pota_tpu_torch.render.splat import resolve_aovs

        rc = self.rc
        phase(f"config 5: the differentiable step, {rc.xres}x{rc.yres} "
              "@ 1 spp")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        ops.reset_launches()
        loss, _, fb = self.step()
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"launches in the config 5 step: {launches}", flush=True)
        print(f"config5 resident before the step {resident} GiB", flush=True)
        want = want_launches("config5", trace_chunks_of(self.cfg, rc))
        if {k: v for k, v in launches.items() if v} != want:
            fail(f"config 5: the launches must be {want}, and nothing else")
        with torch.no_grad():
            npix = rc.xres * rc.yres
            w_sum = float(fb["filter_weight"].double().sum())
            for k, v in resolve_aovs(rc, fb).items():
                if not bool(torch.isfinite(v).all()):
                    fail(f"config 5: plane {k} is not finite")
        del fb
        gnorm = [float(c.grad.norm()) for c in self.coeffs]
        print(f"config5 sum(filter_weight) {w_sum:.4f} vs {npix}",
              flush=True)
        if abs(w_sum - npix) > ENERGY_TOL * npix:
            fail("config 5: energy conservation")
        if not all(np.isfinite(g) and g > 0 for g in gnorm):
            fail(f"config 5: gradient norms {gnorm}")
        self.step()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            self.step()
            walls.append(time.perf_counter() - t0)
        print(f"config5_step_s {statistics.median(walls)} (steps "
              f"{' / '.join(f'{w:.4f}' for w in walls)}) {tag}", flush=True)
        print(f"config5_peak_gib {peak} {tag}", flush=True)
        print(f"config5_loss {loss}", flush=True)
        print(f"config5_grad_norm pt {gnorm[0]} ap {gnorm[1]}", flush=True)

        self.descent()
        return launches

    def recording(self):
        """A kernel set that keeps K3's outputs and K2's slot -> source map
        in ``self.k3_out`` and ``self.src``."""
        from pota_tpu_torch import ops

        def po_splat(*a):
            self.k3_out = ops.KERNELS.po_splat(*a)
            return self.k3_out

        def expand(*a):
            self.src = a[0]
            return ops.KERNELS.expand(*a)

        return ops.KERNELS._replace(po_splat=po_splat, expand=expand)

    def l2(self, target, held=None) -> float:
        """The L2 loss toward ``target``, forward only, through
        :meth:`recording`; with ``held`` = (gates, K3 outputs) of an
        earlier frame, its budgets and K3's decisions are those."""
        import torch

        from pota_tpu_torch import ops
        from pota_tpu_torch.render import splat

        rec = self.recording()
        gates = splat.compute_gates_and_budget
        if held is not None:
            def held_k3(*a):
                ops.KERNELS.po_splat(*a)
                return held[1]

            splat.compute_gates_and_budget = lambda *a, **k: held[0]
            rec = rec._replace(po_splat=held_k3)
        try:
            img, _ = self.render(ops=rec)
        finally:
            splat.compute_gates_and_budget = gates
        with torch.no_grad():
            return float(((img.detach() - target) ** 2).double().mean())

    def descent(self) -> None:
        """Three descent steps of JAX's ``train_step_sharded`` L2 loss
        toward the fit's own frame, from seeded 1e-3 perturbed coefficients
        (c1; kept with the target and c1's step for the sharded phase),
        each :data:`DESCENT_STEP` of the coefficients' norm along -g: the
        first-order prediction g . (step taken) beside the measured change
        of the loss, and of the loss with the budgets and K3's decisions
        held at the step's start; whether the splat queue moved, else the
        K3 slots whose ``lin`` or ``ok`` moved.  The first frame after each
        step must fold K3's table again.  Nothing asserts a decrease:
        tests/test_torch_descent.py shows that the L2 loss jumps at every
        step the float32 coefficients can take (PERF.md section 6)."""
        import torch

        from pota_tpu_torch.ops import po_kernels as pk
        from pota_tpu_torch.render import splat

        folds = [0]
        folded_table = pk._folded_table

        def counted_fold(lens, kind, lams, device, on_fold=None):
            def hook():
                folds[0] += kind == "solve"
                if on_fold is not None:
                    on_fold()
            return folded_table(lens, kind, lams, device, on_fold=hook)

        pk._folded_table = counted_fold
        try:
            _, self.target, _ = self.step()
            g = torch.Generator(device=self.dev).manual_seed(5)
            with torch.no_grad():
                for c in self.coeffs:
                    c.mul_(1.0 + 1e-3 * torch.randn(c.shape, generator=g,
                                                    device=self.dev))
            self.c1 = [c.detach().clone() for c in self.coeffs]
            gates_fn = splat.compute_gates_and_budget

            def recording_gates(*a, **k):
                self.gates = gates_fn(*a, **k)
                return self.gates

            for i in range(3):
                splat.compute_gates_and_budget = recording_gates
                try:
                    loss_i, _, _ = self.step(target=self.target,
                                             ops=self.recording())
                finally:
                    splat.compute_gates_and_budget = gates_fn
                held = (self.gates, self.k3_out)
                src_i = self.src
                if i == 0:
                    self.l2_ref = (loss_i, *(c.grad.clone()
                                             for c in self.coeffs))
                with torch.no_grad():
                    gn = torch.sqrt(sum((c.grad.double() ** 2).sum()
                                        for c in self.coeffs))
                    cn = torch.sqrt(sum((c.double() ** 2).sum()
                                        for c in self.coeffs))
                    old = [c.clone() for c in self.coeffs]
                    for c in self.coeffs:
                        c.sub_((c.grad.double() * (DESCENT_STEP * cn / gn))
                               .float())
                    pred = float(sum((c.grad.double() * (c.double()
                                                         - o.double())).sum()
                                     for c, o in zip(self.coeffs, old)))
                before = folds[0]
                loss_held = self.l2(self.target, held=held)
                loss_next = self.l2(self.target)
                if folds[0] == before or not np.isfinite(loss_next):
                    fail(f"config 5 descent step {i} did not fold K3's "
                         "table again")
                moved = "the splat queue moved"
                if torch.equal(self.src, src_i):
                    flips = ((self.k3_out[0] != held[1][0])
                             | (self.k3_out[1] != held[1][1]))
                    moved = (f"K3 slots moved {int(flips.sum())} of "
                             f"{src_i.shape[0]}")
                print(f"config5 descent step {i}: L2 loss {loss_i}; step "
                      f"{DESCENT_STEP:g} of |c|: predicted change {pred:.4e}, "
                      f"measured {loss_next - loss_i:.4e}, with the budgets "
                      f"and K3's decisions held {loss_held - loss_i:.4e} "
                      f"(ratio {(loss_held - loss_i) / pred:.3f}); {moved} "
                      f"(K3 solve tables folded {folds[0] - before})",
                      flush=True)
                del held, src_i
        finally:
            pk._folded_table = folded_table
            self.k3_out = self.src = self.gates = None

    def sharded_step(self, mesh, tag) -> dict:
        """``train_step_sharded`` at world size 1 on the 4K step, from c1
        toward the fit's own frame (:meth:`descent`): one warm-up and one
        timed step (launches counted), its peak memory, the loss and the
        ``pt`` / ``ap`` gradients against c1's single-process step.
        Returns the timed step's launches."""
        import torch

        from pota_tpu_torch import ops
        from pota_tpu_torch.parallel import sharded as sh

        def run():
            with torch.no_grad():
                for c, c1 in zip(self.coeffs, self.c1):
                    c.copy_(c1)
            out = sh.train_step_sharded(self.cfg, self.rc, self.scene, self.m,
                                        mesh, self.target, self.lens,
                                        self.state)
            torch.cuda.synchronize()
            return out

        run()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        loss, grads = run()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"launches in the sharded config 5 step: {launches}",
              flush=True)
        want = want_launches("sharded_config5",
                             trace_chunks_of(self.cfg, self.rc))
        if {k: v for k, v in launches.items() if v} != want:
            fail(f"sharded config 5 step: the launches must be {want}, and "
                 "nothing else")
        ref_loss, *ref = self.l2_ref
        errs = [abs(float(loss) - ref_loss) / abs(ref_loss)] + [
            float((g - r).norm() / r.norm()) for g, r in zip(grads, ref)]
        same = [float(loss) == ref_loss] + [bool(torch.equal(g, r))
                                            for g, r in zip(grads, ref)]
        print(f"sharded_config5_step_s {wall} {tag}", flush=True)
        print(f"sharded_config5_peak_gib {peak} {tag}", flush=True)
        print(f"sharded config 5 step against the single-process step: loss "
              f"{float(loss)} / {ref_loss}, relative errors loss {errs[0]:.3e}"
              f" pt {errs[1]:.3e} ap {errs[2]:.3e}; bit-identical {same}",
              flush=True)
        if max(errs) > SHARDED_STEP_TOL or not all(
                bool(torch.isfinite(g).all()) for g in grads):
            fail("sharded config 5 step disagrees with the single-process "
                 "step")
        return launches


def sharded_phase(dev, tag, m, frames, c5) -> dict:
    """The ``sharded`` phase: a world-size-1 NCCL group (an in-process
    ``HashStore``), ``render_frame_sharded`` on each of ``frames`` (label,
    path, cfg, rc, scene, render kwargs) against ``render_frame``: the
    launches (the path's kernels once each), every plane and the image
    bit-identical, ``sum(filter_weight)``, the frame ms of both (median of
    5); the analytic merge traffic of the flagship at 4 and 8 ranks; then
    config 5's 4K step through ``train_step_sharded``
    (:meth:`Config5.sharded_step`).  The group is destroyed at the end.
    Returns the launches of each path."""
    import torch
    import torch.distributed as dist

    from pota_tpu_torch import ops
    from pota_tpu_torch.parallel import sharded as sh
    from pota_tpu_torch.render.renderer import render_frame

    phase("sharded: render_frame_sharded and train_step_sharded on a "
          "world-size-1 NCCL group")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    out = {}
    try:
        mesh = sh.make_mesh(1, backend="nccl")
        if mesh.device != dev:
            fail(f"sharded: rank 0 took {mesh.device}, not {dev}")
        for label, path, cfg_, rc_, scene_, kw in frames:
            with torch.no_grad():
                ref_img, ref_fb = render_frame(cfg_, rc_, scene_, m, seed=0,
                                               **kw)
                torch.cuda.synchronize()
                ops.reset_launches()
                img, fb = sh.render_frame_sharded(cfg_, rc_, scene_, m, mesh,
                                                  seed=0, **kw)
                torch.cuda.synchronize()
                out[path] = dict(ops.LAUNCHES)
            print(f"launches in the {label} run: {out[path]}", flush=True)
            if {k: v for k, v in out[path].items() if v} != {
                    k: 1 for k in PATH_KERNELS[path]}:
                fail(f"{label}: not each of {PATH_KERNELS[path]} once")
            differ = [k for k in ref_fb if not torch.equal(fb[k], ref_fb[k])]
            if set(fb) != set(ref_fb) or differ or not torch.equal(img,
                                                                    ref_img):
                fail(f"{label}: planes {differ} (or the image) differ from "
                     "render_frame's")
            npix = rc_.xres * rc_.yres
            w_sum = float(fb["filter_weight"].double().sum())
            if abs(w_sum - npix) > ENERGY_TOL * npix:
                fail(f"{label}: sum(filter_weight) {w_sum} != {npix}")
            # float32 channels of the row planes (an [H, W] plane is one)
            n_channels = sum(v.shape[-1] if v.dim() == 3 else 1
                             for v in fb.values())
            del img, fb, ref_img, ref_fb

            def sharded():
                with torch.no_grad():
                    sh.render_frame_sharded(cfg_, rc_, scene_, m, mesh,
                                            seed=0, **kw)

            def single():
                with torch.no_grad():
                    render_frame(cfg_, rc_, scene_, m, seed=0, **kw)

            times = {}
            for name, fn in (("sharded", sharded), ("single", single),
                             ("sharded2", sharded)):
                fn()
                times[name] = host_ms(fn, reps=5)
            print(f"{label}: every plane and the image bit-identical to "
                  f"render_frame's; sum(filter_weight) {w_sum:.4f} vs {npix};"
                  f" {n_channels} channels", flush=True)
            print(f"{path}_frame_ms {times['sharded']} / {times['sharded2']} "
                  f"(render_frame {times['single']}) {tag}", flush=True)
            if path == "sharded_flagship":
                cfg_f, rc_f, scene_f, state_f = (cfg_, rc_, scene_,
                                                 kw["po_state"])
                channels_f = n_channels
            torch.cuda.empty_cache()
        halo = sh.splat_halo_rows(cfg_f, rc_f, scene_f, po_state=state_f)
        for n in (4, 8):
            tile_h = rc_f.yres_region // n
            engaged = (rc_f.yres_region % n == 0
                       and 2 * halo < (n - 1) * tile_h
                       and -(-halo // tile_h) <= n - 1)
            rs, hl = (sh.merge_traffic_bytes(rc_f, n, channels_f, rows)
                      for rows in (None, halo))
            print(f"sharded_flagship merge traffic at {n} ranks ("
                  f"{channels_f} channels, halo {halo} rows, tile {tile_h} "
                  f"rows, the halo exchange "
                  f"{'engaged' if engaged else 'not engaged'}): "
                  f"reduce-scatter {rs} bytes a rank, halo {hl} bytes a "
                  "rank", flush=True)
        out["sharded_config5"] = c5.sharded_step(mesh, tag)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


class GradPath:
    """One differentiable route ``check_supported`` once refused, driven on
    the card: ``render_frame(differentiable=True)`` of ``cfg`` / ``rc`` on
    ``scene`` (``kw``: the lens, the camera at the shutter's end, the
    AOVs), the loss ``loss(rc, img, fb)`` and ``backward()`` into
    ``leaves``; ``parity_rc`` is its parity frame."""

    def __init__(self, path, label, cfg, rc, parity_rc, scene, m, leaves,
                 loss, **kw):
        self.path, self.label, self.cfg, self.rc = path, label, cfg, rc
        self.parity_rc, self.scene, self.m = parity_rc, scene, m
        self.leaves, self.loss, self.kw = leaves, loss, kw

    def forward(self, rc=None, ops=None):
        """The differentiable frame and its loss: (loss, image, fb)."""
        from pota_tpu_torch.render.renderer import render_frame

        rc = rc or self.rc
        for t in self.leaves:
            t.grad = None
        img, fb = render_frame(self.cfg, rc, self.scene, self.m, seed=0,
                               differentiable=True, ops=ops, **self.kw)
        return self.loss(rc, img, fb), img, fb

    def step(self, rc=None, ops=None):
        """One step, synchronised: (loss, image, framebuffer)."""
        import torch

        loss, img, fb = self.forward(rc, ops)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), img.detach(), fb

    def capture(self) -> dict:
        """The arguments of each kernel's first launch in one step."""
        from pota_tpu_torch import ops

        rec = Recorder(ops.KERNELS)
        self.step(ops=rec)
        return rec.args

    def run(self, tag) -> dict:
        """One step with the launch counters set to 0 just before it and
        read just after (the path's kernels once each, K1 and K1v once or
        twice a trace chunk: :func:`want_launches`; nothing else), its
        peak memory, energy, finite planes and gradient norms; a warm-up
        and three timed steps.  Returns the launches."""
        import torch

        from pota_tpu_torch import ops
        from pota_tpu_torch.render.splat import resolve_aovs

        rc = self.rc
        phase(f"{self.path}: {self.label}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        loss, _, fb = self.step()
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"launches in the {self.path} step: {launches}", flush=True)
        want = want_launches(self.path, trace_chunks_of(self.cfg, rc))
        if {k: v for k, v in launches.items() if v} != want:
            fail(f"{self.path}: the launches must be {want}, and nothing "
                 "else")
        with torch.no_grad():
            npix = rc.xres * rc.yres
            w_sum = float(fb["filter_weight"].double().sum())
            for k, v in resolve_aovs(rc, fb, self.kw.get("aovs")).items():
                if not bool(torch.isfinite(v).all()):
                    fail(f"{self.path}: plane {k} is not finite")
        del fb
        gnorm = [float(t.grad.norm()) for t in self.leaves]
        print(f"{self.path} sum(filter_weight) {w_sum:.4f} vs {npix}",
              flush=True)
        if abs(w_sum - npix) > ENERGY_TOL * npix:
            fail(f"{self.path}: energy conservation")
        if not all(np.isfinite(g) and g > 0 for g in gnorm):
            fail(f"{self.path}: gradient norms {gnorm}")
        self.step()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            self.step()
            walls.append(time.perf_counter() - t0)
        print(f"{self.path}_step_s {statistics.median(walls)} (steps "
              f"{' / '.join(f'{w:.4f}' for w in walls)}) {tag}", flush=True)
        print(f"{self.path}_peak_gib {peak} {tag}", flush=True)
        print(f"{self.path}_loss {loss}; gradient norms {gnorm}", flush=True)
        return launches

    def parity(self) -> None:
        """The parity frame through the kernels and through the plain
        versions: the image by the parity frames' pixel limit, every
        leaf's gradient by :data:`CONFIG5_GRAD_TOL`."""
        import torch

        from pota_tpu_torch import ops

        rc = self.parity_rc
        phase(f"parity {self.path} {rc.xres}x{rc.yres} @ {rc.spp} spp, "
              "differentiable: kernels vs plain versions")
        res = {}
        for label, kset in (("kernels", None), ("plain", ops.PLAIN)):
            _, img, fb = self.step(rc, ops=kset)
            res[label] = (img, float(fb["RGBA"].detach().double().sum()),
                          [t.grad.clone() for t in self.leaves])
        off = frac_pixels_off(res["kernels"][0], res["plain"][0])
        g_err = [float((g - r).norm() / r.norm())
                 for g, r in zip(res["kernels"][2], res["plain"][2])]
        print(f"  RGBA: pixels off {off:.5f}; energy kernels "
              f"{res['kernels'][1]:.6f} plain {res['plain'][1]:.6f}; "
              f"gradient rel L2 {' '.join(f'{e:.3e}' for e in g_err)}",
              flush=True)
        if (off > MAX_PIXELS_OFF or max(g_err) > CONFIG5_GRAD_TOL
                or abs(res["kernels"][1] - res["plain"][1])
                > 2e-3 * abs(res["plain"][1])
                or not bool(torch.isfinite(res["kernels"][0]).all())
                or not all(bool(torch.isfinite(g).all())
                           for g in res["kernels"][2])):
            fail(f"{self.path} parity: image, energy or gradient")


def k6_record(a6, path, ptxas) -> dict:
    """K6 (one table) against its plain version on the captured arguments
    ``a6`` of ``path``, and its record."""
    from pota_tpu_torch.ops import po_kernels as pk

    items6 = (1, 2, 3, 4, 5, 7)        # lams (6) is a tuple of floats
    s6 = int(a6[1].shape[0])
    got = pk.po_backward(*a6)
    ref = plain_chunked(pk.po_backward_plain, a6, items6)
    keep_g, keep_p = got[4] > 0, ref[4] > 0
    agree = float((keep_g == keep_p).double().mean())
    both = keep_g & keep_p
    err = max(float((g[both] - r[both]).abs().max())
              for g, r in zip(got[:2], ref[:2]))
    far = share_far(got, ref, both)
    print(f"K6 po_backward ({path}) S={s6} trans>0 agree={agree:.6f} "
          f"max_abs_err(sx, sy) on items both keep {err:.3e} mm; share of "
          f"items > 1e-3 mm apart {far:.6f}", flush=True)
    if agree < MASK_AGREE or far > 1.0 - MASK_AGREE:
        fail(f"K6 po_backward ({path}) disagrees with its plain version")
    del got, ref, keep_g, keep_p, both
    return dict(
        name="po_backward", path=path, route="cuda",
        source="pota_tpu_torch/csrc/po_backward.cu",
        replaces=f"{TPU_KERNELS}:419", max_abs_err=err,
        ms=median_ms(lambda: pk.po_backward(*a6)),
        plain_ms=median_ms(lambda: plain_chunked(
            pk.po_backward_plain, a6, items6), 3),
        **bound(44.0 * s6, s6 * basis_solve_flops(a6[8])),
        library_ms=None, n=s6, mask_agree=agree, share_far=far,
        **ptxas["po_backward"])


def grad_paths(dev, m, m_end, res=(1920, 1080), res1=(256, 256, 16),
               parity_res=(256, 144), parity_res1=(64, 64, 4)) -> dict:
    """The differentiable routes' paths (:class:`GradPath` by name):
    ``grad_mb_1080p`` (config 5's camera, ``trace_chunks`` 8, the teapot,
    the camera trucked as ``flagship_mb``'s, 1920x1080 @ 1 spp; K2, K6,
    K4), ``grad_aovs_1080p`` (the same camera on ``flagship_idmatte``'s
    glass teapot with a gaussian transmission plane beside RGBA, which the
    output string ``transmission RGB gaussian_filter`` parses to: K4 sums
    nine payload columns; K2, K3, K4), ``grad_config1`` (BASELINE config
    1, gradients of the scene's albedo, emission and centers and of
    ``cam_to_world``; K2, K5, K4) and ``grad_config1_coma`` (config 1
    with ``abb_coma`` 0.5, the decomposed thin lens: K2 and K4 only).
    ``res`` / ``res1`` are the PO and thin-lens frames, ``parity_res`` /
    ``parity_res1`` their parity frames (width, height[, spp])."""
    import pota_tpu_torch as pt
    from pota_tpu_torch.optics.fit import load_poly_lens
    from pota_tpu_torch.optics.focus import setup_po_camera
    from pota_tpu_torch.render import scene as sc
    from pota_tpu_torch.render.aov import DEFAULT_AOVS, GAUSSIAN, AOVSpec
    from pota_tpu_torch.render.splat import resolve_aovs

    def mean_rgb(rc, img, fb):
        return img[..., :3].mean()

    # the output string "transmission RGB gaussian_filter": the stream's
    # transmission has three channels, so an "RGBA" plane of it would not
    # resolve, in JAX either
    aovs_t = list(DEFAULT_AOVS) + [
        AOVSpec("transmission", "RGB", GAUSSIAN, "transmission")]

    def mean_rgb_and_transmission(rc, img, fb):
        tr = resolve_aovs(rc, fb, aovs_t)["transmission"]
        return img[..., :3].mean() + tr[..., :3].mean()

    cfg5 = pt.CameraConfig(
        camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
        fstop=2.8, focus_distance=20.0, vignetting_retries=2,
        splat_queue_mult=4, trace_chunks=8)
    rc_full = pt.RenderConfig(xres=res[0], yres=res[1], spp=1)
    rc_par = pt.RenderConfig(xres=parity_res[0], yres=parity_res[1], spp=1)

    def po(scene):
        lens = load_poly_lens(FLAGSHIP, device=dev)
        state = setup_po_camera(lens, cfg5, scene=scene)
        return dict(po_lens=lens, po_state=state), [
            lens.pt.coeffs.requires_grad_(True),
            lens.ap.coeffs.requires_grad_(True)]

    teapot = sc.teapot_scene(device=dev)
    po_mb, leaves_mb = po(teapot)
    glass = glass_teapot(dev)
    po_g, leaves_g = po(glass)
    cfg1 = pt.CameraConfig(focal_length=50.0, fstop=1.4, focus_distance=150.0,
                           vignetting_retries=3, splat_queue_mult=8)
    scene1 = sc.teapot_scene(device=dev)
    m1 = m.clone().requires_grad_(True)
    leaves1 = [scene1.albedo.requires_grad_(True),
               scene1.emission.requires_grad_(True),
               scene1.centers.requires_grad_(True), m1]
    rc1 = pt.RenderConfig(xres=res1[0], yres=res1[1], spp=res1[2])
    rc1_par = pt.RenderConfig(xres=parity_res1[0], yres=parity_res1[1],
                              spp=parity_res1[2])
    po_label = f"{rc_full.xres}x{rc_full.yres} @ 1 spp"
    thin_label = f"{rc1.xres}x{rc1.yres} @ {rc1.spp} spp"
    paths = {
        "grad_mb_1080p": GradPath(
            "grad_mb_1080p", "camera motion blur, the decomposed PO route, "
            + po_label, cfg5, rc_full, rc_par, teapot, m, leaves_mb,
            mean_rgb, cam_to_world_end=m_end, **po_mb),
        "grad_aovs_1080p": GradPath(
            "grad_aovs_1080p", "a gaussian transmission AOV beside RGBA, "
            "K3, " + po_label, cfg5, rc_full, rc_par, glass, m, leaves_g,
            mean_rgb_and_transmission, aovs=aovs_t, **po_g),
        "grad_config1": GradPath(
            "grad_config1", "BASELINE config 1's thin lens, K5, "
            + thin_label, cfg1, rc1, rc1_par, scene1, m1, leaves1,
            mean_rgb),
        "grad_config1_coma": GradPath(
            "grad_config1_coma", "config 1 with coma 0.5, the decomposed "
            "thin lens, " + thin_label,
            dataclasses.replace(cfg1, abb_coma=0.5), rc1, rc1_par, scene1,
            m1, leaves1, mean_rgb),
    }
    return paths


def grad_routes_phase(dev, tag, m, m_end, ptxas, **sizes) -> tuple:
    """The three differentiable routes (:func:`grad_paths`, ``sizes`` its
    frame sizes), each a counted step, three timed steps and its parity
    frame (:class:`GradPath`), then their kernels against the plain
    versions on the steps' own arguments: K2 on ``grad_mb_1080p``'s,
    ``grad_aovs_1080p``'s and ``grad_config1``'s, K3 on
    ``grad_aovs_1080p``'s (the plain version on the first
    :data:`CONFIG5_PLAIN_SLOTS` slots), K6 on ``grad_mb_1080p``'s, K4 on
    ``grad_aovs_1080p``'s (nine payload columns), K5 on
    ``grad_config1``'s.  Returns (the launches of each path, the kernel
    records)."""
    import torch

    from pota_tpu_torch.ops import po_kernels as pk, splat_accum

    paths = grad_paths(dev, m, m_end, **sizes)
    launches = {}
    for path, gp in paths.items():
        launches[path] = gp.run(tag)
        gp.parity()
        torch.cuda.empty_cache()

    phase("differentiable routes: kernels vs plain versions on the steps' "
          "arguments")
    records = []
    caps = {path: paths[path].capture() for path in (
        "grad_mb_1080p", "grad_aovs_1080p", "grad_config1")}
    with torch.no_grad():
        for path, cap in caps.items():
            records.append(k2_record(cap.pop("expand"), ptxas, path))
        a3 = caps["grad_aovs_1080p"].pop("po_splat")
        k3 = check_splat_kernel(
            "po_splat", pk.po_splat, pk.po_splat_plain, a3, slice(1, 10),
            "pota_tpu_torch/csrc/po_splat.cu", f"{TPU_KERNELS}:697", 41.0,
            basis_solve_flops(a3[13]) + 60
            + 20 * paths["grad_aovs_1080p"].scene.n_objects + 20,
            plain_reps=3, plain_n=CONFIG5_PLAIN_SLOTS)
        k3.update(path="grad_aovs_1080p", **ptxas["po_splat"])
        records.append(k3)
        del a3
        args = {path: caps.pop(path)[name] for path, name in (
            ("grad_mb_1080p", "po_backward"),
            ("grad_aovs_1080p", "segment_accum"),
            ("grad_config1", "tl_splat"))}
        records.append(k6_record(args.pop("grad_mb_1080p"), "grad_mb_1080p",
                                 ptxas))
        a4 = args.pop("grad_aovs_1080p")
        if a4[2].shape[1] != 9:
            fail(f"grad_aovs_1080p: K4's payload is {a4[2].shape[1]} "
                 "columns wide, not 9")
        seg = splat_accum.segment_accum
        seg_plain = splat_accum.segment_accum_plain
        err4 = check_accum("grad_aovs_1080p", seg, seg_plain, a4)
        records.append(dict(
            name="segment_accum", path="grad_aovs_1080p", route="cuda",
            source="pota_tpu_torch/csrc/segment_accum.cu",
            replaces="pota_tpu/ops/splat_accum.py:59", max_abs_err=err4,
            **timed_ms(lambda: seg(*a4)),
            plain_ms=median_ms(lambda: seg_plain(*a4)), **accum_bound(a4),
            row_gather_ms=row_gather_ms(a4), library_ms=None,
            n=int(a4[0].shape[0]), k=int(a4[2].shape[1]),
            **ptxas["segment_accum"]))
        del a4
        a5 = args.pop("grad_config1")
        k5 = check_splat_kernel(
            "tl_splat", pk.tl_splat, pk.tl_splat_plain, a5, slice(0, 9),
            "pota_tpu_torch/csrc/tl_splat.cu", f"{TPU_KERNELS}:958", 41.0,
            85.0 + 20 * paths["grad_config1"].scene.n_objects)
        k5.update(path="grad_config1", **timed_ms(lambda: pk.tl_splat(*a5)),
                  **ptxas["tl_splat"])
        records.append(k5)
        del a5
    for r in records:
        print(f"{r['name']} ({r['path']}): kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}) {tag}", flush=True)
    torch.cuda.empty_cache()
    return launches, records


def fit_fidelity(poly, lens, n: int = FIT_HELDOUT_RAYS):
    """rms (position mm, slope, iris mm) of a fit against the port's own
    tracer on fresh held-out rays (tests/test_fit_fidelity.py's measure)."""
    import torch
    from pota_tpu_torch.optics import fit as tfit
    from pota_tpu_torch.optics.polynomial import poly_eval
    from pota_tpu_torch.optics.raytrace import trace_to_chart

    samples, _, _ = tfit.sample_fit_domain(lens, n, seed=FIT_HELDOUT_SEED)
    with torch.no_grad():
        s = torch.as_tensor(samples, device=lens.device)
        out, _, ap_xy, v = trace_to_chart(lens, s)
        pt = poly_eval(poly.pt, s)[v]
        ap = poly_eval(poly.ap, s)[v]
    if int(v.sum()) < 10:
        fail(f"fit_catalog {lens.name}: too few valid held-out rays")
    rms = lambda a: float(torch.sqrt((a.double() ** 2).mean()))
    return (rms(pt[:, :2] - out[v, :2]), rms(pt[:, 2:4] - out[v, 2:4]),
            rms(ap - ap_xy[v]))


def term_set(poly) -> set:
    return {tuple(e) for e in poly.pt.exponents.tolist()}


def fit_catalog(dev, tag) -> dict:
    """Refit the catalog on the card with JAX's defaults, one lens per base
    design first; each fit held to the fidelity gate.  Returns the fits."""
    import torch
    from pota_tpu_torch.lens import database as db
    from pota_tpu_torch.optics import fit as tfit

    names = db.lens_names()
    first = {}       # one lens per base design, the flagship for its own
    for name in [FLAGSHIP] + names:
        first.setdefault(db.CATALOG[name][0], name)
    order = list(first.values()) + [n for n in names
                                    if n not in first.values()]
    fits, secs, cut, by_design = {}, [], [], {}
    t_all = time.perf_counter()
    for name in order:
        if (name not in first.values()
                and time.perf_counter() - t_all > FIT_BUDGET_S):
            cut.append(name)
            continue
        lens = db.get_lens_system(name, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poly, diag = tfit.fit_lens(lens, return_diagnostics=True, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        rms = fit_fidelity(poly, lens)
        limit = FIT_THRESH_BY_FAMILY.get(name.split("__")[1], FIT_THRESH)
        committed = tfit.load_poly_lens(name, device=dev)
        shared = (len(term_set(poly) & term_set(committed))
                  if committed is not None else None)
        print(f"fit {name}: {secs[-1]:.3f} s, valid_frac "
              f"{diag['valid_frac']:.4f}, terms {diag['n_terms']}, shared "
              f"with the committed fit {shared}, held-out rms pos "
              f"{rms[0]:.5f} dir {rms[1]:.6f} ap {rms[2]:.5f} (limits "
              f"{limit}), design singular values {diag['min_singular']:.3e}"
              f"..{diag['max_singular']:.3e} rank {diag['rank']}",
              flush=True)
        if any(r > t for r, t in zip(rms, limit)):
            fail(f"fit_catalog {name}: held-out rms {rms} over {limit}")
        fam = by_design.setdefault(db.CATALOG[name][0], dict(
            lenses=0, min_rank=diag["rank"], min_singular=diag["min_singular"],
            min_shared=shared))
        fam["lenses"] += 1
        fam["min_rank"] = min(fam["min_rank"], diag["rank"])
        fam["min_singular"] = min(fam["min_singular"], diag["min_singular"])
        if shared is not None:
            fam["min_shared"] = min(fam["min_shared"] or shared, shared)
        fits[name] = poly
    total = time.perf_counter() - t_all
    print(f"fit_catalog_total_s {total} ({len(fits)} fits) {tag}", flush=True)
    print(f"fit_catalog_s_per_fit {statistics.median(secs)} (median; first "
          f"{secs[0]}) {tag}", flush=True)
    print(f"fit_catalog by base design (lenses, the least rank of the valid "
          f"rays' design, its least singular value, the fewest terms shared "
          f"with a committed fit): {json.dumps(by_design)}", flush=True)
    if cut:
        print(f"fit_catalog: the fits passed {FIT_BUDGET_S} s, so the rest "
              f"of the catalog was cut to one lens per base design; left "
              f"out {len(cut)}: {cut}", flush=True)
    return fits


def deriv_check(trace64, samples, live, xres: int, yres: int, derivs,
                label: str, seed: int = 5) -> None:
    """Hold ray differentials on DERIV_CHECK_RAYS seeded live rays to
    central differences of ``trace64(sx, sy)`` (the deriv-ray path in
    float64), DERIV_STEP of a pixel each way."""
    import torch

    idx = torch.nonzero(live)[:, 0]
    rng = np.random.default_rng(seed)
    pick = rng.choice(idx.numel(), min(DERIV_CHECK_RAYS, idx.numel()),
                      replace=False)
    idx = idx[torch.as_tensor(np.sort(pick), device=idx.device)]
    s = {k: samples[k][idx].double() for k in ("sx", "sy", "r1", "r2")}
    hx, hy = 2.0 / xres * DERIV_STEP, 2.0 / yres * DERIV_STEP
    with torch.no_grad():
        ox1, dx1 = trace64(s, s["sx"] + hx, s["sy"])
        ox0, dx0 = trace64(s, s["sx"] - hx, s["sy"])
        oy1, dy1 = trace64(s, s["sx"], s["sy"] + hy)
        oy0, dy0 = trace64(s, s["sx"], s["sy"] - hy)
    fd = {"dOdx": (ox1 - ox0) / (2 * DERIV_STEP),
          "dDdx": (dx1 - dx0) / (2 * DERIV_STEP),
          "dOdy": (oy1 - oy0) / (2 * DERIV_STEP),
          "dDdy": (dy1 - dy0) / (2 * DERIV_STEP)}
    for k, want in fd.items():
        got = derivs[k][idx].double()
        err = (got - want).abs()
        bad = err > DERIV_ATOL + DERIV_RTOL * want.abs()
        rel = float((got - want).norm() / want.norm().clamp(min=1e-30))
        print(f"{label} {k}: max |jvp - fd| {float(err.max()):.3e} on "
              f"values up to {float(want.abs().max()):.3e}, relative L2 "
              f"{rel:.3e}, {int(bad.sum())} of {idx.numel()} rays outside "
              f"rtol {DERIV_RTOL} atol {DERIV_ATOL}", flush=True)
        if bool(bad.any()):
            fail(f"{label} {k}: differentials disagree with float64 central "
                 f"differences")


def fit_phase(dev, tag, cfg, rc, scene, m, po, drive) -> dict:
    """Phase 12: the catalog refitted on the card, the flagship frame with
    the fresh fit, and the command line fitting a lens with no committed
    fit.  Returns the launches of the fresh fit's frame."""
    import os
    import tempfile

    import torch
    from pota_tpu_torch import cli
    from pota_tpu_torch.io.exr import read_exr
    from pota_tpu_torch.ops import po_kernels as pk
    from pota_tpu_torch.optics import fit as tfit
    from pota_tpu_torch.optics.focus import setup_po_camera
    from pota_tpu_torch.render.renderer import render_frame
    from pota_tpu_torch.render.splat import resolve_imager

    phase("fit_catalog: refit the catalog on the card (degree 5, 200,000 "
          "samples, 160 terms, seed 0)")

    def lens_files():
        return sorted((f, os.path.getmtime(os.path.join(tfit.LENS_DIR, f)))
                      for f in os.listdir(tfit.LENS_DIR))

    data_before = lens_files()
    fits = fit_catalog(dev, tag)
    fresh = fits[FLAGSHIP]
    del fits
    pk.check_basis(fresh)
    po_fresh = dict(po_lens=fresh, po_state=setup_po_camera(fresh, cfg))
    print(f"setup_po_camera (fresh flagship fit) {po_fresh['po_state']}",
          flush=True)
    launches, fb = drive("flagship with the card's fresh fit",
                         "flagship_fresh_fit", cfg, rc, scene, **po_fresh)
    if {k: v for k, v in launches.items() if v} != {
            k: 1 for k in PATH_KERNELS["flagship_fresh_fit"]}:
        fail(f"flagship_fresh_fit: launches {launches}, not one of each of "
             f"K1-K4")
    with torch.no_grad():
        e_fresh = float(resolve_imager(rc, fb)[..., :3].double().sum())
        del fb
        img, _ = render_frame(cfg, rc, scene, m, seed=0, **po)
        e_committed = float(img[..., :3].double().sum())
        del img
    print(f"flagship_fresh_fit energy {e_fresh} against the committed "
          f"fit's {e_committed} (relative {e_fresh / e_committed - 1.0:+.4e})"
          f" {tag}", flush=True)
    del po_fresh, fresh
    torch.cuda.empty_cache()

    # the command line with a lens that has no committed fit
    cached = os.path.join(tfit.FIT_CACHE_DIR, "double_gauss__deg5.npz")
    if os.path.exists(cached):
        os.remove(cached)
    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/dg.exr"
        t0 = time.perf_counter()
        if cli.main(["--camera", "po", "--lens", "double_gauss", "--scene",
                     "lightgrid", "--res", "512", "--spp", "1",
                     "--out", out]) != 0:
            fail("cli --lens double_gauss: non-zero exit")
        print(f"cli_fit_s {time.perf_counter() - t0} {tag}", flush=True)
        planes = read_exr(out)
    if not all(np.isfinite(v).all() for v in planes.values()):
        fail("cli --lens double_gauss: channels not finite")
    if not os.path.exists(cached):
        fail(f"cli --lens double_gauss: no fit cached at {cached}")
    if lens_files() != data_before:
        fail("fit_catalog: data/lenses/ changed")
    print(f"cli --lens double_gauss fitted into {cached}; data/lenses/ "
          f"unchanged ({len(data_before)} files)", flush=True)
    torch.cuda.empty_cache()
    return {"flagship_fresh_fit": launches}


def k1j_record(a, ptxas, tag) -> dict:
    """K1j on the arguments ``a`` of the 1080p PO differentials: its primal
    identical to K1's on every ray, and against its plain version (1M-ray
    chunks) ``trans > 0`` agreement, the primal's largest error and the
    Jacobian's relative L2 on the rays both keep; its record."""
    import torch

    from pota_tpu_torch.ops import _build, po_kernels as pk

    got = pk.po_forward_jvp(*a)
    k1 = pk.po_forward(*a)
    same = all(torch.equal(g, k) for g, k in zip(got[:4], k1))
    del k1
    ref = plain_chunked(pk.po_forward_jvp_plain, a, slice(1, 5))
    ok_g, ok_p = got[1] > 0, ref[1] > 0
    agree = float((ok_g == ok_p).double().mean())
    both = ok_g & ok_p
    primal_err = max(float((g[both] - r[both]).abs().max())
                     for g, r in zip(got[:4], ref[:4]))
    jg, jr = got[4][both].double(), ref[4][both].double()
    jac_rel = float((jg - jr).norm() / jr.norm())
    jac_abs = float((jg - jr).abs().max())
    n = int(a[1].shape[0])
    print(f"K1j po_forward_jvp (derivs_po) N={n}: primal identical to K1's "
          f"{same}; against its plain version trans>0 agree={agree:.6f}, "
          f"primal max_abs_err {primal_err:.3e} mm, Jacobian relative L2 "
          f"{jac_rel:.3e} (max abs {jac_abs:.3e}) on the rays both keep",
          flush=True)
    if (not same or agree < MASK_AGREE or primal_err > 1e-5
            or jac_rel > JVP_TOL):
        fail("K1j po_forward_jvp disagrees with K1 or its plain version")
    del got, ref, ok_g, ok_p, both, jg, jr
    rec = dict(
        name="po_forward_jvp", path="derivs_po", route="cuda",
        source="pota_tpu_torch/csrc/po_forward_jvp.cu",
        replaces=f"{TPU_KERNELS}:83",
        role="K1's forward derivative; no TPU kernel: JAX takes jax.jvp of "
             "its pure path (pota_tpu/render/renderer.py:126-131)",
        max_abs_err=jac_abs, jac_rel_l2=jac_rel,
        primal_max_abs_err=primal_err, primal_identical_to_k1=same,
        ms=median_ms(lambda: pk.po_forward_jvp(*a)),
        plain_ms=median_ms(
            lambda: plain_chunked(pk.po_forward_jvp_plain, a, slice(1, 5)),
            3),
        k1_ms=median_ms(lambda: pk.po_forward(*a)),
        **bound(76.0 * n, n * basis_forward_jvp_flops(a[7])),
        library_ms=None, n=n, mask_agree=agree,
        blocks_per_sm=_build.lib().pota_po_forward_jvp_blocks_per_sm(),
        **ptxas["po_forward_jvp"])
    print(f"po_forward_jvp (derivs_po): {rec['ms']:.3f} ms at N={n} (K1 on "
          f"the same rays {rec['k1_ms']:.3f} ms), plain "
          f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
          f"({rec['bound_by']}), {rec['registers']} registers, "
          f"{rec['spill_bytes']} spill bytes, {rec['blocks_per_sm']} blocks "
          f"of 256 an SM {tag}", flush=True)
    return rec


def term_trace_derivs(cfg, rc, smp, lens, state) -> dict:
    """The PO differentials by the route K1j replaced: the primary rays
    through ``trace_camera_rays`` (K1), then one ``torch.func.jvp`` per
    pixel step over the deriv ray's term trace
    (``trace_fw_po(deriv_ray=True)``, ``_ApertureSolve.jvp``).  Returns
    {"dOdx", "dOdy", "dDdx", "dDdy"}."""
    import torch
    from pota_tpu_torch.models.po_camera import trace_fw_po
    from pota_tpu_torch.render.renderer import trace_camera_rays

    trace_camera_rays(cfg, smp, po_lens=lens, po_state=state)

    def deriv_trace(sx, sy):
        return trace_fw_po(cfg, lens, sx, sy, smp["r1"], smp["r2"], None,
                           state, deriv_ray=True)[:2]

    zeros = torch.zeros_like(smp["sx"])
    (dOdx, dDdx), (dOdy, dDdy) = (
        torch.func.jvp(deriv_trace, (smp["sx"], smp["sy"]), t)[1]
        for t in ((torch.full_like(zeros, 2.0 / rc.xres), zeros),
                  (zeros, torch.full_like(zeros, 2.0 / rc.yres))))
    return {"dOdx": dOdx, "dOdy": dOdy, "dDdx": dDdx, "dDdy": dDdy}


def derivs_phase(dev, tag, rc, lens, cfg_po, state_po, cfg_thin,
                 ptxas) -> tuple:
    """Phase 13: ray differentials of a full frame, PO (K1 for the primary
    rays, K1j once for both axes) and thin lens (no kernel), held to
    float64 central differences of the deriv ray's term trace
    (``trace_fw_po(deriv_ray=True)`` on a float64 lens); K1j held to K1
    and to its plain version on the frame's arguments
    (:func:`k1j_record`); the PO differentials also by the route before
    K1j (:func:`term_trace_derivs`: K1's primary rays and the term trace's
    ``torch.func.jvp`` on the card), once, its ms and peak memory beside
    K1j's route.  Returns (the launches of each run, [K1j's record])."""
    import copy

    import torch
    from pota_tpu_torch import ops
    from pota_tpu_torch.models.po_camera import trace_fw_po
    from pota_tpu_torch.optics import thinlens
    from pota_tpu_torch.render import sampling
    from pota_tpu_torch.render.renderer import trace_camera_rays_with_derivs

    phase(f"derivs {rc.xres}x{rc.yres} @ {rc.spp} spp: "
          f"trace_camera_rays_with_derivs, PO (config 2's camera) and thin "
          f"lens (config 1's camera)")
    lens64 = copy.deepcopy(lens).double()
    out, records = {}, []
    for path, cfg_d, kw, trace64 in (
            ("derivs_po", cfg_po, dict(po_lens=lens, po_state=state_po),
             lambda s, sx, sy: trace_fw_po(
                 cfg_po, lens64, sx, sy, s["r1"], s["r2"], None, state_po,
                 deriv_ray=True)[:2]),
            ("derivs_thin", cfg_thin, {},
             lambda s, sx, sy: thinlens.trace_fw_thinlens(
                 cfg_thin, sx, sy, s["r1"], s["r2"], deriv_ray=True)[:2])):
        smp = sampling.frame_samples(rc, 0, device=dev)

        def run(**extra):
            return trace_camera_rays_with_derivs(cfg_d, rc, smp, **kw,
                                                 **extra)

        if path == "derivs_po":
            rec = Recorder(ops.KERNELS)
            run(ops=rec)
            with torch.no_grad():
                records.append(k1j_record(rec.args.pop("po_forward_jvp"),
                                          ptxas, tag))
            del rec
            torch.cuda.empty_cache()
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        _, _, w, der = run()
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"launches in the {path} run: {launches}", flush=True)
        if {k: v for k, v in launches.items() if v} != {
                k: 1 for k in PATH_KERNELS[path]}:
            fail(f"{path}: launches {launches}, want {PATH_KERNELS[path]} "
                 f"once each")
        live = w > 0
        print(f"{path} live rays {int(live.sum())} of {live.numel()}",
              flush=True)
        for k, v in der.items():
            if not bool(torch.isfinite(v[live]).all()):
                fail(f"{path}: {k} not finite on live rays")
        deriv_check(trace64, smp, live, rc.xres, rc.yres, der, path)
        ms = host_ms(run)
        print(f"{path}_ms {ms} {tag}", flush=True)
        print(f"{path}_peak_device_gb {peak} {tag}", flush=True)
        if path == "derivs_po":
            # the route before K1j: the term trace under torch.func.jvp
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            terms = term_trace_derivs(cfg_d, rc, smp, lens, state_po)
            torch.cuda.synchronize()
            terms_ms = (time.perf_counter() - t0) * 1e3
            terms_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            gap = max(float((der[k] - terms[k])[live].abs().max())
                      for k in der)
            print(f"derivs_po by the term trace's torch.func.jvp (one run): "
                  f"{terms_ms} ms, peak {terms_peak} GiB; K1j's route "
                  f"{ms} ms, peak {peak} GiB; the two routes' differentials "
                  f"at most {gap:.3e} apart on live rays {tag}", flush=True)
            del terms
        del der, w, live
        out[path] = launches
        del smp
        torch.cuda.empty_cache()
    return out, records


def replay_phase(dev, tag, cfg, rc, scene, m, po) -> dict:
    """Phase 14: a frame's stream captured to a file, read back onto the
    card and replayed with the scene (against the live frame) and without
    one (the decomposed route).  Returns the launches of both replays."""
    import os
    import tempfile

    import torch
    from pota_tpu_torch import ops
    from pota_tpu_torch.render import replay, splat as tsplat
    from pota_tpu_torch.render.renderer import (
        render_frame, render_sample_stream)

    phase(f"replay {rc.xres}x{rc.yres} @ {rc.spp} spp: the flagship's "
          f"stream saved, read back and re-splatted")
    with torch.no_grad():
        img_live, fb_live = render_frame(cfg, rc, scene, m, seed=0, **po)
        stream = render_sample_stream(cfg, rc, scene, m, 0, **po)
    n_rows = stream["rgba"].shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        cap = f"{tmp}/flagship.pstream"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay.save_capture(cap, stream)
        write_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(cap)
        if size != 24 + n_rows * len(replay.FIELDS) * 4:
            fail(f"replay: capture of {size} bytes for {n_rows} rows")
        del stream
        t0 = time.perf_counter()
        loaded = replay.load_capture(cap, device=dev)
        torch.cuda.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
    print(f"replay capture {n_rows} x {len(replay.FIELDS)} float32, {size} "
          f"bytes; replay_write_ms {write_ms} replay_read_ms {read_ms} {tag}",
          flush=True)
    out = {}

    def replay_run(label, path, scene_):
        with torch.no_grad():
            ops.reset_launches()
            img_, fb_ = replay.replay_splat(cfg, rc, loaded, m, scene=scene_,
                                            **po)
            torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        print(f"launches in the {label} run: {launches} (route "
              f"{tsplat.LAST_ROUTE})", flush=True)
        if {k: v for k, v in launches.items() if v} != {
                k: 1 for k in PATH_KERNELS[path]}:
            fail(f"{label}: launches {launches}, want {PATH_KERNELS[path]} "
                 f"once each")
        if not bool(torch.isfinite(img_).all()):
            fail(f"{label}: image not finite")
        out[path] = launches
        return img_, fb_

    img_r, fb_r = replay_run("replay with the scene", "replay", scene)
    e_live = float(img_live[..., :3].double().sum())
    e_r = float(img_r[..., :3].double().sum())
    off = frac_pixels_off(img_r, img_live)
    same = all(torch.equal(fb_r[k], fb_live[k]) for k in fb_live)
    print(f"replay energy {e_r} against the live frame's {e_live} "
          f"(relative {e_r / e_live - 1.0:+.3e}), pixels off {off}, "
          f"framebuffer planes bit-identical: {same}, image bit-identical: "
          f"{torch.equal(img_r, img_live)}", flush=True)
    if abs(e_r - e_live) > REPLAY_ENERGY_TOL * abs(e_live):
        fail("replay: energy off the live frame's")
    if off > MAX_PIXELS_OFF:
        fail(f"replay: {off} of pixels off the live frame")
    del fb_r, fb_live, img_r, img_live
    ms = host_ms(lambda: replay.replay_splat(cfg, rc, loaded, m, scene=scene,
                                             **po))
    print(f"replay_splat_ms {ms} {tag}", flush=True)

    img_n, fb_n = replay_run("replay without a scene", "replay_null", None)
    if tsplat.LAST_ROUTE != "decomposed_po":
        fail(f"replay without a scene took the {tsplat.LAST_ROUTE} route")
    e_n = float(img_n[..., :3].double().sum())
    if not e_n > 0.0:
        fail("replay without a scene: no energy")
    del img_n, fb_n
    ms = host_ms(lambda: replay.replay_splat(cfg, rc, loaded, m, **po))
    print(f"replay_null energy {e_n}; replay_null_splat_ms {ms} {tag}",
          flush=True)
    del loaded
    torch.cuda.empty_cache()
    return out


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
    from pota_tpu_torch.render.aov import DEFAULT_AOVS, GAUSSIAN, AOVSpec
    from pota_tpu_torch.render.bokeh_image import build_bokeh_cdf
    from pota_tpu_torch.render.renderer import (
        look_at, render_frame, render_sample_stream)
    from pota_tpu_torch.render import splat as tsplat
    from pota_tpu_torch.render.crypto import crypto_topk
    from pota_tpu_torch.render.splat import (
        chroma_wavelengths, resolve_aovs, resolve_crypto, splat_frame)

    phase("build")
    t0 = time.perf_counter()
    _build.lib()
    print(f"build_s {time.perf_counter() - t0:.2f} "
          f"(nvcc {_build.build_info['seconds']:.2f} s, "
          f"cached={_build.build_info['cached']})", flush=True)
    entries = _build.ptxas_entries()
    for mangled, info in sorted(entries.items()):
        print(f"ptxas {mangled}: {info}", flush=True)
    # every kernel's registers and spills
    ptxas = {}
    for name, key, label in (
            ("po_forward", "17po_forward_kernelE",
             "K1 (the folded forward, its candidate mode)"),
            ("po_forward_selected", "po_forward_select_kernel",
             "K1's select mode (it hands back rays)"),
            ("po_splat", "po_splat_kernelILi0E",
             "K3 flagship instantiation (SPLAT_DISK, the basis solve)"),
            ("po_splat_lam", "po_splat_kernelILi1E",
             "K3b per-slot-wavelength instantiation (SPLAT_DISK_LAM)"),
            ("po_splat_ext", "po_splat_kernelILi2E",
             "K3b external-aperture instantiation (SPLAT_EXTERNAL)"),
            ("po_backward", "po_backward_kernel", "K6 (the basis solve)"),
            ("po_forward_vjp", "po_forward_vjp_kernelILb0E",
             "K1v (K1's VJP on the folded table)"),
            ("po_forward_vjp_selected", "po_forward_vjp_kernelILb1E",
             "K1v's select mode (the rays' cotangents through the chart)"),
            ("po_forward_vjp_finish", "po_forward_vjp_finish",
             "K1v's float64 sums and unfold"),
            ("po_forward_jvp", "po_forward_jvp_kernel",
             "K1j (K1's JVP on the folded table)"),
            ("expand", "expand_kernelILi4E", "K2 (four slots a thread)"),
            ("segment_accum", "segment_tile_kernel", "K4 tiles"),
            ("segment_carry", "segment_carry_kernel", "K4 carries"),
            ("tl_splat", "tl_splat_kernel", "K5")):
        found = [v for k, v in entries.items() if key in k]
        if len(found) != 1:
            fail(f"no ptxas report for {label}")
        info = found[0]
        ptxas[name] = dict(
            registers=info.get("registers"),
            spill_bytes=info.get("spill_stores", 0) + info.get(
                "spill_loads", 0))
        print(f"{label}: {info.get('registers')} registers, "
              f"{info.get('stack')} bytes stack frame, "
              f"{info.get('spill_stores')} bytes spill stores, "
              f"{info.get('spill_loads')} bytes spill loads", flush=True)

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
    # flagship_mb: the camera trucks 2 units across the shutter
    m_end = look_at([2.0, 0, 0], [2.0, 0, -1], device=dev)
    t0 = time.perf_counter()
    state = setup_po_camera(lens, cfg)
    print(f"setup_po_camera {state} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    rc_full = pt.RenderConfig(xres=1920, yres=1080, spp=1)
    po = dict(po_lens=lens, po_state=state)

    # BASELINE config 1 (bench.py:58-83): thin-lens teapot
    cfg1 = pt.CameraConfig(focal_length=50.0, fstop=1.4, focus_distance=150.0,
                           vignetting_retries=3, splat_queue_mult=8)
    scene1 = sc.teapot_scene(device=dev)
    rc1 = pt.RenderConfig(xres=256, yres=256, spp=16)
    # BASELINE config 3 (bench.py:117-169): chromatic image-bokeh lightgrid;
    # bench.py's splat_chunks only chunks the TPU's memory (same output)
    cfg3 = dataclasses.replace(cfg, abb_chromatic=0.6,
                               bokeh_enable_image=True)
    cfg3_nb = dataclasses.replace(cfg3, bokeh_enable_image=False)
    scene3 = sc.lightgrid_scene(n=4, spacing=14.0, z=-150.0, radius=0.8,
                                intensity=40.0, device=dev)
    state3 = setup_po_camera(lens, cfg3, scene=scene3)
    print(f"setup_po_camera (config 3) {state3}", flush=True)
    cdf3 = build_bokeh_cdf(ring_pixels(), device=dev)
    rc3 = pt.RenderConfig(xres=512, yres=512, spp=2)
    po3 = dict(po_lens=lens, po_state=state3)

    # BASELINE config 5 (bench.py:249-297): the differentiable 4K step
    c5 = Config5(dev, m)

    def capture(cfg_, rc_, scene_, **kw):
        rec_ = Recorder(ops.KERNELS)
        with torch.no_grad():
            render_frame(cfg_, rc_, scene_, m, seed=0, ops=rec_, **kw)
        torch.cuda.synchronize()
        return rec_.args

    phase("kernels vs plain versions (main-path inputs)")
    rec = capture(cfg, rc_full, scene, **po)
    records = []
    n_sph = scene.n_objects
    splat_extra = 60 + 20 * n_sph        # pixel map, lens point, occlusion

    with torch.no_grad():
        # K1: PO forward in its select mode, N rays of K candidates
        records.append(k1_record(rec["po_forward_selected"], ptxas, tag))

        # K2: expand, S slots; the library yardstick is index_select
        a2 = rec["expand"]
        got = pk.expand(*a2)
        ref = pk.expand_plain(*a2)
        err2 = max(float((got[0] - ref[0]).abs().max()),
                   float((got[1] - ref[1]).abs().max()))
        print(f"K2 expand S={a2[0].shape[0]} max_abs_err={err2}", flush=True)
        if err2 != 0:
            fail("K2 expand disagrees with its plain version")
        s2, n2 = a2[0].shape[0], a2[1].shape[1]
        rows = a2[1].shape[0] + a2[2].shape[0]

        def index_select():
            return a2[1].index_select(1, a2[0]), a2[2].index_select(1, a2[0])

        records.append(dict(
            name="expand", route="cuda",
            source="pota_tpu_torch/csrc/expand.cu",
            replaces=f"{TPU_KERNELS}:877", max_abs_err=err2,
            ms=median_ms(lambda: pk.expand(*a2)),
            plain_ms=median_ms(lambda: pk.expand_plain(*a2)),
            **bound(4.0 * (s2 + rows * (s2 + n2)), 0.0),
            library_ms=median_ms(index_select), n=int(s2),
            **ptxas["expand"]))
        del got, ref

        # K3: PO splat, S slots
        a3 = rec["po_splat"]

        def splat_witness(name, plain, args, items):
            """Which of the kernel and its f32 plain version loses the
            slots they disagree on, against the float64 solve."""
            def witness(lin_g, ok_g, lin_p, ok_p):
                lin_w, ok_w = f64_witness(plain, args, items)
                off = {"kernel": disagreement(lin_g, ok_g, lin_w, ok_w),
                       "plain_f32": disagreement(lin_p, ok_p, lin_w, ok_w)}
                for who, d in off.items():
                    print(f"{name} f64 witness: {who} disagrees on ok "
                          f"{d['ok'] * 100:.6f}% of slots, on lin "
                          f"{d['lin'] * 100:.6f}% of slots both keep",
                          flush=True)
                return dict(f64_disagreement=off)
            return witness

        k3 = check_splat_kernel(
            "po_splat", pk.po_splat, pk.po_splat_plain, a3, slice(1, 10),
            "pota_tpu_torch/csrc/po_splat.cu", f"{TPU_KERNELS}:697", 41.0,
            basis_solve_flops(a3[13]) + splat_extra + 20, plain_reps=3,
            witness=splat_witness("po_splat", pk.po_splat_plain, a3,
                                  slice(1, 10)))
        k3.update(
            design_bound_ms=k3["bound_ms"],
            runtime_term_bound_ms=bound(41.0 * k3["n"], k3["n"] * (
                solve_flops(lens.pt.exponents, a3[13]) + splat_extra
                + 20))["bound_ms"],
            **ptxas["po_splat"])
        print(f"po_splat (flagship, basis solve): {k3['ms']:.3f} ms, bound "
              f"{k3['bound_ms']:.3f} ms ({k3['bound_by']}, the basis solve), "
              f"runtime-term solve's bound "
              f"{k3['runtime_term_bound_ms']:.3f} ms, "
              f"{k3['registers']} registers, {k3['spill_bytes']} spill bytes "
              f"{tag}", flush=True)
        records.append(k3)
        del a3

        # K4: segment accumulate over the flagship's W writers
        seg = splat_accum.segment_accum
        seg_plain = splat_accum.segment_accum_plain
        a4 = rec["segment_accum"]
        err4 = check_accum("flagship", seg, seg_plain, a4)
        w4, k4, npix4 = a4[0].shape[0], a4[2].shape[1], a4[4]
        k4rec = dict(
            name="segment_accum", route="cuda",
            source="pota_tpu_torch/csrc/segment_accum.cu",
            replaces="pota_tpu/ops/splat_accum.py:59", max_abs_err=err4,
            **timed_ms(lambda: seg(*a4)),
            plain_ms=median_ms(lambda: seg_plain(*a4)),
            **accum_bound(a4), row_gather_ms=row_gather_ms(a4),
            every_writer_bound_ms=bound(
                w4 * (20.0 + 4.0 * k4) + npix4 * (4.0 * k4 + 9.0),
                float(w4 * k4))["bound_ms"],
            library_ms=None, n=int(w4), **ptxas["segment_accum"],
            carry_kernel=ptxas["segment_carry"])
        print(f"segment_accum (tiles and carries): {k4rec['ms']:.3f} ms "
              f"(10-90%: {k4rec['ms_spread'][0]:.3f}-"
              f"{k4rec['ms_spread'][1]:.3f}), "
              f"{k4rec['live_writers']} live writers of {w4}, "
              f"{k4rec['heads']} pixels written, bound "
              f"{k4rec['bound_ms']:.3f} ms ({k4rec['bound_by']}; every "
              f"writer counted: {k4rec['every_writer_bound_ms']:.3f} ms), "
              f"the live rows' payload gathered alone (index_select) "
              f"{k4rec['row_gather_ms']:.3f} ms, "
              f"{k4rec['registers']} registers, {k4rec['spill_bytes']} spill "
              f"bytes {tag}", flush=True)
        records.append(k4rec)
        del rec, a2, a4
        torch.cuda.empty_cache()

        # K4 on a piled-up stream at the flagship's shape (half of the live
        # writers on 64 pixels) and on the same stream without the pile-up
        piled = {}
        for label, hot in (("uniform", 0), ("piled", 64)):
            a4s = writer_stream(w4, k4, npix4, hot, dev)
            check_accum(f"{label} stream", seg, seg_plain, a4s)
            piled[label] = dict(**timed_ms(lambda: seg(*a4s)),
                                plain_ms=median_ms(lambda: seg_plain(*a4s)),
                                row_gather_ms=row_gather_ms(a4s),
                                **accum_bound(a4s))
            del a4s
            torch.cuda.empty_cache()
        piled["ratio"] = piled["piled"]["ms"] / piled["uniform"]["ms"]
        k4rec["streams"] = piled
        print(f"segment_accum on W={w4} K={k4}: uniform stream "
              f"{piled['uniform']['ms']:.3f} ms, piled-up stream (half the "
              f"live writers on 64 pixels) {piled['piled']['ms']:.3f} ms "
              f"({piled['ratio']:.3f}x; plain "
              f"{piled['uniform']['plain_ms']:.3f} / "
              f"{piled['piled']['plain_ms']:.3f} ms) {tag}", flush=True)

        # K5: thin-lens splat, config 1's S slots
        rec1 = capture(cfg1, rc1, scene1)
        a5 = rec1["tl_splat"]
        k5 = check_splat_kernel(
            "tl_splat", pk.tl_splat, pk.tl_splat_plain, a5, slice(0, 9),
            "pota_tpu_torch/csrc/tl_splat.cu", f"{TPU_KERNELS}:958", 41.0,
            85.0 + 20 * scene1.n_objects)
        k5.update(**timed_ms(lambda: pk.tl_splat(*a5)), **ptxas["tl_splat"],
                  **k5_profile(a5, k5["n"]))
        mix = ", ".join(f"{k} {v:.1f}" for k, v in
                        sorted(k5["sass_per_slot"].items()))
        print(f"tl_splat: {k5['ms']:.3f} ms (10-90%: "
              f"{k5['ms_spread'][0]:.3f}-{k5['ms_spread'][1]:.3f}), bound "
              f"{k5['bound_ms']:.3f} ms ({k5['bound_by']}), issue-rate time "
              f"{k5['issue_ms']:.3f} ms ({k5['sass_per_slot']['total']:.0f} "
              f"instructions a slot at {k5['clock_mhz']} MHz, "
              f"{k5['probed_share']:.4f} of slots probed), "
              f"{k5['registers']} registers, {k5['spill_bytes']} spill bytes,"
              f" {k5['blocks_per_sm']} blocks an SM; instructions a slot: "
              f"{mix} {tag}", flush=True)
        records.append(k5)
        check_accum("config 1", seg, seg_plain, rec1["segment_accum"])
        del a5, rec1
        # K3b: config 3 with image bokeh off (the per-slot-wavelength
        # instantiation, 20 operations more for the disk), and config 3
        extra3 = 60 + 20 * scene3.n_objects
        items3b = (*range(1, 9), 10, 11)   # lams (9) is a tuple of floats
        for name, plain, line, cfg_, kw, disk in (
                ("po_splat_lam", pk.po_splat_lam_plain, 743, cfg3_nb, {}, 20),
                ("po_splat_ext", pk.po_splat_ext_plain, 747, cfg3,
                 dict(bokeh_cdf=cdf3), 0)):
            rec3 = capture(cfg_, rc3, scene3, **kw, **po3)
            a3b = rec3[name]
            check_accum(name, seg, seg_plain, rec3["segment_accum"])
            del rec3
            if (a3b[9] != chroma_wavelengths(cfg3)
                    or a3b[10].dtype != torch.int32):
                fail(f"{name} got wavelengths {a3b[9]} on a chromatic frame")
            flops = basis_solve_flops(a3b[14]) + extra3 + disk
            k3b = check_splat_kernel(
                name, getattr(pk, name), plain, a3b, items3b,
                "pota_tpu_torch/csrc/po_splat.cu", f"{TPU_KERNELS}:{line}",
                45.0, flops, witness=splat_witness(name, plain, a3b, items3b)
                if name == "po_splat_lam" else None)
            k3b.update(
                runtime_term_bound_ms=bound(45.0 * k3b["n"], k3b["n"] * (
                    solve_flops(lens.pt.exponents, a3b[14]) + extra3
                    + disk))["bound_ms"],
                designs=k3b_designs(getattr(pk, name), a3b, items3b),
                **ptxas[name])
            d = k3b["designs"]
            print(f"{name} (basis solve, three tables): {k3b['ms']:.3f} ms, "
                  f"bound {k3b['bound_ms']:.3f} ms ({k3b['bound_by']}), "
                  f"runtime-term bound {k3b['runtime_term_bound_ms']:.3f} ms,"
                  f" {k3b['registers']} registers, {k3b['spill_bytes']} "
                  f"spill bytes; on {d['n']} slots: channel-uniform warps "
                  f"{d['channel_uniform_ms']:.3f} ms, an index per slot "
                  f"{d['slot_index_ms']:.3f} ms, one table "
                  f"{d['one_table_ms']:.3f} ms ({d['uniform_warp_share']:.4f}"
                  f" of warps one channel) {tag}", flush=True)
            records.append(k3b)
            del a3b
        torch.cuda.empty_cache()

        # K6: PO backward solve, the motion-blurred flagship's S slots,
        # on one table; then on three (the chroma trio, slot % 3)
        a6 = capture(cfg, rc_full, scene, cam_to_world_end=m_end,
                     **po)["po_backward"]
        items6 = (1, 2, 3, 4, 5, 7)       # lams (6) is a tuple of floats
        s6 = int(a6[1].shape[0])
        if a6[6] != (cfg.lambda_um,) or a6[7] is not None:
            fail(f"K6 got wavelengths {a6[6]} on the monochromatic frame")

        def check_k6(label, args):
            """K6 against its plain version on ``args``: (outputs, keep
            agreement, max errors, share of kept items > 1e-3 mm apart)."""
            got_ = pk.po_backward(*args)
            ref_ = plain_chunked(pk.po_backward_plain, args, items6)
            keep_g, keep_p = got_[4] > 0, ref_[4] > 0
            agree_ = float((keep_g == keep_p).double().mean())
            both_ = keep_g & keep_p
            errs_ = [float((g[both_] - r[both_]).abs().max())
                     for g, r in zip(got_, ref_)]
            far_ = share_far(got_, ref_, both_)
            print(f"K6 po_backward {label} S={s6} trans>0 agree={agree_:.6f}"
                  f" max_abs_err(sx, sy, sdx, sdy) on items both keep (mm) "
                  f"{errs_[0]:.3e} {errs_[1]:.3e} {errs_[2]:.3e} "
                  f"{errs_[3]:.3e}, trans {errs_[4]:.3e}; share of items > "
                  f"1e-3 mm apart {far_:.6f} (trans>0 rate "
                  f"{float(keep_g.double().mean()):.4f})", flush=True)
            if agree_ < MASK_AGREE or far_ > 1.0 - MASK_AGREE:
                fail(f"K6 po_backward ({label}) disagrees with its plain "
                     "version")
            return (got_, ref_), agree_, errs_, far_

        (got, ref), agree6, errs, far = check_k6("one table", a6)
        w6 = f64_witness(pk.po_backward_plain, a6, items6)
        witness6 = {who: k6_disagreement(out, w6)
                    for who, out in (("kernel", got), ("plain_f32", ref))}
        for who, d in witness6.items():
            print(f"po_backward f64 witness: {who} disagrees on trans>0 "
                  f"{d['keep'] * 100:.6f}% of items, is > 1e-3 mm off on "
                  f"{d['far'] * 100:.6f}% of items both keep, at most "
                  f"{d['max_mm']:.3e} mm", flush=True)
        del got, ref, w6
        a6c = (*a6[:6], chroma_wavelengths(cfg3),
               (torch.arange(s6, device=dev) % 3).to(torch.int32), a6[8])
        _, agree6c, _, far_c = check_k6("three tables", a6c)
        k6 = dict(
            name="po_backward", route="cuda",
            source="pota_tpu_torch/csrc/po_backward.cu",
            replaces=f"{TPU_KERNELS}:419", max_abs_err=max(errs[:2]),
            ms=median_ms(lambda: pk.po_backward(*a6)),
            plain_ms=median_ms(lambda: plain_chunked(
                pk.po_backward_plain, a6, items6), 3),
            **bound(44.0 * s6, s6 * basis_solve_flops(a6[8])),
            runtime_term_bound_ms=bound(44.0 * s6, s6 * solve_flops(
                lens.pt.exponents, a6[8]))["bound_ms"],
            **ptxas["po_backward"], library_ms=None, n=s6,
            mask_agree=agree6, share_far=far, f64_disagreement=witness6,
            three_tables=dict(ms=median_ms(lambda: pk.po_backward(*a6c)),
                              mask_agree=agree6c, share_far=far_c))
        print(f"po_backward (basis solve): one table {k6['ms']:.3f} ms, "
              f"three tables {k6['three_tables']['ms']:.3f} ms, bound "
              f"{k6['bound_ms']:.3f} ms ({k6['bound_by']}), runtime-term "
              f"bound {k6['runtime_term_bound_ms']:.3f} ms, "
              f"{k6['registers']} registers, {k6['spill_bytes']} spill "
              f"bytes {tag}", flush=True)
        records.append(k6)
        del a6, a6c
        torch.cuda.empty_cache()

        # config 5: K2, K3 and K4 on the 4K differentiable step's own
        # arguments, and the VJPs of K2 and K4 there
        records += c5.kernel_records(ptxas, tag)
    for r in records:
        print(f"{r['name']}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}), library {r['library_ms']} ms {tag}",
              flush=True)
    torch.cuda.empty_cache()

    def parity(label, cfg_, rc_, scene_, aovs=None, **kw):
        phase(f"parity {label}: kernels vs plain versions")
        with torch.no_grad():
            _, fb_k = render_frame(cfg_, rc_, scene_, m, seed=0, aovs=aovs,
                                   **kw)
            _, fb_p = render_frame(cfg_, rc_, scene_, m, seed=0, aovs=aovs,
                                   ops=ops.PLAIN, **kw)
        aov_k = resolve_aovs(rc_, fb_k, aovs)
        aov_p = resolve_aovs(rc_, fb_p, aovs)
        if rc_.enable_id_matte:
            # the id-matte: the pixel totals and the resolved layers
            aov_k["crypto_total"] = fb_k["crypto_total"][..., None]
            aov_p["crypto_total"] = fb_p["crypto_total"][..., None]
            for r, (lk, lp) in enumerate(zip(resolve_crypto(fb_k),
                                             resolve_crypto(fb_p))):
                aov_k[f"crypto{r:02d}"], aov_p[f"crypto{r:02d}"] = lk, lp
        for k in aov_p:
            off = frac_pixels_off(aov_k[k], aov_p[k])
            print(f"  {k}: pixels off {off:.5f}", flush=True)
            if not bool(torch.isfinite(aov_k[k]).all()) or off > MAX_PIXELS_OFF:
                fail(f"{label} parity: plane {k}")
        for k in ("RGBA", "filter_weight"):
            e_k = float(fb_k[k].double().sum())
            e_p = float(fb_p[k].double().sum())
            print(f"  energy {k}: kernels {e_k:.6f} plain {e_p:.6f}",
                  flush=True)
            if abs(e_k - e_p) > 2e-3 * abs(e_p):
                fail(f"{label} parity: energy {k}")

    def emitter(x):
        """tests/golden_configs.py::_emitter, one bright sphere."""
        return sc.sphere_scene_from_numpy(
            centers=[[x, 0.0, -45.0]], radii=[1.0],
            emission=np.full((1, 3), 40.0), albedo=np.zeros((1, 3)),
            sky_color=np.zeros(3), light_dir=[0.0, 1.0, 0.0],
            light_color=np.zeros(3), device=dev)

    rc256 = pt.RenderConfig(xres=256, yres=256, spp=1)
    parity("flagship 256x256 @ 1 spp", cfg, rc256, scene, **po)
    parity("config 1 64x64 @ 4 spp", cfg1, pt.RenderConfig(
        xres=64, yres=64, spp=4), scene1)
    parity("config 3 128x128 @ 2 spp", cfg3, pt.RenderConfig(
        xres=128, yres=128, spp=2), scene3, bokeh_cdf=cdf3, **po3)
    parity("config 3 with image bokeh off 128x128 @ 2 spp", cfg3_nb,
           pt.RenderConfig(xres=128, yres=128, spp=2), scene3, **po3)
    parity("flagship_mb 256x256 @ 1 spp with a gaussian P AOV", cfg, rc256,
           scene, cam_to_world_end=m_end,
           aovs=list(DEFAULT_AOVS) + [AOVSpec("P_gauss", "VECTOR", GAUSSIAN,
                                              "P")], **po)
    parity("config 3 with image bokeh off and motion blur 128x128 @ 2 spp",
           cfg3_nb, pt.RenderConfig(xres=128, yres=128, spp=2), scene3,
           cam_to_world_end=m_end, **po3)
    # the thin-lens golden configurations (tests/golden_configs.py:83-100)
    cfg_tl = pt.CameraConfig(focal_length=65.0, fstop=1.8,
                             focus_distance=15.0, vignetting_retries=2,
                             splat_queue_mult=6)
    rc_tl = pt.RenderConfig(xres=128, yres=128, spp=4)
    parity("thinlens_chromatic 128x128 @ 4 spp",
           dataclasses.replace(cfg_tl, abb_chromatic=1.0), rc_tl, emitter(4.0))
    parity("bokeh_image_aperture 128x128 @ 4 spp",
           dataclasses.replace(cfg_tl, bokeh_enable_image=True), rc_tl,
           emitter(0.0), bokeh_cdf=build_bokeh_cdf(ring_pixels(lo=0.55),
                                                   device=dev))
    # flagship_idmatte's camera and scene
    scene_g = glass_teapot(dev)
    po_g = dict(po_lens=lens, po_state=setup_po_camera(lens, cfg,
                                                       scene=scene_g))
    parity("flagship_idmatte 256x256 @ 1 spp (thin glass, id-matte)", cfg,
           dataclasses.replace(rc256, enable_id_matte=True), scene_g, **po_g)
    c5.parity()
    torch.cuda.empty_cache()

    def drive(label, path, cfg_, rc_, scene_, **kw):
        """One main-path frame with the counters set to 0 just before it and
        read just after; returns (launches, fb)."""
        with torch.no_grad():
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            _, fb_ = render_frame(cfg_, rc_, scene_, m, seed=0, **kw)
            aovs_ = resolve_aovs(rc_, fb_)
            torch.cuda.synchronize()
            launches_ = dict(ops.LAUNCHES)
        print(f"launches in the {label} run: {launches_}", flush=True)
        print(f"{path}_peak_device_gb "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30} {tag}",
              flush=True)
        missing = [k for k in PATH_KERNELS[path] if launches_[k] < 1]
        stray = [k for k, v in launches_.items()
                 if v and k not in PATH_KERNELS[path]]
        if missing or stray:
            fail(f"{label}: kernels not launched {missing}, "
                 f"off-path kernels launched {stray}")
        for k, v in aovs_.items():
            if not bool(torch.isfinite(v).all()):
                fail(f"{label}: plane {k} is not finite")
        npix = rc_.xres * rc_.yres
        w_sum = float(fb_["filter_weight"].double().sum())
        print(f"{label} sum(filter_weight) {w_sum:.4f} vs {npix}", flush=True)
        if abs(w_sum - npix) > ENERGY_TOL * npix:
            fail(f"{label}: energy conservation, sum(filter_weight) != npix")
        return launches_, fb_

    def time_flagship(prefix, **kw):
        """Frame, forward and splat+resolve wall times of the 1080p
        flagship (with ``kw``), issued slots and valid splats."""
        with torch.no_grad():
            def e2e():
                _, fb_ = render_frame(cfg, rc_full, scene, m, seed=0, **po,
                                      **kw)
                resolve_aovs(rc_full, fb_)

            stream = render_sample_stream(cfg, rc_full, scene, m, 0, **po,
                                          **kw)

            def splat_resolve():
                fb_ = splat_frame(cfg, rc_full, scene, stream, m,
                                  with_diagnostics=True, **po, **kw)
                resolve_aovs(rc_full, fb_)
                return fb_

            fb_d = splat_resolve()
            n_valid = int(fb_d["_n_valid_splats"])
            n_issued = int(fb_d["_n_issued_slots"])
            del fb_d
            if n_valid <= 0:
                fail(f"{prefix}no valid splats")
            frame_ms = host_ms(e2e)
            forward_ms = host_ms(lambda: render_sample_stream(
                cfg, rc_full, scene, m, 0, **po, **kw))
            splat_ms = host_ms(splat_resolve)
            del stream
        for label, val in (
                ("frame_ms", frame_ms), ("forward_ms", forward_ms),
                ("splat_resolve_ms", splat_ms), ("issued_slots", n_issued),
                ("valid_splats", n_valid),
                ("valid_splats_per_s", n_valid / (splat_ms * 1e-3))):
            print(f"{prefix}{label} {val} {tag}", flush=True)
        torch.cuda.empty_cache()

    phase("flagship 1920x1080 @ 1 spp (BASELINE config 4)")
    path_launches = {}
    path_launches["flagship"], fb = drive("flagship", "flagship", cfg,
                                          rc_full, scene, **po)
    del fb
    time_flagship("")

    phase("flagship_mb 1920x1080 @ 1 spp, camera motion blur "
          "(the decomposed route)")
    path_launches["flagship_mb"], fb = drive(
        "flagship_mb", "flagship_mb", cfg, rc_full, scene,
        cam_to_world_end=m_end, **po)
    del fb
    time_flagship("flagship_mb_", cam_to_world_end=m_end)

    for label, path, cfg_, rc_, scene_, kw in (
            ("config 1 thin-lens teapot 256x256 @ 16 spp", "config1", cfg1,
             rc1, scene1, {}),
            ("config 3 with image bokeh off, 512x512 @ 2 spp",
             "config3_no_bokeh", cfg3_nb, rc3, scene3, po3),
            ("config 3 chromatic image bokeh 512x512 @ 2 spp", "config3",
             cfg3, rc3, scene3, dict(bokeh_cdf=cdf3, **po3))):
        phase(label)
        path_launches[path], fb = drive(label, path, cfg_, rc_, scene_, **kw)
        del fb

        def e2e():
            with torch.no_grad():
                _, fb_ = render_frame(cfg_, rc_, scene_, m, seed=0, **kw)
                resolve_aovs(rc_, fb_)

        e2e()
        ms = host_ms(e2e)
        n_aa = rc_.xres * rc_.yres * rc_.spp
        print(f"{path}_frame_ms {ms} {tag}", flush=True)
        print(f"{path}_aa_samples_per_s {n_aa / (ms * 1e-3)} {tag}",
              flush=True)
        torch.cuda.empty_cache()

    # ---- flagship_idmatte: the id-matte of thin glass at the flagship's width
    phase("flagship_idmatte 1920x1080 @ 1 spp: teapot with two glass "
          "spheres, id-matte")
    rc_id = dataclasses.replace(rc_full, enable_id_matte=True)
    npix = rc_full.xres * rc_full.yres
    captured = {}
    records_fn = tsplat.id_matte_records

    def capture_records(*a):
        captured["args"] = a
        return records_fn(*a)

    tsplat.id_matte_records = capture_records
    try:
        path_launches["flagship_idmatte"], fb = drive(
            "flagship_idmatte", "flagship_idmatte", cfg, rc_id, scene_g,
            **po_g)
    finally:
        tsplat.id_matte_records = records_fn
    once = {k: v for k, v in path_launches["flagship_idmatte"].items() if v}
    if once != {k: 1 for k in PATH_KERNELS["flagship_idmatte"]}:
        fail(f"flagship_idmatte: launches {once}, not one of each kernel")
    id_args = captured.pop("args")
    with torch.no_grad():
        id_records = tsplat.id_matte_records(*id_args)
        layers = resolve_crypto(fb)
    check_id_matte("flagship_idmatte", fb, id_records, layers, npix)
    del id_records, layers

    def id_stage():
        with torch.no_grad():
            crypto_topk(*tsplat.id_matte_records(*id_args), npix, k=6)

    stage_ms = median_ms(id_stage)
    resolve_ms = median_ms(lambda: resolve_crypto(fb))
    del fb, id_args
    torch.cuda.empty_cache()

    def e2e_g(rc_):
        def run():
            with torch.no_grad():
                _, fb_ = render_frame(cfg, rc_, scene_g, m, seed=0, **po_g)
                resolve_aovs(rc_, fb_)
        return run

    e2e_g(rc_id)()
    frame_id_ms = host_ms(e2e_g(rc_id))
    frame_off_ms = host_ms(e2e_g(rc_full))
    frame_id_ms2 = host_ms(e2e_g(rc_id))
    for name, val in (
            ("flagship_idmatte_frame_ms", [frame_id_ms, frame_id_ms2]),
            ("flagship_idmatte_off_frame_ms", frame_off_ms),
            ("flagship_idmatte_stage_ms", stage_ms),
            ("flagship_idmatte_resolve_crypto_ms", resolve_ms)):
        print(f"{name} {val} {tag}", flush=True)
    torch.cuda.empty_cache()

    # ---- config2: the PO forward trace alone (bench.py:86-114)
    phase("config2 1920x1080 @ 1 spp: trace_camera_rays (BASELINE config 2)")
    from pota_tpu_torch.render import sampling
    from pota_tpu_torch.render.renderer import trace_camera_rays

    cfg_fw = pt.CameraConfig(
        camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
        fstop=2.8, focus_distance=150.0, vignetting_retries=3)
    state_fw = setup_po_camera(lens, cfg_fw)

    def forward_rays():
        with torch.no_grad():
            smp = sampling.frame_samples(rc_full, 0, device=dev)
            smp["key"] = (smp["key"] + 1) & 0xFFFFFFFF
            o, d, w = trace_camera_rays(cfg_fw, smp, po_lens=lens,
                                        po_state=state_fw)
            return o.sum() + d.sum() + w.sum()

    forward_rays()
    ops.reset_launches()
    total = forward_rays()
    torch.cuda.synchronize()
    path_launches["config2"] = dict(ops.LAUNCHES)
    print(f"launches in the config2 run: {path_launches['config2']}",
          flush=True)
    if {k: v for k, v in path_launches["config2"].items() if v} != {
            "po_forward": 1}:
        fail("config2: K1 not launched once, or another kernel launched")
    if not bool(torch.isfinite(total)):
        fail("config2: the traced rays are not finite")
    fw_ms = median_ms(forward_rays, reps=10)
    n_rays = rc_full.xres * rc_full.yres * rc_full.spp
    print(f"config2_frame_ms {fw_ms} {tag}", flush=True)
    print(f"po_forward_rays_per_s_1080p {n_rays / (fw_ms * 1e-3)} {tag}",
          flush=True)

    # ---- the command line on the card
    phase("cli: python -m pota_tpu_torch.cli on the card")
    import tempfile

    from pota_tpu_torch import cli
    from pota_tpu_torch.io.exr import read_exr

    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/cli.exr"
        argv = ["--camera", "po", "--res", "1024", "--spp", "1", "--aovs",
                "--id-matte", "--glare", "0.5", "--aperture-blades", "6",
                "--out", out]
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            fail("cli: non-zero exit")
        print(f"cli_s {time.perf_counter() - t0} {tag}", flush=True)
        planes = read_exr(out)
    want = {f"crypto{r:02d}.{c}" for r in range(3) for c in "RGBA"}
    if not want <= set(planes):
        fail(f"cli: missing channels {sorted(want - set(planes))}")
    bad = [k for k, v in planes.items() if not np.isfinite(v).all()]
    if bad:
        fail(f"cli: channels not finite {bad}")
    print(f"cli wrote {len(planes)} channels {sorted(planes)}", flush=True)
    torch.cuda.empty_cache()

    path_launches["config5"] = c5.run(tag)
    torch.cuda.empty_cache()
    path_launches.update(sharded_phase(dev, tag, m, (
        ("sharded flagship 1920x1080 @ 1 spp", "sharded_flagship", cfg,
         rc_full, scene, po),
        ("sharded config 1 256x256 @ 16 spp", "sharded_config1", cfg1, rc1,
         scene1, {})), c5))
    path_launches.update(fit_phase(dev, tag, cfg, rc_full, scene, m, po,
                                   drive))
    derivs_launches, derivs_records = derivs_phase(
        dev, tag, rc_full, lens, cfg_fw, state_fw, cfg1, ptxas)
    path_launches.update(derivs_launches)
    records += derivs_records
    path_launches.update(replay_phase(dev, tag, cfg, rc_full, scene, m, po))
    grad_launches, grad_records = grad_routes_phase(dev, tag, m, m_end,
                                                    ptxas)
    path_launches.update(grad_launches)
    records += grad_records

    path_of = {"tl_splat": "config1", "po_splat_lam": "config3_no_bokeh",
               "po_splat_ext": "config3", "po_backward": "flagship_mb"}
    for r in records:
        r["launches"] = path_launches[r.get("path") or path_of.get(
            r["name"], "flagship")][r["name"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
