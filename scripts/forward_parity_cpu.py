"""How far a frame moves when only the rounding of the PO forward trace (K1's
function) changes, on the CPU.

Renders the flagship lens's 96x64 @ 2 spp lightgrid frame (the frame of
tests/test_torch_cuda.py::test_render_kernels_match_plain) three times, each
with another forward trace and everything else the plain versions:

  term32   pt_sample_aperture then pt_evaluate on the fit's own terms in
           float32 (the arithmetic of JAX's trace and of K1 before the
           folded basis);
  folded   po_forward_plain: K1's arithmetic on the folded table, in
           float32 (what the kernel computes, bit for bit);
  term64   the term32 trace in float64, returned as float32.

and prints the share of RGBA pixels that differ by more than 2e-3 of the
frame's scale between each pair (the parity measure of chip_smoke.py).  A
grazing sphere hit moves with the last bits of its ray, and its highlight's
splats move with it, so two traces agree on a frame only if they round
alike; run this before giving K1 another arithmetic.

Run from the repository root:  python3 scripts/forward_parity_cpu.py
"""
import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pota_tpu_torch as pt  # noqa: E402
from pota_tpu_torch import ops  # noqa: E402
from pota_tpu_torch.ops import po_kernels as pk  # noqa: E402
from pota_tpu_torch.optics.fit import load_poly_lens  # noqa: E402
from pota_tpu_torch.optics.focus import POState  # noqa: E402
from pota_tpu_torch.render import scene as sc  # noqa: E402
from pota_tpu_torch.render.renderer import look_at, render_frame  # noqa: E402

FLAGSHIP = "angenieux__double_gauss__1953__49mm"


def main() -> None:
    torch.set_num_threads(4)
    cfg = pt.CameraConfig(
        camera_type=pt.CameraType.POLYNOMIAL_OPTICS, lens_model=FLAGSHIP,
        fstop=2.8, focus_distance=20.0, vignetting_retries=3,
        splat_queue_mult=8)
    state = POState(aperture_radius=4.672678708153359,
                    sensor_shift=15.091056449990935, focus_distance=200.0,
                    tan_fov=0.36734693877551)
    lens = load_poly_lens(FLAGSHIP, device="cpu")
    lens64 = copy.deepcopy(lens).double()
    scene = sc.lightgrid_scene(n=3, spacing=18.0, z=-150.0, radius=1.0,
                               intensity=40.0, device="cpu")
    rc = pt.RenderConfig(xres=96, yres=64, spp=2)
    m = look_at([0, 0, 0], [0, 0, -1], device="cpu")

    def term64(lens_, x, y, ax, ay, lam_um, shift, iterations=3):
        out = pk._po_forward_terms(lens64, x.double(), y.double(),
                                   ax.double(), ay.double(), lam_um, shift,
                                   iterations)
        return tuple(t.float() for t in out)

    def selected(trace):
        """K1's select mode, called as ``po_forward_selected``, with
        ``trace`` in place of plain K1 on the candidates drawn in torch,
        then the select in torch."""
        def fn(lens_, sx, sy, hsw, r1, r2, key, tries, radius, blades,
               lam_um, shift, scale, iterations=3):
            x, y = sx * hsw, sy * hsw
            cand = trace(lens_, *pk.drawn_rays(x, y, r1, r2, key, tries,
                                               radius, blades),
                         lam_um, shift, iterations)
            return pk._select_candidates(lens_, x, y, cand, tries, shift,
                                         scale, False)
        return fn

    traces = {"term32": pk._po_forward_terms, "folded": pk.po_forward_plain,
              "term64": term64}
    images = {}
    for name, trace in traces.items():
        images[name], _ = render_frame(
            cfg, rc, scene, m, po_lens=lens, po_state=state,
            ops=ops.PLAIN._replace(po_forward=trace,
                                   po_forward_selected=selected(trace)))

    def off(a, b):
        scale = max(float(b.abs().max()), 1.0)
        return float(((a - b).abs().amax(-1) > 2e-3 * scale).double().mean())

    for a, b in (("folded", "term32"), ("term64", "term32"),
                 ("term64", "folded")):
        print(f"{a} vs {b}: {off(images[a], images[b]):.5f} of RGBA pixels "
              "off by > 2e-3 of scale", flush=True)


if __name__ == "__main__":
    main()
