"""K1v's time for one checkout of pota_tpu_torch, by the share of the
candidates that carry a cotangent.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/time_k1v.py [--root DIR] [--n 777600] [--launches 20]

``--root`` names the checkout whose ``pota_tpu_torch`` is timed (default:
this one), so that an older commit unpacked with ``git archive`` under
``build/`` is timed by the same script in the same call: parent, change,
change, parent.  Inputs: ``--n`` seeded rays of the flagship fit (sensor
points within 14 mm, aperture points within 0.6 of the housing radius;
config 5's chunk has 777,600 candidates) at K1's solution, 0.55 um, and a
standard normal cotangent of out4 on none, 6.4% (config 5's share) and all
of them.  Per share: the device time a launch of K1v's two kernels
(``chip_smoke.device_ms``: a ``torch.profiler`` trace of ``--launches``
back-to-back launches) and the time a launch through the wrapper over the
same launches (CUDA events).  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARES = (0.0, 0.064, 1.0)
SHIFT = 15.091056449990935      # the flagship's sensor shift at focus 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--n", type=int, default=777_600)
    ap.add_argument("--launches", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import numpy as np
    import torch

    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    import pota_tpu_torch as pt
    from pota_tpu_torch.ops import po_kernels as pk
    from pota_tpu_torch.optics.fit import load_poly_lens

    if not pt.__file__.startswith(root):
        print(f"FAIL: imported {pt.__file__}, not from {root}", flush=True)
        return 1
    dev = torch.device("cuda", 0)
    lens = load_poly_lens(cs.FLAGSHIP, device=dev)
    rng = np.random.default_rng(0)
    n = args.n
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    r = lens.aperture_housing_radius * 0.6
    rays = [f32(rng.uniform(-14, 14, n)), f32(rng.uniform(-14, 14, n)),
            f32(rng.uniform(-r, r, n)), f32(rng.uniform(-r, r, n))]
    g4 = f32(rng.standard_normal((n, 4)))
    u = rng.uniform(size=n)
    out = dict(root=root, card=cs.card_line(), n=n)
    with torch.no_grad():
        _, _, dx, dy = pk.po_forward(lens, *rays, 0.55, SHIFT, 3)
        for share in SHARES:
            live = torch.as_tensor(u < share, device=dev)
            g = torch.where(live[:, None], g4, 0.0).contiguous()
            a = (lens, *rays, dx, dy, g, None, None, None, 0.55, SHIFT,
                 False)

            def launches():
                for _ in range(args.launches):
                    pk.po_forward_vjp(*a)

            dev_ms = cs.device_ms(launches, ("po_forward_vjp_kernel",
                                             "po_forward_vjp_finish"))
            out[str(share)] = dict(
                live=int(live.sum()),
                kernels_ms={k: None if v is None else v / args.launches
                            for k, v in dev_ms.items()},
                wrapper_ms=cs.median_ms(launches) / args.launches)
            print(f"{share}: {out[str(share)]}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
