"""Time K4 (segment_accum) of one checkout of pota_tpu_torch on two seeded
writer streams at the flagship's shape: uniform, and piled up (half of the
live writers on 64 pixels).  Both have W = 18,662,400 writers, K = 5
payload columns, 2,073,600 pixels and a quarter of the writers dead, and
come from ``chip_smoke.writer_stream``.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/time_accum_streams.py [--root DIR]

``--root`` names the checkout whose ``pota_tpu_torch`` is timed (default:
this one), so that an older commit unpacked with ``git archive`` is timed
by the same script on the same streams, in the same call.  Each kernel is
held to its plain version (sums within 1e-4 of scale, winners identical)
before it is timed; times are CUDA-event medians of 50 runs after a
warm-up, with their 10th and 90th percentiles (``chip_smoke.timed_ms``).
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

W, K, NPIX, HOT = 18_662_400, 5, 2_073_600, 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    # the streams and checks are this checkout's; the kernel is root's
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    from pota_tpu_torch.ops import splat_accum

    if not splat_accum.__file__.startswith(root):
        print(f"FAIL: imported {splat_accum.__file__}, not from {root}")
        return 1
    dev = torch.device("cuda", 0)
    out = dict(root=root, card=cs.card_line())
    seg, plain = splat_accum.segment_accum, splat_accum.segment_accum_plain
    for label, hot in (("uniform", 0), ("piled", HOT)):
        a = cs.writer_stream(W, K, NPIX, hot, dev)
        with torch.no_grad():
            err = cs.check_accum(label, seg, plain, a)
            out[label] = dict(**cs.timed_ms(lambda: seg(*a)),
                              max_abs_err=err, **cs.accum_bound(a))
        del a
        torch.cuda.empty_cache()
    out["ratio"] = out["piled"]["ms"] / out["uniform"]["ms"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
