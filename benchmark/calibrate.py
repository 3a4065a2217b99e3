"""The readings the comparison limits are set from, for one cell, at the
cell's own size, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control 3] [--faults half altered --faulted 3] [--out FILE]

For each seed: the program's answer as a run produces it (a frame of the
cell's traffic, or the fit's first steps from set-up), the plain
reference's answer, and the numbers that decide ``correct``; for the first
``--control`` seeds also the control (the reference with bfloat16 at its
kernels' boundaries) against the reference, and for the first
``--faulted`` seeds each fault of ``--faults`` planted under the program
(``faults/<name>.py``) against the reference.
Prints one JSON line a reading and writes them all to ``--out``.  The
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]


def program_answer(cell, seed: int, device, fault=None) -> dict:
    """What a run of ``cell`` seeded ``seed`` hands the check, from its
    set-up and its first window unit, with ``fault`` (a name under
    ``faults/``) planted."""
    import contextlib

    from harness import spec
    from harness.loop import Run

    run = Run(cell, seed, device)
    with (spec.load_fault(fault, cell.base).planted() if fault
          else contextlib.nullcontext()):
        run.setup()
        run.unit()
    return run.release()


def readings(cell, seeds, device, control: int = 0, fault_names=(),
             faulted: int = 0, log=print) -> list:
    """The program's, the control's and the faults' numbers per seed."""
    import torch

    from harness import check

    out = []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        got = program_answer(cell, seed, device)
        ref = check.reference_answer(cell, device, seed, got)
        sides = [("program", got)]
        if i < control:
            sides.append(("control", check.reference_answer(
                cell, device, seed, got, control=True)))
        if i < faulted:
            sides += [(f"fault:{f}", program_answer(cell, seed, device, f))
                      for f in fault_names]
        for side, ans in sides:
            row = {"cell": cell.name, "seed": seed, "side": side,
                   "numbers": check.numbers(cell, ans, ref),
                   "seconds": time.perf_counter() - t}
            log(json.dumps(row))
            out.append(row)
        del got, ref, sides
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--faulted", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    from harness import report, spec

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    print(report.power_limit(), flush=True)
    cell = spec.load_cell(args.workload)
    rows = readings(cell, args.seeds, torch.device("cuda", 0),
                    args.control, args.faults, args.faulted,
                    log=lambda s: print(s, flush=True))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
