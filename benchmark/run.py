"""Run one cell of the pota_tpu_torch benchmark once, on the CUDA card of
this machine, and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` at the checkout's root; its
configuration, traffic, limits and metric readers are files under
``benchmark/`` found by name (``harness/spec.py``).  ``--trace 0`` measures
the window and prints the cell's end-to-end metrics; ``--trace 1`` traces a
short stretch with ``torch.profiler`` and prints its per-layer metrics.
Either way the run then checks what the timed path produced against the
plain reference (``benchmark/reference/``) and prints each number compared
beside its limit, on standard error and under ``checks`` in the result.

The run exits 3 without a result when there is no CUDA card (or fewer than
the cell asks for), and 4 when a JAX module or the JAX package was loaded,
or a reference module imports the program.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's build and kernel caches, at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if HERE not in sys.path:
    sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import report, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"no result: the cell needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    result = report.run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0), T0)
    found = report.forbidden_modules()
    if found:
        print(f"no result: loaded {', '.join(found)}", file=sys.stderr)
        return 4
    report.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
