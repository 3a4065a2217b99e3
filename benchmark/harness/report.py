"""A run from set-up to its result line: the window, the check against the
reference, the metrics, the device; and the check of what was loaded."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import torch

from . import check
from .loop import Run
from .spec import HERE

BANNED = ("jax", "jaxlib", "flax", "pota_tpu")
REFERENCE_DIR = os.path.join(HERE, "reference")


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def read_metrics(entries: list, reader, rec) -> dict:
    """Each entry's number from its reader; a reader that finds nothing
    to read leaves its metric out."""
    out = {}
    for m in entries:
        v = reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t0: float) -> dict:
    """One run of ``cell``: the result's fields, ``checks`` last."""
    run = Run(cell, seed, device)
    rec = run.go(seconds, traced, t0)
    metrics = read_metrics(cell.per_layer if traced else cell.end_to_end,
                           cell.reader, rec)
    got = run.release()
    ref = check.reference_answer(cell, device, seed, got)
    values = check.numbers(cell, got, ref)
    del ref
    judged = check.judged(values, cell.check["limits"])
    dev = torch.device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    card = power_limit() if dev.type == "cuda" else None
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": run.memory_peak,
                   "card": card}
    result = {"correct": (run.failed == 0
                          and all(j["ok"] for j in judged.values())),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device_info}
    if traced:
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    result["launches_per_unit"] = rec.launches
    result["checks"] = {k: {"value": j["value"], "limit": j["limit"]}
                        for k, j in judged.items()}
    return result


def emit(result: dict) -> None:
    """Each number compared beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for k, j in result["checks"].items():
        print(f"check {k} {j['value']!r} limit {j['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def forbidden_modules() -> list:
    """The top-level names of :data:`BANNED` in ``sys.modules`` (compared
    whole), and each loaded module of ``benchmark/reference/`` that
    imports the program or one of them."""
    found = sorted({n.split(".")[0] for n in list(sys.modules)
                    if n.split(".")[0] in BANNED})
    for name, mod in list(sys.modules.items()):
        path = getattr(mod, "__file__", None) or ""
        if os.path.abspath(path).startswith(REFERENCE_DIR + os.sep):
            bad = _imports(path) & {*BANNED, "pota_tpu_torch"}
            found += [f"{name} (imports {b})" for b in sorted(bad)]
    return found
