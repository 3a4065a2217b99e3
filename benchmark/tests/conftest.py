"""The benchmark's own tests: run from the repository root with
``python -m pytest benchmark/tests -q``.  Cases that need the card are
marked ``cuda`` and skip without one (decided in the ``cuda`` fixture)."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small(cell, size=(16, 16)):
    """``cell`` cut to a CPU test's size: a ``size`` frame, four trace
    chunks, no kernel launches expected (the CPU runs the plain
    versions)."""
    cell.config["render"].update(xres=size[0], yres=size[1])
    if "trace_chunks" in cell.config["camera"]:
        cell.config["camera"]["trace_chunks"] = 4
    cell.check["route"] = {}
    return cell
