"""The plain reference against the program's own plain path, the control
that has to come out as not correct, and the faults planted under the
timed path that the check has to catch, each on the CPU at a small size;
the control at the cells' own size on the card."""
import time

import pytest
import torch

from conftest import small
from harness import check, report, spec

CELLS = ("po_bidir_1080p.lights", "po_bidir_1080p.truck", "po_grad_4k.fit",
         "po_grad_4k.fit_truck")
SEED = 2 ** 31 + 2 ** 20 + 3
CPU = torch.device("cpu")


def run(cell, seed=SEED):
    return report.run_cell(cell, seed, 0.2, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_reference_is_the_plain_path(name):
    """On the CPU the program runs its kernels' plain versions, of which
    the reference is a frozen copy: every number compared reads 0."""
    out = run(small(spec.load_cell(name)))
    assert out["correct"]
    assert all(c["value"] == 0.0 for c in out["checks"].values()), out


def control_numbers(cell, seed=SEED) -> dict:
    """The control's numbers against the reference on what a run of
    ``cell`` hands the check."""
    import calibrate

    got = calibrate.program_answer(cell, seed, CPU)
    ref = check.reference_answer(cell, CPU, seed, got)
    ctl = check.reference_answer(cell, CPU, seed, got, control=True)
    return check.numbers(cell, ctl, ref)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small(spec.load_cell(name))
    judged = check.judged(control_numbers(cell), cell.check["limits"])
    assert not all(j["ok"] for j in judged.values()), judged


def caught_faults():
    """(cell, fault) for each fault under ``faults/`` that applies to the
    cell's kind and that a number of the check is held against."""
    out = []
    for c in CELLS:
        kind = spec.load_cell(c).traffic["kind"]
        for f in spec.fault_names():
            mod = spec.load_fault(f)
            if kind in mod.KINDS and getattr(mod, "CAUGHT", True):
                out.append((c, f))
    return out


@pytest.mark.parametrize("name,fault", caught_faults())
def test_a_fault_under_the_timed_path_is_caught(name, fault):
    cell = small(spec.load_cell(name))
    with spec.load_fault(fault).planted():
        out = run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(cuda, name):
    """The control at the cell's own size on three seeds: each fails."""
    cell = spec.load_cell(name)
    for seed in (SEED, SEED + 1, SEED + 2):
        import calibrate

        got = calibrate.program_answer(cell, seed, cuda)
        ref = check.reference_answer(cell, cuda, seed, got)
        ctl = check.reference_answer(cell, cuda, seed, got, control=True)
        judged = check.judged(check.numbers(cell, ctl, ref),
                              cell.check["limits"])
        assert not all(j["ok"] for j in judged.values()), (seed, judged)
