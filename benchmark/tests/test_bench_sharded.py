"""The sharded fit step (``kinds/sharded_step.py``, cell
``po_grad_4k.sharded4``) on the CPU at a small size: rank 0 in this
process, ranks 1-3 its child processes, joined by gloo.  A traced run's
set-up, two units, per-layer metrics and check; the control and every
fault of the kind fail the check; the counted bytes equal the roofline's
count; a rank that ends early is seen at once."""
import os
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import small
from harness import check, ranks, report, spec
from harness import world as wd

CELL = "po_grad_4k.sharded4"
SEED = 2 ** 33 + 29
CPU = torch.device("cpu")
# four ranks share this host's cores
torch.set_num_threads(1)


def cell():
    return small(spec.load_cell(CELL), (16, 16))


def test_traced_run_reads_its_metrics():
    out = report.run_cell(cell(), SEED, 0.2, True, CPU, time.perf_counter())
    assert out["correct"] and out["attempted"] == 2 and out["failed"] == 0
    limits = spec.load_cell(CELL).check["limits"]
    for k, v in out["checks"].items():
        assert v["value"] <= limits[k] / 100, (k, v)
    m = out["metrics"]
    # the step readers read the sharded step as a fit step
    assert m["device_idle_pct.step"]["value"] == 100.0
    assert m["trace_idle_ms.step"]["value"] > 0
    assert m["merge_bytes.step"]["value"] > 0
    # no NCCL kernel, no device time: no link share
    assert "merge_link_pct.step" not in m
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_counted_bytes_are_the_roofline_count(monkeypatch):
    from pota_tpu_torch.utils import trace

    # the program's counters add up over every traced stretch of a process
    trace.reset()
    out = report.run_cell(cell(), SEED, 0.2, True, CPU, time.perf_counter())
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    c = cell()
    w = SimpleNamespace(pkg=wd.PROGRAM, rc=SimpleNamespace(
        yres_region=16, xres_region=16),
        coeffs=(torch.zeros(5, 160), torch.zeros(2, 160)))
    ops, n_bytes = spec.roofline_count(c.base, "merge")(w)
    assert ops == 0.0
    assert out["metrics"]["merge_bytes.step"]["value"] == n_bytes


def test_a_layout_the_traffic_breaks_is_refused():
    import torch.distributed as dist

    c = cell()
    assert c.config["layout"]["world_size"] == c.traffic["world_size"] == 4
    c.traffic["world_size"] = 2
    with pytest.raises(ValueError, match="layout is 4 ranks"):
        report.run_cell(c, SEED, 0.2, False, CPU, time.perf_counter())
    assert not dist.is_initialized()


def test_control_is_not_correct():
    import calibrate

    c = cell()
    got = calibrate.program_answer(c, SEED, CPU)
    ref = check.reference_answer(c, CPU, SEED, got)
    ctl = check.reference_answer(c, CPU, SEED, got, control=True)
    judged = check.judged(check.numbers(c, ctl, ref), c.check["limits"])
    assert not all(j["ok"] for j in judged.values()), judged


def faults():
    return [f for f in spec.fault_names()
            if "sharded_step" in spec.load_fault(f).KINDS]


def test_the_kind_has_its_faults():
    assert set(faults()) == {"rank_dropped", "grads_unreduced",
                             "altered_sharded", "half_sharded",
                             "unchanged_sharded"}


@pytest.mark.parametrize("fault", faults())
def test_a_fault_under_every_rank_is_caught(fault):
    with spec.load_fault(fault).planted():
        assert os.environ[ranks.FAULTS] == fault
        out = report.run_cell(cell(), SEED, 0.2, False, CPU,
                              time.perf_counter())
    assert ranks.FAULTS not in os.environ
    assert not out["correct"], out["checks"]


def test_a_rank_that_ends_early_is_seen(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text("import sys, json\n"
                      "start = json.loads(sys.stdin.readline())\n"
                      "sys.exit(7 if start['rank'] == 2 else 0)\n")
    seen = []
    r = ranks.Ranks(str(script), 4, {}, on_death=lambda rank, code:
                    seen.append((rank, code)))
    end = time.monotonic() + 30
    while not seen and time.monotonic() < end:
        time.sleep(0.1)
    assert seen and seen[0][1] in (0, 7)
    r.stop()
    assert all(p.poll() is not None for p in r.procs)


def test_stopped_ranks_end(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text("import sys\nsys.stdin.readline()\n"
                      "for line in sys.stdin:\n"
                      "    if line.strip() == 'stop':\n        break\n")
    left = []
    r = ranks.Ranks(str(script), 3, {}, on_death=lambda *a: left.append(a),
                    after_stop=lambda: left.append("after"))
    r.send("step 1")
    procs = r.procs
    del r
    assert all(p.poll() == 0 for p in procs)
    assert left == ["after"]
