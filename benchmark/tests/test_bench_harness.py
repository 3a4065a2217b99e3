"""The harness: discovery by name, the form of the result line, the checks
of what a run loaded, and the refusal without a card."""
import json
import os
import shutil
import subprocess
import sys
import time

import torch

from conftest import BENCH, ROOT, small
from harness import report, spec

SEED = 2 ** 33 + 17


def copy_benchmark(tmp_path):
    """The benchmark's files in a temporary folder (its tests and the
    reference left out), and its ``BENCHMARK.json`` as a dict."""
    base = tmp_path / "benchmark"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests", "reference"))
    return base, spec.read_json(os.path.join(ROOT, "BENCHMARK.json"))


def add_config(base, bench, name):
    cfg = spec.read_json(os.path.join(BENCH, "configs",
                                      "po_bidir_1080p.json"))
    cfg["scene"]["args"] = {"n": 3, "spacing": 10.0, "z": -120.0,
                            "radius": 1.0, "intensity": 30.0}
    (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": name, "file": "x", "source": "x",
                             "reduced": [], "why": "x"})


def test_new_files_make_a_new_cell(tmp_path):
    """A configuration, a traffic mix, a check and a metric added as new
    files, with new ``BENCHMARK.json`` entries, run with no file of the
    harness edited."""
    base, bench = copy_benchmark(tmp_path)
    add_config(base, bench, "dummy")
    (base / "traffic" / "dummy.json").write_text(json.dumps(
        {"kind": "frame", "truck": 0.5, "trace_units": 1}))
    (base / "checks" / "dummy.lights.json").write_text(json.dumps(
        {"route": {}, "limits": {"rgba_l1": 1e-3, "aov_off": 1e-3}}))
    (base / "metrics" / "dummy_frames.py").write_text(
        "def read(rec):\n    return float(rec.units)\n")
    bench["workloads"].append({"name": "dummy.lights", "config": "dummy",
                               "traffic": "dummy", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "dummy_frames", "unit": "frames",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["dummy.lights"]})
    cell = small(spec.load_cell("dummy.lights", base=str(base),
                                bench=bench), (24, 16))
    assert cell.traffic["truck"] == 0.5
    out = report.run_cell(cell, SEED, 0.5, False, torch.device("cpu"),
                          time.perf_counter())
    assert out["correct"] and out["failed"] == 0
    assert out["metrics"]["dummy_frames"] == {
        "value": float(out["attempted"]), "unit": "frames"}
    assert "frame_ms" not in out["metrics"]
    assert "setup_s" in out["metrics"]


# a kind of unit none of the cells has: primary rays and their ray
# differentials (trace_camera_rays_with_derivs)
RAYS_KIND = '''
import importlib

from harness import world as wd


def _rays(w, seed):
    sampling = importlib.import_module(f"{w.pkg}.render.sampling")
    samples = sampling.frame_samples(w.rc, seed, device=w.m.device)
    _, d, _, der = w.renderer.trace_camera_rays_with_derivs(
        w.cfg, w.rc, samples, po_lens=w.lens, po_state=w.state, ops=w.ops)
    return {"direction": d.detach(), **{k: v.detach()
                                        for k, v in der.items()}}


def setup(w, traffic, seed):
    _rays(w, wd.unit_seed(seed, -2))
    return {"got": {}}, 0


def unit(w, state, seed):
    return _rays(w, seed)


def done(state, out, seed, index, keep):
    if keep:
        state["got"] = {"rays": out, "seed": seed}
    return True


def reference(w, traffic, seed, got):
    return {"rays": _rays(w, got["seed"])}


def numbers(got, ref):
    return {"ray_gap": max(float((got["rays"][k] - v).abs().max())
                           for k, v in ref["rays"].items())}
'''


def test_new_files_make_a_new_kind(tmp_path):
    """A kind of unit, a per-layer metric over a range of the program no
    metric had, and a roofline count read from the program's world, each
    a new file, run with no file of the harness edited."""
    base, bench = copy_benchmark(tmp_path)
    add_config(base, bench, "dummy")
    (base / "kinds" / "rays.py").write_text(RAYS_KIND)
    (base / "traffic" / "rays.json").write_text(json.dumps(
        {"kind": "rays", "trace_units": 2}))
    (base / "checks" / "dummy.rays.json").write_text(json.dumps(
        {"route": {}, "limits": {"ray_gap": 0.0}}))
    (base / "metrics" / "sample_calls.rays.py").write_text(
        "RANGES = ((\"render.sampling\", \"frame_samples\"),)\n\n\n"
        "def read(rec):\n"
        "    if rec.trace is None:\n        return None\n"
        "    return float(sum(1 for r in rec.trace.ranges\n"
        "                     if r[0] == \"frame_samples\"))\n")
    (base / "roofline" / "rays.py").write_text(
        "def count(w):\n"
        "    n = w.rc.xres * w.rc.yres * w.rc.spp\n"
        "    return 100.0 * n, 48.0 * n\n")
    (base / "metrics" / "rays_bytes.rays.py").write_text(
        "from harness.spec import roofline_count\n\n\n"
        "def read(rec):\n"
        "    if rec.world is None or rec.trace is None:\n"
        "        return None\n"
        "    return roofline_count(rec.base, \"rays\")(rec.world)[1]\n")
    bench["workloads"].append({"name": "dummy.rays", "config": "dummy",
                               "traffic": "rays", "chips": 1, "why": "x"})
    for name in ("sample_calls.rays", "rays_bytes.rays"):
        bench["per_layer"].append({
            "name": name, "unit": "1", "better": "lower",
            "source": "device_trace", "layer": "x", "moves": "setup_s",
            "workloads": ["dummy.rays"]})
    cell = small(spec.load_cell("dummy.rays", base=str(base),
                                bench=bench), (24, 16))
    assert ("render.sampling", "frame_samples") in cell.ranges()
    out = report.run_cell(cell, SEED, 0.5, True, torch.device("cpu"),
                          time.perf_counter())
    assert out["correct"] and out["failed"] == 0, out
    assert out["attempted"] == 2
    assert out["checks"] == {"ray_gap": {"value": 0.0, "limit": 0.0}}
    # the range wrapped once a unit, and the count read from the world
    assert out["metrics"]["sample_calls.rays"]["value"] == 2.0
    assert out["metrics"]["rays_bytes.rays"]["value"] == 48.0 * 24 * 16
    # the program's functions are back as they were
    from pota_tpu_torch.render import sampling
    assert not hasattr(sampling.frame_samples, "__wrapped__")


def test_metrics_ask_for_their_ranges():
    """The traced stretch wraps what the cell's per-layer metrics list."""
    got = spec.load_cell("po_bidir_1080p.lights").ranges()
    assert ("render.renderer", "render_sample_stream") in got
    assert ("render.splat", "splat_frame") in got
    assert len(got) == len(set(got))


def test_result_line(capsys):
    cell = small(spec.load_cell("po_bidir_1080p.lights"), (24, 16))
    out = report.run_cell(cell, SEED, 0.2, False, torch.device("cpu"),
                          time.perf_counter())
    report.emit(out)
    std = capsys.readouterr()
    line = json.loads(std.out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1
    for m in ("frame_ms", "frame_p95_ms", "setup_s"):
        assert line["metrics"][m]["value"] > 0
    assert set(line["checks"]) == {"rgba_l1", "aov_off"}
    tail = std.err.strip().splitlines()[-2:]
    assert [t.split()[1] for t in tail] == ["rgba_l1", "aov_off"]
    assert all(" limit " in t for t in tail)


def test_the_traced_stretch_reads_its_metrics():
    cell = small(spec.load_cell("po_grad_4k.fit"), (16, 16))
    cell.traffic["trace_units"] = 1
    out = report.run_cell(cell, SEED, 0.2, True, torch.device("cpu"),
                          time.perf_counter())
    assert out["correct"]
    # the CPU runs no device operation: the share idle is all of it, and
    # no busy time or roofline is read
    assert out["metrics"]["device_idle_pct.step"]["value"] == 100.0
    assert "splat_busy_ms.step" not in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_forbidden_modules(tmp_path, monkeypatch):
    assert report.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert report.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib.fake")
    # the program's name starts with the JAX package's: compared whole
    monkeypatch.setitem(sys.modules, "pota_tpu_torch_x", object())
    assert report.forbidden_modules() == []
    bad = tmp_path / "mod.py"
    bad.write_text("import os\nfrom pota_tpu_torch.ops import KERNELS\n")
    assert report._imports(str(bad)) == {"os", "pota_tpu_torch"}


def test_reference_imports_nothing_of_the_program():
    for dirpath, _, files in os.walk(report.REFERENCE_DIR):
        for f in files:
            if f.endswith(".py"):
                names = report._imports(os.path.join(dirpath, f))
                assert not names & {*report.BANNED, "pota_tpu_torch"}, f


def test_no_card_no_result():
    if torch.cuda.is_available():
        return
    env = {k: v for k, v in os.environ.items() if k != "BENCH_RUN"}
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "po_bidir_1080p.lights", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
