"""A step of the lens fit split over ranks, as BASELINE config 5 publishes
it: the program's ``parallel/sharded.py::train_step_sharded`` over a
``torch.distributed`` group of the traffic's ``world_size`` ranks, then the
descent (:func:`harness.world.descend`) on the all-reduced gradients.

Each rank traces and splats its contiguous quarter of the frame's sample
stream (a band of rows) into a full-frame partial framebuffer; the
partials merge by an all-to-all of row bands and a sum in rank order
(``halo_rows=None``); the loss and the gradients are all-reduced, so every
rank makes the same descent.

Rank 0 is the run's own process, its world and device the run's.  Ranks
1..n-1 are child processes (:class:`harness.ranks.Ranks`: this file run as
a script), rank ``r`` on ``cuda:r`` (NCCL) or, where the run's device is
the CPU, on the CPU (gloo); each builds its own world
(:func:`harness.world.build`) from the cell's configuration once rank 0 has
built the kernels, and is driven unit by unit from rank 0.  The group
has a timeout (:data:`TIMEOUT_S`); a rank that ends early ends the run.

Set-up, window and check follow ``kinds/step.py``, whose ``numbers`` this
kind uses: set-up renders the plate with the unperturbed fit (the sharded
frame, its bands gathered), perturbs the fit from the seed, and drives
every rank through ``SETUP_STEPS`` steps; the check compares the first
step's beauty (gathered from the bands), the losses, the first gradient
and the first change against the plain reference from the same
perturbation (:func:`reference`).

The reference renders the frame as the ranks do, in one process: each
rank's band of the sample stream through the plain path
(``benchmark/reference/``: ``render_sample_stream`` and ``splat_frame``,
the band's splat queue sized and rescaled from its own samples), the
partial framebuffers merged as the sharded frame defines it (gaussian
planes summed in rank order; each pixel's closest planes from the rank of
least depth, the lowest on a tie), then the loss over the whole frame,
``backward`` and the descent.  A band's queue is its own: at 4K the frame
fills ~97% of its queue, and a band whose sources ask for more than its
quarter is rescaled alone, so the sharded frame is not the one-process
frame there.

The harness hands a kind neither its cell nor its record: set-up takes
both from the ``Run`` whose set-up calls it (:func:`_the_run`), for the
cell's configuration (the ranks build their worlds from it) and to file
the record as a fit step's, so that the step readers (``step_ms``,
``launches.step``, ...) read it.
"""
from __future__ import annotations

import datetime
import importlib
import json
import math
import os
import sys

KINDS_DIR = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(KINDS_DIR)
if __name__ == "__main__":   # a rank's process: the benchmark on the path
    sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import torch  # noqa: E402

from harness import ranks as rk  # noqa: E402
from harness import world as wd  # noqa: E402
from harness.spec import load_module  # noqa: E402

step_kind = load_module(os.path.join(KINDS_DIR, "step.py"),
                        "bench_kinds_step_of_sharded")
SETUP_STEPS = step_kind.SETUP_STEPS
REF_STEPS = step_kind.REF_STEPS
numbers = step_kind.numbers

# the process group's timeout: a collective that waits longer fails
TIMEOUT_S = 180


def _the_run():
    """The harness's ``Run`` whose set-up called this kind's."""
    from harness.loop import Run

    f = sys._getframe(1)
    while f is not None:
        run = f.f_locals.get("self")
        if isinstance(run, Run):
            return run
        f = f.f_back
    raise RuntimeError("sharded_step: set-up must be called by a "
                       "harness.loop.Run")


def _sharded(pkg: str):
    sh = importlib.import_module(f"{pkg}.parallel.sharded")
    if not hasattr(sh, "gather_rows"):
        raise RuntimeError(f"{pkg}.parallel.sharded has no gather_rows: "
                           "this program cannot run a sharded fit step")
    return sh


def _whole(sh, w, mesh, img):
    """The whole frame from this rank's part of it (a band of rows where
    the rows divide by the world size, else the frame itself)."""
    if w.rc.yres_region % mesh.size:
        return img
    return sh.gather_rows(img, mesh)


def _step(sh, w, mesh, target, seed: int, descent: float,
          image: bool = False):
    """One sharded step and the descent; ``(loss, grads[, band])``."""
    for c in w.coeffs:
        c.grad = None
    out = sh.train_step_sharded(w.cfg, w.rc, w.scene, w.m, mesh, target,
                                w.lens, w.state, seed=seed,
                                return_image=image)
    for c, g in zip(w.coeffs, out[1]):
        c.grad = g
    wd.descend(w, descent)
    return out


def _fit(sh, w, mesh, traffic: dict, seed: int) -> tuple:
    """Every rank's set-up: the plate (the unperturbed fit's sharded frame,
    gathered), the perturbation (rank 0's bits, broadcast) and the first
    ``SETUP_STEPS`` steps; (plate, what the check reads)."""
    import torch.distributed as dist

    with torch.no_grad():
        img, _ = sh.render_frame_sharded(
            w.cfg, w.rc, w.scene, w.m, mesh, seed=wd.unit_seed(seed, -1),
            po_lens=w.lens, po_state=w.state)
        target = _whole(sh, w, mesh, img)
    noise = step_kind.make_noise(w.coeffs, seed, mesh.device)
    wd.perturb(w, noise, traffic["perturbation"])
    with torch.no_grad():
        for c in w.coeffs:
            dist.broadcast(c, 0, group=mesh.group)
    got = {"losses": [], "c0": [c.detach().clone() for c in w.coeffs],
           "cs": [], "noise": noise}
    for k in range(SETUP_STEPS):
        out = _step(sh, w, mesh, target, wd.unit_seed(seed, k),
                    traffic["descent_step"], image=k == 0)
        got["losses"].append(float(out[0]))
        if k == 0:
            got["image"] = _whole(sh, w, mesh, out[2]).cpu()
            got["grad"] = [g.detach().clone() for g in out[1]]
        got["cs"].append([c.detach().clone() for c in w.coeffs])
    return target, got


def _join(backend: str, init: str, rank: int, n: int):
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=n,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def setup(w: wd.World, traffic: dict, seed: int) -> tuple:
    """Rank 0's set-up: the kernels built, ranks 1..n-1 started, the group
    joined, every rank's plate and first steps; (state, first window
    index).  Ranks 1..n-1 stop when the state is freed."""
    run = _the_run()
    if run.rec is not None:
        run.rec.kind = "step"
    sh = _sharded(w.pkg)
    device = torch.device(w.m.device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        importlib.import_module(f"{w.pkg}.ops._build").lib()
    n = int(traffic["world_size"])
    layout = run.cell.config.get("layout", {}).get("world_size", n)
    if int(layout) != n:
        raise ValueError(f"the configuration's layout is {layout} ranks, "
                         f"the traffic's world_size {n}")
    init = f"tcp://localhost:{rk.free_port()}"
    ranks = rk.Ranks(os.path.abspath(__file__), n, {
        "config": run.cell.config, "traffic": traffic, "seed": seed,
        "n": n, "init": init, "backend": backend}, after_stop=_leave)
    _join(backend, init, 0, n)
    mesh = sh.make_mesh(n, backend)
    target, got = _fit(sh, w, mesh, traffic, seed)
    return {"got": got, "target": target, "traffic": traffic, "sh": sh,
            "mesh": mesh, "ranks": ranks}, SETUP_STEPS


def _leave() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def unit(w: wd.World, state: dict, seed: int):
    """One sharded step on every rank; rank 0's loss (a device scalar, the
    all-reduced loss)."""
    state["ranks"].send(f"step {seed}")
    return _step(state["sh"], w, state["mesh"], state["target"], seed,
                 state["traffic"]["descent_step"])[0]


def done(state: dict, out, seed: int, index: int, keep: bool) -> bool:
    """A step whose loss is not finite failed."""
    return math.isfinite(float(out))


def _banded_frame(w: wd.World, seed: int, n: int,
                  differentiable: bool = False):
    """The resolved beauty of the frame rendered as ``n`` ranks render it,
    each band of the sample stream on its own (the plain path of ``w``'s
    side), the partial framebuffers merged in rank order."""
    sampling = importlib.import_module(f"{w.pkg}.render.sampling")
    dev = w.m.device
    samples = sampling.frame_samples(w.rc, seed, device=dev)
    size = samples["px"].shape[0] // n
    parts = []
    with torch.enable_grad() if differentiable else torch.no_grad():
        for r in range(n):
            band = {k: v[r * size:(r + 1) * size] for k, v in samples.items()}
            stream = w.renderer.render_sample_stream(
                w.cfg, w.rc, w.scene, w.m, seed, po_lens=w.lens,
                po_state=w.state, ops=w.ops, differentiable=differentiable,
                samples=band)
            parts.append(w.splat.splat_frame(
                w.cfg, w.rc, w.scene, stream, w.m, po_lens=w.lens,
                po_state=w.state, ops=w.ops, differentiable=differentiable))
        aov = importlib.import_module(f"{w.pkg}.render.aov")
        closest = {a.name for a in aov.DEFAULT_AOVS
                   if a.filter == aov.CLOSEST}
        z = torch.stack([p["zmin"] for p in parts])
        winner = torch.argmin(z, 0)   # the first (lowest) rank on a tie
        merged = {}
        for k in parts[0]:
            if k in closest:
                stack = torch.stack([p[k] for p in parts])
                merged[k] = torch.gather(
                    stack, 0, winner[None, ..., None].expand(
                        1, *stack.shape[1:]))[0]
            elif k == "zmin":
                merged[k] = z.min(0).values
            else:
                acc = torch.zeros_like(parts[0][k])
                for p in parts:
                    acc = acc + p[k]
                merged[k] = acc
        return w.splat.resolve_imager(w.rc, merged)


def reference(w: wd.World, traffic: dict, seed: int, got: dict) -> dict:
    """The plain reference's plate and first ``REF_STEPS`` steps from the
    same perturbation, each frame rendered band by band
    (:func:`_banded_frame`), the loss the mean squared error over the whole
    frame; in the form :func:`kinds.step.fit_steps` gives."""
    n = int(traffic["world_size"])
    target = _banded_frame(w, wd.unit_seed(seed, -1), n)
    wd.perturb(w, got["noise"], traffic["perturbation"])
    out = {"losses": [], "c0": [c.detach().clone() for c in w.coeffs],
           "cs": []}
    for k in range(REF_STEPS):
        for c in w.coeffs:
            c.grad = None
        img = _banded_frame(w, wd.unit_seed(seed, k), n, differentiable=True)
        loss = ((img - target) ** 2).mean()
        loss.backward()
        wd.descend(w, traffic["descent_step"])
        out["losses"].append(float(loss.detach()))
        if k == 0:
            out["image"] = img.detach().cpu()
            out["grad"] = [c.grad.detach().clone() for c in w.coeffs]
        out["cs"].append([c.detach().clone() for c in w.coeffs])
        del img, loss
    return out


def rank_main() -> int:
    """A rank 1..n-1: join, build, set up as rank 0 does, then one step a
    ``step <seed>`` line until ``stop`` or the end of the input."""
    rk.watch_parent()
    start = json.loads(sys.stdin.readline())
    backend, rank = start["backend"], start["rank"]
    if backend == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        # the host's cores shared among the ranks' processes
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // start["n"]))
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    traffic = start["traffic"]
    with rk.planted_here(BENCH):
        w = wd.build(wd.PROGRAM, start["config"], traffic, device)
        sh = _sharded(w.pkg)
        _join(backend, start["init"], rank, start["n"])
        mesh = sh.make_mesh(start["n"], backend)
        target, _ = _fit(sh, w, mesh, traffic, start["seed"])
        for line in sys.stdin:
            op, *arg = line.split()
            if op == "stop":
                break
            _step(sh, w, mesh, target, int(arg[0]), traffic["descent_step"])
        _leave()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
