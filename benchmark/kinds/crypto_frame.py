"""A frame with its Cryptomatte layers, as the CLI renders it for an artist:
``render_frame`` under ``no_grad`` (the configuration's ``render`` asks for
the id-matte), ``resolve_aovs``, then ``resolve_crypto`` packing the
traffic's ``ranks`` RGBA layers with the configuration's object names'
spec hashes (``id_names``; the hash table is made once, in set-up).

Set-up renders ``kinds/frame.py``'s ``WARMUP`` frames on seeds no window
frame has.  The check compares one frame of the window, drawn from the
seed: ``rgba_l1`` and ``aov_off`` as ``kinds/frame.py`` computes them, and
``crypto_off``, the share of pixels at which any of the layers' ``2 *
ranks`` ranks is off against the reference's (:func:`crypto_off`).

The harness files a run's record under its traffic's kind, and the frame
readers (``frame_ms``, ``launches.frame``, ...) read a record of kind
``frame``: set-up takes the ``Run`` whose set-up calls it from its caller's
stack (``kinds/sharded_step.py``'s ``_the_run``) and files the
record as a frame's.  It also reads the configuration's ``id_names`` there,
and hands them to the reference in what the check reads.
"""
from __future__ import annotations

import importlib
import math
import os

import torch

from harness import world as wd
from harness.spec import load_module

KINDS_DIR = os.path.dirname(os.path.abspath(__file__))
frame_kind = load_module(os.path.join(KINDS_DIR, "frame.py"),
                         "bench_kinds_frame_of_crypto_frame")
WARMUP = frame_kind.WARMUP
# the Run whose set-up calls this kind's, found on the caller's stack
_the_run = load_module(os.path.join(KINDS_DIR, "sharded_step.py"),
                       "bench_kinds_sharded_step_of_crypto_frame")._the_run

# Normalised coverages lie in [0, 1]: a coverage is off by more than 1e-3
# of a pixel, ``kinds/frame.py``'s AOV_TOL on a plane of scale 1 (an 8-bit
# matte's step is 3.9e-3).  Both sides sum each run in float64 and round
# once, so rounding alone moves a coverage by ~1e-7; what moves more is K3
# placing a few hundredths of a percent of the queue's splats a pixel
# from the plain solve's, which the share's limit holds.  Two of a pixel's
# coverages within the tolerance may rank either way round.
CRYPTO_TOL = 1e-3


def _hashes(w: wd.World, names) -> torch.Tensor:
    """``w``'s side's spec float ids of ``names``, on the world's device."""
    crypto = importlib.import_module(f"{w.pkg}.render.crypto")
    return crypto.id_hash_table(list(names), device=w.m.device)


def frame(w: wd.World, seed: int, ranks: int, hashes) -> dict:
    """One frame: the resolved planes and the Cryptomatte layers."""
    with torch.no_grad():
        _, fb = w.renderer.render_frame(
            w.cfg, w.rc, w.scene, w.m, seed=seed, po_lens=w.lens,
            po_state=w.state, cam_to_world_end=w.m_end, ops=w.ops)
        planes = w.splat.resolve_aovs(w.rc, fb)
        layers = w.splat.resolve_crypto(fb, ranks=ranks, id_hashes=hashes)
    return {"planes": planes, "crypto": layers}


def setup(w: wd.World, traffic: dict, seed: int) -> tuple:
    """The hash table, then every shape the window uses warmed; (state,
    first window index)."""
    run = _the_run()
    if run.rec is not None:
        run.rec.kind = "frame"
    names = list(run.cell.config["id_names"])
    state = {"got": {}, "names": names, "ranks": int(traffic["ranks"]),
             "hashes": _hashes(w, names)}
    for i in range(WARMUP):
        frame(w, wd.unit_seed(seed, -2 - i), state["ranks"], state["hashes"])
    return state, 0


def unit(w: wd.World, state: dict, seed: int):
    """One frame's planes and layers (not yet synchronised)."""
    return frame(w, seed, state["ranks"], state["hashes"])


def done(state: dict, out, seed: int, index: int, keep: bool) -> bool:
    """Keep the frame for the check where the draw picked it."""
    if keep:
        state["got"] = {**out, "seed": seed, "index": index,
                        "id_names": state["names"]}
    return True


def reference(w: wd.World, traffic: dict, seed: int, got: dict) -> dict:
    """The frame of the same sample seed, the same names' hashes."""
    return frame(w, got["seed"], int(traffic["ranks"]),
                 _hashes(w, got["id_names"]))


def _ranks(layers) -> tuple:
    """(float ids, normalised coverages) [H, W, 2 * len(layers)] in rank
    order, from layers of (id, coverage, id, coverage)."""
    t = torch.stack(list(layers), -2).double()     # [H, W, L, 4]
    h, w = t.shape[:2]
    return t[..., 0::2].reshape(h, w, -1), t[..., 1::2].reshape(h, w, -1)


def crypto_off(got_layers, ref_layers) -> float:
    """The share of pixels at which any rank is off: its coverage more than
    :data:`CRYPTO_TOL` from the reference's, or its id not the reference's
    where the reference's coverage at that rank is more than
    :data:`CRYPTO_TOL` from each neighbouring rank's (near-ties may swap on
    rounding: ``chip_smoke.py::check_id_matte``)."""
    gid, gcov = _ranks(got_layers)
    if not bool(torch.isfinite(gcov).all() & torch.isfinite(gid).all()):
        return math.inf
    rid, rcov = _ranks(ref_layers)
    off = (gcov - rcov).abs() > CRYPTO_TOL
    close = (rcov[..., 1:] - rcov[..., :-1]).abs() <= CRYPTO_TOL
    apart = torch.ones_like(off)
    apart[..., 1:] &= ~close
    apart[..., :-1] &= ~close
    off |= apart & (gid != rid)
    return float(off.any(-1).double().mean())


def numbers(got: dict, ref: dict) -> dict:
    """``rgba_l1`` and ``aov_off`` (``kinds/frame.py``) and
    ``crypto_off``."""
    out = frame_kind.numbers(got, ref)
    out["crypto_off"] = crypto_off(got["crypto"], ref["crypto"])
    return out
