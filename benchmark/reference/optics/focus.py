"""Focus search and f-stop calibration for the PO camera (port of
:mod:`pota_tpu.optics.focus`).  The batched polynomial evaluations run on
the lens's device; selection over the candidates happens on the host in
numpy, as in JAX."""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from . import geometry as geo
from .polynomial import (
    PolyLens,
    inner_pupil_ok,
    lt_sample_aperture,
    pt_evaluate,
    pt_sample_aperture,
)

log = logging.getLogger("reference.camera_po")

_BIG = 1e9
# the target distance (mm) of the infinity estimates
_INFINITY_MM = 999999999.0
# sensor-shift hard limit (ref camera_set_focus clamp, src/lentil.h:1500-1516)
SENSOR_SHIFT_LIMIT_MM = 45.0


def logarithmic_shift_candidates(step: float = 1e-4) -> np.ndarray:
    """Sensor shifts swept by the reference's logarithmic_values
    (src/lens.h:395-407): sign(i) * i^2 * 45 mm for i in [-1, 1]."""
    i = np.arange(-1.0, 1.0 + step * 0.5, step)
    return np.sign(i) * i ** 2 * 45.0


@torch.no_grad()
def _axial_probe_distance(lens: PolyLens, shifts, lam: float):
    """Scene-side y = 0 crossing distance of an axial probe ray per shift
    (ref camera_get_y0_intersection_distance, src/lentil.h:1361-1386)."""
    dev = lens.device
    n = shifts.shape[0]
    sensor = torch.zeros((n, 5), device=dev)
    sensor[:, 4] = lam
    ap_target = torch.tensor(
        [0.0, lens.aperture_housing_radius * 0.25], device=dev).expand(n, 2)
    sensor = pt_sample_aperture(lens, sensor, ap_target)
    shifted = sensor.clone()
    shifted[:, 0] += sensor[:, 2] * shifts
    shifted[:, 1] += sensor[:, 3] * shifts
    out4, trans = pt_evaluate(lens, shifted)
    R = lens.outer_pupil_curvature_radius
    pos, direction = geo.chart_to_cs(out4[:, :2], out4[:, 2:4], -R, R,
                                     lens.outer_chart)
    hit = geo.line_plane_intersection_y0(pos, direction)
    ok = ((trans > 0.0)
          & (out4[:, 0] ** 2 + out4[:, 1] ** 2 <= lens.outer_pupil_radius ** 2)
          & inner_pupil_ok(lens, shifted))
    return hit[:, 2], ok


def _focus_sweep(lens: PolyLens, lam: float):
    """The axial probe over every logarithmic candidate shift, on the host:
    (shifts, crossing distance float64, ok)."""
    shifts = logarithmic_shift_candidates()
    dist, ok = _axial_probe_distance(
        lens, torch.tensor(shifts, dtype=torch.float32, device=lens.device),
        lam)
    return shifts, dist.double().cpu().numpy(), ok.cpu().numpy()


def _best_shift(sweep, target_mm: float):
    """Index of the swept shift whose probe ray crosses closest below
    ``target_mm`` (ref src/lentil.h:1445-1460), or None when none does."""
    _, dist, ok = sweep
    delta = target_mm - dist
    candidates = np.where(ok & (delta > 0.0), delta, np.inf)
    best = int(np.argmin(candidates))
    return best if np.isfinite(candidates[best]) else None


def logarithmic_focus_search(lens: PolyLens, focus_distance_mm: float,
                             lam: float = 0.55) -> float:
    """Best sensor shift (mm) focusing at ``focus_distance_mm``, as a
    float32 candidate like JAX's (0 when no probe ray crosses below the
    target).  :func:`setup_po_camera` picks the same candidate from its own
    sweep and keeps it in float64, as JAX's setup does."""
    sweep = _focus_sweep(lens, lam)
    best = _best_shift(sweep, focus_distance_mm)
    return 0.0 if best is None else float(np.float32(sweep[0][best]))


def focus_check(lens: PolyLens, sensor_shift: float, lam: float = 0.55):
    """Scene distance at which the shifted sensor focuses, and whether the
    probe ray passes (ref trace_ray_focus_check, src/lentil.h:1316-1357)."""
    dist, ok = _axial_probe_distance(
        lens, torch.tensor([sensor_shift], dtype=torch.float32,
                           device=lens.device), lam)
    return float(dist[0]), bool(ok[0])


def focus_infinity_shift(lens: PolyLens, lam: float = 0.55) -> float:
    """Infinity-focus sensor shift by the logarithmic search (the
    reference's second infinity estimate, src/lentil.h:1621-1624)."""
    return logarithmic_focus_search(lens, _INFINITY_MM, lam)


def camera_set_focus_infinity(lens: PolyLens, lam: float = 0.55) -> float:
    """Sensor shift focusing parallel light, by one backward trace of a ray
    at height ``aperture_housing_radius * 0.1`` (ref src/lentil.h:1524-1563).
    NaN -> 0."""
    dev = lens.device
    h = lens.aperture_housing_radius * 0.1
    target = torch.tensor([[0.0, h, _BIG]], device=dev)
    ap = torch.tensor([[0.0, h]], device=dev)
    with torch.no_grad():
        sensor5, _, _ = lt_sample_aperture(lens, target, ap, lam)
    s = sensor5.double().cpu().numpy()[0]
    offs, cnt = 0.0, 0
    for k in range(2):
        if s[2 + k] > 0.0:
            offs += s[k] / s[2 + k]
            cnt += 1
    if cnt == 0:
        return 0.0
    offset = offs / cnt
    return float(offset) if np.isfinite(offset) else 0.0


@torch.no_grad()
def _fstop_scan(lens: PolyLens, h, lam: float):
    """Marginal-ray f-number per parallel-ray height."""
    target = torch.stack(
        [torch.zeros_like(h), h, torch.full_like(h, _BIG)], -1)
    ap = torch.stack([torch.full_like(h, 0.01), h], -1)
    sensor5, out4, trans = lt_sample_aperture(lens, target, ap, lam)
    ok = (trans > 0.0) & inner_pupil_ok(lens, sensor5)
    Ri = lens.inner_pupil_curvature_radius
    pos, _ = geo.chart_to_cs(out4[:, :2], out4[:, 2:4],
                             -Ri + lens.back_focal_length, Ri,
                             lens.inner_chart)
    theta = torch.arctan(pos[:, 1] / pos[:, 2])
    return 1.0 / (torch.sin(theta) * 2.0), ok


def calibrate_fstop(lens: PolyLens, fstop_target: float, lam: float = 0.55,
                    n_rays: int = 1000):
    """F-stop -> aperture radius: the largest parallel-ray height whose
    f-number still exceeds the target (ref src/lentil.h:1390-1441)."""
    heights = np.arange(1, n_rays) / n_rays * lens.outer_pupil_radius
    fstop, ok = _fstop_scan(
        lens, torch.tensor(heights, dtype=torch.float32, device=lens.device),
        lam)
    fstop = fstop.double().cpu().numpy()
    ok = ok.cpu().numpy()
    best_f, best_r = 0.0, 0.0
    for i in range(len(heights)):
        if not ok[i]:
            continue
        if fstop[i] < fstop_target:
            break
        best_f, best_r = float(fstop[i]), float(heights[i])
    return best_f, best_r


@dataclasses.dataclass(frozen=True)
class POState:
    """Derived per-render camera state (python floats)."""

    aperture_radius: float
    sensor_shift: float
    focus_distance: float
    tan_fov: float


def setup_po_camera(lens: PolyLens, cfg, scene=None) -> POState:
    """Camera setup for PO (ref src/lentil.h:1568-1661): aperture radius from
    the f-stop calibration, sensor shift from one probe sweep over the
    20,001 logarithmic candidates, clamped to +-45 mm.  ``scene`` is accepted
    for signature parity with JAX (which prebuilds kernels there); the
    port's kernels take the lens as runtime data and need no prebuild."""
    del scene
    lam = cfg.lambda_um
    focus_distance = cfg.focus_distance * 10.0
    if cfg.fstop == 0.0:
        aperture_radius = lens.aperture_radius_at_fstop
    else:
        _, calibrated_r = calibrate_fstop(lens, cfg.effective_fstop, lam)
        aperture_radius = min(lens.aperture_radius_at_fstop, calibrated_r)
        if aperture_radius <= 0.0:
            aperture_radius = lens.aperture_radius_at_fstop
    # one probe sweep serves the focus search, the infinity estimate and
    # the sanity check (JAX's setup does the same)
    sweep = _focus_sweep(lens, lam)
    shifts_np, dist_np, ok_np = sweep

    def pick(target):
        best = _best_shift(sweep, target)
        return 0.0 if best is None else float(shifts_np[best])

    sensor_shift = pick(focus_distance) + cfg.extra_sensor_shift
    if abs(sensor_shift) > SENSOR_SHIFT_LIMIT_MM:
        log.warning("sensor shift %.3f mm exceeds limit +-%s mm; clamping",
                    sensor_shift, SENSOR_SHIFT_LIMIT_MM)
        sensor_shift = float(np.clip(sensor_shift, -SENSOR_SHIFT_LIMIT_MM,
                                     SENSOR_SHIFT_LIMIT_MM))
    log.info("%s: sensor_shift %.4f mm (infinity: log-search %.4f mm, "
             "parallel light-trace %.4f mm)", lens.name, sensor_shift,
             pick(_INFINITY_MM), camera_set_focus_infinity(lens, lam))
    # setup-time focus sanity check against the nearest swept candidate
    j = int(np.argmin(np.abs(shifts_np - sensor_shift)))
    if not bool(ok_np[j]):
        log.warning("%s: focus check FAILED at shift %.4f mm", lens.name,
                    sensor_shift)
    elif focus_distance > 0.0:
        rel_err = abs(float(dist_np[j]) - focus_distance) / focus_distance
        if rel_err > 0.05 and focus_distance < 1e6:
            log.warning("%s: focus test ray crosses at %.1f mm vs requested "
                        "%.1f mm", lens.name, float(dist_np[j]),
                        focus_distance)
    return POState(
        aperture_radius=float(aperture_radius),
        sensor_shift=float(sensor_shift),
        focus_distance=float(focus_distance),
        tan_fov=float(np.tan(lens.fov / 2.0)),
    )
