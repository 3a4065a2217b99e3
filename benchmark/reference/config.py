"""Camera / render configuration (the port's own copy of
:mod:`pota_tpu.config`, field for field; the port imports nothing of
``pota_tpu``).

Field-for-field equivalent of the reference's camera node parameters
(zpelgrims/pota ``src/lentil_camera.cpp:19-52``).  Canonical defaults follow
the C++ node defaults, not the UI DSL (see SURVEY.md Appendix B: the two
disagree; .ass files get the C++ values).

The config is a frozen dataclass of Python scalars, so every gate the
reference evaluates per ray is a Python branch taken once per frame.
:func:`config_from_fields` builds these classes from another package's
field dict (``dataclasses.asdict``), mapping enum members by name.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class CameraType(enum.IntEnum):
    THIN_LENS = 0
    POLYNOMIAL_OPTICS = 1


class UnitModel(enum.IntEnum):
    MM = 0
    CM = 1
    DM = 2
    M = 3


class ChromaticType(enum.IntEnum):
    GREEN_MAGENTA = 0
    RED_CYAN = 1


# scale factor applied to thin-lens rays per unit model (ref src/lentil.h:540-561)
THINLENS_UNIT_SCALE = {UnitModel.MM: 10.0, UnitModel.CM: 1.0, UnitModel.DM: 0.1, UnitModel.M: 0.01}
# scale factor applied to PO rays per unit model, incl. the ray reversal
# (ref src/lentil.h:395-416)
PO_UNIT_SCALE = {UnitModel.MM: -1.0, UnitModel.CM: -0.1, UnitModel.DM: -0.01, UnitModel.M: -0.001}
# world units -> camera-space scale used by the filter (ref src/lentil_filter.cpp:145-150)
FILTER_UNIT_SCALE = {UnitModel.MM: 0.1, UnitModel.CM: 1.0, UnitModel.DM: 10.0, UnitModel.M: 100.0}


def _clamp(x, lo, hi):
    return min(max(x, lo), hi)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """All user-facing camera parameters (defaults = reference C++ defaults)."""

    camera_type: CameraType = CameraType.THIN_LENS
    units: UnitModel = UnitModel.CM
    sensor_width: float = 36.0          # mm
    enable_dof: bool = True
    fstop: float = 0.0                  # 0.0 = wide open (PO sentinel)
    focus_distance: float = 150.0       # in scene units (cm default), like focus_dist
    aperture_blades: int = 0
    exposure: float = 1.0
    lens_model: str = "cooke__speed_panchro__1920__40mm"
    wavelength: float = 550.0           # nm
    extra_sensor_shift: float = 0.0     # mm
    focal_length: float = 35.0          # mm (thin-lens)
    optical_vignetting_distance: float = 0.0
    optical_vignetting_radius: float = 1.0
    abb_spherical: float = 0.5
    abb_distortion: float = 0.0
    abb_coma: float = 0.0
    abb_chromatic: float = 0.0
    abb_chromatic_type: ChromaticType = ChromaticType.GREEN_MAGENTA
    circle_to_square: float = 0.0
    bokeh_anamorphic: float = 0.0       # raw user value; effective = 1 - value
    bokeh_enable_image: bool = False
    bokeh_image_path: Optional[str] = None
    vignetting_retries: int = 15
    bidir_sample_mult: int = 5
    bidir_add_energy: float = 0.0
    bidir_add_energy_minimum_luminance: float = 2.0
    bidir_add_energy_transition: float = 1.0
    enable_bidir_transmission: bool = False
    enable_skydome: bool = False

    # TPU-build additions (no reference counterpart): static shape controls.
    # The reference uses data-dependent loops; XLA needs static bounds.
    #
    # The bidirectional splat runs on a flat *queue* of slots: every
    # redistributed sample claims ``budget`` (x3 when chromatic) contiguous
    # slots via a cumsum of budgets, so big-CoC highlights get their full
    # [4, 2000] budget (ref src/lentil_filter.cpp:197-202) instead of a flat
    # per-sample lane cap.  ``splat_queue_mult`` sizes the static queue as
    # ``mult * n_samples``; when the frame's total budget exceeds the queue,
    # budgets are rescaled proportionally (the analog of the reference's
    # 5x overshoot cap — a *global* work bound instead of a per-sample one).
    max_bidir_samples: int = 2000       # per-sample budget clamp (ref: 2000)
    splat_queue_mult: int = 16          # splat queue slots per AA sample
    # Backward-splat Newton depth.  Measured on the flagship 160-term fit:
    # 3 iterations already agree with 8 to p99 8.6e-6 mm sensor position
    # (1 px at 1080p = 0.019 mm), so deeper solves only burn VPU time.
    lt_newton_iterations: int = 3
    # Sequentialize the queue's heavy per-slot stages (backward Newton
    # projection + occlusion probes) over this many lax.map chunks.  The
    # stages' working set scales with the live chunk, so HBM temp usage
    # drops ~1/chunks while the scatter stays one fused pass: a 1080p
    # frame's 16M-slot queue compiles in ~56G of temps unchunked (v5e OOM)
    # and fits comfortably at 16 chunks.  1 = fully parallel (small frames).
    splat_chunks: int = 1
    # Sequentialize the FORWARD trace over this many lax.map chunks (with
    # rematerialization: the chunk body recomputes in the backward pass).
    # The pure-path pt_sample_aperture holds a [N, K, T] monomial temp —
    # 16 GB at 4K/160 terms unchunked; 32 chunks bound it at ~0.5 GB, which
    # is what lets BASELINE config 5 (4K differentiable step) fit HBM.
    trace_chunks: int = 1
    # When False, gradients treat the backward-splat landing positions as
    # constant (energy values stay differentiable through the forward
    # trace); collapses the training-step transpose graph dramatically.
    differentiate_splat_geometry: bool = True

    # ------------------------------------------------------------------ derived
    @property
    def effective_fstop(self) -> float:
        return max(self.fstop, 0.01)

    @property
    def effective_focal_length(self) -> float:
        return max(self.focal_length, 0.01)

    @property
    def effective_abb_spherical(self) -> float:
        return _clamp(self.abb_spherical, 0.001, 0.999)

    @property
    def effective_circle_to_square(self) -> float:
        return _clamp(self.circle_to_square, 0.01, 0.99)

    @property
    def effective_anamorphic(self) -> float:
        # ref src/lentil.h:1228-1229: stored as 1 - user value, clamped [0,1]
        return _clamp(1.0 - self.bokeh_anamorphic, 0.0, 1.0)

    @property
    def lambda_um(self) -> float:
        return self.wavelength * 0.001

    @property
    def thinlens_aperture_radius(self) -> float:
        # ref src/lentil.h:1667
        return (self.effective_focal_length / (2.0 * self.effective_fstop)) / 10.0

    @property
    def thinlens_fov(self) -> float:
        import math
        return 2.0 * math.atan(self.sensor_width / (2.0 * self.effective_focal_length))

    @property
    def thinlens_tan_fov(self) -> float:
        import math
        return math.tan(self.thinlens_fov / 2.0)

    @property
    def unit_scale_thinlens(self) -> float:
        return THINLENS_UNIT_SCALE[UnitModel(self.units)]

    @property
    def unit_scale_po(self) -> float:
        return PO_UNIT_SCALE[UnitModel(self.units)]

    @property
    def unit_scale_filter(self) -> float:
        return FILTER_UNIT_SCALE[UnitModel(self.units)]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Frame/output configuration (the reference reads these from Arnold options)."""

    xres: int = 256
    yres: int = 256
    spp: int = 16                  # AA samples per pixel (squared count, like AA_samples**2)
    region_min_x: int = 0
    region_min_y: int = 0
    region_max_x: Optional[int] = None   # inclusive, like Arnold's region
    region_max_y: Optional[int] = None
    filter_width: float = 1.5      # ref src/lentil.h:1083-1088 (1.0 if OIDN)
    enable_redistribution: bool = True
    enable_id_matte: bool = False  # cryptomatte-style ranked id coverage AOV
    # Reference-parity AA gate: the reference disables redistribution when
    # the sample density is below the final AA level (inv_density > 0.2,
    # src/lentil_filter.cpp:79-88,108-113 — IPR/preview passes).  Here spp
    # is explicit, so the gate is opt-in; a per-sample "inv_density" stream
    # field always applies the 0.2 threshold regardless of this flag.
    enforce_aa_gate: bool = False

    @property
    def xres_region(self) -> int:
        mx = self.region_max_x if self.region_max_x is not None else self.xres - 1
        return mx - self.region_min_x + 1

    @property
    def yres_region(self) -> int:
        my = self.region_max_y if self.region_max_y is not None else self.yres - 1
        return my - self.region_min_y + 1


_ENUM_FIELDS = {"camera_type": CameraType, "units": UnitModel,
                "abb_chromatic_type": ChromaticType}


def config_from_fields(cls, fields: dict):
    """``cls`` (:class:`CameraConfig` or :class:`RenderConfig`) from a dict
    of field values, e.g. ``dataclasses.asdict`` of another package's
    config.  Enum values map to this module's members by ``.name`` (plain
    ints by value)."""
    if cls not in (CameraConfig, RenderConfig):
        raise TypeError(f"not a config class of this package: {cls!r}")
    kw = dict(fields)
    for key, enum_cls in _ENUM_FIELDS.items():
        if key in kw:
            v = kw[key]
            kw[key] = enum_cls[v.name] if hasattr(v, "name") else enum_cls(v)
    return cls(**kw)


def require_port_configs(cfg=None, rc=None) -> None:
    """Raise ``TypeError`` unless ``cfg`` / ``rc`` are this package's
    classes: another package's config would be read field by field with
    its own enums (convert with :func:`config_from_fields`)."""
    for obj, cls in ((cfg, CameraConfig), (rc, RenderConfig)):
        if obj is not None and not isinstance(obj, cls):
            raise TypeError(
                f"expected reference.config.{cls.__name__}, got "
                f"{type(obj).__module__}.{type(obj).__name__} (convert it "
                "with reference.config.config_from_fields)")
