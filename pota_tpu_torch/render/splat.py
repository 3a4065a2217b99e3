"""Bidirectional energy redistribution (port of
:func:`pota_tpu.render.splat.splat_frame`).

The reference's per-sample splat loop (``src/lentil_filter.cpp:66-480``)
becomes a flat splat queue: the gate chain picks the samples that
redistribute, each claims a contiguous range of ``budget`` slots in a queue
of ``splat_queue_mult * N`` slots, and the slots run through the kernels:

  compact source table --K2 expand--> slot rows --projection--> (pixel, ok)
  -> success counts and weights -> stable (pixel, depth) sort
  --K4 segment accumulate--> per-pixel sums + closest winner

The projection takes the route JAX takes on a chip (:data:`LAST_ROUTE`):
the fused splat kernels of its expanded branch, K3 (PO; ``po_splat_lam``
when chromatic, ``po_splat_ext`` with image bokeh or blades) and K5 (the
plain thin lens), or its decomposed branch (``splat.py:944-1012``) for
camera motion blur and the aberrated thin lens: per-slot aperture samples,
the PO backward solve K6 (``po_backward_project``) or the thin-lens
projection in torch (``thinlens_backward_project``), the pixel map and a
world-space occlusion probe through each slot's own camera matrix.

Per-source weights are ``inv_density / successes``, so energy is conserved
exactly as in the reference's retry-until-success loop; a sample with no
successful slot falls back to its own pixel.  The JAX branch's ``_map_chunks``
queue chunking is not ported: a 1080p frame's queue fits in 80 GB at once;
only the decomposed occlusion probe runs in queue chunks (its [S, spheres,
3] temporaries would not).
"""
from __future__ import annotations

import torch

from ..config import CameraConfig, CameraType, RenderConfig, ChromaticType
from ..optics import aberrations, samplers, thinlens
from ..optics.polynomial import inner_pupil_ok
from ..ops import po_kernels as pk
from ..ops.splat_accum import accumulate_sorted
from ..utils import rng as prng
from ..utils import trace
from ..utils.trace import span
from .aov import CLOSEST, DEFAULT_AOVS, GAUSSIAN, aov_value_rgba
from .bokeh_image import bokeh_sample_alias
from .renderer import check_supported, interp_camera_matrix

# the splat route of the last splat_frame call (a test probe): "k3",
# "k3_lam", "k3_ext", "k5", "decomposed_po" or "decomposed_tl"
LAST_ROUTE = None
# queue slots per chunk of the decomposed occlusion probe
OCCLUSION_CHUNK = 1 << 21


def world_to_camera(cam_to_world):
    rot = cam_to_world[:3, :3]
    trans = cam_to_world[:3, 3]
    inv_rot = rot.T
    m = torch.eye(4, dtype=cam_to_world.dtype, device=cam_to_world.device)
    m[:3, :3] = inv_rot
    m[:3, 3] = -inv_rot @ trans
    return m


def _norm(v):
    return torch.sqrt(torch.sum(v * v, -1))


def _luminance(rgb):
    # the reference's redistribution luminance is the channel mean
    return (rgb[..., 0] + rgb[..., 1] + rgb[..., 2]) / 3.0


@span("pota.splat.gates")
def compute_gates_and_budget(cfg: CameraConfig, rc: RenderConfig, stream,
                             cam_space_pos, po_lens=None, po_state=None):
    """The redistribute-or-not gate chain and the per-sample backward budget
    (ref src/lentil_filter.cpp:105-240).  Returns (redistribute mask, budget
    [N] int32 clamped to [4, max_bidir_samples], coc [N], skydome mask)."""
    z = stream["z"]
    if "inv_density" in stream:
        inv_density = stream["inv_density"]
        redistribute = inv_density <= 0.2
    else:
        inv_density = 1.0 / rc.spp
        redistribute = torch.ones_like(z, dtype=torch.bool)
        if inv_density > 0.2 and rc.enforce_aa_gate:
            redistribute = torch.zeros_like(z, dtype=torch.bool)
    if not cfg.enable_dof or cfg.bidir_sample_mult <= 0:
        redistribute = torch.zeros_like(z, dtype=torch.bool)

    sky = (z >= 1e29) | (_norm(stream["P"]) < 1e-7)
    if cfg.enable_skydome:
        redistribute &= ~sky | (_norm(stream["raydir"]) > 1e-7)
    else:
        redistribute &= ~sky

    rgb = stream["rgba"][..., :3]
    if "volume" in stream:
        redistribute &= ~(torch.amax(stream["volume"], -1) > 0.0)
    if "transmission" in stream and not cfg.enable_bidir_transmission:
        tr = stream["transmission"][..., :3]
        transmitted = torch.amax(tr, -1) > 0.0
        redistribute &= ~transmitted
        rgb = torch.where(transmitted[..., None], rgb - tr, rgb)
    if "lentil_ignore" in stream:
        redistribute &= ~(stream["lentil_ignore"] > 0.0)

    lum = _luminance(rgb)
    lum_mult = torch.clamp(
        torch.sqrt(torch.clamp(lum, max=20.0)) * cfg.bidir_sample_mult,
        min=0.0)
    if cfg.camera_type == CameraType.POLYNOMIAL_OPTICS:
        coc = thinlens.coc_thinlens(
            cfg, cam_space_pos[..., 2],
            aperture_radius=po_state.aperture_radius,
            focus_distance=po_state.focus_distance,
        )
        redistribute &= (torch.abs(cam_space_pos[..., 2])
                         >= po_lens.lens_length * 0.1)
    else:
        coc = thinlens.coc_thinlens(cfg, cam_space_pos[..., 2])

    coc_px = (coc * rc.yres) ** 2 * lum_mult ** 2 * 1e-5
    redistribute &= coc >= 0.4
    # NaN budgets become 0 before the clip, as XLA's saturating cast does
    budget = torch.nan_to_num(torch.ceil(coc_px * inv_density), nan=0.0)
    budget = torch.clamp(budget, 4, cfg.max_bidir_samples).to(torch.int32)
    return redistribute, budget, coc, sky


def _queue_slots(budget, redistribute, queue_size: int,
                 rays_per_count: int):
    """Granted slots per source [N] int64 (``budget * rays_per_count`` for
    a redistributed source, every budget rescaled when the total exceeds
    ``queue_size``, never below one budget unit), their range starts and
    the live-slot mask [S]."""
    slots = torch.where(redistribute, budget.to(torch.int64) * rays_per_count,
                        0)
    total = torch.sum(slots.to(torch.float32))
    scale = torch.clamp(
        (queue_size * (1.0 - 1e-6)) / torch.clamp(total, min=1.0), max=1.0)
    scaled = torch.floor(slots.to(torch.float32) * scale).to(torch.int64)
    slots = torch.where(slots > 0, torch.clamp(scaled, min=rays_per_count), 0)
    offsets = torch.cumsum(slots, 0)
    starts = offsets - slots
    slot_on = torch.arange(queue_size, device=budget.device) < offsets[-1]
    return slots, starts, slot_on


def _slot_sources(starts, marked, queue_size: int, n: int):
    """Slot -> source: one mark at each ``marked`` source's start slot
    inside the queue, then a prefix sum."""
    marks = torch.zeros((queue_size,), dtype=torch.int64, device=starts.device)
    claim = marked & (starts < queue_size)
    # each boolean index reads the count of its True entries
    trace.host_read(claim, 2)
    marks.index_add_(0, starts[claim], torch.ones_like(starts[claim]))
    return torch.clamp(torch.cumsum(marks, 0) - 1, 0, n - 1)


def splat_queue(budget, redistribute, rays_per_count: int, queue_size: int):
    """Slot -> source mapping of the splat queue, with source ids in sample
    order (JAX's ``splat_queue``; the port's splat takes
    :func:`splat_queue_compact`, whose slot layout is the same).  Returns
    (src int64 [S], lane int64 [S] the slot's index within its source,
    slot_on bool [S], slots int64 [N] granted)."""
    slots, starts, slot_on = _queue_slots(budget, redistribute, queue_size,
                                          rays_per_count)
    # every source marks its start, so a zero-slot source advances the
    # count without claiming a slot
    src = _slot_sources(starts, torch.ones_like(redistribute), queue_size,
                        budget.shape[0])
    q = torch.arange(queue_size, device=budget.device)
    lane = torch.where(slot_on, q - starts[src], 0)
    return src, lane, slot_on, slots


@span("pota.splat.queue")
def splat_queue_compact(budget, redistribute, queue_size: int,
                        rays_per_count: int = 1):
    """Slot -> compact source mapping of the splat queue.

    Every redistributed source claims ``budget * rays_per_count`` contiguous
    slots; when the total exceeds ``queue_size`` all budgets are rescaled
    (never below one budget unit).  ``src`` numbers only the slot-owning
    sources.  Returns (src int64 [S], slot_on bool [S], slots int64 [N])."""
    slots, starts, slot_on = _queue_slots(budget, redistribute, queue_size,
                                          rays_per_count)
    src = _slot_sources(starts, slots > 0, queue_size, budget.shape[0])
    return src, slot_on, slots


class PermuteFn(torch.autograd.Function):
    """``cols[:, order]`` for a permutation ``order`` [N], by the same
    indexing; the backward gathers the cotangent by the inverse
    permutation, since each column receives exactly one value (autograd's
    ``IndexBackward0`` sorts the indices and accumulates into zeros)."""

    @staticmethod
    def forward(ctx, cols, order):
        ctx.save_for_backward(order)
        return cols[:, order]

    @staticmethod
    @span("pota.source_table.vjp")
    def backward(ctx, grad):
        (order,) = ctx.saved_tensors
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        return grad.index_select(1, inv), None


@span("pota.splat.source_table")
def _source_table(stream, p_cam_safe, p_ws, sky, slot_vals, depth, starts,
                  has, time=None):
    """The compact source table: one column per slot-owning sample (in
    sample order, by a stable sort on the has-slots flag), f32 and int32
    rows side by side (``ops.po_kernels.TF_*`` / ``TI_*``); with ``time``
    (motion blur) the shutter time rides as row ``TF_TIME``.  Also returns
    the f32 rows whose values carry a gradient."""
    n = depth.shape[0]
    rows_f = [
        p_cam_safe[:, 0], p_cam_safe[:, 1], p_cam_safe[:, 2],
        p_ws[:, 0], p_ws[:, 1], p_ws[:, 2], sky.to(torch.float32),
        slot_vals[:, 0], slot_vals[:, 1], slot_vals[:, 2], slot_vals[:, 3],
        depth,
    ]
    if time is not None:
        rows_f.append(time)
    cols_f = torch.stack(rows_f, 0)
    cols_i = torch.stack([
        stream["px"], stream["py"], starts,
        torch.arange(n, dtype=torch.int64, device=depth.device),
    ], 0).to(torch.int32)
    order = torch.argsort((~has).to(torch.int8), stable=True)
    grad_rows = tuple(i for i, r in enumerate(rows_f) if r.requires_grad)
    return (PermuteFn.apply(cols_f, order).contiguous(),
            cols_i[:, order].contiguous(), grad_rows)


@span("pota.splat.camera_space")
def _camera_space(cfg: CameraConfig, stream, cam_to_world, cam_to_world_end):
    """Camera-space positions (unit-scaled) of the samples, their world
    positions with the skydome synthesised, and the sky mask.  With
    ``cam_to_world_end`` each sample uses the camera matrix of its own
    shutter time (motion blur, ref src/lentil_filter.cpp:141-150)."""
    unit = cfg.unit_scale_filter
    if cam_to_world_end is not None:
        c2w_s = interp_camera_matrix(cam_to_world, cam_to_world_end,
                                     stream["time"])
        w2c_rot = c2w_s[:, :3, :3].transpose(1, 2)
        w2c_trans = -torch.einsum("nij,nj->ni", w2c_rot, c2w_s[:, :3, 3])

        def to_cam(p):
            return torch.einsum("nij,nj->ni", w2c_rot, p) + w2c_trans
    else:
        w2c = world_to_camera(cam_to_world)
        rot_t, trans = w2c[:3, :3].T, w2c[:3, 3]

        def to_cam(p):
            return p @ rot_t + trans
    p_cam = to_cam(stream["P"]) * unit
    sky = (stream["z"] >= 1e29) | (_norm(stream["P"]) < 1e-7)
    if cfg.enable_skydome:
        # skydome position synthesis (ref src/lentil_filter.cpp:119-133)
        p_ws = torch.where(sky[:, None], stream["raydir"] * 99999999.0,
                           stream["P"])
        p_cam = torch.where(sky[:, None], to_cam(p_ws) * unit, p_cam)
    else:
        p_ws = stream["P"]
    return p_cam, p_ws, sky


def _k5_takes(cfg: CameraConfig) -> bool:
    """The thin-lens settings JAX's expanded branch (K5) serves
    (``splat.py:686-693``); the others take its decomposed branch."""
    return (cfg.abb_coma == 0.0 and cfg.abb_chromatic == 0.0
            and cfg.optical_vignetting_distance == 0.0
            and cfg.abb_distortion == 0.0 and not cfg.bokeh_enable_image
            and cfg.aperture_blades < 2)


def chroma_wavelengths(cfg: CameraConfig) -> tuple:
    """The wavelength (um) of each chromatic channel, as Python floats (ref
    src/lentil_filter.cpp:255-267): R lerp(1 - ca, 0.35, 0.55), G 0.55, B
    lerp(ca, 0.55, 0.85)."""
    ca = cfg.abb_chromatic
    return (0.35 + (1.0 - ca) * 0.2, 0.55, 0.55 + ca * 0.3)


def _chroma_rgb_weight(channel, dtype):
    """Channel weights (3, 0, 0) / (0, 3, 0) / (0, 0, 3) per slot."""
    return (torch.eye(3, dtype=dtype, device=channel.device) * 3.0)[channel]


def _sensor_to_pixel(rc: RenderConfig, s_x, s_y):
    """Region-aware sensor -> pixel mapping (ref src/lentil_filter.cpp:
    276-278: full-frame NDC mapped with the full resolution, then shifted
    into the render region)."""
    s_y = s_y * (rc.xres / rc.yres)
    pixel_x = ((s_x + 1.0) / 2.0) * rc.xres - rc.region_min_x
    pixel_y = ((-s_y + 1.0) / 2.0) * rc.yres - rc.region_min_y
    return pixel_x, pixel_y


def _po_aperture(cfg: CameraConfig, po_state, seeds, counter,
                 bokeh_cdf=None):
    """Per-slot aperture point (mm) [S, 2] of the decomposed PO splat (ref
    trace_ray_bw_po aperture seeding, src/lentil.h:594-609).  All three
    channels of one counter value share an aperture point, like the
    reference."""
    u = prng.uniforms(seeds, counter, 2)
    r1, r2 = u[..., 0], u[..., 1]
    if cfg.bokeh_enable_image and bokeh_cdf is not None:
        unit_disk = bokeh_sample_alias(bokeh_cdf, r1, r2)
    elif cfg.aperture_blades <= 2:
        unit_disk = samplers.concentric_disk_sample(r1, r2)
    else:
        unit_disk = samplers.triangular_aperture_sample(
            r1, r2, 1.0, cfg.aperture_blades)
    return unit_disk * po_state.aperture_radius


@span("pota.splat.project")
def po_backward_project(cfg: CameraConfig, rc: RenderConfig, lens, po_state,
                        p_cam, seeds, counter, channel=None, bokeh_cdf=None,
                        ops=None):
    """Backward PO projection per queue slot through K6 (ref
    trace_ray_bw_po, src/lentil.h:573-661, and the splat loop,
    src/lentil_filter.cpp:248-300).  ``p_cam`` [S, 3] is the slot's
    camera-space point; ``channel`` [S] in {0, 1, 2} selects the chromatic
    wavelength and weight (None: one wavelength, white).  K6 gets the
    frame's wavelengths from ``cfg`` on the host (one, or the chroma three
    with ``channel`` as the index), so nothing is read back from the card.
    Returns the pixel coordinates, the camera-space lens point ``lens_cs``
    [S, 3] (cm, before the 1/unit rescale), ``rgb_weight`` and ``ov_ok``
    (trans > 0 and the inner pupil)."""
    if ops is None:
        from ..ops import KERNELS as ops
    aperture = _po_aperture(cfg, po_state, seeds, counter, bokeh_cdf)
    if channel is None:
        lams, lam_idx, rgb_weight = (cfg.lambda_um,), None, None
    else:
        lams, lam_idx = chroma_wavelengths(cfg), channel.to(torch.int32)
        rgb_weight = _chroma_rgb_weight(channel, aperture.dtype)
    target = -p_cam * 10.0  # ref src/lentil_filter.cpp:271
    ax, ay = aperture[:, 0].contiguous(), aperture[:, 1].contiguous()
    sx, sy, sdx, sdy, trans = ops.po_backward(
        lens, *(target[:, k].contiguous() for k in range(3)), ax, ay, lams,
        lam_idx, cfg.lt_newton_iterations)
    ok = (trans > 0.0) & inner_pupil_ok(
        lens, torch.stack([sx, sy, sdx, sdy], -1))
    # sensor shift compensation (ref src/lentil.h:653-655)
    shift = -po_state.sensor_shift
    hsw = cfg.sensor_width * 0.5
    pixel_x, pixel_y = _sensor_to_pixel(rc, (sx + sdx * shift) / hsw,
                                        (sy + sdy * shift) / hsw)
    # lens point of the occlusion probe: -aperture * 0.1 puts the mm-space
    # aperture point in cm (ref src/lentil.h:613-619)
    lens_cs = torch.stack([-ax * 0.1, -ay * 0.1, torch.zeros_like(ax)], -1)
    return {"pixel_x": pixel_x, "pixel_y": pixel_y, "lens_cs": lens_cs,
            "rgb_weight": rgb_weight, "ov_ok": ok}


def _unit(v):
    return v / torch.sqrt(torch.sum(v * v, -1, keepdim=True))


@span("pota.splat.project")
def thinlens_backward_project(cfg: CameraConfig, rc: RenderConfig, p_cam,
                              seeds, k_idx, bokeh_cdf=None):
    """One backward thin-lens sample per slot: scene point -> pixel, with
    every aberration of the extended thin lens (port of JAX's
    ``thinlens_backward_project``, ref src/lentil_filter.cpp:311-446).
    ``k_idx`` is the within-source counter of the slot's TEA/LCG stream;
    under chromatic aberration a random channel is drawn from the fifth
    uniform.  Returns the pixel coordinates, the camera-space lens point
    ``lens_cs`` [S, 3], ``rgb_weight`` [S, 3] and ``ov_ok``."""
    u = prng.uniforms(seeds, k_idx, 6)
    r1, r2, r5 = u[..., 0], u[..., 1], u[..., 4]
    unit_disk = thinlens.sample_aperture(cfg, r1, r2, bokeh_cdf)
    unit_disk = torch.stack(
        [unit_disk[..., 0] * cfg.effective_anamorphic, unit_disk[..., 1]], -1)
    aperture_radius = cfg.thinlens_aperture_radius
    lens = torch.cat([unit_disk * aperture_radius,
                      torch.zeros_like(unit_disk[..., :1])], -1)

    f = cfg.effective_focal_length
    image_dist_samplepos = (-f * p_cam[..., 2]) / (-f + p_cam[..., 2])
    dir_from_center = _unit(p_cam)
    dir_lens_to_p = _unit(p_cam - lens)
    if cfg.abb_coma != 0.0:
        coma_mult = cfg.abb_coma * aberrations.coma_multiplier(
            cfg.sensor_width, f, dir_from_center, unit_disk)
        dir_lens_to_p = aberrations.coma_perturb(
            dir_lens_to_p, dir_from_center, coma_mult, reverse=True)
        cam_pos_perturbed = (torch.sqrt(torch.sum(p_cam * p_cam, -1,
                                                  keepdim=True))
                             * dir_lens_to_p)
        dir_from_center = _unit(cam_pos_perturbed)
    else:
        cam_pos_perturbed = p_cam

    samplepos_image_t = torch.abs(image_dist_samplepos
                                  / dir_from_center[..., 2])
    samplepos_image_point = dir_from_center * samplepos_image_t[..., None]
    dir_lens_to_image = _unit(samplepos_image_point - lens)

    if cfg.optical_vignetting_distance > 0.0:
        ov_ok = aberrations.optical_vignetting_square(
            lens, _unit(cam_pos_perturbed - lens), aperture_radius,
            cfg.optical_vignetting_radius, cfg.optical_vignetting_distance,
            samplers.lerp_squircle_mapping(cfg.effective_circle_to_square))
    else:
        ov_ok = torch.ones(lens.shape[:-1], dtype=torch.bool,
                           device=lens.device)

    # chromatic aberration: one random channel per splat with a shifted
    # focus distance (ref src/lentil_filter.cpp:392-406)
    focusdist_t = torch.abs(thinlens.image_dist_focusdist(cfg)
                            / dir_lens_to_image[..., 2])
    rgb_weight = None
    if cfg.abb_chromatic > 0.0:
        fip_unp = lens + dir_lens_to_image * focusdist_t[..., None]
        sx_unp = fip_unp[..., 0] / fip_unp[..., 2]
        sy_unp = fip_unp[..., 1] / fip_unp[..., 2]
        dist_center = torch.sqrt(sx_unp * sx_unp + sy_unp * sy_unp)
        channel = torch.floor(r5 * 3.0).to(torch.int64) - 1   # -1, 0, 1
        rgb_weight = _chroma_rgb_weight(channel + 1, lens.dtype)
        if cfg.abb_chromatic_type == ChromaticType.GREEN_MAGENTA:
            direction_shift = torch.abs(channel).to(lens.dtype)
        else:
            direction_shift = channel.to(lens.dtype)
        shift = direction_shift * cfg.abb_chromatic * 5.0 * dist_center
        focusdist_t = torch.abs(thinlens.image_dist_focusdist(cfg, shift)
                                / dir_lens_to_image[..., 2])

    fip = lens + dir_lens_to_image * focusdist_t[..., None]
    sensor = torch.stack([fip[..., 0] / fip[..., 2],
                          fip[..., 1] / fip[..., 2]], -1)
    sensor = sensor / ((cfg.sensor_width * 0.5) / -f)
    if cfg.abb_distortion > 0.0:
        sensor = aberrations.inverse_barrel_distortion(sensor,
                                                       cfg.abb_distortion)
    pixel_x, pixel_y = _sensor_to_pixel(rc, sensor[..., 0], sensor[..., 1])
    return {"pixel_x": pixel_x, "pixel_y": pixel_y, "lens_cs": lens,
            "rgb_weight": rgb_weight, "ov_ok": ov_ok}


@span("pota.splat.occlusion")
def _occluded_through_camera(scene, p_ws_q, lens_cs, sky_q, cam_to_world,
                             cam_to_world_end=None, time_q=None):
    """The decomposed branch's occlusion probe (``splat.py:979-999``): from
    the slot's world point to its lens point, taken to world space through
    the slot's own camera matrix (blended to its shutter time under motion
    blur, one [S] row per matrix entry, no [S, 4, 4] tensor), in queue
    chunks of :data:`OCCLUSION_CHUNK`.  Sky slots are never occluded."""
    lx, ly = lens_cs[:, 0], lens_cs[:, 1]
    if cam_to_world_end is not None:
        w0 = 1.0 - time_q
        entry = lambda k, j: (cam_to_world[k, j] * w0
                              + cam_to_world_end[k, j] * time_q)
    else:
        entry = lambda k, j: cam_to_world[k, j]
    # the lens point has z = 0: the third column drops out
    cam_pos_ws = torch.stack([entry(k, 0) * lx + entry(k, 1) * ly + entry(k, 3)
                              for k in range(3)], -1)
    occ = torch.cat([
        scene.occluded(p_ws_q[i:i + OCCLUSION_CHUNK],
                       cam_pos_ws[i:i + OCCLUSION_CHUNK])
        for i in range(0, p_ws_q.shape[0], OCCLUSION_CHUNK)])
    return occ & (sky_q < 0.5)


@span("pota.splat")
def splat_frame(cfg: CameraConfig, rc: RenderConfig, scene, stream,
                cam_to_world, po_lens=None, po_state=None, aovs=None,
                bokeh_cdf=None, n_crypto_ids: int = 0,
                cam_to_world_end=None, with_diagnostics: bool = False,
                ops=None, differentiable: bool = False):
    """Full filter stage: gates + backward splats + buffer accumulation.

    Returns the framebuffer dict consumed by :func:`resolve_imager` /
    :func:`resolve_aovs`: one [H, W, 4] buffer per AOV, the [H, W]
    ``filter_weight`` plane and ``zmin``; with ``with_diagnostics`` also the
    valid-splat and issued-slot counts.  ``bokeh_cdf`` is the image bokeh's
    :class:`~pota_tpu_torch.render.bokeh_image.BokehImage`;
    ``cam_to_world_end`` the camera matrix at the end of the shutter.
    ``ops`` picks the kernel set (default :data:`pota_tpu_torch.ops.KERNELS`).
    Every gaussian AOV rides the one sorted accumulation (RGBA with the
    filter weight as a fifth column, the others four each).  A non-zero
    ``n_crypto_ids`` adds the id-matte's ranked coverage planes
    ``crypto_rank_id`` / ``crypto_rank_w`` [H, W, 6] and ``crypto_total``
    [H, W] (:func:`~pota_tpu_torch.render.crypto.crypto_topk`, no gradient
    on any route), read by :func:`resolve_crypto`.

    ``differentiable`` (JAX's ``splat.py:750-790, 1134-1140``): the gates,
    budgets, queue, seeds and weights carry no gradient (integers, booleans
    and floors) and are built under ``no_grad``; so is the projection of
    every route (K3 / K3b / K5 on the expanded geometry detached, as JAX's
    ``stop_gradient`` does; K6 or the thin-lens projection and the
    occlusion probe on the decomposed route, whose outputs reach the image
    only through floors and booleans, as JAX's
    ``differentiate_splat_geometry=False``); the value chain stays
    differentiable: the source table's value rows, K2 through
    :class:`~pota_tpu_torch.ops.po_kernels.ExpandFn`, the payload columns
    of every gaussian AOV, the source-pixel fallback, and K4 through
    :class:`~pota_tpu_torch.ops.splat_accum.AccumFn`.

    Routes, as JAX routes a chip (see :data:`LAST_ROUTE`): on a scene of
    spheres (``centers``) without motion blur, a PO frame takes K3 (with an
    external aperture for image bokeh and blades, else with a wavelength
    per slot when chromatic) and a thin-lens frame K5 when its settings
    allow (:func:`_k5_takes`); every other frame, a replay's sphere-less
    scene included, the decomposed projection, with K6 for the PO lens.  A
    chromatic PO frame gives each budget unit three slots, one per
    wavelength (ref src/lentil_filter.cpp:255-267)."""
    global LAST_ROUTE
    if ops is None:
        from ..ops import KERNELS as ops
    if aovs is None:
        aovs = DEFAULT_AOVS
    check_supported(cfg, rc, po_lens=po_lens)

    n = stream["rgba"].shape[0]
    dev = stream["rgba"].device
    dtype = stream["rgba"].dtype
    s_cap = cfg.splat_queue_mult * n
    thin = cfg.camera_type == CameraType.THIN_LENS
    motion_blur = cam_to_world_end is not None
    chroma = not thin and cfg.abb_chromatic > 0.0
    use_bokeh = cfg.bokeh_enable_image and bokeh_cdf is not None
    ext_aperture = not thin and (use_bokeh or cfg.aperture_blades > 2)
    # a scene without spheres (a replay's NullScene) has nothing for the
    # fused kernels to probe: JAX's fused branch needs ``centers``
    decomposed = (motion_blur or (thin and not _k5_takes(cfg))
                  or not hasattr(scene, "centers"))
    rays_per_count = 3 if chroma else 1
    inv_density = 1.0 / rc.spp

    with torch.no_grad():
        p_cam, p_ws, sky = _camera_space(cfg, stream, cam_to_world,
                                         cam_to_world_end)
        redistribute, budget, _, _ = compute_gates_and_budget(
            cfg, rc, stream, p_cam, po_lens=po_lens, po_state=po_state)

    # additional energy with soft transition (ref src/lentil.h:1128-1138)
    lum = _luminance(stream["rgba"])
    if cfg.bidir_add_energy > 0.0:
        perc = torch.clamp((lum - cfg.bidir_add_energy_minimum_luminance)
                           / cfg.bidir_add_energy_transition, 0.0, 1.0)
        add_energy = cfg.bidir_add_energy * perc
    else:
        add_energy = torch.zeros_like(lum)

    xres_r, yres_r = rc.xres_region, rc.yres_region
    npix = xres_r * yres_r
    with torch.no_grad():
        # gated-out samples can hold degenerate positions: give their
        # (unused) table columns a benign point
        trace.host_write(dev)
        p_cam_safe = torch.where(
            redistribute[:, None], p_cam,
            torch.tensor([0.0, 0.0, -100.0], dtype=p_cam.dtype, device=dev))

        # ---- queue, source table, expand (K2) --------------------------
        src, slot_on, granted = splat_queue_compact(budget, redistribute,
                                                    s_cap, rays_per_count)
        depth_src = torch.abs(stream["z"])
        offs = torch.cumsum(granted, 0)
        starts = offs - granted
        trace.count("splat.queue_slots", s_cap)
        trace.count("splat.issued_slots", offs[-1], most=s_cap)
    trace.host_write(dev)
    slot_vals = stream["rgba"] + add_energy[:, None] * torch.tensor(
        [1.0, 1.0, 1.0, 0.0], dtype=dtype, device=dev)
    table_f, table_i, grad_rows = _source_table(
        stream, p_cam_safe, p_ws, sky, slot_vals, depth_src, starts,
        granted > 0, time=stream["time"] if motion_blur else None)
    bounds = None
    if table_f.requires_grad:
        with torch.no_grad():
            # each table column's slot range, cut at the live end: the
            # range sums of ExpandFn's backward, which skip the slots past it
            bounds = torch.stack([starts, offs]).clamp_(max=s_cap).to(
                torch.int32).index_select(1, table_i[pk.TI_SID])
            trace.count("expand.vjp_dead_slots", offs[-1], most=s_cap,
                        of=s_cap)
    ex_f, ex_i = pk.ExpandFn.apply(table_f, src.to(torch.int32), table_i,
                                   bounds, ops.expand, grad_rows)
    # geometry, counts and weights: no gradient (the kernels run here)
    with torch.no_grad():
        ex_g = ex_f.detach()
        # ---- per-slot seed / counter (and chroma channel) -------------------
        q = torch.arange(s_cap, dtype=torch.int64, device=dev)
        lane = torch.clamp(q - ex_i[pk.TI_START], min=0)
        if chroma:
            # channel lane % 3 of the slot's source range (splat.py:
            # 767-777, 849-858; after a queue rescale the count need not be
            # a multiple of 3: ROADMAP Queue 3, chroma channel tint)
            ctr = lane // 3
            channel = lane - 3 * ctr
        else:
            ctr, channel = lane, None
        px_q = ex_i[pk.TI_PX].to(torch.int64)
        seed = (px_q * ex_i[pk.TI_PY] + px_q) & prng.MASK32
        sky_q = ex_g[pk.TF_SKY]
        rgb_weight = None

        if decomposed:
            # ---- JAX's decomposed branch (splat.py:944-1012) ----------------
            p_cam_q = ex_g[pk.TF_PCX:pk.TF_PCZ + 1].T
            if thin:
                LAST_ROUTE = "decomposed_tl"
                proj = thinlens_backward_project(cfg, rc, p_cam_q, seed,
                                                 ctr, bokeh_cdf=bokeh_cdf)
            else:
                LAST_ROUTE = "decomposed_po"
                proj = po_backward_project(cfg, rc, po_lens, po_state,
                                           p_cam_q, seed, ctr,
                                           channel=channel,
                                           bokeh_cdf=bokeh_cdf, ops=ops)
            rgb_weight = proj["rgb_weight"]
            occluded = _occluded_through_camera(
                scene, ex_g[pk.TF_PWX:pk.TF_PWZ + 1].T,
                proj["lens_cs"] * (1.0 / cfg.unit_scale_filter), sky_q,
                cam_to_world, cam_to_world_end,
                ex_g[pk.TF_TIME] if motion_blur else None)
            pixel_x, pixel_y = proj["pixel_x"], proj["pixel_y"]
            in_bounds = ((pixel_x >= 0) & (pixel_x < xres_r)
                         & (pixel_y >= 0) & (pixel_y < yres_r)
                         & torch.isfinite(pixel_x) & torch.isfinite(pixel_y))
            ok = in_bounds & proj["ov_ok"] & ~occluded
            lin_splat = (pk._floor_clip(pixel_y, yres_r - 1.0) * xres_r
                         + pk._floor_clip(pixel_x, xres_r - 1.0))
            lin_splat = torch.where(in_bounds, lin_splat,
                                    0.0).to(torch.int32)
        else:
            # ---- JAX's expanded branch: the fused splat kernels -------------
            params = pk.splat_kernel_params(
                cfg, rc, None if thin else po_state, cam_to_world)
            spheres = torch.cat([scene.centers, scene.radii[:, None]],
                                -1).to(torch.float32).contiguous()
            slot_geo = (ex_g[pk.TF_PCX], ex_g[pk.TF_PCY], ex_g[pk.TF_PCZ],
                        ex_g[pk.TF_PWX], ex_g[pk.TF_PWY], ex_g[pk.TF_PWZ])
            seed_i, ctr_i = seed.to(torch.int32), ctr.to(torch.int32)
            iters = cfg.lt_newton_iterations
            # K3b's wavelengths, from cfg on the host: the chroma three
            # with the slot's channel as the index, or the frame's one
            lams, lam_idx = ((chroma_wavelengths(cfg),
                              channel.to(torch.int32))
                             if chroma else ((cfg.lambda_um,), None))
            if thin:
                LAST_ROUTE = "k5"
                lin_splat, ok = ops.tl_splat(
                    *slot_geo, seed_i, ctr_i, sky_q, params, spheres,
                    cfg.effective_abb_spherical,
                    cfg.effective_circle_to_square)
            elif ext_aperture:
                # image bokeh (alias sampler) or the blade fan, from the
                # stream's first two uniforms (splat.py:795-813)
                LAST_ROUTE = "k3_ext"
                u = prng.uniforms(seed, ctr, 2)
                if use_bokeh:
                    unit_disk = bokeh_sample_alias(bokeh_cdf, u[..., 0],
                                                   u[..., 1])
                else:
                    unit_disk = samplers.triangular_aperture_sample(
                        u[..., 0], u[..., 1], 1.0, cfg.aperture_blades)
                aperture = unit_disk * po_state.aperture_radius
                lin_splat, ok = ops.po_splat_ext(
                    po_lens, *slot_geo, aperture[:, 0].contiguous(),
                    aperture[:, 1].contiguous(), lams, lam_idx, sky_q,
                    params, spheres, iters)
            elif chroma:
                LAST_ROUTE = "k3_lam"
                lin_splat, ok = ops.po_splat_lam(
                    po_lens, *slot_geo, seed_i, ctr_i, lams, lam_idx, sky_q,
                    params, spheres, iters)
            else:
                LAST_ROUTE = "k3"
                lin_splat, ok = ops.po_splat(po_lens, *slot_geo, seed_i,
                                             ctr_i, sky_q, params, spheres,
                                             cfg.lambda_um, iters)
            if chroma:
                rgb_weight = _chroma_rgb_weight(channel, dtype)
        valid = slot_on & ok
        oid = ex_i[pk.TI_SID].to(torch.int64)

    # ---- per-source success counts (slots are source-contiguous) --------
    with torch.no_grad(), span("pota.splat.weights"):
        csum_valid = torch.cumsum(valid.to(torch.int64), 0)
        trace.count("splat.valid_splats", csum_valid[-1])
        end_i = torch.clamp(offs, 0, s_cap) - 1
        start_i = torch.clamp(starts, 0, s_cap) - 1

        def pick(i):
            return torch.where(i >= 0, csum_valid[torch.clamp(i, min=0)],
                               0)

        successes = pick(end_i) - pick(start_i)
        inv_success = torch.where(successes > 0, 1.0 / successes, 0.0)
        use_source = (~redistribute) | (successes == 0)
        lin_source = ((stream["py"] - rc.region_min_y) * xres_r
                      + (stream["px"] - rc.region_min_x))

        # ---- weight chain (ref src/lentil_filter.cpp:295-298, 442-444) ------
        w_slot = torch.where(valid, inv_density * inv_success[oid], 0.0)
        w_src = torch.where(use_source, inv_density, 0.0)

        # ---- writers: all queue slots + the source-pixel fallback -----------
        writer_valid = torch.cat([valid, use_source])
        writer_pix = torch.cat([lin_splat.to(torch.int64), lin_source])
        writer_pix_s = torch.where(writer_valid, writer_pix, npix)
        writer_depth = torch.cat([ex_g[pk.TF_Z], depth_src])
        sample_of_writer = torch.cat(
            [oid, torch.arange(n, dtype=torch.int64, device=dev)])

        stream = {
            **stream,
            "debug": torch.where(redistribute, budget, 0).to(dtype),
            "time": stream.get("time", torch.zeros_like(depth_src)),
        }
    # ---- payload: every gaussian AOV (splat.py:1071-1092, 1200-1227) ---
    with span("pota.splat.payload"):
        gauss_specs = [s for s in aovs if s.filter == GAUSSIAN]
        cols = []
        for spec in gauss_specs:
            values = aov_value_rgba(stream, spec)
            if spec.name == "RGBA":
                # the expanded rows carry the slot rgba with the additional
                # energy folded in; the chromatic channel weight rides rgb
                k_rgb = [ex_f[pk.TF_R], ex_f[pk.TF_G], ex_f[pk.TF_B]]
                if rgb_weight is not None:
                    k_rgb = [k * rgb_weight[:, c]
                             for c, k in enumerate(k_rgb)]
                k_all = k_rgb + [ex_f[pk.TF_A]]
                cols += [torch.cat([k_all[c] * w_slot, values[:, c] * w_src])
                         for c in range(4)]
                cols.append(torch.cat([w_slot, w_src]))
            else:
                slot_v = values[oid]
                cols += [torch.cat([slot_v[:, c] * w_slot,
                                    values[:, c] * w_src]) for c in range(4)]
        if not cols:  # closest-only AOV list: one empty payload column
            cols = [torch.zeros((s_cap + n,), dtype=dtype, device=dev)]
        payload = torch.stack(cols, 1)

    # ---- sort + segment accumulate (K4) ---------------------------------
    accum, winner_depth, winner_sample, has_winner = accumulate_sorted(
        writer_pix_s, writer_depth, payload, sample_of_writer, npix, ops=ops)

    buffers = {}
    weight = torch.zeros((npix,), dtype=dtype, device=dev)
    col0 = 0
    for spec in gauss_specs:
        ncol = 5 if spec.name == "RGBA" else 4
        block = accum[:, col0:col0 + ncol]
        col0 += ncol
        if spec.name == "RGBA":
            weight = block[:, 4]
            block = block[:, :4]
        buffers[spec.name] = block.reshape(yres_r, xres_r, 4)
    has_closest = any(spec.filter == CLOSEST for spec in aovs)
    for spec in aovs:
        if spec.filter != CLOSEST:
            continue
        # winner-take by depth: the winning sample's value per pixel
        vals = aov_value_rgba(stream, spec)
        px_vals = (vals[winner_sample.to(torch.int64)]
                   * has_winner[:, None].to(dtype))
        if spec.name == "lentil_debug":
            # a winner with debug == 0 stays [0, 0, 0, 0]
            px_vals = px_vals * (px_vals[:, :1] != 0).to(dtype)
        buffers[spec.name] = px_vals.reshape(yres_r, xres_r, 4)

    if n_crypto_ids:
        from .crypto import crypto_topk

        with torch.no_grad(), span("pota.splat.idmatte"):
            rank_id, rank_w, total = crypto_topk(
                *id_matte_records(stream, lin_splat, lin_source, oid, w_slot,
                                  w_src), npix, k=6)
        buffers["crypto_rank_id"] = rank_id.reshape(yres_r, xres_r, -1)
        buffers["crypto_rank_w"] = rank_w.reshape(yres_r, xres_r, -1)
        buffers["crypto_total"] = total.reshape(yres_r, xres_r)

    buffers["filter_weight"] = weight.reshape(yres_r, xres_r)
    if has_closest:
        buffers["zmin"] = torch.where(
            has_winner, winner_depth, 3e38).reshape(yres_r, xres_r)
    if with_diagnostics:
        buffers["_n_valid_splats"] = valid.sum()
        buffers["_n_issued_slots"] = slot_on.sum()
    return buffers


def id_matte_records(stream, lin_splat, lin_source, oid, w_slot, w_src):
    """The id-matte's coverage records (ref add_to_buffer_cryptomatte,
    src/lentil.h:814-819; JAX's ``splat.py:1286-1322``): every coverage
    layer of a sample rides the splat's weight chain, one record per
    (writer, layer), a queue slot's at its splat pixel with its source's id
    and ``w_slot`` times the layer weight, a source's at its own pixel with
    ``w_src``.  The layers are the stream's ``crypto_ids`` /
    ``crypto_weights`` [N, D] (thin glass), else ``obj_id`` with weight 1.
    Returns (pixel int64, id, weight) [(S + N) * D]."""
    if "crypto_ids" in stream:
        ids_d, wts_d = stream["crypto_ids"], stream["crypto_weights"]
    else:
        ids_d = stream["obj_id"][:, None]
        wts_d = torch.ones_like(ids_d, dtype=w_slot.dtype)
    pix = torch.cat([lin_splat.to(torch.int64), lin_source.to(torch.int64)])
    ids, wts = [], []
    for d in range(ids_d.shape[1]):
        oid_d, lw = ids_d[:, d], wts_d[:, d]
        ids += [oid_d[oid], oid_d]
        wts += [w_slot * lw[oid], w_src * lw]
    return (pix.repeat(ids_d.shape[1]), torch.cat(ids), torch.cat(wts))


@span("pota.resolve.crypto")
def resolve_crypto(fb: dict, ranks: int = 3, id_hashes=None) -> list:
    """The id-matte's cryptomatte layers: ``ranks`` RGBA planes [H, W, 4],
    each holding two (id, normalised coverage) pairs (the reference
    imager's crypto resolve, src/lentil_imager.cpp:121-160).  ``id_hashes``
    (:func:`~pota_tpu_torch.render.crypto.id_hash_table`) gives spec float
    name-hash ids; without it the scene object index rides as a float."""
    from .crypto import pack_layers

    rank_id = fb["crypto_rank_id"]
    h, w, k = rank_id.shape
    layers = pack_layers(rank_id.reshape(-1, k),
                         fb["crypto_rank_w"].reshape(-1, k),
                         fb["crypto_total"].reshape(-1), ranks=ranks,
                         id_hashes=id_hashes)
    return [layer.reshape(h, w, 4) for layer in layers]


@span("pota.resolve")
def resolve_imager(rc: RenderConfig, fb: dict) -> torch.Tensor:
    """Beauty resolve: RGBA normalized by the accumulated filter weight
    (ref src/lentil_imager.cpp:169-179)."""
    return fb["RGBA"] / torch.clamp(fb["filter_weight"], min=1e-12)[..., None]


@span("pota.resolve")
def resolve_aovs(rc: RenderConfig, fb: dict, aovs=None) -> dict:
    """Resolve every AOV plane: gaussian-class divide by the filter weight;
    closest-class pass through (ref src/lentil_imager.cpp:164-186)."""
    if aovs is None:
        aovs = DEFAULT_AOVS
    w = torch.clamp(fb["filter_weight"], min=1e-12)[..., None]
    out = {}
    for spec in aovs:
        buf = fb[spec.name]
        if spec.filter == GAUSSIAN and spec.name != "lentil_debug":
            out[spec.name] = buf / w
        else:
            out[spec.name] = buf
    return out
