"""Bidirectional energy redistribution (port of the expanded branch of
:func:`pota_tpu.render.splat.splat_frame`).

The reference's per-sample splat loop (``src/lentil_filter.cpp:66-480``)
becomes a flat splat queue: the gate chain picks the samples that
redistribute, each claims a contiguous range of ``budget`` slots in a queue
of ``splat_queue_mult * N`` slots, and the slots run through four kernels:

  compact source table --K2 expand--> slot rows --K3 / K5 splat--> (pixel, ok)
  -> success counts and weights -> stable (pixel, depth) sort
  --K4 segment accumulate--> per-pixel sums + closest winner

Per-source weights are ``inv_density / successes``, so energy is conserved
exactly as in the reference's retry-until-success loop; a sample with no
successful slot falls back to its own pixel.  The JAX branch's ``_map_chunks``
queue chunking is not ported: a 1080p frame's queue fits in 80 GB at once.
"""
from __future__ import annotations

import torch

from pota_tpu.config import CameraConfig, CameraType, RenderConfig

from ..optics import samplers, thinlens
from ..ops import po_kernels as pk
from ..ops.splat_accum import accumulate_sorted
from ..utils import rng as prng
from .aov import CLOSEST, DEFAULT_AOVS, GAUSSIAN, aov_value_rgba
from .bokeh_image import bokeh_sample_alias
from .renderer import check_supported


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


def splat_queue_compact(budget, redistribute, queue_size: int,
                        rays_per_count: int = 1):
    """Slot -> compact source mapping of the splat queue.

    Every redistributed source claims ``budget * rays_per_count`` contiguous
    slots; when the total exceeds ``queue_size`` all budgets are rescaled
    (never below one budget unit).  ``src`` numbers only the slot-owning
    sources.  Returns (src int64 [S], slot_on bool [S], slots int64 [N])."""
    n = budget.shape[0]
    dev = budget.device
    slots = torch.where(redistribute, budget.to(torch.int64) * rays_per_count,
                        0)
    total = torch.sum(slots.to(torch.float32))
    scale = torch.clamp(
        (queue_size * (1.0 - 1e-6)) / torch.clamp(total, min=1.0), max=1.0)
    scaled = torch.floor(slots.to(torch.float32) * scale).to(torch.int64)
    slots = torch.where(slots > 0, torch.clamp(scaled, min=rays_per_count), 0)
    offsets = torch.cumsum(slots, 0)
    starts = offsets - slots
    marks = torch.zeros((queue_size,), dtype=torch.int64, device=dev)
    claim = (slots > 0) & (starts < queue_size)
    marks.index_add_(0, starts[claim], torch.ones_like(starts[claim]))
    src = torch.clamp(torch.cumsum(marks, 0) - 1, 0, n - 1)
    slot_on = torch.arange(queue_size, device=dev) < offsets[-1]
    return src, slot_on, slots


def _source_table(stream, p_cam_safe, p_ws, sky, slot_vals, depth, starts,
                  has):
    """The compact source table: one column per slot-owning sample (in
    sample order, by a stable sort on the has-slots flag), f32 and int32
    rows side by side (``ops.po_kernels.TF_*`` / ``TI_*``)."""
    n = depth.shape[0]
    cols_f = torch.stack([
        p_cam_safe[:, 0], p_cam_safe[:, 1], p_cam_safe[:, 2],
        p_ws[:, 0], p_ws[:, 1], p_ws[:, 2], sky.to(torch.float32),
        slot_vals[:, 0], slot_vals[:, 1], slot_vals[:, 2], slot_vals[:, 3],
        depth,
    ], 0)
    cols_i = torch.stack([
        stream["px"], stream["py"], starts,
        torch.arange(n, dtype=torch.int64, device=depth.device),
    ], 0).to(torch.int32)
    order = torch.argsort((~has).to(torch.int8), stable=True)
    return cols_f[:, order].contiguous(), cols_i[:, order].contiguous()


def splat_frame(cfg: CameraConfig, rc: RenderConfig, scene, stream,
                cam_to_world, po_lens=None, po_state=None, aovs=None,
                bokeh_cdf=None, with_diagnostics: bool = False, ops=None):
    """Full filter stage: gates + backward splats + buffer accumulation.

    Returns the framebuffer dict consumed by :func:`resolve_imager` /
    :func:`resolve_aovs`: one [H, W, 4] buffer per AOV, the [H, W]
    ``filter_weight`` plane and ``zmin``; with ``with_diagnostics`` also the
    valid-splat and issued-slot counts.  ``bokeh_cdf`` is the image bokeh's
    :class:`~pota_tpu_torch.render.bokeh_image.BokehImage`.  ``ops`` picks
    the kernel set (default :data:`pota_tpu_torch.ops.KERNELS`).  The
    id-matte, motion blur and the differentiable mode are not ported: this
    function takes none of their arguments.

    The splat kernel is the one JAX's expanded branch picks: K5 for the
    thin lens; for the PO lens K3 with an external aperture (image bokeh,
    blades), else K3 with a wavelength per slot (chromatic), else the
    flagship K3.  A chromatic PO frame gives each budget unit three slots,
    one per wavelength (ref src/lentil_filter.cpp:255-267)."""
    if ops is None:
        from ..ops import KERNELS as ops
    if aovs is None:
        aovs = DEFAULT_AOVS
    check_supported(cfg, rc, aovs)

    n = stream["rgba"].shape[0]
    dev = stream["rgba"].device
    dtype = stream["rgba"].dtype
    s_cap = cfg.splat_queue_mult * n
    thin = cfg.camera_type == CameraType.THIN_LENS
    chroma = not thin and cfg.abb_chromatic > 0.0
    use_bokeh = cfg.bokeh_enable_image and bokeh_cdf is not None
    ext_aperture = not thin and (use_bokeh or cfg.aperture_blades > 2)
    rays_per_count = 3 if chroma else 1
    inv_density = 1.0 / rc.spp
    unit = cfg.unit_scale_filter

    w2c = world_to_camera(cam_to_world)
    rot_t, trans = w2c[:3, :3].T, w2c[:3, 3]
    p_cam = (stream["P"] @ rot_t + trans) * unit
    sky = (stream["z"] >= 1e29) | (_norm(stream["P"]) < 1e-7)
    if cfg.enable_skydome:
        # skydome position synthesis (ref src/lentil_filter.cpp:119-133)
        p_ws = torch.where(sky[:, None], stream["raydir"] * 99999999.0,
                           stream["P"])
        p_cam = torch.where(sky[:, None], (p_ws @ rot_t + trans) * unit,
                            p_cam)
    else:
        p_ws = stream["P"]

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
    # gated-out samples can hold degenerate positions: give their (unused)
    # table columns a benign point
    p_cam_safe = torch.where(
        redistribute[:, None], p_cam,
        torch.tensor([0.0, 0.0, -100.0], dtype=p_cam.dtype, device=dev))

    # ---- queue, source table, expand (K2) ------------------------------
    src, slot_on, granted = splat_queue_compact(budget, redistribute, s_cap,
                                                rays_per_count)
    depth_src = torch.abs(stream["z"])
    slot_vals = stream["rgba"] + add_energy[:, None] * torch.tensor(
        [1.0, 1.0, 1.0, 0.0], dtype=dtype, device=dev)
    offs = torch.cumsum(granted, 0)
    starts = offs - granted
    table_f, table_i = _source_table(stream, p_cam_safe, p_ws, sky,
                                     slot_vals, depth_src, starts,
                                     granted > 0)
    ex_f, ex_i = ops.expand(src.to(torch.int32), table_f, table_i)

    # ---- per-slot seed / counter, then the splat kernel (K3 / K5) --------
    q = torch.arange(s_cap, dtype=torch.int64, device=dev)
    lane = torch.clamp(q - ex_i[pk.TI_START], min=0)
    if chroma:
        # the expanded branch's lane % 3 channel, kept after a queue
        # rescale (splat.py:767-777; ROADMAP Queue 3, chroma channel tint)
        ctr = lane // 3
        channel = lane - 3 * ctr
        ca = cfg.abb_chromatic
        lam_tab = torch.tensor([0.35 + (1.0 - ca) * 0.2, 0.55, 0.55 + ca * 0.3],
                               dtype=dtype, device=dev)
        lam_q = lam_tab[channel]
    else:
        ctr = lane
    px_q = ex_i[pk.TI_PX].to(torch.int64)
    seed = (px_q * ex_i[pk.TI_PY] + px_q) & 0xFFFFFFFF
    params = pk.splat_kernel_params(cfg, rc, None if thin else po_state,
                                    cam_to_world)
    spheres = torch.cat([scene.centers, scene.radii[:, None]], -1).to(
        torch.float32).contiguous()
    slot_geo = (ex_f[pk.TF_PCX], ex_f[pk.TF_PCY], ex_f[pk.TF_PCZ],
                ex_f[pk.TF_PWX], ex_f[pk.TF_PWY], ex_f[pk.TF_PWZ])
    sky_q = ex_f[pk.TF_SKY]
    seed_i, ctr_i = seed.to(torch.int32), ctr.to(torch.int32)
    iters = cfg.lt_newton_iterations
    if thin:
        lin_splat, ok = ops.tl_splat(
            *slot_geo, seed_i, ctr_i, sky_q, params, spheres,
            cfg.effective_abb_spherical, cfg.effective_circle_to_square)
    elif ext_aperture:
        # image bokeh (alias sampler) or the blade fan, from the stream's
        # first two uniforms (splat.py:795-813)
        u = prng.uniforms(seed, ctr, 2)
        if use_bokeh:
            unit_disk = bokeh_sample_alias(bokeh_cdf, u[..., 0], u[..., 1])
        else:
            unit_disk = samplers.triangular_aperture_sample(
                u[..., 0], u[..., 1], 1.0, cfg.aperture_blades)
        aperture = unit_disk * po_state.aperture_radius
        if not chroma:
            lam_q = torch.full((s_cap,), cfg.lambda_um, dtype=dtype,
                               device=dev)
        lin_splat, ok = ops.po_splat_ext(
            po_lens, *slot_geo, aperture[:, 0].contiguous(),
            aperture[:, 1].contiguous(), lam_q, sky_q, params, spheres, iters)
    elif chroma:
        lin_splat, ok = ops.po_splat_lam(
            po_lens, *slot_geo, seed_i, ctr_i, lam_q, sky_q, params, spheres,
            iters)
    else:
        lin_splat, ok = ops.po_splat(po_lens, *slot_geo, seed_i, ctr_i,
                                     sky_q, params, spheres, iters)
    valid = slot_on & ok
    oid = ex_i[pk.TI_SID].to(torch.int64)

    # ---- per-source success counts (slots are source-contiguous) --------
    csum_valid = torch.cumsum(valid.to(torch.int64), 0)
    end_i = torch.clamp(offs, 0, s_cap) - 1
    start_i = torch.clamp(starts, 0, s_cap) - 1

    def pick(i):
        return torch.where(i >= 0, csum_valid[torch.clamp(i, min=0)], 0)

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
    writer_depth = torch.cat([ex_f[pk.TF_Z], depth_src])
    sample_of_writer = torch.cat(
        [oid, torch.arange(n, dtype=torch.int64, device=dev)])

    stream = {
        **stream,
        "debug": torch.where(redistribute, budget, 0).to(dtype),
        "time": stream.get("time", torch.zeros_like(depth_src)),
    }
    gauss = [s for s in aovs if s.filter == GAUSSIAN][0]
    values = aov_value_rgba(stream, gauss)
    k_rgb = [ex_f[pk.TF_R], ex_f[pk.TF_G], ex_f[pk.TF_B]]
    if chroma:
        # channel weights (3,0,0) / (0,3,0) / (0,0,3) folded into the
        # payload (ref src/lentil_filter.cpp:255-267)
        k_rgb = [k * 3.0 * (channel == c).to(dtype)
                 for c, k in enumerate(k_rgb)]
    payload = torch.stack([
        torch.cat([k_rgb[0] * w_slot, values[:, 0] * w_src]),
        torch.cat([k_rgb[1] * w_slot, values[:, 1] * w_src]),
        torch.cat([k_rgb[2] * w_slot, values[:, 2] * w_src]),
        torch.cat([ex_f[pk.TF_A] * w_slot, values[:, 3] * w_src]),
        torch.cat([w_slot, w_src]),
    ], 1)

    # ---- sort + segment accumulate (K4) ---------------------------------
    accum, winner_depth, winner_sample, has_winner = accumulate_sorted(
        writer_pix_s, writer_depth, payload, sample_of_writer, npix, ops=ops)

    buffers = {"RGBA": accum[:, :4].reshape(yres_r, xres_r, 4)}
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

    buffers["filter_weight"] = accum[:, 4].reshape(yres_r, xres_r)
    if has_closest:
        buffers["zmin"] = torch.where(
            has_winner, winner_depth, 3e38).reshape(yres_r, xres_r)
    if with_diagnostics:
        buffers["_n_valid_splats"] = valid.sum()
        buffers["_n_issued_slots"] = slot_on.sum()
    return buffers


def resolve_imager(rc: RenderConfig, fb: dict) -> torch.Tensor:
    """Beauty resolve: RGBA normalized by the accumulated filter weight
    (ref src/lentil_imager.cpp:169-179)."""
    return fb["RGBA"] / torch.clamp(fb["filter_weight"], min=1e-12)[..., None]


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
