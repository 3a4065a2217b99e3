"""Multi-device rendering on ``torch.distributed`` (port of
:mod:`pota_tpu.parallel.sharded`).

One process a rank.  Each rank traces, shades and splats its contiguous
chunk of the frame's sample stream (a band of rows, since the stream is
row-major) through :func:`~pota_tpu_torch.render.renderer.render_frame`'s
own route, into a full-frame partial framebuffer; the partials are then
merged:

* **gaussian planes sum**;
* **closest planes** take the global minimum depth, a tie going to the
  lowest rank;
* when the region's rows divide by the world size the merge is
  tile-sharded, each rank keeping the summed band of rows it owns (a
  reduce-scatter over rows); otherwise every rank gets the whole frame (an
  all-reduce);
* with ``halo_rows`` the tile-sharded merge exchanges only the boundary
  bands a splat can reach (:func:`splat_halo_rows`), hop by hop, and gives
  the reduce-scatter merge's bits.

The row reduce-scatter is an all-to-all of the row bands followed by a sum
in ascending rank order on each rank, rather than the collective library's
own reduce-scatter, whose order of additions is its own (NCCL's ring, say):
with one order on every path, the halo merge equals it bit for bit and a
rerun repeats it.  It moves the same ``(n - 1) / n`` of the frame a rank.
The all-reduce is likewise an all-gather and the same ordered sum (it
moves ``n - 1`` frames a rank, against a ring all-reduce's ``2 (n - 1) /
n``; it serves only frames whose rows do not divide).

JAX's ``shard_map`` and its ``use_pallas`` switch are not ported: each rank
runs the port's kernels as :func:`render_frame` does.  NCCL joins ranks on
the card and gloo on the CPU; rank ``r`` takes ``cuda:(r % device
count)``.  The caller starts the processes (``torchrun --nproc-per-node
N``) and may initialise ``torch.distributed`` itself; :func:`make_mesh`
otherwise initialises it from the environment.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..config import CameraConfig, RenderConfig
from ..optics import thinlens
from ..render import sampling
from ..render.aov import CLOSEST, DEFAULT_AOVS
from ..render.renderer import check_supported, render_sample_stream
from ..render.splat import resolve_imager, splat_frame

# the closest fold's "no candidate yet" depth
_NO_DEPTH = float("inf")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a sharded frame runs on: the process group, this process's
    rank, the world size, the backend and this rank's device."""

    group: object
    rank: int
    size: int
    backend: str
    device: torch.device


def make_mesh(n_devices: int | None = None, backend: str | None = None):
    """The :class:`Mesh` of this process.  ``backend`` is ``"nccl"`` (the
    default: ranks on the card, rank ``r`` on ``cuda:(r % device count)``)
    or ``"gloo"`` (ranks on the CPU).  ``torch.distributed`` is initialised
    by the caller, or here from the environment (``env://``, as
    ``torchrun`` sets it).  ``n_devices`` is the world size the caller
    expects (default: the group's)."""
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: the nccl backend needs CUDA (torch.cuda.is_available()"
            " is false); pass backend='gloo' to run the ranks on the CPU")
    if not dist.is_initialized():
        dist.init_process_group(backend)
    if dist.get_backend() != backend:
        raise ValueError(f"torch.distributed runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the world has {size} "
                         "ranks: start one process a rank")
    if backend == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    return Mesh(dist.group.WORLD, rank, size, backend, device)


def splat_halo_rows(cfg: CameraConfig, rc: RenderConfig, scene,
                    po_state=None, margin: float = 1.5) -> int:
    """Bound (in pixel rows) on how far a backward splat lands from its
    source pixel: the halo a row-sharded merge must exchange.  A splat
    moves at most one circle-of-confusion radius (ref
    src/lentil_filter.cpp:311-446), and the CoC is monotone in 1/z, so the
    bound is the largest CoC at the scene's depth extremes (and at the sky
    when the skydome redistributes): ``ceil(max CoC * 0.5 * yres *
    margin) + 2``.  Computed on the host."""
    centers = scene.centers.detach().double().cpu().numpy()
    radii = scene.radii.detach().double().cpu().numpy()
    dist_c = np.linalg.norm(centers, axis=-1)
    z = np.concatenate([dist_c - radii, dist_c + radii])
    z = np.maximum(z, 1e-3) * float(cfg.unit_scale_filter)
    if cfg.enable_skydome:
        z = np.concatenate([z, [1e12]])
    kw = {}
    if po_state is not None:
        kw = dict(aperture_radius=po_state.aperture_radius,
                  focus_distance=po_state.focus_distance)
    coc = thinlens.coc_thinlens(cfg, torch.tensor(-z, dtype=torch.float32),
                                **kw).double().numpy()
    # the CoC is a diameter in frame heights (ref src/lentil_filter.cpp:177)
    return int(np.ceil(float(np.max(coc)) * 0.5 * rc.yres * margin)) + 2


def _shard_stream(stream: dict, n_shards: int, idx: int) -> dict:
    """Rank ``idx``'s contiguous chunk of a flat sample stream."""
    total = stream["px"].shape[0]
    if total % n_shards:
        raise ValueError(f"{total} samples do not split into {n_shards} "
                         "equal chunks")
    chunk = total // n_shards
    return {k: v[idx * chunk:(idx + 1) * chunk] for k, v in stream.items()}


def merge_traffic_bytes(rc: RenderConfig, n_shards: int, n_channels: int,
                        halo_rows: int | None) -> int:
    """Analytic merge traffic of one sharded frame, a rank: the
    reduce-scatter moves ``(n - 1) / n`` of the frame, the halo exchange
    two ``halo x width`` bands.  ``n_channels`` counts the framebuffer's
    float32 channels (an [H, W] plane counts one)."""
    frame = rc.yres_region * rc.xres_region * n_channels * 4
    if halo_rows is None:
        return int(frame * (n_shards - 1) / n_shards)
    return int(2 * halo_rows * rc.xres_region * n_channels * 4)


# ----------------------------------------------------------- collectives


def _all_gather_single(out, x, group):
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _rank_sum(parts):
    """Sum of ``parts`` [n, ...] in ascending rank order, from zero."""
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc = acc + p
    return acc


class _RowReduceScatter(torch.autograd.Function):
    """Rank ``r`` gets rows ``[r * H/n, (r + 1) * H/n)`` of the sum of
    every rank's [H, ...] tensor, summed in ascending rank order (an
    all-to-all of the row bands, then the sum); the backward all-gathers
    the bands' cotangents."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.contiguous()
        bands = torch.empty_like(x)
        dist.all_to_all_single(bands, x, group=mesh.group)
        return _rank_sum(bands.view(mesh.size, -1, *x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous()
        full = g.new_empty((g.shape[0] * mesh.size,) + tuple(g.shape[1:]))
        _all_gather_single(full, g, mesh.group)
        return full, None


def _ordered_all_reduce(x, mesh):
    """The sum of every rank's ``x`` on every rank, in ascending rank order
    (an all-gather, then the sum)."""
    x = x.contiguous()
    parts = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_single(parts, x, mesh.group)
    return _rank_sum(parts.view(mesh.size, *x.shape))


class _AllReduceSum(torch.autograd.Function):
    """:func:`_ordered_all_reduce`; the backward sums the ranks' cotangents
    the same way (each rank's loss is its share of the total)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _ordered_all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _ordered_all_reduce(g, ctx.mesh), None


# ------------------------------------------------------------------ merges


def _pack(fb: dict, names):
    """The planes ``names`` as one [H, W, C] tensor, and each one's width
    (0 for an [H, W] plane)."""
    cols, widths = [], []
    for nm in names:
        v = fb[nm]
        cols.append(v if v.dim() == 3 else v[..., None])
        widths.append(v.shape[-1] if v.dim() == 3 else 0)
    return torch.cat(cols, -1), widths


def _unpack(packed, names, widths) -> dict:
    out, c = {}, 0
    for nm, w in zip(names, widths):
        out[nm] = packed[..., c:c + max(w, 1)]
        if w == 0:
            out[nm] = out[nm][..., 0]
        c += max(w, 1)
    return out


def _plane_names(fb: dict, specs):
    """(gaussian plane names, closest plane names) of ``fb``, in its
    order; ``zmin`` is neither."""
    closest = {s.name for s in specs if s.filter == CLOSEST}
    gauss = [k for k in fb if k != "zmin" and k not in closest]
    return gauss, [k for k in fb if k in closest]


def _merge(fb: dict, specs, rc: RenderConfig, mesh: Mesh, tiled: bool):
    """JAX's reduce-scatter merge (``sharded.py:153-200``): gaussian planes
    summed, closest planes kept from the rank holding the global minimum
    depth (the lowest such rank), each plane multiplied by its ``keep``
    mask and summed; row-scattered when ``tiled``."""
    gauss, closest = _plane_names(fb, specs)
    merged = {}
    if "zmin" in fb:
        with torch.no_grad():
            local_z = fb["zmin"]
            global_z = local_z.clone()
            dist.all_reduce(global_z, op=dist.ReduceOp.MIN, group=mesh.group)
            has_min = local_z <= global_z
            winner = torch.where(has_min, mesh.rank, 1 << 30).to(torch.int32)
            dist.all_reduce(winner, op=dist.ReduceOp.MIN, group=mesh.group)
            keep = (has_min & (winner == mesh.rank)).to(local_z.dtype)
            fb = {**fb, **{k: fb[k] * keep[..., None] for k in closest}}
        if tiled:
            tile_h = rc.yres_region // mesh.size
            global_z = global_z[mesh.rank * tile_h:(mesh.rank + 1) * tile_h]
        merged["zmin"] = global_z
    names = gauss + closest
    packed, widths = _pack(fb, names)
    if tiled:
        packed = _RowReduceScatter.apply(packed, mesh)
    else:
        packed = _AllReduceSum.apply(packed, mesh)
    merged.update(_unpack(packed, names, widths))
    return {k: merged[k] for k in fb}


def _halo_merge(fb: dict, specs, rc: RenderConfig, mesh: Mesh, halo: int):
    """The tile-sharded merge from the halo bands alone (JAX's
    ``_halo_merge``, ``sharded.py:230-366``).  Rank ``i``'s partial is zero
    outside rows ``[i * tile_h - halo, (i + 1) * tile_h + halo)``, so hop
    ``k`` sends the rows of its reach inside the tile of rank ``i + k``
    (and of ``i - k``): ``2 x halo`` rows a rank in all.  Every plane rides
    one packed band a hop and direction; edge ranks receive nothing.
    Gaussian planes add in ascending rank order (the reduce-scatter
    merge's bits); closest planes fold in ascending rank order, a
    candidate taken when its depth is strictly below the running one (the
    lowest rank wins a tie)."""
    n, idx = mesh.size, mesh.rank
    tile_h = rc.yres_region // n
    n_hops = -(-halo // tile_h)
    # hop k (1-based) carries min(tile_h, halo - (k - 1) * tile_h) rows
    sizes = [min(tile_h, halo - (k - 1) * tile_h)
             for k in range(1, n_hops + 1)]
    gauss, closest = _plane_names(fb, specs)
    names = gauss + closest + (["zmin"] if "zmin" in fb else [])
    packed, widths = _pack(fb, names)
    ng = sum(max(w, 1) for w in widths[:len(gauss)])
    t0 = idx * tile_h

    ops, from_lower, from_upper = [], {}, {}
    for k, rows in enumerate(sizes, 1):
        if idx + k < n:   # my rows in rank idx+k's tile top: down k hops
            start = (idx + k) * tile_h
            ops.append(dist.P2POp(dist.isend,
                                  packed[start:start + rows].contiguous(),
                                  idx + k, mesh.group))
            from_upper[k] = packed.new_empty((rows,) + packed.shape[1:])
            ops.append(dist.P2POp(dist.irecv, from_upper[k], idx + k,
                                  mesh.group))
        if idx - k >= 0:  # my rows at rank idx-k's tile bottom: up k hops
            start = (idx - k + 1) * tile_h - rows
            ops.append(dist.P2POp(dist.isend,
                                  packed[start:start + rows].contiguous(),
                                  idx - k, mesh.group))
            from_lower[k] = packed.new_empty((rows,) + packed.shape[1:])
            ops.append(dist.P2POp(dist.irecv, from_lower[k], idx - k,
                                  mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    # the candidates of each row band, in ascending rank order: (rows of
    # my tile, band)
    own = packed[t0:t0 + tile_h]
    cands = ([(slice(0, sizes[k - 1]), from_lower[k])
              for k in range(n_hops, 0, -1) if k in from_lower]
             + [(slice(0, tile_h), own)]
             + [(slice(tile_h - sizes[k - 1], tile_h), from_upper[k])
                for k in range(1, n_hops + 1) if k in from_upper])

    acc = torch.zeros_like(own[..., :ng])
    for rows, band in cands:
        acc[rows] = acc[rows] + band[..., :ng]
    out = [acc]
    if "zmin" in fb:
        run = torch.zeros_like(own[..., ng:])
        run[..., -1] = _NO_DEPTH
        for rows, band in cands:
            cur = run[rows]
            take = band[..., -1] < cur[..., -1]
            run[rows] = torch.where(take[..., None], band[..., ng:], cur)
        out.append(run)
    merged = _unpack(torch.cat(out, -1), names, widths)
    return {k: merged[k] for k in fb}


# ------------------------------------------------------------------ frames


def render_frame_sharded(cfg: CameraConfig, rc: RenderConfig, scene,
                         cam_to_world, mesh: Mesh, seed: int = 0,
                         po_lens=None, po_state=None, aovs=None,
                         halo_rows: int | None = None, ops=None,
                         differentiable: bool = False):
    """The bidirectional frame with the sample stream split over ``mesh``
    (JAX's ``render_frame_sharded``, ``sharded.py:87``).  Each rank draws
    the whole frame's samples, keeps its contiguous chunk (a band of rows)
    and runs :func:`render_frame`'s route on it (no id-matte, motion blur
    or image bokeh, as JAX's), its splat queue sized and rescaled from its
    own chunk.  The partial framebuffers merge as the module docstring
    says; ``halo_rows`` (:func:`splat_halo_rows`) takes the halo exchange
    when the rows divide, it moves less than the reduce-scatter
    (``2 halo < (n - 1) tile_h``) and its hops fit the ranks.

    Returns ``(resolve_imager(rc, merged), merged)`` of this rank's band of
    ``yres_region / n`` rows, or of the whole frame when the rows do not
    divide by the world size.  ``differentiable`` records the frame for
    autograd as :func:`render_frame` does (gaussian planes only; the
    closest merge carries no gradient, as JAX stops it)."""
    check_supported(cfg, rc, po_lens=po_lens)
    if differentiable and halo_rows is not None:
        raise NotImplementedError(
            "the halo merge carries no gradient: a differentiable sharded "
            "frame takes the reduce-scatter merge (halo_rows=None)")
    dev = scene.device
    if dev != mesh.device:
        raise ValueError(f"the scene lies on {dev}, but this rank's device "
                         f"is {mesh.device} (backend {mesh.backend})")
    n = mesh.size
    tiled = rc.yres_region % n == 0
    tile_h = rc.yres_region // n
    use_halo = (halo_rows is not None and tiled and n > 1
                and 2 * halo_rows < (n - 1) * tile_h
                and -(-halo_rows // tile_h) <= n - 1)
    cam_to_world = cam_to_world.to(dev, torch.float32)
    samples = _shard_stream(sampling.frame_samples(rc, seed, device=dev), n,
                            mesh.rank)
    with torch.enable_grad() if differentiable else torch.no_grad():
        stream = render_sample_stream(cfg, rc, scene, cam_to_world, seed,
                                      po_lens=po_lens, po_state=po_state,
                                      ops=ops, differentiable=differentiable,
                                      samples=samples)
        fb = splat_frame(cfg, rc, scene, stream, cam_to_world,
                         po_lens=po_lens, po_state=po_state, aovs=aovs,
                         ops=ops, differentiable=differentiable)
        specs = DEFAULT_AOVS if aovs is None else aovs
        if use_halo:
            merged = _halo_merge(fb, specs, rc, mesh, halo_rows)
        else:
            merged = _merge(fb, specs, rc, mesh, tiled)
        return resolve_imager(rc, merged), merged


def train_step_sharded(cfg: CameraConfig, rc: RenderConfig, scene,
                       cam_to_world, mesh: Mesh, target_image, po_lens,
                       po_state, seed: int = 0, aovs=None):
    """One lens-fitting step of BASELINE config 5 over ``mesh`` (JAX's
    ``train_step_sharded``, ``sharded.py:369``): the differentiable sharded
    frame, JAX's L2 loss ``mean((img - target)^2)`` over the whole frame,
    and its gradients with respect to ``po_lens``'s ``pt`` and ``ap``
    coefficients.  Each rank's loss is its band's squared error over the
    frame's element count (the whole frame's, a world-size-th share, when
    the rows do not divide); the loss and the gradients are summed over the
    ranks.  ``target_image`` is the whole [H, W, 4] frame.  The lens's
    coefficients keep their ``requires_grad`` and ``grad``.  Returns
    ``(loss, (g_pt, g_ap))``, the same on every rank."""
    coeffs = (po_lens.pt.coeffs, po_lens.ap.coeffs)
    was = [c.requires_grad for c in coeffs]
    try:
        for c in coeffs:
            c.requires_grad_(True)
        img, _ = render_frame_sharded(
            cfg, rc, scene, cam_to_world, mesh, seed=seed, po_lens=po_lens,
            po_state=po_state, aovs=aovs, differentiable=True)
        target = target_image.to(img.device, img.dtype)
        share = 1.0
        if rc.yres_region % mesh.size == 0:
            tile_h = rc.yres_region // mesh.size
            target = target[mesh.rank * tile_h:(mesh.rank + 1) * tile_h]
        else:
            share = 1.0 / mesh.size
        local = ((img - target) ** 2).sum() * (share / target_image.numel())
        grads = torch.autograd.grad(local, coeffs)
    finally:
        for c, w in zip(coeffs, was):
            c.requires_grad_(w)
    loss = local.detach().clone()
    for t in (loss, *grads):
        dist.all_reduce(t, group=mesh.group)
    return loss, grads
