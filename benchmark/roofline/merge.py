"""The sharded fit step's collectives (``parallel/sharded.py``): the bytes
rank 0 sends a step, counted from the packed planes' shape and the world
size as the program counts them at each call site (its ``merge.bytes``).

The merge packs every plane but ``zmin`` into one [H, W, C] float32 tensor:
each AOV plane is four wide (RGBA, and each closest AOV as RGBA), plus
``filter_weight``.  A step sends

- the all-to-all of the row bands: ``(n - 1) / n`` of the packed tensor;
- its backward's all-gather of the bands' cotangents: ``n - 1`` bands;
- the closest merge's two ``MIN`` all-reduces of an [H, W] plane (the
  depths, float32; the winning rank, int32), and the loss's and the two
  gradients' all-reduces: each ``2 (n - 1) / n`` of the tensor, as a ring
  all-reduce sends.

No operations are counted: the link's roofline is its bytes.  The world
size is the process group's, read while the run's group exists (None
without one).
"""
import importlib

F32 = 4


def count(w):
    """(operations, bytes) rank 0 sends in one sharded step of the world
    ``w``; None without a process group."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return None
    n = dist.get_world_size()
    aovs = importlib.import_module(f"{w.pkg}.render.aov").DEFAULT_AOVS
    h, wd = w.rc.yres_region, w.rc.xres_region
    packed = h * wd * (4 * len(aovs) + 1) * F32
    sent = [(n - 1) * packed / n, (n - 1) * (packed // n)]
    plane = h * wd * F32
    reduced = [plane, plane, F32] + [c.numel() * F32 for c in w.coeffs]
    sent += [2 * (n - 1) * b / n for b in reduced]
    return 0.0, float(sum(int(b) for b in sent))
