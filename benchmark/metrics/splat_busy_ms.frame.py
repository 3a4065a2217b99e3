"""splat_busy_ms.frame: device ms a frame of the operations launched inside
splat_frame and resolve_aovs (render.splat).  The ranges of the splat's
stages, inside splat_frame, name its idle gaps in the breakdown."""
from harness.readers import busy_ms

RANGES = (("render.splat", "splat_frame"),
          ("render.splat", "_camera_space"),
          ("render.splat", "compute_gates_and_budget"),
          ("render.splat", "splat_queue_compact"),
          ("render.splat", "_source_table"),
          ("render.splat", "po_backward_project"),
          ("render.splat", "_occluded_through_camera"),
          ("render.splat", "accumulate_sorted"),
          ("render.splat", "resolve_aovs"))


def read(rec):
    return busy_ms(rec, "frame", ("splat_frame", "resolve_aovs"))
