"""forward_busy_ms.frame: device ms a frame of the operations launched inside
render_sample_stream (samples, the forward trace K1, shading).  The range
of trace_camera_rays, inside it, names the trace's idle gaps in the
breakdown."""
from harness.readers import busy_ms

RANGES = (("render.renderer", "render_sample_stream"),
          ("render.renderer", "trace_camera_rays"))


def read(rec):
    return busy_ms(rec, "frame", ("render_sample_stream",))
