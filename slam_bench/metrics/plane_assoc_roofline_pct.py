"""``plane_assoc_roofline_pct``: the point map's plane search's least time
(its bytes and operations at the scan's static sizes over the H100's peaks,
roofline_point.py) over the device time of every operation launched inside
the profiled ``assoc`` spans, a search."""
LAYER = "kernels"
UNIT = "%"
MOVES = "scans_per_s"
WORKLOADS = ["kitti-hdl64-point.drive"]


def read(trace):
    bound = trace.work.get("assoc")
    n = trace.span_count("assoc")
    device = trace.device_ms_in("assoc")
    if not bound or not n or not device:
        return None
    return 100.0 * bound * n / device
