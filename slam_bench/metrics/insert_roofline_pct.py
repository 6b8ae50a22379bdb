"""``insert_roofline_pct``: the surfel insert's least time (the census of its
table-scale work at the scan's static sizes over the H100's HBM rate,
roofline.py) over the device time of every operation launched inside the
profiled ``insert`` spans."""
LAYER = "kernels"
UNIT = "%"
MOVES = "scans_per_s"
WORKLOADS = ["kitti-hdl64.drive"]


def read(trace):
    bound = trace.work.get("insert")
    n = trace.span_count("insert")
    device = trace.device_ms_in("insert")
    if not bound or not n or not device:
        return None
    return 100.0 * bound * n / device
