"""``plane_assoc_ms``: device time of the point map's plane searches a scan:
the LIO's spans ``assoc`` (``ieskf.update`` on the point map, models/lio.py;
four a scan after the first), CUDA events through the LIO's profiler hook,
summed over the window and divided by its ``scan`` spans."""
LAYER = "LIO stages"
UNIT = "ms"
MOVES = "scans_per_s"
WORKLOADS = ["kitti-hdl64-point.drive"]


def read(trace):
    ms = trace.spans.get("assoc")
    scans = trace.spans.get("scan")
    return sum(ms) / len(scans) if ms and scans else None
