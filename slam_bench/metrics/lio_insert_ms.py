"""``lio_insert_ms``: mean device time of the LIO's span ``insert``
(ops/surfel_map.py insert), CUDA events through the LIO's profiler hook."""
LAYER = "LIO stages"
UNIT = "ms"
MOVES = "scans_per_s"
WORKLOADS = ["kitti-hdl64.drive"]


def read(trace):
    ms = trace.spans.get("insert")
    return sum(ms) / len(ms) if ms else None
