"""``pgo_solve_ms``: mean device time of the pipeline's span ``opt``
(ops/pgo.py optimize), CUDA events through the pipeline's profiler hook."""
LAYER = "pose graph"
UNIT = "ms"
MOVES = "scan_ms_p95"
WORKLOADS = ["kitti-hdl64.drive"]


def read(trace):
    ms = trace.spans.get("opt")
    return sum(ms) / len(ms) if ms else None
