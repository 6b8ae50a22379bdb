"""``keyframe_add_ms``: mean device time of the pipeline's span ``key_add``
(ops/voxel.py voxel_downsample and models/keyframes.py append), CUDA events
through the pipeline's profiler hook."""
LAYER = "keyframe"
UNIT = "ms"
MOVES = "scan_ms_p95"
WORKLOADS = ["kitti-hdl64.drive"]


def read(trace):
    ms = trace.spans.get("key_add")
    return sum(ms) / len(ms) if ms else None
