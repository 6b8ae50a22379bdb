"""``lio_ms``: mean device time of ``LIO.process_scan`` (models/lio.py), from
CUDA events the harness records around each call."""
LAYER = "LIO scan step"
UNIT = "ms"
MOVES = "scans_per_s"
WORKLOADS = ["kitti-hdl64.drive"]


def read(trace):
    ms = trace.spans.get("lio")
    return sum(ms) / len(ms) if ms else None
