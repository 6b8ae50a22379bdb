"""``reg_gicp_ms``: mean device time of the registration's span ``reg.gicp``
(models/loop_closure.py): the coarse-aligned source's covariances and the
batched GICP loop (K2b), CUDA events through the port's tracer, after the
profiled steps."""
LAYER = "registration stages"
UNIT = "ms"
MOVES = "scan_ms_p95"
WORKLOADS = ["mulran-os1-64.revisit-batch4"]


def read(trace):
    ms = trace.spans.get("reg.gicp")
    return sum(ms) / len(ms) if ms else None
