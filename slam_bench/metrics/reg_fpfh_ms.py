"""``reg_fpfh_ms``: mean device time of the registration's span ``reg.fpfh``
(models/loop_closure.py): both clouds' radius features (K3b-K5b) and the
distinctiveness filter, CUDA events through the port's tracer, after the
profiled steps."""
LAYER = "registration stages"
UNIT = "ms"
MOVES = "scan_ms_p95"
WORKLOADS = ["mulran-os1-64.revisit-batch4"]


def read(trace):
    ms = trace.spans.get("reg.fpfh")
    return sum(ms) / len(ms) if ms else None
