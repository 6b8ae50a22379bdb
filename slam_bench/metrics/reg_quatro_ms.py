"""``reg_quatro_ms``: mean device time of the registration's span
``reg.quatro`` (models/loop_closure.py): Quatro's clique, GNC-TLS yaw and
translation voting, lane by lane, CUDA events through the port's tracer,
after the profiled steps."""
LAYER = "registration stages"
UNIT = "ms"
MOVES = "scan_ms_p95"
WORKLOADS = ["mulran-os1-64.revisit-batch4"]


def read(trace):
    ms = trace.spans.get("reg.quatro")
    return sum(ms) / len(ms) if ms else None
