"""``loop_tick_ms``: mean device time of the pipeline's span ``loop``, one
2 Hz tick: the candidate fetch and the batched registration of its
pending keyframes (models/pipeline.py, models/loop_closure.py), CUDA events
through the port's tracer, after the profiled steps."""
LAYER = "loop closure"
UNIT = "ms"
MOVES = "scan_ms_p95"
WORKLOADS = ["mulran-os1-64.revisit-batch4"]


def read(trace):
    ms = trace.spans.get("loop")
    return sum(ms) / len(ms) if ms else None
