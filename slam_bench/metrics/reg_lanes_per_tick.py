"""``reg_lanes_per_tick``: lanes with a candidate a loop tick, the mean of
the port's counter ``reg_lanes`` over the window's ``loop`` spans after
the profiled steps: how full the batched registration runs (at most
``loop_batch``)."""
LAYER = "loop closure"
UNIT = "lanes"
MOVES = "scan_ms_p95"
WORKLOADS = ["mulran-os1-64.revisit-batch4"]


def read(trace):
    lanes = getattr(trace, "reg_lanes", None)
    if not lanes or any(n is None for n in lanes):
        return None
    return sum(lanes) / len(lanes)
