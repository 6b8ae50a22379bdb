"""``device_idle_pct.scan``: the share of the profiled scans' wall time in
which no operation ran on the device: 100 x (1 - the union of the device
operations' intervals over the window)."""
LAYER = "device"
UNIT = "%"
MOVES = "scans_per_s"
WORKLOADS = ["kitti-hdl64.drive"]


def read(trace):
    if not trace.ops or trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s())
