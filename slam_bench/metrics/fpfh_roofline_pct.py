"""``fpfh_roofline_pct``: the least time of the FPFH kernels (K3b-K5b, or
K3-K5 for a single lane) on the profiled steps' clouds, their in-radius
pairs' work at the H100's peaks (roofline_fpfh.py), over the device time
of every operation launched inside the profiled ``reg.fpfh`` spans."""
LAYER = "kernels"
UNIT = "%"
MOVES = "scan_ms_p95"
WORKLOADS = ["mulran-os1-64.revisit-batch4"]


def read(trace):
    bound = trace.work.get("fpfh")
    device = trace.device_ms_in("reg.fpfh")
    if not bound or not device:
        return None
    return 100.0 * bound / device
