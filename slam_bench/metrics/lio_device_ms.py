"""``lio_device_ms``: device time of every operation launched inside the
program's ``scan`` spans (``LIO.process_scan``, models/lio.py) of the
profiled steps, a scan.  Beside ``lio_ms`` (CUDA events around the same
call), the share of the LIO's span in which the device works."""
LAYER = "LIO scan step"
UNIT = "ms"
MOVES = "scans_per_s"
WORKLOADS = ["kitti-hdl64.drive"]


def read(trace):
    n = trace.span_count("scan")
    ms = trace.device_ms_in("scan")
    return ms / n if n and ms else None
