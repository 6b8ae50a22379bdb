"""``lio_launches``: device operations launched inside the program's
``scan`` spans (``LIO.process_scan``, models/lio.py) of the profiled steps,
a scan: the launches a host-bound scan step pays for."""
LAYER = "LIO scan step"
UNIT = "ops"
MOVES = "scans_per_s"
WORKLOADS = ["kitti-hdl64.drive"]


def read(trace):
    n = trace.span_count("scan")
    return trace.ops_in_spans()["scan"][1] / n if n else None
