"""Host runtime of the port: the native scan loader, ApproximateTime sync
and LZ4 decoder (``native.py`` over ``runtime.cpp``) and the rosbag reader
(``rosbag.py``)."""
from .native import ApproxTimeSync, ScanLoader, available, read_scan  # noqa: F401
