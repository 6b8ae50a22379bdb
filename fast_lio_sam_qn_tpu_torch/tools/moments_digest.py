"""A digest of kernel K3's valid rows on the caller's row order.

Usage (on a machine with a CUDA card):

    python3 fast_lio_sam_qn_tpu_torch/tools/moments_digest.py [--tree DIR]

Imports ``fast_lio_sam_qn_tpu_torch`` from the checkout ``DIR`` (default:
the one that holds this script), builds its kernels, and prints one line
per case: the SHA-256 of K3's output rows of valid points, unsorted, on
the benchmark's voxelized source and target clouds at the benchmark's and
the pipeline's paddings, through the single kernel and, on two lanes (the
cloud and the cloud with every third valid point masked), through the
batched one.  Two checkouts whose K3 sums each row in the same order print
the same lines, whatever they write into masked rows.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys


def _digest(rows) -> str:
    return hashlib.sha256(rows.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    from fast_lio_sam_qn_tpu_torch import kernels
    from fast_lio_sam_qn_tpu_torch.models.loop_closure import _single_frame
    from fast_lio_sam_qn_tpu_torch.ops import fpfh_stream as fs
    from fast_lio_sam_qn_tpu_torch.tools import bench_pair as bp

    if not torch.cuda.is_available():
        print("moments_digest: no CUDA device", file=sys.stderr)
        return 1
    kernels.load_library()
    dev = torch.device("cuda", 0)
    store, _ = bp.build_store(dev)
    print(f"package {os.path.dirname(os.path.dirname(fs.__file__))}")
    for caps in ((bp.SRC_CAP, bp.DST_CAP), (bp.PIPE_SRC_CAP, bp.PIPE_DST_CAP)):
        for tag, idx, cap in (("src", 1, caps[0]), ("dst", 0, caps[1])):
            p, m = _single_frame(store, idx, cap, 0.3)
            one = fs.moments(p, m, 0.9, 0.6)
            thinned = m & (torch.cumsum(m.int(), 0) % 3 != 0)
            P, M = torch.stack([p, p]), torch.stack([m, thinned])
            both = fs.moments_batched(P, M, 0.9, 0.6)
            torch.cuda.synchronize()
            print(f"K3 {tag}@{cap} ({int(m.sum())} valid rows): single "
                  f"{_digest(one[m])}, batched lanes {_digest(both[0][m])} "
                  f"{_digest(both[1][thinned])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
