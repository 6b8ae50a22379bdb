"""The LIO path's measurements for the package of one checkout, through that
checkout's own ``chip_smoke.py``, so that two checkouts (a parent and a
change) can be compared in turns on one card.

Usage (on a machine with a CUDA card, from the repository root):

    python3 fast_lio_sam_qn_tpu_torch/tools/profile_lio.py [--tree DIR] \\
        [--heavy]

Puts the checkout ``DIR`` (default: the one that holds this script) first
on the import path, builds its kernels and runs its ``chip_smoke.py``'s
``lio_kitti`` (the LIO at the kitti width: ms per scan and its stage
spans, host syncs and kernels a scan), ``lio_golden`` (the 240-scan sim
golden: its LIO spans and pins) and the loop-closure attempt
(``main_path_runs``, then each mode timed with CUDA events); with
``--heavy`` also ``bench_phase`` (the bench record, its
``pipeline_ms_per_scan``), ``cli_kitti`` (``--kitti`` scans/s) and
``longrun_phase`` (the 1,600-scan long run).  Every phase logs its own
numbers with the card's name and power limit; the last line is one JSON
object of the phases' seconds.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap.add_argument("--heavy", action="store_true")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from fast_lio_sam_qn_tpu_torch import kernels
    from fast_lio_sam_qn_tpu_torch.tools import bench_pair as bp

    if not torch.cuda.is_available():
        print("profile_lio: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kernels.load_library()
    torch.zeros(1, device=dev)
    card = cs.card_line()
    cs.log(f"profile_lio: tree {tree} [{card}]")
    seconds = {}

    def phase(name, fn):
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
        cs.log(f"{name}: {seconds[name]:.1f} s")

    def attempts():
        store, drift = bp.build_store(dev)
        for label, lc in cs.main_path_runs(store, drift).items():
            t = cs.cuda_ms(lambda: lc.fetch_and_perform(store, 1))
            cs.log(f"time attempt {label}: {t:.3f} ms per fetch_and_perform "
                   f"[{card}]")

    def cli_kitti():
        tmp = tempfile.mkdtemp(prefix="profile_lio_")
        try:
            d, stamps, truth = cs.write_dataset(tmp, card)
            errs = {k: 0.0 for k in cs.launches_now()}
            cs.cli_kitti(dev, card, errs, d, stamps, truth, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    phase("lio_kitti", lambda: cs.lio_kitti(dev, card))
    phase("lio_golden", lambda: cs.lio_golden(dev, card))
    phase("attempts", attempts)
    if args.heavy:
        phase("bench", lambda: cs.bench_phase(dev, card))
        phase("cli_kitti", cli_kitti)
        phase("longrun", lambda: cs.longrun_phase(dev, card))
    print(json.dumps({"tree": tree, "card": card, "seconds": seconds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
