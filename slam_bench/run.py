"""The benchmark of ``fast_lio_sam_qn_tpu_torch`` on NVIDIA GPUs: one run of
one cell, as one process.

    python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

In order: build or load the port's kernels (cached under ``build/`` in the
checkout), generate the cell's traffic on the card from the seed, warm up
the cell's shapes, measure for ``--seconds``, compare what the window
produced with the plain reference, and print one JSON line, the last on
standard output.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics.  ``--control 1`` puts the reference
computed with TF32 matrix products in the program's place at every
compared step (a control that has to come out not correct).

It exits non-zero, printing no result, without as many CUDA cards as the
cell asks for, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "slam_bench" / sub)
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from slam_bench import harness as H  # noqa: E402

H.T_PROCESS = T_START


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None, device: str = "cuda", overrides=None) -> int:
    """One run; ``device`` and ``overrides`` (small widths) are for the CPU
    tests, the command line always runs on the card."""
    args = parser().parse_args(argv)
    cells = {w["name"]: w for w in H.benchmark()["workloads"]}
    if args.workload not in cells:
        H.say(f"unknown workload {args.workload!r}")
        return 2
    chips = cells[args.workload]["chips"]
    if device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < chips:
            H.say(f"{args.workload} needs {chips} CUDA card(s); {cards} "
                  "available")
            return 2
        from fast_lio_sam_qn_tpu_torch import kernels

        path, nvcc_s = kernels.build()
        kernels.load_library()
        torch.zeros(1, device=device)
        H.say(f"kernels: {path.name} ({nvcc_s:.1f} s of nvcc)")
    work, cfgj = H.load_cell(args.workload, overrides)
    driver = importlib.import_module(f"slam_bench.{work['driver']}")
    result = driver.run(args.workload, work, cfgj, args.seed, args.seconds,
                        bool(args.trace), device, control=bool(args.control))
    bad = H.forbidden_modules()
    if bad:
        H.say(f"loaded in this process: {', '.join(bad)}; no result")
        return 3
    H.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
