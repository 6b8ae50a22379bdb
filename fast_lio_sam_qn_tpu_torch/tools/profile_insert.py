"""Per-stage profile of the surfel-map insert and of the full LIO step at
the KITTI width (32,768-point scans, a 2^19-slot table, 0.5 m voxels), on
the card — the port's counterpart of the JAX package's
``tools/profile_insert.py``.

Each stage is timed with CUDA events around the call (after a warm-up
call; median of ``--reps`` calls on the same populated map), so a stage's
time includes its host-bound gaps.  Prints one line per stage and writes
them as JSON to ``chiprun_out/profile_insert.json``.

Usage (on a machine with the card):

    python3 -m fast_lio_sam_qn_tpu_torch.tools.profile_insert
    python3 -m fast_lio_sam_qn_tpu_torch.tools.profile_insert --drift \\
        --device cpu     # the final position error of the KITTI-width run

``--drift`` runs the KITTI-width LIO run of ``chip_smoke.py``'s lio_kitti
phase (10 + 20 scans) on ``--device`` and prints its final position error
from the truth.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..models.lio import LIO
from ..ops import surfel_map
from ..ops.hashgrid import _INT_MAX, _scatter_rounds
from ..ops.surfel_map import _locate, _outer_sym, _refit_planes, _vox_center
from ..ops.voxel import voxel_coords
from ..run import initial_state, sim_scan_inputs
from ..utils import sim
from ..utils.config import LioConfig

N = 32768
TABLE = 1 << 19
RES = 0.5
HOOD_CAP = 8192
KITTI_SCANS = 30            # 10 warm-up scans, then 20 timed
KITTI_PERIOD = 0.1


def kitti_world():
    """A 120 m room with 24 boxes and a straight 2 m/s drive through it."""
    return (sim.World.room(size=120.0, height=8.0, n_boxes=24, seed=7),
            sim.Trajectory.straight(speed=2.0))


def kitti_lio(device, n_points: int = N, table: int = TABLE, profiler=None):
    """The LIO at ``LioConfig()`` defaults (the kitti width), its scan
    capacity and table optionally cut, with a fresh state moving with the
    trajectory.  Returns (lio, state)."""
    cfg = dataclasses.replace(LioConfig(), max_points_per_scan=n_points,
                              map_table_size=table)
    lio = LIO(cfg, device=device, profiler=profiler)
    return lio, initial_state(lio, kitti_world()[1])


def kitti_inputs(s: int, n_points: int = N):
    """process_scan inputs of scan s of the KITTI-width run: a swept scan
    of ``n_points`` rays (seed 400 + s), noise-free 200 Hz IMU samples."""
    world, traj = kitti_world()
    return sim_scan_inputs(world, traj, s, KITTI_PERIOD, n_points,
                           imu_noise=False, seed=400)


def kitti_truth(t: float) -> np.ndarray:
    """Ground-truth pose at t in the filter's world frame."""
    traj = kitti_world()[1]
    return np.linalg.inv(traj.pose(0.0)) @ traj.pose(t)


def drift(device, n_scans: int = KITTI_SCANS, n_points: int = N,
          table: int = TABLE):
    """(final position error from the truth in m, match counts per scan)
    of the KITTI-width LIO run."""
    lio, state = kitti_lio(device, n_points, table)
    matches = []
    for s in range(n_scans):
        inputs = kitti_inputs(s, n_points)
        state, res = lio.process_scan(state, *inputs)
        matches.append(res.num_matches)
    err = np.linalg.norm(res.pose.cpu().numpy()[:3, 3]
                         - kitti_truth(inputs[-1])[:3, 3])
    return float(err), [int(m) for m in matches]


def _cuda_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _random_scans(dev, count: int):
    """Scans of N points drawn from one fixed random volume (120 x 120 x
    8 m, 6N points): successive inserts mostly touch existing voxels."""
    rng = np.random.default_rng(0)
    world = rng.uniform([-60, -60, -2], [60, 60, 6],
                        size=(6 * N, 3)).astype(np.float32)
    for seed in range(count):
        r = np.random.default_rng(seed)
        sel = r.choice(len(world), size=N, replace=False)
        pts = world[sel] + r.normal(0, 0.01, (N, 3)).astype(np.float32)
        yield torch.from_numpy(pts).to(dev)


def stages(dev, reps: int) -> dict:
    """ms per insert stage on the random volume and on a planar scene, and
    per full LIO step at the kitti width."""
    out = {}
    th = float(np.float32(0.1))
    mask = torch.ones(N, dtype=torch.bool, device=dev)
    scans = list(_random_scans(dev, 13))
    m = surfel_map.empty(RES, TABLE, dev)
    for pts in scans[:12]:
        m = surfel_map.insert(m, pts, mask, th, hood_cap=HOOD_CAP)
    torch.cuda.synchronize()
    out["occupied voxels (random volume)"] = int(m.occupied.sum())
    pts = scans[12]
    coords = voxel_coords(pts, RES)
    slot0, found0 = _locate(m, coords)
    use0 = mask & found0
    slots0 = torch.clamp(torch.where(use0, slot0, TABLE), 0, TABLE - 1)

    def moments():
        sidx = torch.where(use0, slot0, TABLE)
        w = use0.to(torch.float32)
        rel = pts - _vox_center(coords, RES)
        upd = torch.cat([w[:, None], rel * w[:, None],
                         _outer_sym(rel) * w[:, None]], dim=-1)
        return m.mom + surfel_map._segment_sum(upd, sidx, TABLE + 1)[:TABLE]

    timed = {
        "full insert (hood 27)": lambda: surfel_map.insert(
            m, pts, mask, th, hood_cap=HOOD_CAP, halo_cap=4096),
        "full insert (hood 7)": lambda: surfel_map.insert(
            m, pts, mask, th, hood_cap=HOOD_CAP, halo_cap=4096,
            hood_window=7),
        "insert without halo": lambda: surfel_map.insert(
            m, pts, mask, th, hood_cap=HOOD_CAP, halo=False),
        "locate": lambda: _locate(m, coords),
        "claim rounds": lambda: _scatter_rounds(
            m.occupied, torch.full((TABLE + 1,), _INT_MAX, dtype=torch.int64,
                                   device=dev), coords, mask, TABLE,
            already_present=found0),
        "moment scatter": moments,
        "refit planes": lambda: _refit_planes(m, slots0, use0, th,
                                              hood_cap=HOOD_CAP),
        "refit planes (hood 7)": lambda: _refit_planes(
            m, slots0, use0, th, hood_cap=HOOD_CAP, hood_window=7),
        "evict_beyond": lambda: surfel_map.evict_beyond(
            m, torch.zeros(3, device=dev), 90.0),
        "query_planes w=1": lambda: surfel_map.query_planes(m, pts, mask,
                                                            window=1),
        "query_planes w=3": lambda: surfel_map.query_planes(m, pts, mask,
                                                            window=3),
    }
    for name, fn in timed.items():
        out[name] = _cuda_ms(fn, reps)

    # a planar scene, where the map converges
    world = sim.World.room(size=120.0, height=8.0, n_boxes=24, seed=7)
    mp = surfel_map.empty(RES, TABLE, dev)
    T = np.eye(4)
    for s in range(12):
        T[:3, 3] = [2.0 * s, 0.0, 1.5]
        sp, _ = sim.simulate_scan(world, T, n_points=N, noise=0.01,
                                  seed=300 + s)
        spw = torch.from_numpy(sp @ T[:3, :3].T + T[:3, 3]).to(dev)
        mp = surfel_map.insert(mp, torch.nan_to_num(spw), torch.isfinite(
            spw).all(-1), th, hood_cap=HOOD_CAP, halo_cap=4096,
            hood_window=7)
    sp, _ = sim.simulate_scan(world, T, n_points=N, noise=0.01, seed=999)
    spw = torch.from_numpy(sp @ T[:3, :3].T + T[:3, 3]).to(dev)
    pmask = torch.isfinite(spw).all(-1)
    spw = torch.nan_to_num(spw)
    out["planar steady-state insert (hood 7)"] = _cuda_ms(
        lambda: surfel_map.insert(mp, spw, pmask, th, hood_cap=HOOD_CAP,
                                  halo_cap=4096, hood_window=7), reps)

    # the full per-scan LIO step at the kitti preset, on a warmed map
    lio, state = kitti_lio(dev)
    for s in range(10):
        state, _ = lio.process_scan(state, *kitti_inputs(s))
    inputs = kitti_inputs(10)
    out["full LIO step (kitti preset)"] = _cuda_ms(
        lambda: lio.process_scan(state, *inputs), reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--drift", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/profile_insert.json")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if args.drift:
        t0 = time.perf_counter()
        err, matches = drift(dev)
        print(f"kitti-width LIO run on {dev}: {KITTI_SCANS} scans in "
              f"{time.perf_counter() - t0:.1f} s, final position error "
              f"{err!r} m, matches {matches}", flush=True)
        return 0
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("profile_insert: the stage profile runs on the card")
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = stages(dev, args.reps)
    for name, v in out.items():
        print(f"{name}: {v}" + (" ms" if isinstance(v, float) else ""),
              flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "ms": out}, fh, indent=1)
    print(f"[{card}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
