"""The port's point-map LIO step held to the benchmark's plain float64
reference (``slam_bench/reference/lio_points.py``) on the CPU, within the
limits of the cell ``kitti-hdl64-point.drive``, through the cell's own
comparison (``slam_bench/check_points.py``).

The stream is the sim golden's ("sim" preset with ``map_backend =
"point"``: 4,096 rows, 0.3 m voxels) on a 2^14-slot table, so that by its
41st scan the table holds ~12,300 voxels (~75 % of its slots) and new
voxels meet taken probe slots: the reference's claim model has to place
and drop the same voxels as the table.  A step is compared on a fresh map
(one scan old) and on that map 40 scans old, each from the filter's state
moved 6 cm off, so that the Gauss-Newton steps move the pose.  Three
planted faults must come out not correct: one plane search skipped (the
second Gauss-Newton step given the first step's planes and residuals), one
map point moved 5 cm after the insert, and, on the loaded table, the
reference's claim model off (every new voxel placed)."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu_torch.models.lio import LIO
from fast_lio_sam_qn_tpu_torch.ops import ieskf
from fast_lio_sam_qn_tpu_torch.run import initial_state, sim_scan_inputs
from fast_lio_sam_qn_tpu_torch.tools import lio_scenarios
from slam_bench import check, check_points
from slam_bench.reference import geometry as G
from slam_bench.reference import points

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CELL = "kitti-hdl64-point.drive"
LIMITS = json.loads((ROOT / "slam_bench" / "workloads" / f"{CELL}.json")
                    .read_text())["limits"]
TABLE = 1 << 14
CASES = {"fresh": 1, "old": 40}


def _cfg():
    cfg = lio_scenarios.point_config()
    cfg.lio = dataclasses.replace(cfg.lio, map_table_size=TABLE)
    return cfg


def _cfg_dict(cfg) -> dict:
    """The configuration in the benchmark's file layout, as far as the
    comparison reads it (no keyframe is compared here)."""
    return {"lio": dataclasses.asdict(cfg.lio),
            "pipeline": {"loop": {"voxel_res": cfg.loop.voxel_res},
                         "caps": {"keyframe_points":
                                  cfg.caps.keyframe_points}}}


class _Searches:
    """``ieskf._plane_correspondences`` wrapped: the rows each search
    matched (the last one kept), and with ``skip`` the second search of an
    update given the first one's outputs."""

    def __init__(self, skip: bool = False):
        self.skip, self.calls, self.first, self.matched = skip, 0, None, None

    def __call__(self, orig):
        def search(*args, **kwargs):
            self.calls += 1
            out = orig(*args, **kwargs)
            if self.calls == 1:
                self.first = out
            elif self.calls == 2 and self.skip:
                out = self.first
            self.matched = out[2].clone()
            return out
        return search


def _step(lio, before, inputs, monkeypatch, skip=False):
    probe = _Searches(skip)
    monkeypatch.setattr(ieskf, "_plane_correspondences",
                        probe(ieskf._plane_correspondences))
    after, _ = lio.process_scan(before, *inputs)
    monkeypatch.undo()
    return after, probe


def _off(state):
    """The state moved 6.2 cm and 0.29 deg off the filter's: three
    Gauss-Newton steps then move the pose, and each search meets other
    planes."""
    nav = state.nav
    yaw = torch.tensor([[1.0, -0.005, 0.0], [0.005, 1.0, 0.0],
                        [0.0, 0.0, 1.0]])
    return state._replace(nav=nav._replace(
        R=nav.R @ yaw, p=nav.p + torch.tensor([0.05, -0.03, 0.02])))


@pytest.fixture(scope="module")
def stream():
    """The LIO over the sim stream on the small table: (lio, {case:
    (state before, inputs)})."""
    cfg = _cfg()
    world, traj = lio_scenarios.golden_world()
    lio = LIO(cfg.lio, imu_cap=64, device="cpu")
    state = initial_state(lio, traj)
    kept = {}
    for i in range(max(CASES.values()) + 1):
        inputs = tuple(
            torch.from_numpy(x) if isinstance(x, np.ndarray) else x
            for x in sim_scan_inputs(world, traj, i,
                                     1 / lio_scenarios.POINT_HZ,
                                     4 * cfg.lio.max_points_per_scan))
        for case, at in CASES.items():
            if i == at:
                kept[case] = (_off(check.clone(state)), inputs)
        state, _ = lio.process_scan(state, *inputs)
    return cfg, lio, kept


def _gaps(cfg, before, inputs, after, matched):
    return check_points.scan(_cfg_dict(cfg), before, inputs, after, None,
                             matched)


def _over(gaps):
    return {k: v for k, v in gaps.items() if k in LIMITS and
            not v <= LIMITS[k]}


@pytest.mark.parametrize("case", list(CASES))
def test_the_step_is_within_the_cells_limits(stream, case, monkeypatch):
    cfg, lio, kept = stream
    before, inputs = kept[case]
    after, probe = _step(lio, before, inputs, monkeypatch)
    assert probe.calls == cfg.lio.max_iteration + 1
    gaps = _gaps(cfg, before, inputs, after, probe.matched)
    print(case, gaps)
    assert not _over(gaps), gaps
    assert gaps["match_share"] < 0.01
    occupied = int(after.grid.occupied.sum())
    if case == "old":
        # the claim model at work: a loaded table, voxels left unplaced
        assert occupied > 0.7 * TABLE
        assert gaps["drop_share"] > 0
    else:
        # under a third full: few new voxels left unplaced
        assert occupied < 0.35 * TABLE
        assert gaps["drop_share"] < 0.05


@pytest.mark.parametrize("case", list(CASES))
def test_a_skipped_search_is_not_correct(stream, case, monkeypatch):
    cfg, lio, kept = stream
    before, inputs = kept[case]
    after, probe = _step(lio, before, inputs, monkeypatch, skip=True)
    gaps = _gaps(cfg, before, inputs, after, probe.matched)
    print(case, gaps)
    assert _over(gaps), gaps


@pytest.mark.parametrize("case", list(CASES))
def test_a_moved_map_point_is_not_correct(stream, case, monkeypatch):
    cfg, lio, kept = stream
    before, inputs = kept[case]
    after, probe = _step(lio, before, inputs, monkeypatch)
    g = after.grid
    slot = int(torch.nonzero(g.occupied)[0])
    moved = g.points.clone()
    moved[slot, 0] += 0.05
    after = after._replace(grid=g._replace(points=moved))
    gaps = _gaps(cfg, before, inputs, after, probe.matched)
    print(case, gaps)
    assert set(_over(gaps)) == {"map_point_m"}, gaps


def _claim_off(m, keys, bids):
    """Every new voxel placed, at its first probe slot."""
    return G.probe_slots(G.unpack(keys), m.table)[:, 0], \
        torch.ones_like(bids, dtype=torch.bool)


def test_the_claim_model_off_is_not_correct(stream, monkeypatch):
    """On the loaded table (a fresh map places all but ~1 % of its new
    voxels: too few there to tell the claim model from none)."""
    cfg, lio, kept = stream
    before, inputs = kept["old"]
    after, probe = _step(lio, before, inputs, monkeypatch)
    monkeypatch.setattr(points, "claim", _claim_off)
    gaps = _gaps(cfg, before, inputs, after, probe.matched)
    print(gaps)
    assert "map_share" in _over(gaps), gaps
