"""The comparisons that decide ``correct`` on the point map (the cell
``kitti-hdl64-point.drive``): what the timed path produced, held against
the plain reference (``reference/lio_points.py``, ``reference/points.py``)
computed in float64 from the same inputs.

As in ``check.py``: a sampled scan starts from the program's filter state
and point map before it, and the reference works out the whole scan again
from the raw points and IMU samples (the pose, the plane searches, the
map after its insert, the keyframe's voxels where the scan made one); a
sampled pose-graph solve starts from the graph the program handed it.
Every gap is logged; the cell's ``limits`` name those that decide
``correct``.  Nothing here imports the port.
"""
from __future__ import annotations

import torch

from . import check
from .reference import geometry as G
from .reference import lio as ref_lio
from .reference import lio_points
from .reference import points

NUMBERS = ("lio_pos_m", "lio_rot_rad", "lio_vel_mps", "map_share",
           "map_point_m", "kf_share", "match_share", "drop_share",
           "pgo_pos_m")


def reference_state(state, res: float, dtype) -> ref_lio.State:
    """The program's LIO state (its filter and the point map's table) in
    the reference's terms."""
    nav, g = state.nav, state.grid
    return ref_lio.State(
        *(t.to(dtype) for t in (nav.R, nav.p, nav.v, nav.bg, nav.ba,
                                nav.grav, state.P)),
        map=points.from_grid(g.points, g.coords, g.occupied, g.src_idx, res,
                             dtype))


def _step(cfg: dict, before, inputs, dtype) -> lio_points.Scan:
    lc = cfg["lio"]
    dev = before.nav.p.device
    return lio_points.step(
        reference_state(before, lc["filter_size_map"], dtype), inputs, lc,
        torch.tensor(lc["extrinsic_R"], dtype=dtype,
                     device=dev).reshape(3, 3),
        torch.tensor(lc["extrinsic_T"], dtype=dtype, device=dev))


def control_scan(cfg: dict, before, inputs) -> lio_points.Scan:
    """The reference's step in float32 with TF32 products: the control's
    stand-in for the program's."""
    with check.tf32():
        return _step(cfg, before, inputs, torch.float32)


def scan(cfg: dict, before, inputs, after, keyframe, matched,
         stand_in=None) -> dict:
    """One sampled scan: the reference's step from the program's state
    ``before`` on the raw ``inputs``, against the program's ``after``, the
    keyframe it stored (cloud, mask; None if the scan made none) and the
    rows its last plane search matched.  ``stand_in`` (a reference step,
    the control's) replaces the program's results.  Returns {number:
    gap}."""
    res = cfg["lio"]["filter_size_map"]
    loop = cfg["pipeline"]["loop"]
    kf_res, kf_cap = loop["voxel_res"], \
        cfg["pipeline"]["caps"]["keyframe_points"]
    want = _step(cfg, before, inputs, torch.float64)
    if stand_in is None:
        got_R, got_p, got_v = after.nav.R, after.nav.p, after.nav.v
        got_map = reference_state(after, res, torch.float64).map
        got_kf = None if keyframe is None else torch.unique(
            G.pack(G.voxel_of(keyframe[0][keyframe[1]].double(), kf_res)))
    else:
        s = stand_in.state
        got_R, got_p, got_v, got_map = s.R, s.p, s.v, s.map
        matched = stand_in.matched
        got_kf = None if keyframe is None else G.downsample_keys(
            stand_in.body, stand_in.mask, kf_res, kf_cap)
    w = want.state
    share, largest = points.gap(got_map, w.map)
    either = matched | want.matched
    gaps = {"lio_pos_m": float(torch.linalg.norm(w.p - got_p.double())),
            "lio_rot_rad": check.rot_gap(w.R, got_R),
            "lio_vel_mps": float(torch.linalg.norm(w.v - got_v.double())),
            "map_share": share, "map_point_m": largest,
            "match_share": float((matched != want.matched).sum())
            / max(int(either.sum()), 1),
            "drop_share": (want.new - want.placed) / max(want.new, 1)}
    if got_kf is not None:
        gaps["kf_share"] = check.key_share(
            got_kf, G.downsample_keys(want.body, want.mask, kf_res, kf_cap))
    return gaps
