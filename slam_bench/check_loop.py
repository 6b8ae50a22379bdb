"""The comparisons of a revisit's loop closure: what the program's
registration produced at each stage, held against the plain reference
(``reference/registration.py``) computed in float64 from the program's own
inputs to that stage, and each committed loop measurement against the
route's true relative pose.

- ``fpfh_share``: of a cloud's rows that either side calls valid, the
  share whose descriptor is off: valid on one side only, or over
  ``FPFH_ROW_L1`` apart in L1 (of the 300 a row's three blocks sum to).
  The reference works out the features from the program's anchored cloud
  and viewpoint.
- ``fpfh_row_mass``: over the rows valid on both sides, the largest gap
  between a descriptor block's sum and the reference's (100 in a valid
  row).  No rounding moves it; a row the program zeroes or leaves
  unnormalized reads 100, which a share of rows cannot show.
- ``coarse_rot_rad``, ``coarse_pos_m``: Quatro from the program's
  correspondences, against the program's coarse transform: the angle
  between the rotations, and how far apart the two carry the matches'
  centroid.
- ``fine_rot_rad``, ``fine_pos_m``: GICP from the program's coarse-aligned
  source, its target and the plane covariances the program gave its GICP
  (from the radius moments; a few per cent of rows, in near-collinear
  neighbourhoods, turn their plane between float32 and float64 and move
  GICP's optimum by centimetres, which says nothing of the GICP), against
  the program's fine transform: the angle, and how far apart the
  two carry the source's centroid; on the lanes the program accepts (a
  rejected registration's answer is never used, and from a wrong coarse
  transform GICP's path is chaotic in any precision).
- ``loop_truth_m``, ``loop_truth_rad``: each loop factor committed in the
  window, Z, against the true T_i^-1 T_j of its two keyframes' route poses.

A lane without a candidate (a pad lane) is not compared.  Nothing here
imports the port.
"""
from __future__ import annotations

import torch

from . import check
from .reference import geometry as G
from .reference import registration as R

NUMBERS = ("fpfh_share", "fpfh_row_mass", "coarse_rot_rad", "coarse_pos_m",
           "fine_rot_rad", "fine_pos_m", "loop_truth_m", "loop_truth_rad")
# a row's L1 distance (of 300) beyond which its descriptor is off: one
# neighbour of ~50 crossing the radius, or a normal's ~5e-3 rad tilt moving
# a few pairs a bin, stays below it; a wrong neighbourhood or normal field
# does not
FPFH_ROW_L1 = 30.0


def transform_gap(Ta: torch.Tensor, Tb: torch.Tensor, at=None):
    """(m, rad) between two transforms: how far apart they carry the point
    ``at`` (3,) (the origin when None), and the angle of Ra^T Rb."""
    Ta, Tb = Ta.double(), Tb.double()
    x = torch.zeros(3, dtype=torch.float64, device=Ta.device) if at is None \
        else at.double()
    moved = Ta[:3, :3] @ x + Ta[:3, 3] - Tb[:3, :3] @ x - Tb[:3, 3]
    return (float(torch.linalg.norm(moved)),
            float(torch.linalg.norm(G.log_so3(Ta[:3, :3].T @ Tb[:3, :3]))))


def centroid(points, mask):
    """The mean of a cloud's masked points: where a registration's
    translation is judged (in the anchored frame a transform's own
    translation carries its rotation's error times the lever arm to the
    anchor)."""
    return points[mask].double().mean(0) if bool(mask.any()) \
        else points.new_zeros(3, dtype=torch.float64)


def _qc(cfg: dict) -> dict:
    return cfg["pipeline"]["loop"]["quatro"]


def reference_fpfh(cfg: dict, points, mask, vp, dtype=torch.float64):
    qc = _qc(cfg)
    return R.fpfh(points.to(dtype), mask, vp.to(dtype),
                  qc["fpfh_normal_radius"], qc["fpfh_radius"],
                  qc["fpfh_cov_radius"])


def fpfh_share(desc_got, valid_got, desc_want, valid_want) -> float:
    """Share of the rows valid on either side whose descriptor is off."""
    either = valid_got | valid_want
    n = int(either.sum())
    if n == 0:
        return 0.0
    l1 = (desc_got.double() - desc_want.double()).abs().sum(-1)
    off = either & ((valid_got != valid_want) | (l1 > FPFH_ROW_L1))
    return int(off.sum()) / n


def fpfh_row_mass(desc_got, valid_got, desc_want, valid_want) -> float:
    """The largest gap between a block's sum on the two sides, over the
    rows valid on both."""
    both = valid_got & valid_want
    if not bool(both.any()):
        return 0.0

    def sums(d):
        return d[both].double().reshape(-1, 3, d.shape[-1] // 3).sum(-1)
    return float((sums(desc_got) - sums(desc_want)).abs().max())


def reference_quatro(cfg: dict, s, d, ok, dtype=torch.float64):
    qc = _qc(cfg)
    T, _ = R.quatro(s.to(dtype), d.to(dtype), ok, qc["noise_bound"],
                    qc["rot_gnc_factor"], qc["rot_cost_diff_thr"],
                    qc["rot_max_iter"])
    return T


def reference_gicp(cfg: dict, src, src_ok, src_cov, dst, dst_ok, dst_cov,
                   dtype=torch.float64):
    """GICP of the program's coarse-aligned source onto its target over
    the points that count (``*_ok``: masked, with a covariance), with the
    plane covariances given."""
    gc = cfg["pipeline"]["loop"]["gicp"]
    T, _ = R.gicp(src.to(dtype), src_ok, src_cov.to(dtype), dst.to(dtype),
                  dst_ok, dst_cov.to(dtype), gc["max_iter"],
                  gc["max_corr_dist"], gc["transformation_epsilon"])
    return T


def registration(cfg: dict, cap: dict, control: bool = False) -> dict:
    """Every stage gap of one captured registration: {number: [gaps]},
    one a compared lane (both clouds' rows for ``fpfh_share``).  With
    ``control`` the program's results are replaced by the reference's in
    float32 with TF32 products."""
    gaps = {k: [] for k in NUMBERS[:6]}
    for b in cap["lanes"]:
        for pts, mask, vp, desc, valid in cap["fpfh"]:
            want = reference_fpfh(cfg, pts[b], mask[b], vp[b])
            if control:
                with check.tf32():
                    got = reference_fpfh(cfg, pts[b], mask[b], vp[b],
                                         torch.float32)
                desc_b, valid_b = got[0], got[1]
            else:
                desc_b, valid_b = desc[b], valid[b]
            gaps["fpfh_share"].append(
                fpfh_share(desc_b, valid_b, want[0], want[1]))
            gaps["fpfh_row_mass"].append(
                fpfh_row_mass(desc_b, valid_b, want[0], want[1]))
        if "match" in cap and b < len(cap["solve"]):
            s, d, ok = (x[b] for x in cap["match"])
            want = reference_quatro(cfg, s, d, ok)
            if control:
                with check.tf32():
                    got = reference_quatro(cfg, s, d, ok, torch.float32)
            else:
                got = cap["solve"][b]
            t, r = transform_gap(got, want, centroid(s, ok))
            gaps["coarse_pos_m"].append(t)
            gaps["coarse_rot_rad"].append(r)
        if "gicp" in cap and bool(cap["valid"][b]):
            src, src_mask, dst, dst_mask, T = cap["gicp"]
            s_cov, s_ok, d_cov, d_ok = (x[b] for x in cap["gicp_cov"])
            given = (src[b], src_mask[b] & s_ok, s_cov,
                     dst[b], dst_mask[b] & d_ok, d_cov)
            want = reference_gicp(cfg, *given)
            if control:
                with check.tf32():
                    got = reference_gicp(cfg, *given, torch.float32)
            else:
                got = T[b]
            t, r = transform_gap(got, want, centroid(src[b], src_mask[b]))
            gaps["fine_pos_m"].append(t)
            gaps["fine_rot_rad"].append(r)
    return gaps


def loop_truth(meas: torch.Tensor, T_i: torch.Tensor, T_j: torch.Tensor):
    """(m, rad) between a committed measurement Z and the true relative
    pose T_i^-1 T_j (float64 route poses), at keyframe j's origin."""
    return transform_gap(meas, G.inverse(T_i) @ T_j)
