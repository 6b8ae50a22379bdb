"""The comparisons that decide a run's ``correct``: what the timed path
produced, held against the plain reference (``reference/``), computed in
float64 from the same inputs.

The reference follows the program step by step.  A sampled scan starts
from the program's filter state and map before it, and the reference
works out the whole scan again from the raw points and IMU samples: the
pose it reaches, the map after its insert, and the keyframe's voxels where
the scan made one.  A sampled pose-graph solve starts from the graph the
program handed it.  The map the reference starts from is the program's
own; it is judged by the same comparison at every sampled scan.  Every
gap is logged; a cell's ``limits`` name those that decide ``correct``.
Nothing here imports the port.
"""
from __future__ import annotations

import math

import torch

from .reference import geometry as G
from .reference import lio as ref_lio
from .reference import pgo as ref_pgo
from .reference import surfels

INF = math.inf
NUMBERS = ("lio_pos_m", "lio_rot_rad", "lio_vel_mps", "map_share",
           "kf_share", "pgo_pos_m")


def clone(x):
    """A deep copy of a state's tensors (named tuples, tuples, tensors;
    other leaves as they are)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone(f) for f in x))
    if isinstance(x, (tuple, list)):
        return type(x)(clone(f) for f in x)
    return x


def reference_state(state, res: float, dtype) -> ref_lio.State:
    """The program's LIO state (its filter and the map's tables) in the
    reference's terms."""
    nav, g = state.nav, state.grid
    return ref_lio.State(
        *(t.to(dtype) for t in (nav.R, nav.p, nav.v, nav.bg, nav.ba,
                                nav.grav, state.P)),
        map=surfels.from_tables(g.key, g.mom, g.plane, res, dtype))


def rot_gap(Ra: torch.Tensor, Rb: torch.Tensor) -> float:
    """Angle (rad) of Ra^T Rb."""
    return float(torch.linalg.norm(G.log_so3(Ra.double().T @ Rb.double())))


def key_share(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of the keys in either sorted set that only one holds."""
    union = torch.unique(torch.cat([a, b]))
    if union.numel() == 0:
        return 0.0
    both = int(torch.isin(a, b).sum())
    return float(union.numel() - both) / union.numel()


def scan(cfg: dict, before, inputs, after, keyframe, dtype=torch.float64,
         stand_in=None) -> dict:
    """One sampled scan: the reference's step from the program's state
    ``before`` on the raw ``inputs``, against the program's ``after`` and
    the keyframe it stored (cloud, mask; None if the scan made none).
    ``stand_in`` (a reference step, the control's) replaces the program's
    results.  Returns {number: gap}."""
    lc, res = cfg["lio"], cfg["lio"]["filter_size_map"]
    loop = cfg["pipeline"]["loop"]
    kf_res, kf_cap = loop["voxel_res"], \
        cfg["pipeline"]["caps"]["keyframe_points"]
    ext_R = torch.tensor(lc["extrinsic_R"], dtype=dtype).reshape(3, 3)
    ext_t = torch.tensor(lc["extrinsic_T"], dtype=dtype)
    dev = after.nav.p.device
    want = ref_lio.step(reference_state(before, res, dtype), inputs, lc,
                        ext_R.to(dev), ext_t.to(dev))
    if stand_in is None:
        got_R, got_p, got_v = after.nav.R, after.nav.p, after.nav.v
        g = after.grid
        got_map = surfels.from_tables(g.key, g.mom, g.plane, res,
                                      torch.float64)
        got_kf = None if keyframe is None else torch.unique(
            G.pack(G.voxel_of(keyframe[0][keyframe[1]].double(), kf_res)))
    else:
        s = stand_in.state
        got_R, got_p, got_v, got_map = s.R, s.p, s.v, s.map
        got_kf = None if keyframe is None else G.downsample_keys(
            stand_in.body, stand_in.mask, kf_res, kf_cap)
    w = want.state
    gaps = {"lio_pos_m": float(torch.linalg.norm(w.p - got_p.double())),
            "lio_rot_rad": rot_gap(w.R, got_R),
            "lio_vel_mps": float(torch.linalg.norm(w.v - got_v.double())),
            "map_share": surfels.gap(got_map, w.map)}
    if got_kf is not None:
        gaps["kf_share"] = key_share(
            got_kf, G.downsample_keys(want.body, want.mask, kf_res, kf_cap))
    return gaps


def solve_inputs(graph, dtype):
    """The active part of a program's pose graph, in the reference's
    terms: (poses, prior, odometry, loops)."""
    n, nl = int(graph.num_nodes), int(graph.num_loops)
    loops = (graph.loop_i[:nl].long(), graph.loop_j[:nl].long(),
             graph.loop_meas[:nl].to(dtype), graph.loop_var[:nl])
    return (graph.poses[:n].to(dtype), graph.prior_pose.to(dtype),
            graph.odom_meas[:n].to(dtype), loops)


def solve(cfg: dict, graph_in, kwargs, graph_out, dtype=torch.float64,
          stand_in=None) -> float:
    """Largest node position gap (m) between the program's solve (or a
    stand-in's solved poses) and the reference's, on the same graph."""
    n = int(graph_in.num_nodes)
    if n == 0:
        return 0.0
    pc = cfg["pipeline"]
    dev = graph_in.poses.device
    want = ref_pgo.optimize(
        *solve_inputs(graph_in, dtype),
        torch.tensor(pc["prior_variances"], device=dev),
        torch.tensor(pc["odom_variances"], device=dev),
        kwargs["gn_iters"], kwargs["robust_delta"])
    got = graph_out.poses[:n] if stand_in is None else stand_in
    return float(torch.linalg.norm(want[:, :3, 3] - got[:, :3, 3].double(),
                                   dim=1).max())


def control_solve(cfg: dict, graph_in, kwargs):
    """The reference's solve in float32 with TF32 products: the control's
    stand-in for the program's."""
    pc = cfg["pipeline"]
    dev = graph_in.poses.device
    with tf32():
        return ref_pgo.optimize(
            *solve_inputs(graph_in, torch.float32),
            torch.tensor(pc["prior_variances"], device=dev),
            torch.tensor(pc["odom_variances"], device=dev),
            kwargs["gn_iters"], kwargs["robust_delta"])


def control_scan(cfg: dict, before, inputs):
    """The reference's step in float32 with TF32 products."""
    lc = cfg["lio"]
    dev = before.nav.p.device
    with tf32():
        return ref_lio.step(
            reference_state(before, lc["filter_size_map"], torch.float32),
            inputs, lc,
            torch.tensor(lc["extrinsic_R"], device=dev).reshape(3, 3),
            torch.tensor(lc["extrinsic_T"], device=dev))


def worst(values) -> float:
    """The largest gap of a list; inf for none (nothing was compared)."""
    return max(values, default=INF)


class tf32:
    """TF32 matrix products on the card inside the block: the control's
    precision, the one below the configurations' float32."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
