"""SE(3) pose-graph optimizer — port of fast_lio_sam_qn_tpu/ops/pgo.py.

Fixed-capacity masked factor arrays (one prior, an odometry factor per
node, loop factors with isotropic variance = the ICP fitness) and a batched
Gauss-Newton solver, relinearized every outer iteration, with a
matrix-free block-Jacobi preconditioned conjugate gradient.  Residual
convention r = Log(meas^-1 Ti^-1 Tj), tangent (rotation, translation),
right perturbation T <- T exp(xi).

What differs in mechanism, not in result:

- **Deterministic scatters.**  The reference's ``.at[idx].add`` has
  duplicate indices by construction (odometry factor f hits nodes f-1 and
  f; loops hit arbitrary nodes), and ``index_add_`` with duplicate indices
  sums in a run-dependent order on CUDA.  Here odometry rows are two
  shifted adds, and loop rows are a product with a fixed one-hot (node x
  loop) matrix built once per solve, so a solve repeats bit for bit.
  The factor-sharded solve (parallel/spmd.py), whose rank holds any slice
  of the rows, sums them with ``RowScatter``: a product with a one-hot
  (node x row) matrix of the slice's indices (``factor_indices``), never
  ``index_add_``.
- **PCG's early exit.**  The reference's ``while_loop`` stops once
  sum(r*r) <= 1e-10 max(r0.r0, 1e-20) or after ``pcg_iters``.  Here the
  carry freezes (``torch.where``) once that test fails, which gives the
  reference's result exactly, and the host reads the live flag only every
  ``PCG_CHECK`` iterations to stop early: at most pcg_iters / PCG_CHECK
  reads per Gauss-Newton step instead of one per iteration.
- **PCG as CUDA graphs.**  On the card ``optimize`` replays the
  ``PCG_CHECK`` iterations between two reads as one CUDA graph
  (``_pcg_block``, through ``_PCG_GRAPHS``): the same kernels and bits,
  without the host issuing each iteration's ~100 operations.  The rest
  stays eager, and so does the factor-sharded solve (its H x runs a
  collective).
- ``add_*`` and ``grow`` return new tensors, as the reference's do; only
  the pipeline holds a graph.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import cuda_graph, profiling
from . import se3

PCG_CHECK = 8  # PCG iterations between host reads of the live flag
# the PCG blocks' graphs, one a graph's capacities (a few: ``grow`` doubles)
_PCG_GRAPHS = cuda_graph.Runner()


class GraphState(NamedTuple):
    """Fixed-capacity pose graph; node i is keyframe i.  odom_meas[i] is the
    factor from node i-1 to node i (valid for 1 <= i < num_nodes)."""

    poses: torch.Tensor       # (N, 4, 4) current estimates
    num_nodes: torch.Tensor   # () int32
    prior_pose: torch.Tensor  # (4, 4) prior on node 0
    odom_meas: torch.Tensor   # (N, 4, 4)
    loop_i: torch.Tensor      # (L,) int32
    loop_j: torch.Tensor      # (L,) int32
    loop_meas: torch.Tensor   # (L, 4, 4)
    loop_var: torch.Tensor    # (L,) isotropic variance (= ICP score)
    num_loops: torch.Tensor   # () int32

    @property
    def capacity(self) -> int:
        return self.poses.shape[0]


def _eyes(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(4, dtype=like.dtype, device=like.device).repeat(n, 1, 1)


def empty_graph(max_nodes: int, max_loops: int, device: torch.device | str,
                dtype: torch.dtype = torch.float32) -> GraphState:
    ref = torch.zeros((), dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return GraphState(
        poses=_eyes(max_nodes, ref), num_nodes=torch.zeros((), **i32),
        prior_pose=_eyes(1, ref)[0], odom_meas=_eyes(max_nodes, ref),
        loop_i=torch.zeros((max_loops,), **i32),
        loop_j=torch.zeros((max_loops,), **i32),
        loop_meas=_eyes(max_loops, ref),
        loop_var=torch.ones((max_loops,), dtype=dtype, device=device),
        num_loops=torch.zeros((), **i32))


def grow(graph: GraphState, max_nodes: int | None = None,
         max_loops: int | None = None) -> GraphState:
    """Re-pad to larger capacities (amortized growth on overflow)."""
    g = graph
    if max_nodes is not None and max_nodes > g.capacity:
        pad = _eyes(max_nodes - g.capacity, g.poses)
        g = g._replace(poses=torch.cat([g.poses, pad]),
                       odom_meas=torch.cat([g.odom_meas, pad]))
    l_cap = g.loop_i.shape[0]
    if max_loops is not None and max_loops > l_cap:
        pad = max_loops - l_cap
        zeros = torch.zeros((pad,), dtype=torch.int32, device=g.poses.device)
        g = g._replace(
            loop_i=torch.cat([g.loop_i, zeros]),
            loop_j=torch.cat([g.loop_j, zeros]),
            loop_meas=torch.cat([g.loop_meas, _eyes(pad, g.poses)]),
            loop_var=torch.cat([g.loop_var, torch.ones_like(
                g.loop_var[:1]).expand(pad)]))
    return g


def _set(a: torch.Tensor, i: torch.Tensor, v) -> torch.Tensor:
    """a with row i (a 0-d device index) set to v, out of place."""
    return a.index_put((i.reshape(1).long(),),
                       torch.as_tensor(v, dtype=a.dtype,
                                       device=a.device)[None])


def add_first_node(graph: GraphState, pose) -> GraphState:
    """Prior factor + initial estimate (fast_lio_sam_qn.cpp:112-118)."""
    pose = torch.as_tensor(pose, dtype=graph.poses.dtype,
                           device=graph.poses.device)
    zero = torch.zeros_like(graph.num_nodes)
    return graph._replace(poses=_set(graph.poses, zero, pose),
                          prior_pose=pose.clone(), num_nodes=zero + 1)


def add_odom_node(graph: GraphState, pose_from, pose_to) -> GraphState:
    """Append a node with the factor (prev, cur, from.between(to));
    pose_to is also its initial estimate."""
    i = graph.num_nodes
    return graph._replace(
        poses=_set(graph.poses, i, pose_to),
        odom_meas=_set(graph.odom_meas, i,
                       se3.pose_between(pose_from, pose_to)),
        num_nodes=i + 1)


def add_loop_factor(graph: GraphState, i, j, meas, score) -> GraphState:
    """Loop factor (i, j) with isotropic variance = score."""
    n = graph.num_loops
    return graph._replace(
        loop_i=_set(graph.loop_i, n, i), loop_j=_set(graph.loop_j, n, j),
        loop_meas=_set(graph.loop_meas, n, meas),
        loop_var=_set(graph.loop_var, n, score), num_loops=n + 1)


# ---------------------------------------------------------------------------
# residuals and Jacobians
# ---------------------------------------------------------------------------

def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for tangent order (w, v): (..., 4, 4) -> (..., 6, 6)."""
    R, t = se3.split_pose(T)
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([se3.hat(t) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _ad(xi: torch.Tensor) -> torch.Tensor:
    """se(3) little adjoint: (..., 6) -> (..., 6, 6)."""
    W, V = se3.hat(xi[..., :3]), se3.hat(xi[..., 3:])
    top = torch.cat([W, torch.zeros_like(W)], dim=-1)
    bot = torch.cat([V, W], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _eye6(r: torch.Tensor) -> torch.Tensor:
    return torch.eye(6, dtype=r.dtype, device=r.device).expand(
        r.shape[:-1] + (6, 6))


def _between_residual(Ti, Tj, meas):
    """r = Log(meas^-1 Ti^-1 Tj) and the Jacobians for right perturbations
    of Ti, Tj: Ji = -Jr_inv(r) Ad(Tj^-1 Ti), Jj = Jr_inv(r)."""
    rel = se3.pose_between(Ti, Tj)
    r = se3.se3_log(se3.compose(se3.pose_inverse(meas), rel))
    jr_inv = _eye6(r) + 0.5 * _ad(r)
    return r, -(jr_inv @ _adjoint(se3.pose_inverse(rel))), jr_inv


def _factor_data(graph: GraphState, prior_var, odom_var):
    """Linearize all factors.  Rows: odometry (n_cap), loops (l_cap), prior
    (1) — the layout ``huber_loop_weights`` indexes.  Returns (r, Ji, Jj,
    w6, valid); the node indices are implicit in the layout (see
    ``_Scatter``)."""
    n_cap = graph.capacity
    dev = graph.poses.device
    node = torch.arange(n_cap, device=dev)
    Ti = graph.poses[torch.clamp(node - 1, min=0)]
    r_o, Ji_o, Jj_o = _between_residual(Ti, graph.poses, graph.odom_meas)
    valid_o = (node >= 1) & (node < graph.num_nodes)
    w_o = (1.0 / odom_var).expand(n_cap, 6)

    li = torch.clamp(graph.loop_i, 0, n_cap - 1).long()
    lj = torch.clamp(graph.loop_j, 0, n_cap - 1).long()
    r_l, Ji_l, Jj_l = _between_residual(graph.poses[li], graph.poses[lj],
                                        graph.loop_meas)
    l_cap = graph.loop_i.shape[0]
    valid_l = torch.arange(l_cap, device=dev) < graph.num_loops
    w_l = (1.0 / torch.clamp(graph.loop_var, min=1e-8))[:, None].expand(
        l_cap, 6)

    r_p = se3.se3_log(se3.compose(se3.pose_inverse(graph.prior_pose),
                                  graph.poses[0]))
    Jp = _eye6(r_p) + 0.5 * _ad(r_p)

    r = torch.cat([r_o, r_l, r_p[None]])
    Ji = torch.cat([Ji_o, Ji_l, torch.zeros_like(Jp)[None]])
    Jj = torch.cat([Jj_o, Jj_l, Jp[None]])
    w6 = torch.cat([w_o, w_l, (1.0 / prior_var)[None]])
    valid = torch.cat([valid_o, valid_l,
                       torch.ones(1, dtype=torch.bool, device=dev)])
    return r, Ji, Jj, w6, valid


class _Scatter(NamedTuple):
    """Sum per-factor rows into per-node rows, deterministically, for the
    layout of ``_factor_data``: odometry row f hits nodes f-1 (its i side;
    row 0 is never valid) and f; loop row l hits loop_i[l] and loop_j[l];
    the prior row hits node 0 on its j side."""

    Si: torch.Tensor       # (n_cap, l_cap) one-hot of the loops' i nodes
    Sj: torch.Tensor       # (n_cap, l_cap) one-hot of the loops' j nodes
    li: torch.Tensor       # (l_cap,) int64
    lj: torch.Tensor       # (l_cap,) int64

    @classmethod
    def of(cls, graph: GraphState) -> "_Scatter":
        n_cap = graph.capacity
        idx = torch.arange(n_cap, device=graph.poses.device)
        li = torch.clamp(graph.loop_i, 0, n_cap - 1).long()
        lj = torch.clamp(graph.loop_j, 0, n_cap - 1).long()
        dt = graph.poses.dtype
        return cls((idx[:, None] == li[None, :]).to(dt),
                   (idx[:, None] == lj[None, :]).to(dt), li, lj)

    def gather(self, x: torch.Tensor):
        """Per-factor rows of per-node x: (x at side i, x at side j)."""
        xi = torch.cat([x[:1], x[:-1], x[self.li], x[:1]])
        xj = torch.cat([x, x[self.lj], x[:1]])
        return xi, xj

    def __call__(self, ci: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
        n = self.Si.shape[0]
        out = cj[:n].clone()
        out[:-1] += ci[1:n]
        out[0] += ci[0] + ci[-1] + cj[-1]
        flat = out.reshape(n, -1)
        flat += self.Si @ ci[n:-1].reshape(ci.shape[0] - n - 1, -1)
        flat += self.Sj @ cj[n:-1].reshape(cj.shape[0] - n - 1, -1)
        return out


def factor_indices(graph: GraphState):
    """The node indices of ``_factor_data``'s rows, (idx_i, idx_j) int64 in
    the reference's layout: odometry row f joins max(f - 1, 0) and f, loop
    row l joins the clamped loop_i[l] and loop_j[l], and the prior joins a
    virtual node, index -1 (which ``RowScatter`` drops; the reference
    writes 0 there, under a zero Jacobian), to node 0."""
    n_cap = graph.capacity
    node = torch.arange(n_cap, device=graph.poses.device)
    li = torch.clamp(graph.loop_i, 0, n_cap - 1).long()
    lj = torch.clamp(graph.loop_j, 0, n_cap - 1).long()
    return (torch.cat([torch.clamp(node - 1, min=0), li, node[:1] - 1]),
            torch.cat([node, lj, node[:1]]))


class RowScatter:
    """Sum any slice of factor rows into per-node rows by their node
    indices (-1 drops a row), deterministically: a product with the fixed
    one-hot (n_cap x rows) matrix of the indices, built once per solve."""

    def __init__(self, idx: torch.Tensor, n_cap: int, dtype: torch.dtype):
        self.idx = torch.clamp(idx, min=0)
        nodes = torch.arange(n_cap, device=idx.device)
        self.S = (nodes[:, None] == idx[None, :]).to(dtype)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Per-row x at each row's node (node 0 for a dropped row)."""
        return x[self.idx]

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        out = self.S @ rows.reshape(rows.shape[0], -1)
        return out.reshape((self.S.shape[0],) + rows.shape[1:])


class _System(NamedTuple):
    """``optimize``'s H on one Gauss-Newton step, never formed: a call is
    H v on the active rows, v (N, 6).  ``pcg`` replays whole blocks of
    iterations on it as CUDA graphs."""

    scatter: _Scatter
    Ji: torch.Tensor
    Jj: torch.Tensor
    w6: torch.Tensor
    valid: torch.Tensor
    active: torch.Tensor

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        vi, vj = self.scatter.gather(v)
        u = (torch.einsum("fab,fb->fa", self.Ji, vi)
             + torch.einsum("fab,fb->fa", self.Jj, vj))
        wu = u * self.w6 * self.valid[:, None]
        return self.scatter(torch.einsum("fba,fb->fa", self.Ji, wu),
                            torch.einsum("fba,fb->fa", self.Jj, wu)
                            ) * self.active


def huber_loop_weights(r, w6, n_cap: int, l_cap: int, robust_delta: float):
    """Huber reweighting of the loop rows (layout of ``_factor_data``)."""
    f = torch.arange(r.shape[0], device=r.device)
    is_loop = (f >= n_cap) & (f < n_cap + l_cap)
    m = torch.sqrt(torch.clamp(torch.sum(r * r * w6, dim=-1), min=1e-20))
    hub = torch.clamp(robust_delta / m, max=1.0)
    return torch.where(is_loop[:, None], w6 * hub[:, None], w6)


def gn_retract(g: GraphState, x: torch.Tensor, active) -> GraphState:
    """Right-perturbation retraction onto the active nodes, with every
    rotation block re-projected onto SO(3) (see the reference's docstring:
    the compose chain drifts off the manifold otherwise)."""
    new = torch.where(active[..., None], se3.compose(g.poses,
                                                     se3.se3_exp(x)),
                      g.poses)
    new[..., :3, :3] = se3.orthonormalize3(new[..., :3, :3])
    return g._replace(poses=new)


def optimize(graph: GraphState, prior_var, odom_var, gn_iters: int = 3,
             pcg_iters: int = 64, robust_delta: float = 1.0) -> GraphState:
    """Batch Gauss-Newton over all factors, relinearized every iteration,
    each step solved by block-Jacobi PCG warm-started at zero, its whole
    ``PCG_CHECK``-iteration blocks replayed as CUDA graphs on the card
    (the same arithmetic, bit for bit).

    prior_var / odom_var: (6,) variances (reference diag(1e-4 x3,
    1e-2 x3)).  robust_delta: Huber threshold on the loop rows' whitened
    residual; <= 0 disables it."""
    dev = graph.poses.device
    prior_var = torch.as_tensor(prior_var, dtype=graph.poses.dtype,
                                device=dev)
    odom_var = torch.as_tensor(odom_var, dtype=graph.poses.dtype, device=dev)
    active = (torch.arange(graph.capacity, device=dev)
              < graph.num_nodes)[:, None]
    scatter = _Scatter.of(graph)
    g = graph
    for _ in range(gn_iters):
        system, b, Pinv = linearize(g, scatter, active, prior_var, odom_var,
                                    robust_delta)
        x = pcg(b, Pinv, system, active, pcg_iters)
        g = gn_retract(g, x, active)
    return g


def linearize(g: GraphState, scatter: _Scatter, active, prior_var, odom_var,
              robust_delta: float):
    """One Gauss-Newton step's linear system at g's estimate, as
    ``optimize`` solves it: H as a ``_System`` of ``_factor_data``'s rows
    (w6 Huber-weighted on the loop rows where robust_delta > 0), the
    gradient b (N, 6) and the inverted block-Jacobi blocks Pinv (N, 6,
    6)."""
    n_cap, l_cap = g.capacity, g.loop_i.shape[0]
    r, Ji, Jj, w6, valid = _factor_data(g, prior_var, odom_var)
    if robust_delta > 0:
        w6 = huber_loop_weights(r, w6, n_cap, l_cap, robust_delta)
    wr = r * w6 * valid[:, None]
    b = scatter(torch.einsum("fba,fb->fa", Ji, wr),
                torch.einsum("fba,fb->fa", Jj, wr))
    wv = (w6 * valid[:, None])[:, :, None]
    P = scatter(torch.einsum("fba,fbc->fac", Ji, Ji * wv),
                torch.einsum("fba,fbc->fac", Jj, Jj * wv))
    eye6 = torch.eye(6, dtype=P.dtype, device=P.device)
    with profiling.sync("pgo_inv"):   # inv reads its error flags
        Pinv = torch.linalg.inv(P + 1e-6 * eye6)
    return _System(scatter, Ji, Jj, w6, valid, active), b, Pinv


def pcg_start(b, Pinv, active):
    """PCG's state at x = 0 for H x = -b: the carry (x, r, p, r.z, live)
    and the stopping threshold 1e-10 max(r0.r0, 1e-20)."""
    x = torch.zeros_like(b)
    rr = -b * active
    z = torch.einsum("nab,nb->na", Pinv, rr) * active
    rz = torch.sum(rr * z)
    thr = 1e-10 * torch.clamp(torch.sum(rr * rr), min=1e-20)
    live = torch.sum(rr * rr) > thr
    return (x, rr, z, rz, live), thr


def pcg_step(carry, thr, Pinv, hx, active):
    """One PCG iteration: the next carry (x, r, p, r.z, live).  Once
    ``live`` is false the carry stays as it is (the reference's
    ``while_loop`` stopping there)."""
    x, rr, p, rz, live = carry
    hp = hx(p)
    alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-20)
    rr_n = rr - alpha * hp
    z_n = torch.einsum("nab,nb->na", Pinv, rr_n) * active
    rz_n = torch.sum(rr_n * z_n)
    p_n = z_n + rz_n / torch.clamp(rz, min=1e-20) * p
    x = torch.where(live, x + alpha * p, x)
    rr = torch.where(live, rr_n, rr)
    p = torch.where(live, p_n, p)
    rz = torch.where(live, rz_n, rz)
    live = live & (torch.sum(rr * rr) > thr)
    return x, rr, p, rz, live


def pcg(b, Pinv, hx, active, pcg_iters: int) -> torch.Tensor:
    """Block-Jacobi preconditioned CG for H x = -b from x = 0 (N, 6),
    shared by ``optimize`` and the factor-sharded solve: ``Pinv`` (N, 6, 6)
    the inverted diagonal blocks, ``hx(v)`` H v on the active rows.  Stops
    once sum(r*r) <= 1e-10 max(r0.r0, 1e-20) or after ``pcg_iters``; the
    host reads the live flag every ``PCG_CHECK`` iterations (the span
    ``sync.pcg``), and the iterations run go to the open profiler's
    ``pcg_iters``.

    Where ``hx`` is ``optimize``'s ``_System``, each whole ``PCG_CHECK``
    iterations between two reads run as one ``_pcg_block`` through the
    module's runner, loaded with the system once; the rest run here."""
    carry, thr = pcg_start(b, Pinv, active)
    block = None
    if isinstance(hx, _System) and pcg_iters >= PCG_CHECK:
        block = _PCG_GRAPHS.load(_pcg_block, carry, thr, Pinv, hx)
        carry = block.inputs[0][0]      # what each block writes in place
    n = 0
    while n < pcg_iters:
        if block is not None and n + PCG_CHECK <= pcg_iters:
            block()
            n += PCG_CHECK
        else:
            carry = pcg_step(carry, thr, Pinv, hx, active)
            n += 1
        if n % PCG_CHECK == 0:
            with profiling.sync("pcg"):
                done = not bool(carry[4])
            if done:
                break
    profiling.add("pcg_iters", n)
    return carry[0].clone() if block is not None else carry[0]


def _pcg_block(carry, thr, Pinv, system: _System) -> None:
    """``PCG_CHECK`` iterations of ``pcg_step`` on ``optimize``'s system,
    written into ``carry`` in place."""
    out = carry
    for _ in range(PCG_CHECK):
        out = pcg_step(out, thr, Pinv, system, system.active)
    for dst, src in zip(carry, out):
        dst.copy_(src)
