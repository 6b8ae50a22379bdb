"""Quatro's coarse solve (``ops/quatro.py``) with no host read, replayed
through the port's CUDA-graph runner, on the CPU: the solve and its steps
dispatch no ``aten._local_scalar_dense`` (a read on the card) and make no
tensor from host data (a copy from the host on the card); GNC's
device flag gives the early stop's state and the greedy pass the sequential
pass's clique, bit for bit against copies of the loops that read the host
(kept here as oracles); with CPU tensors taken for the card's
(``torch_graph_stub.cpu_as_card``) the graphed solve equals the eager one,
returns tensors of its own, and counts its captures and replays on the
``reg.quatro`` span."""
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fast_lio_sam_qn_tpu_torch import kernels
from fast_lio_sam_qn_tpu_torch.models import keyframes
from fast_lio_sam_qn_tpu_torch.models.loop_closure import LoopClosure
from fast_lio_sam_qn_tpu_torch.ops import quatro, se3
from fast_lio_sam_qn_tpu_torch.utils import profiling
from fast_lio_sam_qn_tpu_torch.utils.config import LoopClosureConfig

import torch_graph_stub

card_graphs = torch_graph_stub.card_graphs

QC = LoopClosureConfig().quatro
KW = dict(noise_bound=QC.noise_bound, gnc_factor=QC.rot_gnc_factor,
          cost_diff_thr=QC.rot_cost_diff_thr, rot_max_iter=QC.rot_max_iter)
C = QC.max_num_corres
NB = QC.noise_bound


def _lane(seed, outliers=0.4, n_valid=C, noise=0.05, yaw=0.7):
    """One lane of C matches: a yawed, shifted copy of a 40 m cloud with
    ``noise`` m of jitter, the first ``outliers`` share of the rows
    replaced at random, rows from ``n_valid`` on invalid."""
    g = torch.Generator().manual_seed(seed)
    s = torch.rand(C, 3, generator=g) * 40.0 - 20.0
    cy, sy = math.cos(yaw), math.sin(yaw)
    R = torch.tensor([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    d = s @ R.T + torch.tensor([3.0, -2.0, 0.5]) + \
        noise * torch.randn(C, 3, generator=g)
    k = int(outliers * C)
    d[:k] = torch.rand(k, 3, generator=g) * 40.0 - 20.0
    valid = torch.arange(C) < n_valid
    return s, d, valid


LANES = {"0 % outliers": dict(outliers=0.0), "40 %": dict(outliers=0.4),
         "100 %": dict(outliers=1.0), "pad lane": dict(n_valid=0)}


def _batch(names, seed=3):
    lanes = [_lane(seed + i, **LANES[n]) for i, n in enumerate(names)]
    return tuple(torch.stack(x) for x in zip(*lanes))


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A float tensor's bit patterns (the sign of a zero included)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x


def _same(a, b) -> bool:
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


class _Reads(TorchDispatchMode):
    """Counts the aten operations dispatched, the host reads among them
    and the tensors made from host data (``aten.lift_fresh``: on the card
    a copy from the host, which a capture refuses)."""

    def __init__(self):
        super().__init__()
        self.ops = self.reads = self.from_host = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.reads += func is torch.ops.aten._local_scalar_dense.default
        self.from_host += func is torch.ops.aten.lift_fresh.default
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# the reads
# ---------------------------------------------------------------------------

def _steps():
    s, d, valid = _lane(1)
    inl = quatro.max_clique_inliers(s, d, valid, NB)
    yaw = torch.tensor(0.7)
    gnc = (QC.rot_gnc_factor, QC.rot_cost_diff_thr)
    return {
        "solve": lambda: quatro.solve(s, d, valid, **KW),
        "solve with scale": lambda: quatro.solve(s, d, valid, **KW,
                                                 estimate_scale=True),
        "max_clique_inliers": lambda: quatro.max_clique_inliers(
            s, d, valid, NB),
        "max_clique_inliers over greedy_cap": lambda:
            quatro.max_clique_inliers(s, d, valid, NB, greedy_cap=64),
        "gnc_rotation_yaw": lambda: quatro.gnc_rotation_yaw(
            s, d, inl, NB, *gnc),
        "translation_voting": lambda: quatro.translation_voting(
            s, d, inl, yaw, NB),
        "estimate_scale_tims": lambda: quatro.estimate_scale_tims(
            s, d, valid, NB),
        "se3.make_pose": lambda: se3.make_pose(torch.eye(3), torch.ones(3)),
    }


@pytest.mark.parametrize("step", sorted(_steps()))
def test_no_host_read(step):
    """The solve and each of its steps dispatch no
    ``aten._local_scalar_dense`` (on the card a copy to the host and a
    wait: the greedy pass alone made 600 a solve when it indexed by 0-d
    tensors) and make no tensor from host data (a copy from the host,
    which a CUDA graph's capture refuses)."""
    fn = _steps()[step]
    with _Reads() as seen:
        fn()
    assert seen.ops > 0
    assert (seen.reads, seen.from_host) == (0, 0)


# ---------------------------------------------------------------------------
# the oracles: the loops that read the host, as they were
# ---------------------------------------------------------------------------

def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _gnc_early_exit(s_pts, d_pts, inliers, noise_bound, gnc_factor,
                    cost_diff_thr, max_iter=50):
    """GNC-TLS yaw that stops on a host read of its rule; returns (yaw,
    weights, converged, iterations run)."""
    v, w, m = quatro._ring_tims(s_pts, d_pts, inliers, (1, 2))
    v, w = v[:, :2], w[:, :2]
    m = m & (torch.linalg.norm(v, dim=-1) > 1e-3)
    nb = _f32(noise_bound, s_pts)
    gnc_factor = _f32(gnc_factor, s_pts)
    cost_diff_thr = _f32(cost_diff_thr, s_pts)
    cbar2 = (2.0 * nb) ** 2

    def yaw_solve(wt):
        a = torch.sum(wt * (v[:, 0] * w[:, 0] + v[:, 1] * w[:, 1]))
        b = torch.sum(wt * (v[:, 0] * w[:, 1] - v[:, 1] * w[:, 0]))
        return torch.atan2(b, a)

    def residual2(yaw):
        cy, sy = torch.cos(yaw), torch.sin(yaw)
        rx = cy * v[:, 0] - sy * v[:, 1] - w[:, 0]
        ry = sy * v[:, 0] + cy * v[:, 1] - w[:, 1]
        return rx * rx + ry * ry

    mf = m.to(torch.float32)
    wt = mf
    yaw = yaw_solve(wt)
    r2_max = torch.max(torch.where(m, residual2(yaw), 0.0))
    mu = torch.clamp(cbar2 / torch.clamp(2.0 * r2_max - cbar2, min=1e-9),
                     min=1e-6)
    cost_prev = _f32(torch.inf, s_pts)
    n = 0
    for _ in range(max_iter):
        n += 1
        r2 = residual2(yaw)
        ub = (mu + 1.0) / mu * cbar2
        lb = mu / (mu + 1.0) * cbar2
        wt = torch.where(
            r2 >= ub, 0.0,
            torch.where(r2 <= lb, 1.0,
                        torch.sqrt(cbar2 * mu * (mu + 1.0)
                                   / torch.clamp(r2, min=1e-12)) - mu))
        wt = torch.clamp(wt, 0.0, 1.0) * mf
        yaw = yaw_solve(wt)
        cost = torch.sum(wt * torch.minimum(residual2(yaw), cbar2))
        done = bool(torch.abs(cost - cost_prev) < cost_diff_thr)
        mu = mu * gnc_factor
        cost_prev = cost
        if done:
            break
    converged = torch.sum(wt > 0.5) >= 3
    return yaw, wt, converged, n


def _greedy_host_indexed(x, A, valid, greedy_cap):
    """The greedy clique pass as it was: indexed by 0-d tensors (three
    host reads a vertex) over all vertices, or by host ints over the top
    ``greedy_cap`` in a compacted index space."""
    c = x.shape[0]
    if c <= greedy_cap:
        order = torch.sort(-x, stable=True).indices
        A_bool = A > 0.5
        kept = torch.zeros(c, dtype=torch.bool)
        for i in range(c):
            v = order[i]
            kept[v] = valid[v] & torch.all(torch.where(kept, A_bool[v],
                                                       True))
        return kept
    topi = torch.sort(x, descending=True, stable=True).indices[:greedy_cap]
    A_sub = A[topi][:, topi] > 0.5
    valid_k = valid[topi]
    kept_k = torch.zeros(greedy_cap, dtype=torch.bool)
    for i in range(greedy_cap):
        kept_k[i] = valid_k[i] & torch.all(
            torch.where(kept_k, A_sub[i], True))
    out = torch.zeros(c, dtype=torch.bool)
    out[topi] = kept_k
    return out


# (lane, inliers: "clique" or the first k rows, cost_diff_thr, iterations
# the early stop runs); where it stops with its weights still moving, its
# state differs from the one all 50 iterations reach, so a state that
# moved after the stop would show
GNC_CASES = {
    "stops at iteration 1": (dict(outliers=0.4, noise=0.2), "clique", 1e3,
                             (2, 2)),
    "stops mid-way": (dict(outliers=0.4, noise=0.3), "clique", 1e-2,
                      (3, 49)),
    "never stops": (dict(outliers=0.4), "clique", 0.0, (50, 50)),
    "clique under 3": (dict(outliers=0.4), 2, QC.rot_cost_diff_thr,
                       (1, 50)),
}


@pytest.mark.parametrize("case", sorted(GNC_CASES))
def test_live_flag_gnc_equals_the_early_exit(case):
    """Every iteration runs and a device flag freezes the state once the
    rule holds: yaw, weights and converged equal the loop that stops on
    a host read, bit for bit, wherever it stops."""
    lane, inl, thr, (lo, hi) = GNC_CASES[case]
    s, d, valid = _lane(5, **lane)
    if inl == "clique":
        inl = quatro.max_clique_inliers(s, d, valid, NB)
    else:
        inl = torch.arange(C) < inl
    args = (s, d, inl, NB, QC.rot_gnc_factor, thr, QC.rot_max_iter)
    *want, n = _gnc_early_exit(*args)
    assert lo <= n <= hi, n
    got = quatro.gnc_rotation_yaw(*args)
    assert _same(got, want)
    if case.startswith("stops"):
        *run_on, _ = _gnc_early_exit(*args[:5], 0.0, QC.rot_max_iter)
        assert not _same(want[:2], run_on[:2])


@pytest.mark.parametrize("greedy_cap", [256, 64])
@pytest.mark.parametrize("lane", sorted(LANES))
def test_greedy_pass_equals_the_host_indexed_pass(lane, greedy_cap):
    """One walk over the first ``greedy_cap`` vertices, on rows gathered
    in visiting order, its flags written through one-element indices,
    keeps the clique of the pass that indexed by 0-d tensors (all of the
    C = 200 vertices) or walked the top ``greedy_cap`` in a compacted
    index space."""
    s, d, valid = _lane(11, **LANES[lane])
    got = quatro.max_clique_inliers(s, d, valid, NB, greedy_cap=greedy_cap)
    # the same replicator dynamics, then the pass as it was
    nb = torch.tensor(NB, dtype=torch.float32)
    ds = torch.linalg.norm(s[:, None, :] - s[None, :, :], dim=-1)
    dd = torch.linalg.norm(d[:, None, :] - d[None, :, :], dim=-1)
    A = ((torch.abs(ds - dd) <= 2.0 * nb) & valid[:, None] & valid[None, :]
         & ~torch.eye(C, dtype=torch.bool)).to(torch.float32)
    x = valid.to(torch.float32)
    x = x / torch.clamp(torch.sum(x), min=1.0)
    for _ in range(64):
        num = x * (A @ x)
        x = num / torch.clamp(torch.sum(num), min=1e-12)
    want = _greedy_host_indexed(x, A, valid, greedy_cap)
    assert torch.equal(got, want)
    assert int(got.sum()) >= (3 if lane in ("0 % outliers", "40 %") else 0)


# ---------------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", [
    ("40 %",), ("0 % outliers", "40 %", "100 %", "pad lane")])
def test_graphed_solve_equals_eager(lanes, monkeypatch):
    """Lane by lane through ``kernels.per_lane``, as the registration runs
    it: the solve through the runner's buffers, capture and replays equals
    the eager solve in all five outputs, bit for bit."""
    batch = _batch(lanes)
    eager = kernels.per_lane(lambda *a: quatro.solve(*a, **KW), *batch)
    torch_graph_stub.cpu_as_card(monkeypatch)
    graphed = kernels.per_lane(lambda *a: quatro.solve(*a, **KW), *batch)
    assert len(quatro._SOLVE_GRAPHS.graphs) == 1
    assert _same(graphed, eager)
    again = kernels.per_lane(lambda *a: quatro.solve(*a, **KW), *batch)
    assert _same(again, eager)
    assert eager.converged.tolist() == [n != "100 %" and n != "pad lane"
                                        for n in lanes]


def test_graphed_outputs_are_the_callers_own(card_graphs):
    """Two consecutive graphed solves return tensors that share no storage
    with each other or with the graph, and the first call's values stay
    as they were after the second (the benchmark's probe keeps them)."""
    a_in, b_in = _lane(1), _lane(2, outliers=0.1, yaw=-0.4)
    a = quatro.solve(*a_in, **KW)
    kept = [x.clone() for x in a]
    b = quatro.solve(*b_in, **KW)
    graph = next(iter(quatro._SOLVE_GRAPHS.graphs.values()))
    held = {x.untyped_storage().data_ptr() for x in graph.out}
    for x, y in zip(a, b):
        assert x.untyped_storage().data_ptr() != \
            y.untyped_storage().data_ptr()
        assert x.untyped_storage().data_ptr() not in held
    assert _same(a, kept)
    assert not torch.equal(a.transform, b.transform)
    assert _same(b, quatro._solve(*b_in, *KW.values(), False))


def _counts(prof, name):
    rec = [r for r in prof.records() if r.name == name][-1]
    return rec.graph_captures, rec.graph_replays


@pytest.mark.parametrize("stub", [True, False])
def test_reg_quatro_counts_captures_and_replays(stub, monkeypatch):
    """On the span ``reg.quatro`` a batch's lane-solves are its replays; a
    key's first load captures once, later ticks capture nothing.  Off the
    card (no stub) both counters stay 0."""
    if stub:
        torch_graph_stub.cpu_as_card(monkeypatch)
    batch = _batch(("0 % outliers", "40 %", "100 %", "pad lane"))
    prof = profiling.Profiler("cpu")
    for tick in ("first", "second"):
        with profiling.span(prof, "loop"), \
                profiling.span(prof, "reg.quatro"):
            kernels.per_lane(lambda *a: quatro.solve(*a, **KW), *batch)
        assert _counts(prof, "reg.quatro") == (
            (int(tick == "first"), 4) if stub else (0, 0))
    assert _counts(prof, "loop") == ((0, 4) if stub else (0, 0))


def test_warm_batch_captures_before_the_first_tick(card_graphs):
    """``LoopClosure.warm_batch`` (the pipeline's set-up at ``loop_batch``
    > 1) loads the solve's graph for the registration's matches, so that
    a tick's solves replay it and capture nothing."""
    cfg = LoopClosureConfig()
    lc = LoopClosure(cfg, 512, 1024)
    store = keyframes.empty_store(2, 64, "cpu")
    prof = profiling.Profiler("cpu")
    with profiling.span(prof, "setup"):
        lc.warm_batch(store, 4)
    assert _counts(prof, "setup") == (1, 0)
    assert len(quatro._SOLVE_GRAPHS.graphs) == 1
    with profiling.span(prof, "reg.quatro"):
        kernels.per_lane(lambda *a: quatro.solve(*a, **lc._solve_settings()),
                         *_batch(("40 %", "pad lane")))
    assert _counts(prof, "reg.quatro") == (0, 2)
