"""The port's pose graph (ops/pgo.py) held against the JAX package's on the
drifted multi-lap circle of tools/profile_pgo.py (``build_graph(128)``):
factor insertion, growth, linearization, Huber weights, the retraction and
whole solves, with and without the Huber loop weights, at 2 and 5
Gauss-Newton steps.  Also the port's own ``build_graph``
(tools/pgo_graph.py) against the JAX package's, and the numpy
conversions.

Tolerance for a solve: 1e-4 m / 1e-4 rad per pose (both solve the same
normal equations in fp32; the sums run in another order).

The PCG's blocks (``pgo._pcg_block`` through the CUDA-graph runner, one
replayed graph a block on the card) run here on the runner's buffers with
CPU tensors taken for the card's (``torch_graph_stub.cpu_as_card``),
block by block as the graph replays them: equal to the eager ``pgo.pcg``
bit for bit, with the same iteration count and host reads."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu.models import keyframes as jkf
from fast_lio_sam_qn_tpu.ops import pgo as jpgo
from fast_lio_sam_qn_tpu.tools.profile_pgo import build_graph
from fast_lio_sam_qn_tpu_torch import convert
from fast_lio_sam_qn_tpu_torch.ops import pgo, se3
from fast_lio_sam_qn_tpu_torch.tools import pgo_graph
from fast_lio_sam_qn_tpu_torch.utils import cuda_graph, profiling

import torch_graph_stub
from torch_graph_stub import cpu_as_card

card_graphs = torch_graph_stub.card_graphs

torch.set_num_threads(1)

VAR = (1e-4, 1e-4, 1e-4, 1e-2, 1e-2, 1e-2)


@pytest.fixture(scope="module")
def graphs():
    g, gt, n_loops = build_graph(128)
    return g, convert.graph_state_from_numpy(*map(np.asarray, g),
                                             device="cpu"), gt


def _pose_err(got, want):
    """Largest translation and rotation difference over poses (N, 4, 4)."""
    d = se3.se3_log(torch.linalg.inv(got.double())
                    @ torch.tensor(np.asarray(want), dtype=torch.float64))
    return (float(d[..., 3:].norm(dim=-1).max()),
            float(d[..., :3].norm(dim=-1).max()))


@pytest.mark.parametrize("robust_delta", [1.0, 0.0])
@pytest.mark.parametrize("gn_iters", [2, 5])
def test_optimize_matches_jax(graphs, robust_delta, gn_iters):
    jg, tg, gt = graphs
    want = jpgo.optimize(jg, jnp.asarray(VAR), jnp.asarray(VAR),
                         gn_iters=gn_iters, robust_delta=robust_delta)
    got = pgo.optimize(tg, VAR, VAR, gn_iters=gn_iters,
                       robust_delta=robust_delta)
    t_err, r_err = _pose_err(got.poses, want.poses)
    print(f"largest difference {t_err:.3e} m / {r_err:.3e} rad")
    assert t_err < 1e-4 and r_err < 1e-4
    # the solve moves the drifted circle toward the truth
    ate = np.sqrt(np.mean(np.sum((got.poses[:, :3, 3].numpy()
                                  - gt[:, :3, 3]) ** 2, -1)))
    ate0 = np.sqrt(np.mean(np.sum((tg.poses[:, :3, 3].numpy()
                                   - gt[:, :3, 3]) ** 2, -1)))
    assert ate < ate0
    # a repeat is bit-identical
    again = pgo.optimize(tg, VAR, VAR, gn_iters=gn_iters,
                         robust_delta=robust_delta)
    assert torch.equal(got.poses, again.poses)


def test_factor_data_huber_and_retract_match_jax(graphs):
    jg, tg, _ = graphs
    idx_i, idx_j, r, Ji, Jj, w6, valid = map(np.asarray, jpgo._factor_data(
        jg, jnp.asarray(VAR), jnp.asarray(VAR)))
    gr, gJi, gJj, gw6, gvalid = pgo._factor_data(
        tg, torch.tensor(VAR), torch.tensor(VAR))
    np.testing.assert_array_equal(gvalid.numpy(), valid)
    m = valid[:, None]
    np.testing.assert_allclose(gr.numpy() * m, r * m, atol=2e-5)
    np.testing.assert_allclose(gJi.numpy() * m[..., None],
                               Ji * m[..., None], atol=1e-4)
    np.testing.assert_allclose(gJj.numpy() * m[..., None],
                               Jj * m[..., None], atol=1e-4)
    np.testing.assert_allclose(gw6.numpy(), w6, rtol=1e-6)
    # the layout's node indices, as _Scatter and gather read them
    sc = pgo._Scatter.of(tg)
    nodes = torch.arange(tg.capacity, dtype=torch.float32)[:, None]
    xi, xj = sc.gather(nodes)
    np.testing.assert_array_equal(xi[:, 0].numpy(), idx_i)
    np.testing.assert_array_equal(xj[:, 0].numpy(), idx_j)
    n_cap, l_cap = tg.capacity, tg.loop_i.shape[0]
    for delta in (1.0, 0.3):
        want = jpgo.huber_loop_weights(jnp.asarray(r), jnp.asarray(w6),
                                       n_cap, l_cap, delta)
        got = pgo.huber_loop_weights(torch.tensor(r), torch.tensor(w6),
                                     n_cap, l_cap, delta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    x = np.random.default_rng(0).normal(0, 0.01, (n_cap, 6)).astype(
        np.float32)
    active = np.arange(n_cap)[:, None] < 100
    want = jpgo.gn_retract(jg, jnp.asarray(x), jnp.asarray(active))
    got = pgo.gn_retract(tg, torch.tensor(x), torch.tensor(active))
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=2e-5)


def test_add_and_grow_match_jax():
    rng = np.random.default_rng(1)
    poses = [se3.se3_exp(torch.tensor(rng.normal(0, 0.5, 6),
                                      dtype=torch.float32)).numpy()
             for _ in range(4)]
    jg = jpgo.empty_graph(3, 1)
    tg = pgo.empty_graph(3, 1, "cpu")
    jg = jpgo.add_first_node(jg, jnp.asarray(poses[0]))
    tg = pgo.add_first_node(tg, poses[0])
    for a, b in zip(poses[:2], poses[1:3]):
        jg = jpgo.add_odom_node(jg, jnp.asarray(a), jnp.asarray(b))
        tg = pgo.add_odom_node(tg, torch.tensor(a), torch.tensor(b))
    jg = jpgo.grow(jg, max_nodes=6, max_loops=3)
    tg = pgo.grow(tg, max_nodes=6, max_loops=3)
    jg = jpgo.add_odom_node(jg, jnp.asarray(poses[2]), jnp.asarray(poses[3]))
    tg = pgo.add_odom_node(tg, torch.tensor(poses[2]), torch.tensor(poses[3]))
    for k in range(2):
        jg = jpgo.add_loop_factor(jg, jnp.int32(3), jnp.int32(k),
                                  jnp.asarray(poses[k]), jnp.float32(0.2))
        tg = pgo.add_loop_factor(tg, 3, k, poses[k], 0.2)
    for name, w, g in zip(jg._fields, jg, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   err_msg=name)
        assert g.dtype == convert.tensors_from_numpy(
            np.asarray(w), device="cpu")[0].dtype, name


def test_pgo_graph_matches_jax():
    """The port's ``build_graph`` draws the same noise: ground truth and loops
    equal, the dead-reckoned initial within float32 rounding."""
    jg, jgt, jn = build_graph(128)
    tg, tgt, tn = pgo_graph.build_graph(128, device="cpu")
    assert jn == tn
    np.testing.assert_array_equal(tgt, jgt)
    for name in ("num_nodes", "loop_i", "loop_j", "loop_var", "num_loops"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    for name in ("poses", "odom_meas", "loop_meas", "prior_pose"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)), atol=1e-4)
    padded, _, _ = pgo_graph.build_graph(128, device="cpu", capacity=256,
                                         loop_capacity=64)
    assert padded.poses.shape[0] == 256 and padded.loop_i.shape[0] == 64
    got = pgo.optimize(padded, VAR, VAR, gn_iters=2)
    want = pgo.optimize(tg, VAR, VAR, gn_iters=2)
    t_err, r_err = _pose_err(got.poses[:128], want.poses.numpy())
    assert t_err < 1e-4 and r_err < 1e-4


def test_numpy_round_trips():
    """graph_state_from_numpy and keyframe_store_from_numpy (intensities
    included) carry the JAX package's state across exactly."""
    jg, _, _ = build_graph(128)
    tg = convert.graph_state_from_numpy(*map(np.asarray, jg), device="cpu")
    for name, w, g in zip(jg._fields, jg, tg):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    rng = np.random.default_rng(2)
    js = jkf.empty_store(4, 16)
    js = jkf.append(js, jnp.asarray(rng.normal(size=(16, 3)), jnp.float32),
                    jnp.asarray(rng.random(16) > 0.5), jnp.eye(4),
                    jnp.eye(4), jnp.float32(1.5),
                    intensity=jnp.asarray(rng.random(16), jnp.float32))
    ts = convert.keyframe_store_from_numpy(*map(np.asarray, js),
                                           device="cpu")
    for name, w, g in zip(js._fields, js, ts):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert ts.intensities.abs().sum() > 0


def _linear_system(g, robust_delta=1.0):
    """``optimize``'s first Gauss-Newton step on graph g: (scatter, Ji, Jj,
    w6, valid, active, Pinv, b, hx)."""
    var = torch.tensor(VAR)
    active = (torch.arange(g.capacity) < g.num_nodes)[:, None]
    system, b, Pinv = pgo.linearize(g, pgo._Scatter.of(g), active, var, var,
                                    robust_delta)
    sc, Ji, Jj, w6, valid, _ = system

    def hx(v):      # a plain function: ``pgo.pcg`` runs it eagerly
        return system(v)
    return sc, Ji, Jj, w6, valid, active, Pinv, b, hx


def _traced_pcg(b, Pinv, hx, active, iters):
    """pgo.pcg under a span: (x, its record, the number of sync.pcg)."""
    p = profiling.Profiler()
    with p.span("opt"):
        x = pgo.pcg(b, Pinv, hx, active, iters)
    recs = p.records()
    return x, recs[0], sum(r.name == "sync.pcg" for r in recs)


@pytest.mark.parametrize("iters", [64, 13, 5, 0])
@pytest.mark.parametrize("nodes", [128, 6])
def test_pcg_blocks_equal_eager_pcg(graphs, card_graphs, nodes, iters):
    """The 128-node circle runs every iteration; its first 6 nodes alone
    (no loops) converge after 24, so a read stops the PCG early."""
    _, tg, _ = graphs
    g = tg._replace(num_nodes=torch.tensor(nodes, dtype=torch.int32),
                    num_loops=tg.num_loops * int(nodes == 128))
    sc, Ji, Jj, w6, valid, active, Pinv, b, hx = _linear_system(g)
    system = pgo._System(sc, Ji, Jj, w6, valid, active)
    want, rec_e, reads_e = _traced_pcg(b, Pinv, hx, active, iters)
    got, rec_b, reads_b = _traced_pcg(b, Pinv, system, active, iters)
    assert torch.equal(got, want)
    blocks = list(pgo._PCG_GRAPHS.graphs.values())
    assert len(blocks) == int(iters >= pgo.PCG_CHECK)
    assert got.data_ptr() not in {t.data_ptr() for g in blocks
                                  for t in g.leaves}
    assert rec_b.pcg_iters == rec_e.pcg_iters
    assert reads_b == reads_e == rec_e.pcg_iters // pgo.PCG_CHECK
    assert (rec_b.graph_captures, rec_b.graph_replays) == (
        len(blocks), reads_b if len(blocks) else 0)
    stops = {128: iters, 6: min(iters, 24)}[nodes]
    assert rec_e.pcg_iters == stops
    # the block loaded with the system again, as a later Gauss-Newton step
    # loads it, gives the same bits again
    again, rec_a, _ = _traced_pcg(b, Pinv, system, active, iters)
    assert torch.equal(again, want) and rec_a.graph_captures == 0


def test_pcg_block_cache_by_capacity(graphs, monkeypatch):
    """The PCG's runner keeps one block a set of capacities (loaded with
    the system at hand) and makes another for a grown graph; ``optimize``
    on the CPU makes none."""
    monkeypatch.setattr(pgo, "_PCG_GRAPHS", cuda_graph.Runner())
    _, tg, _ = graphs
    pgo.optimize(tg, VAR, VAR, gn_iters=1)
    assert pgo._PCG_GRAPHS.graphs == {}
    cpu_as_card(monkeypatch)

    def load(g):
        sc, Ji, Jj, w6, valid, active, Pinv, b, _ = _linear_system(g)
        carry, thr = pgo.pcg_start(b, Pinv, active)
        return pgo._PCG_GRAPHS.load(pgo._pcg_block, carry, thr, Pinv,
                                    pgo._System(sc, Ji, Jj, w6, valid,
                                                active))
    a = load(tg)
    moved = tg._replace(poses=pgo.optimize(tg, VAR, VAR, gn_iters=1).poses)
    second = _linear_system(moved)
    assert load(moved) is a
    (carry, thr, Pinv, system), _ = a.inputs
    assert torch.equal(system.Ji, second[1]) and torch.equal(Pinv, second[6])
    grown = pgo.grow(tg, max_nodes=2 * tg.capacity)
    b = load(grown)
    assert b is not a and len(pgo._PCG_GRAPHS.graphs) == 2
    assert b.inputs[0][2].shape[0] == 2 * tg.capacity
