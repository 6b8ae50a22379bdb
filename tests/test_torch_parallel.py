"""The port's device mesh (fast_lio_sam_qn_tpu_torch/parallel/) held against
the port's single-device paths and against the JAX package's ``spmd``
programs: tests/test_parallel.py's cases on gloo ranks on the CPU.

The ranks are spawned processes (``mesh.run_ranks``: one thread each, a
``file://`` rendezvous under the test's tmp directory, a 120 s limit on the
whole run) that import no JAX: their side is ``torch_mesh_ranks.py``.
Every rank runs every program once at world sizes 2 and 3 (the full
PGO's 41 factor rows take a pad row at both); the pipeline scenario of
__graft_entry__.py:240-290 runs at world size 2.  The JAX references
run here, on conftest's 8 virtual CPU devices.  Inputs come from numpy
with a seed.

Tolerances: the sharded GICP within 1e-4 of the port's single-device
Gauss-Newton and of JAX's sharded one (the same normal equations, summed
in another order), and < 0.02 from the truth; the batched GICP's lanes
equal the unsharded batch's bit for bit (lanes are independent); the
loop-closure batch as tests/test_parallel.py:155-161 (decisions equal,
score rtol 1e-4 / atol 1e-5, pose 1e-3); the full PGO within 1e-4 of
``pgo.optimize`` and of JAX's ``pgo_optimize_full``; the pipeline's events
equal the unsharded run's, its trajectory within 0.02 m, every rank's
outputs identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from fast_lio_sam_qn_tpu.ops import pgo as jpgo
from fast_lio_sam_qn_tpu.parallel import mesh as jmesh
from fast_lio_sam_qn_tpu.parallel import spmd as jspmd
from fast_lio_sam_qn_tpu_torch import kernels
from fast_lio_sam_qn_tpu_torch.models.loop_closure import LoopClosure
from fast_lio_sam_qn_tpu_torch.ops import gicp, knn_cuda, pgo, se3
from fast_lio_sam_qn_tpu_torch.parallel import mesh as meshlib
from fast_lio_sam_qn_tpu_torch.parallel import spmd
from fast_lio_sam_qn_tpu_torch.utils import sim
from fast_lio_sam_qn_tpu_torch.utils.config import LoopClosureConfig

torch.set_num_threads(1)

VAR = ranks.VAR
N_GICP = 1536      # divides over 2, 3 and JAX's 8 devices
LANES = 6          # divides over 2 and 3
QIDX, CIDX = [5, 6, 7, 8, 9, 5], [0, 1, 2, 3, -1, 0]


def _exp(xi):
    return se3.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()


def _gicp_inputs():
    world = sim.World.room(size=16.0, height=4.0, n_boxes=5, seed=1)
    src = world.sample_points(N_GICP, seed=1, noise=0.005).astype(np.float32)
    mask = np.ones(N_GICP, bool)
    T_true = _exp([0.0, 0.0, 0.1, 0.5, -0.3, 0.05])
    dst = (src @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    covs = [gicp.plane_covariances(torch.from_numpy(p), torch.from_numpy(mask),
                                   backend="brute") for p in (src, dst)]
    (sc, sok), (dc, dok) = ((c.numpy(), ok.numpy()) for c, ok in covs)
    return (src, mask & sok, sc, dst, mask & dok, dc), T_true


def _batched_inputs():
    srcs, masks, dsts = [], [], []
    for i in range(LANES):
        world = sim.World.room(size=16.0, height=4.0, n_boxes=5, seed=10 + i)
        src = world.sample_points(512, seed=10 + i, noise=0.005)
        T = _exp([0.0, 0.0, 0.05 * (i % 3), 0.3, 0.1 * i % 2, 0.0])
        srcs.append(src.astype(np.float32))
        dsts.append((src @ T[:3, :3].T + T[:3, 3]).astype(np.float32))
        masks.append(np.ones(512, bool))
    return (np.stack(srcs), np.stack(masks), np.stack(dsts), np.stack(masks),
            np.tile(np.eye(4, dtype=np.float32), (LANES, 1, 1)))


def _chain_graph(seed, rise):
    """tests/test_parallel.py:54-83 / :171-197's graph: 16 nodes 1 m apart
    (climbing ``rise`` rad a step), odometry with 0.01 noise, one
    ground-truth loop 15 -> 0 of variance 1e-3; capacities 32 / 8.
    Returns (the graph's fields as numpy, the loop measurement)."""
    n = 16
    g = pgo.empty_graph(32, 8, "cpu")
    rng = np.random.default_rng(seed)
    gt = [np.eye(4)]
    for _ in range(1, n):
        gt.append(gt[-1] @ _exp([0.0, 0.0, rise, 1.0, 0.0, 0.0]))
    g = pgo.add_first_node(g, gt[0])
    ests = [gt[0]]
    for i in range(1, n):
        rel = np.linalg.inv(gt[i - 1]) @ gt[i]
        ests.append(ests[-1] @ rel @ _exp(rng.normal(0, 0.01, 6)))
        g = pgo.add_odom_node(g, torch.tensor(ests[i - 1], dtype=torch.float32),
                              torch.tensor(ests[i], dtype=torch.float32))
    meas = (np.linalg.inv(gt[n - 1]) @ gt[0]).astype(np.float32)
    g = pgo.add_loop_factor(g, n - 1, 0, meas, 1e-3)
    return tuple(f.numpy() for f in g), meas


@pytest.fixture(scope="module")
def inputs():
    gicp_in, T_true = _gicp_inputs()
    return dict(gicp=gicp_in, T_true=T_true, batched_gicp=_batched_inputs(),
                pgo_step=_chain_graph(0, 0.0)[0],
                pgo_loop=_chain_graph(0, 0.0)[1],
                pgo_full=_chain_graph(1, 0.05)[0],
                loop_batch=(QIDX, CIDX))


@pytest.fixture(scope="module")
def mesh_runs(inputs, tmp_path_factory):
    """world size -> every rank's outputs (one spawn of the ranks each)."""
    runs = {}
    rank_inputs = {k: v for k, v in inputs.items()
                   if k not in ("T_true", "pgo_loop")}

    def get(world):
        if world not in runs:
            runs[world] = meshlib.run_ranks(
                ranks.run_cases, ["cpu"] * world, backend="gloo",
                workdir=str(tmp_path_factory.mktemp(f"mesh{world}")),
                args=(rank_inputs,), timeout_s=120.0, threads=1)
        return runs[world]
    return get


def _same_on_every_rank(outs, key):
    first = outs[0][key]
    for o in outs[1:]:
        np.testing.assert_equal(o[key], first)
    return first


def _max_gap(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows_shape", [(6,), (6, 6)])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_shard_rows_and_row_scatter_sum_every_slice(world, rows_shape):
    """Each rank's block of the rows summed by ``RowScatter`` and the blocks
    added in rank order equal a float64 sum by index; index -1 drops its
    row; a length the world size does not divide raises."""
    rng = np.random.default_rng(world)
    n_cap, f = 16, 42
    idx = rng.integers(-1, n_cap, f)
    rows = rng.normal(0, 1, (f,) + rows_shape).astype(np.float32)
    want = np.zeros((n_cap,) + rows_shape)
    keep = idx >= 0
    np.add.at(want, idx[keep], rows[keep].astype(np.float64))
    got = 0
    for rank in range(world):
        m = meshlib.Mesh(size=world, rank=rank, device=torch.device("cpu"),
                         backend="gloo")
        sl = m.shard_rows(f)
        assert sl.stop - sl.start == f // world
        sc = pgo.RowScatter(torch.tensor(idx[sl]), n_cap, torch.float32)
        got = got + sc(torch.tensor(rows[sl]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if world > 1:
        with pytest.raises(ValueError, match="does not divide"):
            m.shard_rows(f + 1)


def test_make_mesh_refuses_a_world_of_another_size(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="need 2 ranks"):
        meshlib.make_mesh(2, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="backend"):
        meshlib.make_mesh(2, device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        meshlib.make_mesh(2, device="cpu", backend="nccl")


def test_factor_indices_match_jax(inputs):
    """The port's row indices are the JAX layout's, but for the prior's i
    side: -1 (dropped) where JAX writes 0 under a zero Jacobian."""
    fields = inputs["pgo_full"]
    jg = jpgo.GraphState(*map(jnp.asarray, fields))
    want_i, want_j = map(np.asarray, jpgo._factor_data(
        jg, jnp.asarray(VAR), jnp.asarray(VAR))[:2])
    got_i, got_j = pgo.factor_indices(pgo.GraphState(*map(torch.tensor,
                                                          fields)))
    np.testing.assert_array_equal(got_j.numpy(), want_j)
    np.testing.assert_array_equal(got_i.numpy()[:-1], want_i[:-1])
    assert int(got_i[-1]) == -1 and int(want_i[-1]) == 0


# ---------------------------------------------------------------------------
# the sharded programs on 2 and 3 gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3])
def test_sharded_gicp_matches_single_device_and_jax(world, inputs,
                                                    mesh_runs):
    outs = mesh_runs(world)
    T_sh, iters = _same_on_every_rank(outs, "gicp")
    T_true = inputs["T_true"]
    err = se3.se3_log(torch.tensor(np.linalg.inv(T_sh) @ T_true,
                                   dtype=torch.float32))
    assert float(torch.linalg.norm(err)) < 0.02, err
    src, smask, scov, dst, dmask, dcov = map(torch.tensor, inputs["gicp"])
    st = gicp._gicp_iterate(
        src[None], smask[None], scov[None], dst[None], dmask[None],
        dcov[None], torch.eye(4)[None], 52.5, 0.01, 32,
        lambda *a: kernels.per_lane(knn_cuda.nn, *a))
    single = st.T[0].numpy()
    jax_T, jax_it = jspmd.sharded_gicp_align(
        jmesh.make_mesh(8), *map(jnp.asarray, inputs["gicp"]), jnp.eye(4))
    gaps = (_max_gap(T_sh, single), _max_gap(T_sh, jax_T))
    print(f"world {world}: {iters} iterations (single {int(st.it[0])}, "
          f"JAX {int(jax_it)}); largest gap to single {gaps[0]:.3e}, to "
          f"JAX {gaps[1]:.3e}")
    assert max(gaps) < 1e-4


@pytest.mark.parametrize("world", [2, 3])
def test_batched_gicp_lanes_equal_the_unsharded_batch(world, inputs,
                                                      mesh_runs):
    T, fit, conv = _same_on_every_rank(mesh_runs(world), "batched_gicp")
    assert T.shape == (LANES, 4, 4)
    assert conv.all() and fit.max() < 0.05, fit
    want = spmd.align_lanes(*map(torch.tensor, inputs["batched_gicp"]))
    for got, w in zip((T, fit, conv), want):
        np.testing.assert_array_equal(got, w.numpy())


@pytest.mark.parametrize("world", [2, 3])
def test_pgo_sharded_step_reduces_the_residual(world, inputs, mesh_runs):
    """tests/test_parallel.py:54-120: the sharded linear solve's step drops
    the weighted residual of the drifted chain below a fifth, and equals
    one Gauss-Newton step of ``pgo.optimize`` without the Huber weights."""
    dx = torch.tensor(_same_on_every_rank(mesh_runs(world), "pgo_step"))
    g = pgo.GraphState(*map(torch.tensor, inputs["pgo_step"]))
    n = int(g.num_nodes)
    new = se3.compose(g.poses, se3.se3_exp(dx)).double().numpy()
    meas = inputs["pgo_loop"].astype(np.float64)

    def residual(poses):
        w = np.array([1e4] * 3 + [1e2] * 3)
        tot = 0.0
        for i in range(1, n):
            e = se3.se3_log(torch.tensor(
                np.linalg.inv(g.odom_meas[i].double().numpy())
                @ np.linalg.inv(poses[i - 1]) @ poses[i], dtype=torch.float32))
            tot += float(torch.sum(e * e * torch.tensor(w)))
        e = se3.se3_log(torch.tensor(np.linalg.inv(meas) @ np.linalg.inv(
            poses[n - 1]) @ poses[0], dtype=torch.float32))
        return tot + float(torch.sum(e * e)) * 1e3

    before = residual(g.poses.double().numpy())
    after = residual(new)
    assert after < 0.2 * before, (before, after)
    one = pgo.optimize(g, VAR, VAR, gn_iters=1, robust_delta=0.0)
    active = (torch.arange(g.capacity) < n)[:, None]
    mine = pgo.gn_retract(g, dx, active)
    assert _max_gap(mine.poses[:n], one.poses[:n]) < 1e-4


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_loop_closure_batch_matches_unsharded(world, mesh_runs):
    """tests/test_parallel.py:123-161 on the port's stream-FPFH loop
    closure at 1,024-point keyframes."""
    shd = _same_on_every_rank(mesh_runs(world), "loop_batch")
    lc = LoopClosure(LoopClosureConfig(), src_cap=1024, dst_cap=1024)
    ref = lc.perform_loop_closure_batch(ranks.loop_store(), QIDX, CIDX)
    np.testing.assert_array_equal(shd["is_valid"], ref.is_valid.numpy())
    np.testing.assert_array_equal(shd["closest_idx"],
                                  ref.closest_idx.numpy())
    np.testing.assert_allclose(shd["score"], ref.score.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(shd["pose_between"], ref.pose_between.numpy(),
                               atol=1e-3)
    assert int(shd["closest_idx"][4]) == -1
    assert shd["is_valid"][:4].any()


@pytest.mark.parametrize("robust", [1.0, 0.0])
@pytest.mark.parametrize("world", [2, 3])
def test_pgo_optimize_full_matches_single_device_and_jax(world, robust,
                                                         inputs, mesh_runs):
    got = _same_on_every_rank(mesh_runs(world), "pgo_full")[robust]
    fields = inputs["pgo_full"]
    n = int(fields[1])
    single = pgo.optimize(pgo.GraphState(*map(torch.tensor, fields)), VAR,
                          VAR, gn_iters=3, pcg_iters=64, robust_delta=robust)
    jax_g = jspmd.pgo_optimize_full(
        jmesh.make_mesh(8), jpgo.GraphState(*map(jnp.asarray, fields)),
        jnp.asarray(VAR), jnp.asarray(VAR), gn_iters=3, pcg_iters=64,
        robust_delta=robust)
    moved = _max_gap(got[:n], fields[0][:n])
    gaps = (_max_gap(got[:n], single.poses[:n]),
            _max_gap(got[:n], np.asarray(jax_g.poses)[:n]))
    print(f"world {world}, robust {robust}: poses moved {moved:.3e}; gap "
          f"to pgo.optimize {gaps[0]:.3e}, to JAX {gaps[1]:.3e}")
    assert moved > 1e-3 and max(gaps) < 1e-4


def test_pipeline_over_two_ranks_matches_one_process(mesh_runs):
    """__graft_entry__.py:240-290 on the port: the pipeline with a 2-rank
    mesh (the batch sharded, the sharded solve from 4 factors) against the
    same run without a mesh."""
    outs = mesh_runs(2)
    traj, events, (sharded, single, loops_max) = _same_on_every_rank(
        outs, "pipeline")
    want_traj, want_events, _ = ranks.drive_pipeline(None)
    assert sharded > 0 and loops_max > 0, (sharded, single, loops_max)
    assert events == want_events
    assert sum(acc for _, _, acc in events) >= 4, events
    assert traj.shape == want_traj.shape
    gap = _max_gap(traj, want_traj)
    print(f"pipeline: {len(events)} events, {sharded} sharded / {single} "
          f"single solves, trajectory gap {gap:.3e} m, "
          f"{outs[0]['collectives']} collectives a rank")
    assert gap < 0.02
