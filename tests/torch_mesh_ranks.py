"""The rank side of tests/test_torch_parallel.py: each function runs on
every gloo rank (``parallel.mesh.run_ranks``) with the test's numpy inputs
and returns its outputs as numpy.  This module imports no JAX, as the
ranks must not."""
import numpy as np
import torch

from fast_lio_sam_qn_tpu_torch import convert
from fast_lio_sam_qn_tpu_torch.models import keyframes as kf
from fast_lio_sam_qn_tpu_torch.models.loop_closure import LoopClosure
from fast_lio_sam_qn_tpu_torch.models.pipeline import FastLioSamQnPipeline
from fast_lio_sam_qn_tpu_torch.ops import pgo
from fast_lio_sam_qn_tpu_torch.parallel import spmd
from fast_lio_sam_qn_tpu_torch.utils import sim
from fast_lio_sam_qn_tpu_torch.utils.config import (Capacities,
                                                     LoopClosureConfig,
                                                     PipelineConfig)

VAR = (1e-4, 1e-4, 1e-4, 1e-2, 1e-2, 1e-2)


def _t(*arrays):
    return convert.tensors_from_numpy(*arrays, device="cpu")


def loop_store(points=1024):
    """tests/test_parallel.py:127-150's store: 10 keyframes of a 20 m room,
    1.5 m apart, indices 5-9 revisiting 0-4, 40 s apart."""
    world = sim.World.room(size=20.0, height=5.0, n_boxes=8, seed=4)
    store = kf.empty_store(16, points, "cpu")
    for i in range(10):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 1.5 * (i % 5)
        scan, _ = sim.simulate_scan(world, T, n_points=points, noise=0.01,
                                    seed=100 + (i % 5))
        cloud, mask = sim.pad_cloud(scan, points)
        store = kf.append(store, *_t(cloud, mask, T, T), i * 40.0)
    return store


def pipeline_config(loop_batch):
    """__graft_entry__.py:240-250's pipeline: tiny capacities, the GICP-only
    loop path, the sharded solve from 4 factors."""
    cfg = PipelineConfig()
    cfg.caps = Capacities(max_keyframes=32, max_loop_factors=8,
                          keyframe_points=256, src_points=256,
                          dst_points=512)
    cfg.keyframe_threshold = 1.0
    cfg.loop.loop_batch = loop_batch
    cfg.loop.enable_quatro = False
    cfg.pgo_shard_min_factors = 4
    return cfg


def drive_pipeline(mesh=None, loop_batch=2):
    """__graft_entry__.py:252-270's run: 12 scans, 6-11 revisiting 0-5,
    40 s apart.  Returns (corrected trajectory, loop events, the solve
    counters)."""
    world = sim.World.room(size=16.0, height=4.0, n_boxes=4, seed=0)
    pipe = FastLioSamQnPipeline(pipeline_config(loop_batch), device="cpu",
                                mesh=mesh)
    for i in range(12):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 1.5 * (i % 6)
        scan, _ = sim.simulate_scan(world, T, n_points=256, noise=0.01,
                                    seed=300 + i)
        cloud, mask = sim.pad_cloud(scan, 256)
        pipe.feed(T, cloud, mask, float(i * 40.0))
    _, corrected = pipe.get_trajectories()
    events = [(e.query_idx, e.closest_idx, e.accepted)
              for e in pipe.loop_events]
    return corrected, events, (pipe.pgo_sharded_solves,
                               pipe.pgo_single_solves,
                               pipe.pgo_sharded_loop_factors_max)


def run_cases(mesh, inputs):
    """Every sharded program on this rank, on the test's inputs."""
    out = {}
    g = inputs["gicp"]
    T, it = spmd.sharded_gicp_align(mesh, *_t(*g), torch.eye(4))
    out["gicp"] = (T.numpy(), it)

    out["batched_gicp"] = tuple(o.numpy() for o in spmd.batched_gicp_align(
        mesh, *_t(*inputs["batched_gicp"])))

    graph = convert.graph_state_from_numpy(*inputs["pgo_step"],
                                           device="cpu")
    prior, odom = _t(np.float32(VAR), np.float32(VAR))
    r, Ji, Jj, w6, valid = pgo._factor_data(graph, prior, odom)
    ii, jj = pgo.factor_indices(graph)
    pad = (-r.shape[0]) % mesh.size

    def padz(a, fill=0):
        return torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                        dtype=a.dtype)])

    active = (torch.arange(graph.capacity) < graph.num_nodes)[:, None]
    dx = spmd.pgo_optimize_sharded(
        mesh, graph.poses, padz(ii, -1), padz(jj, -1), padz(r), padz(Ji),
        padz(Jj), padz(w6), padz(valid, False), active.float())
    out["pgo_step"] = dx.numpy()

    graph = convert.graph_state_from_numpy(*inputs["pgo_full"],
                                           device="cpu")
    out["pgo_full"] = {robust: spmd.pgo_optimize_full(
        mesh, graph, VAR, VAR, gn_iters=3, pcg_iters=64,
        robust_delta=robust).poses.numpy() for robust in (1.0, 0.0)}

    lc = LoopClosure(LoopClosureConfig(), src_cap=1024, dst_cap=1024)
    reg = lc.perform_loop_closure_batch(loop_store(), *inputs["loop_batch"],
                                        mesh=mesh)
    out["loop_batch"] = {k: v.numpy() for k, v in reg._asdict().items()}

    if mesh.size == 2:
        out["pipeline"] = drive_pipeline(mesh)
    out["collectives"] = mesh.collectives
    return out
