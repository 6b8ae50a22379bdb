"""The point map's plane searches in the LIO's tracer, on the CPU: one span
``assoc`` a search (``max_iteration`` + 1 a scan after the first, with
the extrinsic fixed or co-estimated, none on the surfel map), its counter
``assoc_rows`` (padded rows x the 108 slots a row gathers), no host read
and no changed bit with the tracer on; and the benchmark's copy of the
search's least time
(``slam_bench/roofline_point.py``) held to the port's
``tools/roofline.py``."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fast_lio_sam_qn_tpu_torch.configs.presets import get_pipeline_config
from fast_lio_sam_qn_tpu_torch.models.lio import LIO
from fast_lio_sam_qn_tpu_torch.run import initial_state, sim_scan_inputs
from fast_lio_sam_qn_tpu_torch.tools import lio_scenarios, roofline
from fast_lio_sam_qn_tpu_torch.utils import profiling
from slam_bench import roofline_point

torch.set_num_threads(1)

SCANS = 3
SLOTS = 27 * 4           # the 3^3 window's voxels, 4 probe slots each


class _Reads(TorchDispatchMode):
    """Counts the operations that copy a tensor's value to the host."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _run(backend: str, traced: bool, rows: int = 2048, ext: bool = False):
    """SCANS scans of the sim stream, the inputs as tensors, the extrinsic
    co-estimated with ``ext``: (records or None, the last state, the host
    reads a scan)."""
    cfg = get_pipeline_config("sim").lio
    cfg = dataclasses.replace(cfg, map_backend=backend,
                              max_points_per_scan=rows,
                              map_table_size=1 << 15, extrinsic_est_en=ext)
    prof = profiling.Profiler("cpu") if traced else None
    world, traj = lio_scenarios.golden_world()
    lio = LIO(cfg, imu_cap=64, device="cpu", profiler=prof)
    state = initial_state(lio, traj)
    reads = []
    for i in range(SCANS):
        inputs = [torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                  for x in sim_scan_inputs(world, traj, i, 0.2, 4 * rows)]
        with _Reads() as count:
            state, _ = lio.process_scan(state, *inputs)
        reads.append(count.n)
    return (prof.records() if prof else None), state, reads


@pytest.fixture(scope="module")
def runs():
    return {(b, t): _run(b, t) for b in ("point", "surfel")
            for t in (True, False)}


@pytest.mark.parametrize("backend", ["point", "surfel", "point_ext"])
def test_one_assoc_span_a_search(runs, backend):
    recs = runs[backend, True][0] if backend != "point_ext" else \
        _run("point", True, ext=True)[0]
    per_scan = [sum(1 for r in recs if r.name == "assoc" and r.scan == s)
                for s in range(SCANS)]
    want = 0 if backend == "surfel" else \
        get_pipeline_config("sim").lio.max_iteration + 1
    assert per_scan == [0] + [want] * (SCANS - 1)
    for r in recs:
        if r.name == "assoc":
            assert recs[r.parent].name == "update"
            assert r.syncs == 0


@pytest.mark.parametrize("rows", [1024, 2048])
def test_assoc_rows_counts_the_gathered_slots(runs, rows):
    recs = runs["point", True][0] if rows == 2048 else \
        _run("point", True, rows)[0]
    assoc = [r for r in recs if r.name == "assoc"]
    assert assoc and all(r.assoc_rows == rows * SLOTS for r in assoc)
    for name in ("update", "scan"):
        assert [r.assoc_rows for r in recs if r.name == name] == \
            [0] + [4 * rows * SLOTS] * (SCANS - 1)
    assert "assoc_rows" in profiling.COUNTERS


@pytest.mark.parametrize("backend", ["point", "surfel"])
def test_the_tracer_changes_no_bit_and_makes_no_read(runs, backend):
    recs, on, reads_on = runs[backend, True]
    _, off, reads_off = runs[backend, False]
    assert reads_on == reads_off
    assert not any(r.name.startswith(profiling.SYNC) for r in recs)
    assert all(r.syncs == 0 for r in recs if r.name == "scan")
    for a, b in zip(torch.utils._pytree.tree_leaves(on),
                    torch.utils._pytree.tree_leaves(off)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("n,t", [(4096, 1 << 14), (32768, 1 << 19),
                                 (32768, 1 << 21)])
def test_the_benchmarks_copy_is_the_original(n, t):
    assert roofline_point.plane_assoc_budget(n, t) == \
        roofline.plane_assoc_budget(n, t)
    assert (roofline_point.FP32_FLOPS, roofline_point.HBM_BYTES_S,
            roofline_point.EIGH3_FLOPS) == (roofline.FP32_FLOPS,
                                            roofline.HBM_BYTES_S,
                                            roofline.EIGH3_FLOPS)
    b = roofline.plane_assoc_budget(n, t)
    assert b["bound_ms"] > 0 and b["bound_by"] in ("bytes", "operations")
