"""The surfel insert as the LIO replays it, through the port's CUDA-graph
runner (``utils/cuda_graph.Runner``), on the CPU: with CPU tensors taken
for the card's (``torch_graph_stub.cpu_as_card``) the runner's buffers,
copies and replays give the same maps as ``surfel_map.insert`` bit for
bit, maps that own their storage, under a key derived from every setting,
shape and dtype, with K6's calls; the LIO on the CPU runs the insert
itself and counts no graph."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu_torch.configs.presets import get_pipeline_config
from fast_lio_sam_qn_tpu_torch.models import lio as lio_mod
from fast_lio_sam_qn_tpu_torch.models.lio import LIO
from fast_lio_sam_qn_tpu_torch.ops import linalg3, surfel_map
from fast_lio_sam_qn_tpu_torch.run import initial_state, sim_scan_inputs
from fast_lio_sam_qn_tpu_torch.tools import lio_scenarios as ls
from fast_lio_sam_qn_tpu_torch.utils import cuda_graph, profiling

import torch_graph_stub

card_graphs = torch_graph_stub.card_graphs

torch.set_num_threads(1)

TH = float(np.float32(0.12))
N_PTS, TABLE, SCANS = 1536, 1 << 13, 7


def _scans(seed=7):
    """SCANS scans of a wavy floor drifting in +x, each with ~5 % of its
    points masked out."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(SCANS):
        pts = rng.uniform(-8, 8, (N_PTS, 3)).astype(np.float32)
        pts[:, 0] += 1.5 * s
        pts[:, 2] = 0.1 * np.sin(pts[:, 0]) + 0.01 * pts[:, 2]
        mask = rng.uniform(size=N_PTS) > 0.05
        out.append((torch.from_numpy(pts), torch.from_numpy(mask)))
    return out


def _equal(a: surfel_map.SurfelMap, b: surfel_map.SurfelMap) -> bool:
    return a.res == b.res and all(torch.equal(x, y)
                                  for x, y in zip(a[:4], b[:4]))


@pytest.fixture
def compactions(monkeypatch):
    """Every capped compaction an insert makes, as (whether it is the
    neighbourhood refit's, wanted rows, cap): the refit's key is boolean
    (False wanted), the halo's a priority (0 and 1 wanted)."""
    seen = []
    orig = surfel_map._compact_idx

    def compact(key, cap):
        wanted = ~key if key.dtype == torch.bool else key < 2
        seen.append((key.dtype == torch.bool, int(wanted.sum()), cap))
        return orig(key, cap)
    monkeypatch.setattr(surfel_map, "_compact_idx", compact)
    return seen


CASES = [dict(hood_window=7, hood_cap=256, halo_cap=512),
         dict(hood_window=27, hood_cap=256, halo_cap=512),
         dict(hood_window=7, hood_cap=None, halo_cap=None),
         dict(hood_window=7, hood_cap=256, halo_cap=512, halo=False)]


@pytest.mark.parametrize("kw", CASES, ids=["face-capped", "cube-capped",
                                           "face-uncapped", "no-halo"])
def test_graph_equals_eager_insert_bit_for_bit(card_graphs, compactions,
                                              kw):
    """Seven scans from an empty map, evicted between scans as the LIO
    does: every table equal to the eager insert's after every scan, with
    the caps binding where they are set (more rows than the cap ask for a
    refit and for the halo); one graph for all seven."""
    eager = surfel_map.empty(0.5, TABLE, "cpu")
    graphed = surfel_map.empty(0.5, TABLE, "cpu")
    runner = cuda_graph.Runner()
    binding = set()
    for s, (pts, mask) in enumerate(_scans()):
        compactions.clear()
        eager = surfel_map.insert(eager, pts, mask, **dict(kw, thickness=TH))
        binding |= {hood for hood, n, cap in compactions if n > cap}
        graphed = runner(surfel_map.insert, graphed, pts, mask, thickness=TH,
                         **kw)
        assert _equal(graphed, eager), s
        centre = torch.tensor([1.5 * s, 0.0, 0.0])
        eager = surfel_map.evict_beyond(eager, centre, 9.0)
        graphed = surfel_map.evict_beyond(graphed, centre, 9.0)
    assert len(runner.graphs) == 1
    assert int(eager.occupied.sum()) > 500
    caps = {True: kw["hood_cap"], False: kw.get("halo", True)
            and kw["halo_cap"]}
    assert binding == {hood for hood, cap in caps.items() if cap}


def test_a_returned_map_owns_its_storage(card_graphs):
    """A map one call returned is unchanged by the next call, and shares
    no storage with the graph's buffers or outputs or its inputs."""
    scans = _scans(3)
    runner = cuda_graph.Runner()
    kw = dict(thickness=TH, hood_cap=256, halo_cap=512, hood_window=7)
    m0 = surfel_map.empty(0.5, TABLE, "cpu")
    m1 = runner(surfel_map.insert, m0, *scans[0], **kw)
    kept = [t.clone() for t in m1[:4]]
    m2 = runner(surfel_map.insert, m1, *scans[1], **kw)
    assert all(torch.equal(t, k) for t, k in zip(m1[:4], kept))
    assert not all(torch.equal(a, b) for a, b in zip(m1[:4], m2[:4]))
    (g,) = runner.graphs.values()
    held = {t.untyped_storage().data_ptr()
            for t in (*g.leaves[:4], *g.leaves[5:7], *g.out[:4], *m0[:4],
                      *scans[0], *scans[1])}
    for m in (m1, m2):
        assert not {t.untyped_storage().data_ptr() for t in m[:4]} & held


KEY = dict(table=TABLE, n=N_PTS, res=0.5, thickness=TH, hood_cap=256,
           halo_cap=512, hood_window=7, halo=True, dtype=torch.float32,
           device="cpu")
OTHER = dict(table=TABLE // 2, n=N_PTS // 2, res=0.25, thickness=0.1,
             hood_cap=128, halo_cap=None, hood_window=27, halo=False,
             dtype=torch.float64, device="meta")


def _graph(runner, **over):
    """The runner's graph of the LIO's insert call at KEY with ``over``
    (loaded with zeros)."""
    k = dict(KEY, **over)
    m = surfel_map.empty(k["res"], k["table"], k["device"])
    pts = torch.zeros((k["n"], 3), dtype=k["dtype"], device=k["device"])
    mask = torch.zeros(k["n"], dtype=torch.bool, device=k["device"])
    return runner.load(surfel_map.insert, m, pts, mask,
                       thickness=k["thickness"], hood_cap=k["hood_cap"],
                       halo=k["halo"], halo_cap=k["halo_cap"],
                       hood_window=k["hood_window"])


@pytest.mark.parametrize("field", sorted(OTHER))
def test_the_cache_is_keyed_by_what_a_graph_bakes_in(card_graphs,
                                                     monkeypatch, field):
    """One graph for one key; a change of any setting, the map's table or
    the scan's width, the points' dtype or the device gives another, which
    is kept beside the first.  (The captures here run nothing, and meta
    tensors count as another card's.)"""
    monkeypatch.setattr(cuda_graph, "capture",
                        lambda fn, device: types.SimpleNamespace())
    monkeypatch.setattr(cuda_graph, "_on_card", lambda tensors: all(
        t.device.type in ("cpu", "meta") for t in tensors))
    runner = cuda_graph.Runner()
    a = _graph(runner)
    assert _graph(runner) is a
    b = _graph(runner, **{field: OTHER[field]})
    assert b is not a
    assert _graph(runner, **{field: OTHER[field]}) is b
    assert _graph(runner) is a and len(runner.graphs) == 2


def test_on_the_cpu_no_graph_is_captured_or_replayed(monkeypatch):
    """The LIO on the CPU runs the insert itself (the module's runner
    holds no graph), and a runner called on the CPU captures and replays
    nothing."""
    cfg = dataclasses.replace(get_pipeline_config("sim").lio,
                              max_points_per_scan=1024,
                              map_table_size=1 << 13)
    world, traj = ls.golden_world()
    p = profiling.Profiler("cpu")
    monkeypatch.setattr(lio_mod, "_INSERT_GRAPHS", cuda_graph.Runner())
    lio = LIO(cfg, device="cpu", profiler=p)
    state = initial_state(lio, traj)
    for i in range(2):
        state, _ = lio.process_scan(
            state, *sim_scan_inputs(world, traj, i, 0.2, 4096))
    assert lio_mod._INSERT_GRAPHS.graphs == {}
    runner = cuda_graph.Runner()
    with p.span("insert"):
        runner(surfel_map.insert, state.grid, *_scans()[0], thickness=TH)
    assert runner.graphs == {}
    for r in p.records():
        assert r.graph_captures == r.graph_replays == 0
    for name, row in p.summary().items():
        assert "graph_captures" not in row, name
        assert "graph_replays" not in row, name


def test_k6_counts_the_same_launches_through_the_graph(card_graphs,
                                                       monkeypatch):
    """A replay of the insert's graph, as the stand-in here runs it, calls
    K6's wrapper as often as the eager insert does: twice, the own and the
    neighbourhood refit.  The wrapper runs its plain version on the CPU,
    so the test counts its calls.  On the card a replay calls no wrapper,
    and ``chip_smoke.py`` counts K6 in the device trace of a graphed
    scan."""
    orig = linalg3.eigh3_soa

    def counted(*args, **kwargs):
        counted.launches += 1
        return orig(*args, **kwargs)
    counted.launches = 0
    monkeypatch.setattr(linalg3, "eigh3_soa", counted)
    scans = _scans(5)
    m = surfel_map.empty(0.5, TABLE, "cpu")
    kw = dict(thickness=TH, hood_cap=256, halo_cap=512, hood_window=7)
    runner = cuda_graph.Runner()
    runner.load(surfel_map.insert, m, *scans[0], **kw)    # the capture
    for pts, mask in scans[:3]:
        a = counted.launches
        want = surfel_map.insert(m, pts, mask, **kw)
        b = counted.launches
        m = runner(surfel_map.insert, m, pts, mask, **kw)
        assert b - a == counted.launches - b == 2
        assert _equal(m, want)
