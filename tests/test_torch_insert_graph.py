"""The surfel insert's CUDA graph (``ops/surfel_map.py`` ``InsertGraph``,
``insert_graph``) on the CPU, where it runs the insert eagerly on its
static buffers: the same maps as ``surfel_map.insert`` bit for bit, maps
that own their storage, the cache's key, the graph counters of the tracer
and K6's calls."""
import dataclasses

import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu_torch.configs.presets import get_pipeline_config
from fast_lio_sam_qn_tpu_torch.models.lio import LIO
from fast_lio_sam_qn_tpu_torch.ops import linalg3, surfel_map
from fast_lio_sam_qn_tpu_torch.run import initial_state, sim_scan_inputs
from fast_lio_sam_qn_tpu_torch.tools import lio_scenarios as ls
from fast_lio_sam_qn_tpu_torch.utils import profiling

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
def test_graph_equals_eager_insert_bit_for_bit(compactions, kw):
    """Seven scans from an empty map, evicted between scans as the LIO
    does: every table equal to the eager insert's after every scan, with
    the caps binding where they are set (more rows than the cap ask for a
    refit and for the halo)."""
    eager = surfel_map.empty(0.5, TABLE, "cpu")
    graphed = surfel_map.empty(0.5, TABLE, "cpu")
    g = surfel_map.InsertGraph(graphed, N_PTS, torch.float32, TH, **kw)
    binding = set()
    for s, (pts, mask) in enumerate(_scans()):
        compactions.clear()
        eager = surfel_map.insert(eager, pts, mask, **dict(kw, thickness=TH))
        binding |= {hood for hood, n, cap in compactions if n > cap}
        graphed = g(graphed, pts, mask)
        assert _equal(graphed, eager), s
        centre = torch.tensor([1.5 * s, 0.0, 0.0])
        eager = surfel_map.evict_beyond(eager, centre, 9.0)
        graphed = surfel_map.evict_beyond(graphed, centre, 9.0)
    assert g.graph is None            # no CUDA graph on the CPU
    assert int(eager.occupied.sum()) > 500
    caps = {True: kw["hood_cap"], False: kw.get("halo", True)
            and kw["halo_cap"]}
    assert binding == {hood for hood, cap in caps.items() if cap}


def test_a_returned_map_owns_its_storage():
    """A map one call returned is unchanged by the next call, and shares
    no storage with the graph's buffers or its inputs."""
    scans = _scans(3)
    g = surfel_map.InsertGraph(surfel_map.empty(0.5, TABLE, "cpu"), N_PTS,
                               torch.float32, TH, hood_cap=256,
                               halo_cap=512, hood_window=7)
    m0 = surfel_map.empty(0.5, TABLE, "cpu")
    m1 = g(m0, *scans[0])
    kept = [t.clone() for t in m1[:4]]
    m2 = g(m1, *scans[1])
    assert all(torch.equal(t, k) for t, k in zip(m1[:4], kept))
    assert not all(torch.equal(a, b) for a, b in zip(m1[:4], m2[:4]))
    held = {t.untyped_storage().data_ptr()
            for t in (*g.map[:4], *g.out[:4], g.points, g.mask, *m0[:4])}
    for m in (m1, m2):
        assert not {t.untyped_storage().data_ptr() for t in m[:4]} & held


KEY = dict(table=TABLE, n=N_PTS, res=0.5, thickness=TH, hood_cap=256,
           halo_cap=512, hood_window=7, halo=True, dtype=torch.float32,
           device="cpu")
OTHER = dict(table=TABLE // 2, n=N_PTS // 2, res=0.25, thickness=0.1,
             hood_cap=128, halo_cap=None, hood_window=27, halo=False,
             dtype=torch.float64, device="meta")


def _graph(**over):
    k = dict(KEY, **over)
    m = surfel_map.empty(k["res"], k["table"], k["device"])
    pts = torch.zeros((k["n"], 3), dtype=k["dtype"], device=k["device"])
    return surfel_map.insert_graph(m, pts, k["thickness"], k["hood_cap"],
                                   k["halo"], k["halo_cap"], k["hood_window"])


@pytest.fixture
def no_graphs(monkeypatch):
    monkeypatch.setattr(surfel_map, "_GRAPHS", {})


@pytest.mark.parametrize("field", sorted(OTHER))
def test_the_cache_is_keyed_by_what_a_graph_bakes_in(no_graphs, field):
    """One graph for one key; a change of any field of the key gives
    another, which is kept beside the first."""
    a = _graph()
    assert _graph() is a
    b = _graph(**{field: OTHER[field]})
    assert b is not a
    assert _graph(**{field: OTHER[field]}) is b
    assert _graph() is a and len(surfel_map._GRAPHS) == 2


@pytest.mark.parametrize("counter", ["insert_graph_captures",
                                     "insert_graph_replays"])
def test_insert_graph_counters_roll_up(counter):
    """The insert graphs' counters count on every open ancestor and show
    in ``summary()``, as the PCG graphs' do."""
    assert counter in profiling.COUNTERS
    p = profiling.Profiler()
    with p.span("scan", scan=0):
        with p.span("insert"):
            profiling.add(counter, 1)
        with p.span("update"):
            pass
    with p.span("scan", scan=1):
        with p.span("insert"):
            profiling.add(counter, 1)
    recs = p.records()
    assert [getattr(r, counter) for r in recs] == [1, 1, 0, 1, 1]
    s = p.summary()
    assert s["scan"][counter] == 2 and s["insert"][counter] == 2
    assert counter not in s["update"]


def test_on_the_cpu_no_graph_is_captured_or_replayed(no_graphs):
    """The LIO on the CPU runs the eager insert (no graph is built), and
    an ``InsertGraph`` called on the CPU captures and replays nothing."""
    cfg = dataclasses.replace(get_pipeline_config("sim").lio,
                              max_points_per_scan=1024,
                              map_table_size=1 << 13)
    world, traj = ls.golden_world()
    p = profiling.Profiler("cpu")
    lio = LIO(cfg, device="cpu", profiler=p)
    state = initial_state(lio, traj)
    for i in range(2):
        state, _ = lio.process_scan(
            state, *sim_scan_inputs(world, traj, i, 0.2, 4096))
    assert surfel_map._GRAPHS == {}
    g = surfel_map.InsertGraph(state.grid, N_PTS, torch.float32, TH)
    with p.span("insert"):
        g(state.grid, *_scans()[0])
    for r in p.records():
        assert r.insert_graph_captures == r.insert_graph_replays == 0
    for name, row in p.summary().items():
        assert "insert_graph_captures" not in row, name
        assert "insert_graph_replays" not in row, name


def test_k6_counts_the_same_launches_through_the_graph(monkeypatch):
    """Off the card an insert through ``InsertGraph`` calls K6's wrapper as
    often as the eager insert does: twice, the own and the neighbourhood
    refit.  The wrapper runs its plain version on the CPU, so the test
    counts its calls.  On the card a replay calls no wrapper, and
    ``chip_smoke.py`` counts K6 in the device trace of a graphed scan."""
    orig = linalg3.eigh3_soa

    def counted(*args, **kwargs):
        counted.launches += 1
        return orig(*args, **kwargs)
    counted.launches = 0
    monkeypatch.setattr(linalg3, "eigh3_soa", counted)
    scans = _scans(5)
    m = surfel_map.empty(0.5, TABLE, "cpu")
    g = surfel_map.InsertGraph(m, N_PTS, torch.float32, TH, hood_cap=256,
                               halo_cap=512, hood_window=7)
    for pts, mask in scans[:3]:
        a = counted.launches
        want = surfel_map.insert(m, pts, mask, TH, hood_cap=256,
                                 halo_cap=512, hood_window=7)
        b = counted.launches
        m = g(m, pts, mask)
        assert b - a == counted.launches - b == 2
        assert _equal(m, want)
