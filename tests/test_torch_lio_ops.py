"""The LIO's ops in the port (``ops/hashgrid.py``, ``ops/surfel_map.py``,
``ops/ieskf.py``) held against the JAX package on the same numpy inputs,
plus the port's mirrors of the reference's own surfel-map and IESEKF unit
tests.

Tolerances, each from the fp32 arithmetic it covers:

- hash slots, scatter rounds, keys, neighbour hints, moment counts, eviction
  and the first-per-voxel preprocess: exact (integer or copied values);
- moments: 1e-5 absolute (each voxel's rows are summed in point order on
  both sides; the products may round differently);
- planes: ``valid`` equal except where a fit sits within 1e-4 of a gate
  (thickness, spread), which the test lists; normals (sign-aligned) and
  offsets within 1e-4 on rows valid in both (a 3x3 Jacobi solve in fp32);
- query_planes (the same map on both sides): ``valid`` and normals equal,
  residuals within 1e-4;
- propagate over 64 samples: R, p, v within 1e-5, P within rtol 1e-4;
  deskew within 1e-5 m; update_surfel: the state within 1e-5, P within rtol
  1e-4, matches equal.  P's rtol is taken on the matrix's scale
  (``_assert_cov``): its small off-diagonal entries are differences of
  terms ~1e3 times larger (F P F^T), whose last-bit roundings alone move
  them by ~1e-4 of themselves.

The JAX side is cached with conftest.deterministic_cache."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fast_lio_sam_qn_tpu.ops import hashgrid as jhashgrid
from fast_lio_sam_qn_tpu.ops import ieskf as jieskf
from fast_lio_sam_qn_tpu.ops import surfel_map as jsurfel
from fast_lio_sam_qn_tpu_torch.convert import tensors_from_numpy
from fast_lio_sam_qn_tpu_torch.models import lio as tlio
from fast_lio_sam_qn_tpu_torch.ops import hashgrid, ieskf, se3, surfel_map
from fast_lio_sam_qn_tpu_torch.ops.voxel import voxel_coords
from fast_lio_sam_qn_tpu_torch.utils import sim

torch.set_num_threads(1)

RES, TABLE = 0.3, 1 << 13
TH = float(np.float32(0.1))
NOISE = np.array([0.1, 0.1, 1e-4, 1e-4], np.float32)
INSERT_CASES = {
    "hood27": dict(hood_window=27),
    "hood7": dict(hood_window=7, hood_cap=8192, halo_cap=4096),
    "hood7-capped": dict(hood_window=7, hood_cap=128, halo_cap=256),
    "no-halo": dict(hood_window=7, halo=False),
}


def _cache(name, params, build):
    from conftest import deterministic_cache

    return deterministic_cache(name, params, build, extra_files=(__file__,))


def _t(*arrays):
    return tensors_from_numpy(*arrays, device="cpu")


def _scans(n=2048, count=4):
    """Scans of a small room (floor, walls, two boxes) sampled at 5 mm
    noise, each shifted a little, with a holed mask."""
    world = sim.World.room(size=6.0, height=2.5, n_boxes=2, seed=5)
    rng = np.random.default_rng(3)
    out = []
    for i in range(count):
        pts = world.sample_points(n, seed=10 + i, noise=0.005)
        pts = (pts + np.float32(0.03 * i)).astype(np.float32)
        out.append((pts, rng.random(n) > 0.05))
    return out


def _jax_map(m):
    return [np.asarray(x) for x in (m.key, m.mom, m.plane, m.nbr)]


def _port_map(arrays, res=RES):
    return surfel_map.SurfelMap(*_t(*arrays), res=res)


@pytest.fixture(scope="module")
def ref_maps():
    """The JAX package's map after 3 inserts, for every insert case."""
    def build():
        out = {}
        for name, kw in INSERT_CASES.items():
            m = jsurfel.empty(RES, TABLE)
            for pts, mask in _scans()[:3]:
                m = jsurfel.insert(m, jnp.asarray(pts), jnp.asarray(mask),
                                   jnp.float32(TH), **kw)
            out[name] = _jax_map(m)
        return out

    return _cache("torch_lio_maps", (RES, TABLE, sorted(INSERT_CASES)), build)


def _port_inserts(kw):
    m = surfel_map.empty(RES, TABLE, "cpu")
    for pts, mask in _scans()[:3]:
        m = surfel_map.insert(m, torch.from_numpy(pts),
                              torch.from_numpy(mask), TH, **kw)
    return m


def _hood_fit(m, slots, window):
    """(thickness, spread) of the neighbourhood fit of each slot."""
    coords = m.key[slots, :3]
    offs = surfel_map._hood_offsets(window, "cpu")
    nslot, nfound = surfel_map._locate(m, coords[:, None, :] + offs[None])
    delta = offs.float() * m.res
    mom = m.mom[nslot] * nfound[..., None].float()
    cnt_j, psum_j = mom[..., 0], mom[..., 1:4]
    cross = surfel_map._cross_sym(delta.expand(psum_j.shape), psum_j)
    psum = torch.sum(psum_j + cnt_j[..., None] * delta[None], 1)
    m2 = torch.sum(mom[..., 4:10] + cross
                   + cnt_j[..., None] * surfel_map._outer_sym(delta)[None], 1)
    _, _, th, sp = surfel_map._plane_from(
        torch.sum(cnt_j, 1), psum, m2, surfel_map._vox_center(coords, m.res))
    return th, sp


def _near_gate(m, slot, window):
    """Whether the own or the hood fit of the slot or of a face neighbour
    sits within 1e-4 of the thickness or spread gate."""
    c = m.key[slot, :3]
    cand = c[None] + torch.cat([torch.zeros(1, 3, dtype=torch.int32),
                                surfel_map._face("cpu")])
    slots, found = surfel_map._locate(m, cand)
    slots = slots[found]
    mom = m.mom[slots]
    _, _, th_o, sp_o = surfel_map._plane_from(
        mom[:, 0], mom[:, 1:4], mom[:, 4:10],
        surfel_map._vox_center(m.key[slots, :3], m.res))
    th_h, sp_h = _hood_fit(m, slots, window)
    margin = torch.stack([torch.abs(th_o - TH), torch.abs(sp_o - TH / 2),
                          torch.abs(th_h - TH), torch.abs(sp_h - TH / 2)])
    return bool((margin < 1e-4).any())


def _assert_maps_agree(m, ref, window):
    key, mom, plane, nbr = ref
    np.testing.assert_array_equal(m.key.numpy(), key)
    np.testing.assert_array_equal(m.nbr.numpy(), nbr)
    np.testing.assert_array_equal(m.mom[:, 0].numpy(), mom[:, 0])
    np.testing.assert_allclose(m.mom.numpy(), mom, rtol=0, atol=1e-5)
    got = m.plane.numpy()
    va, vb = got[:, 4] > 0.5, plane[:, 4] > 0.5
    flips = np.nonzero(va != vb)[0]
    print(f"plane validity differs at {flips.tolist()} of {vb.sum()} valid")
    assert all(_near_gate(m, int(s), window) for s in flips), flips
    both = va & vb
    assert both.sum() > 100
    sign = np.where(np.sum(got[:, :3] * plane[:, :3], -1) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got[both, :3] * sign[both, None],
                               plane[both, :3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[both, 3] * sign[both], plane[both, 3],
                               rtol=0, atol=1e-4)


def test_se3_additions_match_reference():
    from fast_lio_sam_qn_tpu.ops import se3 as jse3

    a = se3.so3_exp(torch.tensor([0.3, -0.2, 0.9]))
    b = se3.so3_exp(torch.tensor([-1.1, 0.4, 0.05]))
    np.testing.assert_allclose(
        se3.compose3(a, b).numpy(),
        np.asarray(jse3.compose3(jnp.asarray(a.numpy()), jnp.asarray(
            b.numpy()))), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(se3.identity_pose("cpu").numpy(),
                                  np.asarray(jse3.identity_pose()))


# ---------------------------------------------------------------------------
# the hash and the claim rounds: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", [1 << 8, 1 << 13, 1 << 19])
def test_probe_slots_exact(table):
    rng = np.random.default_rng(table)
    coords = np.concatenate([
        rng.integers(-60, 60, (2000, 3)),
        rng.integers(-2**31, 2**31 - 1, (500, 3), dtype=np.int64),
    ]).astype(np.int32)
    want = np.asarray(jhashgrid._probe_slots(jnp.asarray(coords), table))
    got = hashgrid._probe_slots(torch.from_numpy(coords), table).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("present", [False, True])
def test_scatter_rounds_exact(present):
    """occupied, winner and point_slot equal the reference's on a small
    table (many collisions, repeated voxels, a pre-occupied table)."""
    rng = np.random.default_rng(11)
    t = 1 << 10
    coords = rng.integers(-8, 8, (1500, 3)).astype(np.int32)
    mask = rng.random(1500) > 0.1
    occ = rng.random(t) > 0.7
    already = rng.random(1500) > 0.6 if present else None
    w0 = np.full(t + 1, np.iinfo(np.int32).max, np.int32)
    want = jhashgrid._scatter_rounds(
        jnp.asarray(occ), jnp.asarray(w0), jnp.asarray(coords),
        jnp.asarray(mask), t,
        None if already is None else jnp.asarray(already))
    got = hashgrid._scatter_rounds(
        torch.from_numpy(occ), torch.from_numpy(w0.astype(np.int64)),
        torch.from_numpy(coords), torch.from_numpy(mask), t,
        None if already is None else torch.from_numpy(already))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[2] >= 0).sum() > 200


# ---------------------------------------------------------------------------
# the surfel map against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(INSERT_CASES))
def test_insert_matches_reference(case, ref_maps):
    kw = INSERT_CASES[case]
    m = _port_inserts(kw)
    _assert_maps_agree(m, ref_maps[case], kw.get("hood_window", 27))


def test_caps_bind_in_the_capped_case(ref_maps):
    """The capped case really compacts: its map differs from the uncapped
    face-hood map (the hood and halo caps changed the result)."""
    a, b = ref_maps["hood7-capped"], ref_maps["hood7"]
    assert not np.array_equal(a[2], b[2]) or not np.array_equal(a[0], b[0])


@pytest.mark.parametrize("window", [1, 3])
def test_query_planes_matches_reference(window, ref_maps):
    arrays = ref_maps["hood7"]
    jm = jsurfel.SurfelMap(*map(jnp.asarray, arrays), res=RES)
    pts, mask = _scans()[3]
    want = jsurfel.query_planes(jm, jnp.asarray(pts), jnp.asarray(mask),
                                window=window)
    got = surfel_map.query_planes(_port_map(arrays), torch.from_numpy(pts),
                                  torch.from_numpy(mask), window=window)
    n, r, v = (x.numpy() for x in got)
    np.testing.assert_array_equal(v, np.asarray(want[2]))
    assert v.sum() > 300
    np.testing.assert_array_equal(n, np.asarray(want[0]))
    np.testing.assert_allclose(r, np.asarray(want[1]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("radius", [2.0, 3.5])
def test_evict_beyond_matches_reference(radius, ref_maps):
    arrays = ref_maps["hood27"]
    jm = jsurfel.SurfelMap(*map(jnp.asarray, arrays), res=RES)
    center = np.array([0.4, -0.3, 1.0], np.float32)
    want = jsurfel.evict_beyond(jm, jnp.asarray(center), jnp.float32(radius))
    got = surfel_map.evict_beyond(_port_map(arrays), torch.from_numpy(center),
                                  radius)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got.occupied.sum()) < int((arrays[0][:, 3] > 0).sum())


@pytest.mark.parametrize("out_cap", [700, 5000])
def test_first_per_voxel_matches_reference(out_cap):
    from fast_lio_sam_qn_tpu.models import lio as jlio

    rng = np.random.default_rng(5)
    pts = (rng.normal(0, 3, (4000, 3))).astype(np.float32)
    pts[1000:1400] = pts[:400]                     # repeated points
    sc = rng.random((4000, 2)).astype(np.float32)
    mask = rng.random(4000) > 0.2
    want = jlio._first_per_voxel(jnp.asarray(pts), jnp.asarray(sc),
                                 jnp.asarray(mask), 0.5, out_cap)
    got = tlio._first_per_voxel(*_t(pts, sc, mask), 0.5, out_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_preprocess_matches_reference():
    """LIO.preprocess (blind cull, decimation, first point per voxel) of a
    raw swept scan equals the reference's."""
    from fast_lio_sam_qn_tpu.models.lio import LIO as JLIO
    from fast_lio_sam_qn_tpu.utils.config import LioConfig as JCfg
    from fast_lio_sam_qn_tpu_torch.utils.config import LioConfig

    world = sim.World.room(size=26.0, height=5.0, n_boxes=10, seed=3)
    traj = sim.Trajectory.loop(7.0, 40.0)
    pts, rel = sim.simulate_scan_swept(world, traj, 0.4, n_points=8192,
                                       seed=3, scan_period=0.2)
    cloud, mask = sim.pad_cloud(pts, 8192)
    inten = np.linspace(0, 1, 8192, dtype=np.float32)
    kw = dict(blind=0.5, point_filter_num=2, filter_size_surf=0.3,
              max_points_per_scan=2048)
    want = JLIO(JCfg(**kw)).preprocess(*map(jnp.asarray,
                                            (cloud, rel, mask, inten)))
    got = tlio.LIO(LioConfig(**kw), device="cpu").preprocess(cloud, rel, mask,
                                                             inten)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3].sum()) > 500


# ---------------------------------------------------------------------------
# the IESEKF against the reference
# ---------------------------------------------------------------------------

def _imu(valid=40, holes=False, k=64, seed=0):
    traj = sim.Trajectory.loop_excited()
    ts, gyro, acc = sim.simulate_imu(traj, 2.0, 2.2, gyro_noise=0.01,
                                     acc_noise=0.05, seed=seed)
    t = np.zeros(k, np.float32)
    g = np.zeros((k, 3), np.float32)
    a = np.zeros((k, 3), np.float32)
    m = np.zeros(k, bool)
    n = min(valid, len(ts))
    t[:n], g[:n], a[:n], m[:n] = ts[:n], gyro[:n], acc[:n], True
    if holes:
        m[3:9] = False
        m[20] = False
    T0 = traj.pose(2.0)
    v0, _, _ = traj.derivatives(2.0)
    nav = [T0[:3, :3], T0[:3, 3], T0[:3, :3].T @ v0, [0.01, -0.02, 0.005],
           [0.05, 0.02, -0.03], [0.0, 0.0, -9.81]]
    nav = [np.asarray(x, np.float32) for x in nav]
    P0 = np.diag(np.linspace(1e-4, 1e-2, 18)).astype(np.float32)
    return nav, P0, t, g, a, m


def _assert_cov(P, want):
    """|P - want| <= 1e-4 (|want| + max |want|), elementwise."""
    np.testing.assert_allclose(P, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def _jnav(nav):
    return jieskf.NavState(*map(jnp.asarray, nav))


def _tnav(nav):
    return ieskf.NavState(*_t(*nav))


PROPAGATE_CASES = {"full": dict(), "holed": dict(holes=True),
                   "dropout": dict(valid=0)}


@pytest.fixture(scope="module")
def ref_propagate():
    def build():
        out = {}
        for name, kw in PROPAGATE_CASES.items():
            nav, P0, t, g, a, m = _imu(**kw)
            s, P, log = jieskf.propagate(
                _jnav(nav), jnp.asarray(P0), *map(jnp.asarray, (t, g, a, m)),
                jnp.float32(2.0), jnp.float32(2.2), jnp.asarray(NOISE))
            out[name] = ([np.asarray(x) for x in s], np.asarray(P),
                         [np.asarray(x) for x in log])
        return out

    return _cache("torch_lio_propagate", sorted(PROPAGATE_CASES), build)


@pytest.mark.parametrize("case", sorted(PROPAGATE_CASES))
def test_propagate_matches_reference(case, ref_propagate):
    nav, P0, t, g, a, m = _imu(**PROPAGATE_CASES[case])
    s, P, log = ieskf.propagate(_tnav(nav), *_t(P0, t, g, a, m),
                                torch.tensor(2.0), torch.tensor(2.2),
                                torch.from_numpy(NOISE))
    ws, wP, wlog = ref_propagate[case]
    for x, y in zip(s[:3], ws[:3]):
        np.testing.assert_allclose(x.numpy(), y, rtol=0, atol=1e-5)
    _assert_cov(P.numpy(), wP)
    for x, y in zip(log, wlog):
        np.testing.assert_allclose(x.numpy(), y, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["full", "holed"])
def test_deskew_matches_reference(case, ref_propagate):
    """The port's deskew on the reference's propagation log and end state
    (a lidar extrinsic included)."""
    world = sim.World.room(size=20.0, height=5.0, n_boxes=4, seed=1)
    pts, rel = sim.simulate_scan_swept(world, sim.Trajectory.loop_excited(),
                                       2.0, n_points=2048, seed=2,
                                       scan_period=0.2)
    cloud, mask = sim.pad_cloud(pts, 2048)
    R_li = se3.so3_exp(torch.tensor([0.01, -0.02, 0.03])).numpy()
    t_li = np.array([0.1, -0.05, 0.2], np.float32)
    ws, _, wlog = ref_propagate[case]
    want = jieskf.deskew(
        *map(jnp.asarray, (cloud, rel, mask)),
        jieskf.PropagationLog(*map(jnp.asarray, wlog)), _jnav(ws),
        jnp.float32(2.0), jnp.asarray(R_li), jnp.asarray(t_li))
    got = ieskf.deskew(*_t(cloud, rel, mask),
                       ieskf.PropagationLog(*_t(*wlog)), _tnav(ws),
                       torch.tensor(2.0), *_t(R_li, t_li))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("window", [1, 3])
def test_update_surfel_matches_reference(window, ref_maps):
    """One update_surfel on the same map and state, the scan a fourth
    sample of the map's surfaces seen from a pose off the prior."""
    arrays = ref_maps["hood7"]
    pts, mask = _scans()[3]
    R = se3.so3_exp(torch.tensor([0.0, 0.004, 0.01])).numpy()
    p = np.array([0.03, -0.02, 0.01], np.float32)
    body = ((pts - p) @ R).astype(np.float32)     # R^T (x - p)
    nav = [np.eye(3, dtype=np.float32)] + [np.zeros(3, np.float32)] * 4 + [
        np.array([0, 0, -9.81], np.float32)]
    P0 = np.asarray(jieskf.init_covariance())

    def build():
        jm = jsurfel.SurfelMap(*map(jnp.asarray, arrays), res=RES)
        s, P, k = jieskf.update_surfel(
            _jnav(nav), jnp.asarray(P0), jm, jnp.asarray(body),
            jnp.asarray(mask), jnp.float32(0.0025), max_iter=3,
            window=window)
        return [np.asarray(x) for x in s], np.asarray(P), int(k)

    ws, wP, wk = _cache("torch_lio_update", (window,), build)
    s, P, k = ieskf.update_surfel(_tnav(nav), *_t(P0), _port_map(arrays),
                                  *_t(body, mask), float(np.float32(0.0025)),
                                  max_iter=3, window=window)
    assert int(k) == wk and wk > 300
    for x, y in zip(s, ws):
        np.testing.assert_allclose(x.numpy(), y, rtol=0, atol=1e-5)
    _assert_cov(P.numpy(), wP)
    assert np.linalg.norm(s.p.numpy()) > 1e-3      # the update moved


# ---------------------------------------------------------------------------
# mirrors of tests/test_surfel_map.py and tests/test_surfel_stability.py
# ---------------------------------------------------------------------------

def _insert(pts, res=0.5, table=1 << 12, mask=None, **kw):
    m = surfel_map.empty(res, table, "cpu")
    mask = torch.ones(len(pts), dtype=torch.bool) if mask is None else mask
    return surfel_map.insert(m, torch.from_numpy(pts), mask, TH, **kw)


def _wall(rng, n, offset=(0.0, 0.0, 0.0)):
    xy = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    return np.concatenate(
        [xy, rng.normal(0, 0.01, (n, 1)).astype(np.float32)], -1) + \
        np.asarray(offset, np.float32)


@pytest.mark.parametrize("offset", [(0.0, 0.0, 0.0), (400.0, -300.0, 50.0)])
def test_plane_recovery_on_wall(offset):
    """Points on z = 0 (also ~500 m from the origin, where raw moments
    would cancel in fp32) get planes with normal +-z and small residuals."""
    pts = _wall(np.random.default_rng(0), 2000, offset)
    m = _insert(pts)
    n, resid, valid = surfel_map.query_planes(
        m, torch.from_numpy(pts[:200]), torch.ones(200, dtype=torch.bool))
    v = valid.numpy()
    assert v.mean() > 0.9, v.mean()
    assert (np.abs(n.numpy()[v][:, 2]) > 0.99).all()
    assert np.abs(resid.numpy()[v]).max() < 0.05


def test_thickness_gate_rejects_volumes():
    pts = np.random.default_rng(1).uniform(-2, 2, (3000, 3)).astype(
        np.float32)
    m = _insert(pts)
    _, _, valid = surfel_map.query_planes(m, torch.from_numpy(pts[:200]),
                                          torch.ones(200, dtype=torch.bool))
    assert valid.numpy().mean() < 0.1


def test_moments_accumulate_across_inserts():
    rng = np.random.default_rng(2)
    xy = rng.uniform(-1, 1, (800, 2)).astype(np.float32)
    pts = np.concatenate([xy, np.zeros((800, 1), np.float32)], -1)
    m1 = _insert(pts, table=1 << 10)
    m2 = _insert(pts[:400], table=1 << 10)
    m2 = surfel_map.insert(m2, torch.from_numpy(pts[400:]),
                           torch.ones(400, dtype=torch.bool), TH)
    assert abs(float(m1.count.sum()) - float(m2.count.sum())) < 1e-3
    np.testing.assert_allclose(float(m1.psum.sum()), float(m2.psum.sum()),
                               rtol=1e-5)


def test_evict_beyond_drops_far_voxels():
    pts = np.array([[0.1, 0.1, 0.0], [50.0, 0.0, 0.0]], np.float32)
    m = _insert(pts, table=1 << 8)
    assert int(m.occupied.sum()) == 2
    m = surfel_map.evict_beyond(m, torch.zeros(3), 10.0)
    assert int(m.occupied.sum()) == 1


def test_nbr_hint_invariant():
    """The face-neighbour hints agree with a probe locate for every
    occupied voxel after inserts (capped and uncapped claims), halo claims
    and eviction with slot reuse."""
    rng = np.random.default_rng(7)
    m = surfel_map.empty(0.5, 1 << 13, "cpu")
    for step in range(6):
        pts = rng.uniform(-10 - step, 10, (3000, 3)).astype(np.float32)
        pts[:, 2] = 0.1 * np.sin(pts[:, 0]) + 0.01 * pts[:, 2]
        mask = torch.from_numpy(rng.uniform(size=3000) > 0.05)
        m = surfel_map.insert(m, torch.from_numpy(pts), mask,
                              float(np.float32(0.12)), hood_cap=512,
                              halo=True, halo_cap=1024, hood_window=7)
        if step == 3:
            m = surfel_map.evict_beyond(m, torch.tensor([3.0, 3.0, 0.0]),
                                        8.0)
    slots = torch.nonzero(m.occupied).flatten()
    coords = m.coords[slots]
    ns, ok = surfel_map._nbr_lookup(m, slots, coords)
    ref_slot, ref_found = surfel_map._locate(
        m, coords[:, None, :] + surfel_map._face("cpu")[None])
    assert torch.equal(ok, ref_found)
    assert torch.equal(ns[ok], ref_slot[ref_found])


def test_compact_idx_equals_stable_argsort():
    rng = np.random.default_rng(7)
    n = 4096
    for cap in (64, 1024, n):
        for key in (rng.random(n) > 0.9, rng.random(n) > 0.1,
                    np.zeros(n, bool), rng.integers(0, 3, n)):
            k = np.asarray(key, np.int32)
            want = np.argsort(k, kind="stable")[:cap]
            got = surfel_map._compact_idx(torch.from_numpy(k), cap)
            np.testing.assert_array_equal(got.numpy(), want)


def test_refit_after_rows_reconstruction_exact():
    """The refit's per-row reconstruction equals a table gather whenever it
    reports recon_exact, and reports False when the hood batch
    overflows."""
    rng = np.random.default_rng(7)
    wall = _wall(rng, 1500) * np.float32([4 / 3, 4 / 3, 1])
    blob = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
    pts = torch.from_numpy(np.concatenate([wall, blob]))
    m = _insert(pts.numpy())
    mask = torch.from_numpy(rng.random(len(pts)) > 0.2)
    slot, found = surfel_map._locate(m, voxel_coords(pts, m.res))
    use = mask & found
    t = m.table_size
    slots = torch.clamp(torch.where(use, slot, t), 0, t - 1)
    for hood_cap, window in [(None, 27), (4096, 27), (4096, 7)]:
        m2, _, after, exact = surfel_map._refit_planes(
            m, slots, use, TH, hood_cap=hood_cap, hood_window=window)
        assert bool(exact)
        assert torch.equal(after[use], m2.plane[slots][use])
    _, _, _, exact = surfel_map._refit_planes(m, slots, use, TH, hood_cap=8)
    assert not bool(exact)


def test_line_of_points_has_no_valid_plane():
    t = np.linspace(-4, 4, 3000, dtype=np.float32)
    pts = np.stack([t, 0.2 * t, np.full_like(t, 1.0)], -1)
    m = _insert(pts)
    _, _, valid = surfel_map.query_planes(
        m, torch.from_numpy(pts[::15]), torch.ones(200, dtype=torch.bool),
        window=1)
    assert valid.numpy().mean() < 0.05


def test_halo_contention_picks_best_fit_source():
    """Two perpendicular walls: unmapped voxels above wall A, away from the
    crease, inherit wall A's plane."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 1.9, (3000, 2)).astype(np.float32)
    wall_a = np.stack([xy[:, 0], xy[:, 1],
                       rng.normal(0, 0.005, 3000).astype(np.float32)], -1)
    yz = rng.uniform(0.1, 2.0, (3000, 2)).astype(np.float32)
    wall_b = np.stack([2.0 + rng.normal(0, 0.005, 3000).astype(np.float32),
                       yz[:, 0], yz[:, 1]], -1)
    m = _insert(np.concatenate([wall_a, wall_b]).astype(np.float32), res=0.4,
                table=1 << 13)
    hover = wall_a[wall_a[:, 0] < 1.2][:300] + np.float32([0, 0, 0.5])
    n, resid, valid = surfel_map.query_planes(
        m, torch.from_numpy(hover), torch.ones(300, dtype=torch.bool),
        window=1)
    v = valid.numpy()
    assert v.mean() > 0.5
    assert (np.abs(n.numpy()[v][:, 2]) > 0.9).mean() > 0.95
    assert np.abs(np.abs(resid.numpy()[v]) - 0.5).max() < 0.1


def test_insert_deterministic():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 5, (4000, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) * 0.01
    a = _insert(pts, res=0.4, hood_cap=1024)
    b = _insert(pts, res=0.4, hood_cap=1024)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# mirrors of tests/test_ieskf_units.py and tests/test_lio.py
# ---------------------------------------------------------------------------

def _propagate_once(nav, dt, gyro, acc):
    """One nominal step in float64 (mirrors propagate's step)."""
    R, p, v, bg, ba, g = nav
    w_c, a_c = gyro - bg, acc - ba
    a_w = R @ a_c + g
    Rs = se3.so3_exp(torch.tensor(w_c * dt)).double().numpy()
    return (R @ Rs, p + v * dt + 0.5 * a_w * dt * dt, v + a_w * dt, bg, ba, g)


def test_transition_jacobian_finite_difference():
    nav = (se3.so3_exp(torch.tensor([0.2, -0.1, 0.3])).double().numpy(),
           np.array([1.0, 2.0, 3.0]), np.array([0.5, -0.2, 0.1]),
           np.array([0.01, -0.02, 0.005]), np.array([0.05, 0.02, -0.03]),
           np.array([0.0, 0.0, -9.81]))
    dt, gyro, acc = 0.005, np.array([0.1, -0.3, 0.5]), np.array([0.2, 9.7, 1.0])
    F = ieskf._step_jacobians(
        torch.tensor(nav[0], dtype=torch.float32),
        torch.tensor(acc - nav[4], dtype=torch.float32),
        torch.tensor(gyro - nav[3], dtype=torch.float32),
        torch.tensor(dt, dtype=torch.float32)).numpy()
    base = _propagate_once(nav, dt, gyro, acc)

    def boxminus(a, b):
        dth = se3.so3_log(torch.tensor(b[0].T @ a[0],
                                       dtype=torch.float32)).numpy()
        return np.concatenate([dth] + [a[i] - b[i] for i in range(1, 6)])

    eps = 1e-4
    F_num = np.zeros((18, 18))
    for i in range(18):
        dx = np.zeros(18)
        dx[i] = eps
        pert = (nav[0] @ se3.so3_exp(torch.tensor(dx[0:3])).double().numpy(),
                ) + tuple(nav[k] + dx[3 * k:3 * k + 3] for k in range(1, 6))
        F_num[:, i] = boxminus(_propagate_once(pert, dt, gyro, acc),
                               base) / eps
    np.testing.assert_allclose(F, F_num, atol=5e-3)


def test_covariance_grows_without_measurements():
    nav = ieskf.identity_state("cpu")
    P0 = ieskf.init_covariance("cpu")
    k = 16
    ts = torch.arange(1, k + 1, dtype=torch.float32) * 0.005
    acc = torch.tensor([0.0, 0.0, 9.81]).repeat(k, 1)
    _, P1, _ = ieskf.propagate(nav, P0, ts, torch.zeros(k, 3), acc,
                               torch.ones(k, dtype=torch.bool),
                               torch.tensor(0.0), torch.tensor(0.085),
                               torch.from_numpy(NOISE))
    assert P1[3, 3] > P0[3, 3] and P1[6, 6] > P0[6, 6]
    np.testing.assert_allclose(P1.numpy(), P1.numpy().T, atol=1e-6)
    assert np.all(np.linalg.eigvalsh(P1.numpy()) > -1e-7)


def test_update_tightens_pose_covariance():
    """An update against a map of the true surfaces, from the true pose,
    shrinks the pose block of P and keeps the state."""
    world = sim.World.room(size=16.0, height=4.0, n_boxes=5, seed=1)
    map_pts = world.sample_points(20000, seed=2, noise=0.0)
    m = _insert(map_pts, res=0.3, table=1 << 15)
    scan = torch.from_numpy(world.sample_points(1500, seed=3, noise=0.005))
    nav = ieskf.identity_state("cpu")
    P0 = ieskf.init_covariance("cpu")
    nav1, P1, matches = ieskf.update_surfel(
        nav, P0, m, scan, torch.ones(1500, dtype=torch.bool), 0.0025,
        max_iter=3, window=3)
    assert int(matches) > 300
    assert float(torch.trace(P1[:6, :6])) < float(torch.trace(P0[:6, :6]))
    assert float(torch.linalg.norm(nav1.p - nav.p)) < 0.02
    assert float(torch.linalg.norm(se3.so3_log(nav.R.T @ nav1.R))) < 0.01


def test_deskew_continuous_at_sample_boundaries():
    k, dt = 8, 0.005
    ts = torch.arange(1, k + 1, dtype=torch.float32) * dt
    gyro = torch.from_numpy(np.stack([
        np.linspace(0.2, 2.0, k), np.linspace(-1.0, 1.0, k),
        np.linspace(0.5, -0.5, k)], -1).astype(np.float32))
    acc = torch.tensor([0.0, 0.0, 9.81]).repeat(k, 1)
    nav = ieskf.identity_state("cpu")
    P0 = torch.eye(18) * 1e-4
    s_end, _, log = ieskf.propagate(
        nav, P0, ts, gyro, acc, torch.ones(k, dtype=torch.bool),
        torch.tensor(0.0), ts[-1], torch.tensor([1e-4, 1e-3, 1e-6, 1e-6]))
    pt = torch.tensor([[10.0, 0.0, 0.0]])
    one = torch.ones(1, dtype=torch.bool)
    q = [ieskf.deskew(pt, torch.tensor([float(ts[4]) - e]), one, log, s_end,
                      torch.tensor(0.0), torch.eye(3), torch.zeros(3))
         for e in (1e-5, 0.0)]
    assert float(torch.linalg.norm(q[0] - q[1])) < 2e-4


def _pad_imu(ts, gyro, acc, cap=32):
    k = len(ts)
    t = np.zeros(cap, np.float32)
    g = np.zeros((cap, 3), np.float32)
    a = np.zeros((cap, 3), np.float32)
    m = np.zeros(cap, bool)
    t[:k], g[:k], a[:k], m[:k] = ts, gyro, acc, True
    return _t(t, g, a, m)


def test_imu_propagation_tracks_truth():
    traj = sim.Trajectory.loop(radius=7.0, period=30.0)
    t0, t1 = 2.0, 2.1
    ts, gyro, acc = sim.simulate_imu(traj, t0, t1, rate=200.0)
    T0 = traj.pose(t0)
    v0, _, _ = traj.derivatives(t0)
    nav = ieskf.identity_state("cpu")._replace(
        R=torch.tensor(T0[:3, :3], dtype=torch.float32),
        p=torch.tensor(T0[:3, 3], dtype=torch.float32),
        v=torch.tensor(v0, dtype=torch.float32))
    nav1, P1, _ = ieskf.propagate(
        nav, ieskf.init_covariance("cpu"), *_pad_imu(ts, gyro, acc),
        torch.tensor(t0), torch.tensor(t1), torch.from_numpy(NOISE))
    T1 = traj.pose(t1)
    np.testing.assert_allclose(nav1.p.numpy(), T1[:3, 3], atol=2e-3)
    err = se3.so3_log(torch.tensor(T1[:3, :3].T, dtype=torch.float32)
                      @ nav1.R)
    assert float(torch.linalg.norm(err)) < 2e-3
    assert float(torch.trace(P1)) > float(torch.trace(
        ieskf.init_covariance("cpu")))


def _surface_distance(world, pts_w):
    best = np.full(len(pts_w), np.inf)
    for (o, u, v) in world.surfaces:
        n = np.cross(u, v)
        n = n / np.linalg.norm(n)
        rel = pts_w - o[None]
        dist = np.abs(rel @ n)
        a = (rel @ u) / (u @ u)
        b = (rel @ v) / (v @ v)
        inside = (a >= -0.01) & (a <= 1.01) & (b >= -0.01) & (b <= 1.01)
        best = np.where(inside & (dist < best), dist, best)
    return best


def test_deskew_puts_points_back_on_surfaces():
    world = sim.World.room(size=20.0, height=5.0, n_boxes=4, seed=1)
    traj = sim.Trajectory.straight(speed=3.0)
    t0, period = 1.0, 0.1
    pts_skew, rel_t = sim.simulate_scan_swept(
        world, traj, t0, n_points=2048, noise=0.0, seed=2, scan_period=period)
    ts, gyro, acc = sim.simulate_imu(traj, t0, t0 + period, rate=200.0)
    T0 = traj.pose(t0)
    v0, _, _ = traj.derivatives(t0)
    nav = ieskf.identity_state("cpu")._replace(
        R=torch.tensor(T0[:3, :3], dtype=torch.float32),
        p=torch.tensor(T0[:3, 3], dtype=torch.float32),
        v=torch.tensor(v0, dtype=torch.float32))
    nav1, _, log = ieskf.propagate(
        nav, ieskf.init_covariance("cpu"), *_pad_imu(ts, gyro, acc),
        torch.tensor(t0), torch.tensor(t0 + period), torch.from_numpy(NOISE))
    pj, mask = sim.pad_cloud(pts_skew, 2048)
    body = ieskf.deskew(*_t(pj, rel_t, mask), log, nav1, torch.tensor(t0),
                        torch.eye(3), torch.zeros(3)).numpy()
    T_end = traj.pose(t0 + period)
    w_skew = pts_skew[mask] @ T_end[:3, :3].T + T_end[:3, 3]
    w_desk = body[mask] @ T_end[:3, :3].T + T_end[:3, 3]
    d_skew = _surface_distance(world, w_skew)
    d_desk = _surface_distance(world, w_desk)
    fin = np.isfinite(d_skew) & np.isfinite(d_desk)
    assert d_desk[fin].mean() < 0.2 * d_skew[fin].mean()
    assert d_desk[fin].mean() < 0.02
