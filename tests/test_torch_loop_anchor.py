"""Registration far from the world origin: the same keyframe pair
registered near the origin and with the whole scene moved 1,000 m away,
through the single-candidate tick and through a batched registration,
must give the same graph measurement.

Each lane registers in a frame anchored near its clouds
(``loop_closure.anchor_of``); without it the radius features' float32
d^2 = |q|^2 - 2 q.p + |p|^2 and raw second moments cancel at 1,000 m and
the registration changes basin.  Tolerance: 2 cm and 5e-3 rad between the
two measurements, the loop-closure tests' tolerance between two
implementations (anchored, the far clouds are the near ones moved by a
few whole metres plus their float32 rounding at 1,000 m, ~6e-5 m, and
GICP stops once a step is below 0.01).  The near pair itself recovers the
drift within 6 cm / 0.01 rad, the loop-closure test's gate.  Without the
anchor the far registrations miss by 4.5-9.2 cm and 5.8e-3-1.6e-2 rad."""
import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu_torch.models import keyframes as kf
from fast_lio_sam_qn_tpu_torch.models import loop_closure
from fast_lio_sam_qn_tpu_torch.ops import se3
from fast_lio_sam_qn_tpu_torch.utils import config as tconfig
from fast_lio_sam_qn_tpu_torch.utils import sim

torch.set_num_threads(1)

N_RAYS, CAP = 4096, 1536
FAR = np.array([1000.0, -600.0, 0.0])     # 1,166 m from the origin
TOL_M, TOL_RAD = 0.02, 5e-3


def _frames():
    """tests/test_torch_loop_closure.py's scan pair and a third drifted
    scan: (body cloud, mask, pose, corrected pose, time), float64 poses."""
    world = sim.World.room(size=16.0, height=5.0, n_boxes=12, seed=6)
    out = []
    for seed, yaw, xyz, twist, t in (
            (2, 0.5, (4.0, -3.0, 1.5), None, 0.0),
            (1, 0.0, (2.0, -1.5, 1.5), (0.0, 0.0, 0.15, 1.5, -1.0, 0.1),
             100.0),
            (3, 0.3, (3.0, -2.0, 1.5), (0.0, 0.0, -0.1, -1.0, 0.8, 0.0),
             110.0)):
        T = np.eye(4)
        T[:3, :3] = sim.so3_exp_np(np.array([0.0, 0.0, yaw]))
        T[:3, 3] = xyz
        scan, _ = sim.simulate_scan(world, T, n_points=N_RAYS, noise=0.01,
                                    seed=seed)
        p, m = sim.pad_cloud(scan, N_RAYS)
        Tc = T if twist is None else se3.se3_exp(torch.tensor(
            twist, dtype=torch.float32)).double().numpy() @ T
        out.append((p, m, T, Tc, t))
    return out


def _store(shift):
    """The frames' store with every pose moved by ``shift`` (3,)."""
    S = np.eye(4)
    S[:3, 3] = shift
    st = kf.empty_store(4, N_RAYS, "cpu")
    for p, m, T, Tc, t in _frames():
        st = kf.append(st, torch.from_numpy(p), torch.from_numpy(m),
                       torch.from_numpy((S @ T).astype(np.float32)),
                       torch.from_numpy((S @ Tc).astype(np.float32)), t)
    return st


def _cfg():
    cfg = tconfig.LoopClosureConfig()
    cfg.quatro.planarity_threshold = 65.0
    return cfg


def _meas(store, reg, q, c):
    """The graph measurement of a registration (fetch_and_perform's)."""
    pose_from = se3.compose(reg.pose_between, store.poses_corrected[q])
    return se3.pose_between(pose_from, store.poses_corrected[c])


def _gap(a, b):
    d = se3.se3_log(torch.linalg.inv(a.double()) @ b.double())
    return float(d[3:].norm()), float(d[:3].norm())


def _truth(q):
    """The measurement a perfect registration of query q against 0 gives:
    the true relative pose T_q^-1 T_0."""
    fr = _frames()
    return torch.from_numpy(np.linalg.inv(fr[q][2]) @ fr[0][2])


def test_anchor_is_a_multiple_of_the_grid_and_zero_near_the_origin():
    pos = torch.tensor([[1000.0, -600.0, 1.5], [20.0, -63.0, 1.5],
                        [-52.0, 26.0, 0.0]])
    a = loop_closure.anchor_of(pos)
    assert torch.equal(a[1:], torch.zeros(2, 3))
    assert not torch.signbit(a[1:]).any()      # +0, never -0
    assert torch.equal(a[0], torch.round(pos[0]))
    assert float((pos[0] - a[0]).abs().max()) <= 0.5
    # one coordinate past ANCHOR_NEAR moves the whole lane's anchor
    edge = torch.tensor([[10.4, loop_closure.ANCHOR_NEAR + 0.3, -2.6]])
    assert torch.equal(loop_closure.anchor_of(edge),
                       torch.tensor([[10.0, 64.0, -3.0]]))
    T = se3.make_pose(se3.so3_exp(torch.tensor([0.0, 0.0, 0.3])),
                      torch.tensor([0.5, -0.25, 0.1]))[None]
    assert torch.equal(loop_closure.unanchor(T, torch.zeros(1, 3)), T)
    A = torch.eye(4, dtype=torch.float64)
    A[:3, 3] = a[0].double()
    want = A @ T[0].double() @ torch.linalg.inv(A)
    torch.testing.assert_close(loop_closure.unanchor(T, a[:1])[0].double(),
                               want, atol=1e-4, rtol=0)


def test_single_tick_far_from_the_origin():
    near, far = _store(np.zeros(3)), _store(FAR)
    out = []
    for st in (near, far):
        reg, meas = loop_closure.LoopClosure(
            _cfg(), CAP, CAP).fetch_and_perform(st, 1)
        assert int(reg.closest_idx) == 0 and bool(reg.is_valid)
        out.append(meas)
    t_err, r_err = _gap(out[0], _truth(1))
    assert t_err < 0.06 and r_err < 0.01, (t_err, r_err)
    gap = _gap(out[0], out[1])
    print(f"single tick, near vs far: {gap[0]:.3e} m / {gap[1]:.3e} rad")
    assert gap[0] < TOL_M and gap[1] < TOL_RAD, gap


@pytest.mark.parametrize("shift", [np.zeros(3), FAR], ids=["near", "far"])
def test_batched_lanes_match_the_single_tick(shift):
    """Two lanes and a pad lane: each lane's measurement against the near
    single tick's, near and 1,000 m away."""
    st = _store(shift)
    ref = _store(np.zeros(3))
    lc = loop_closure.LoopClosure(_cfg(), CAP, CAP)
    reg = lc.perform_loop_closure_batch(st, [1, 2, 0], [0, 0, -1])
    assert reg.closest_idx.tolist() == [0, 0, -1]
    assert reg.is_valid.tolist() == [True, True, False]
    for b, q in enumerate((1, 2)):
        one = lc.perform_loop_closure(ref, q, 0)
        want = _meas(ref, one, q, 0)
        got = _meas(st, loop_closure.RegistrationOutput(
            *(f[b] for f in reg)), q, 0)
        gap = _gap(want, got)
        print(f"lane {b} ({'far' if shift.any() else 'near'}) vs the near "
              f"single tick: {gap[0]:.3e} m / {gap[1]:.3e} rad")
        assert gap[0] < TOL_M and gap[1] < TOL_RAD, (b, gap)
