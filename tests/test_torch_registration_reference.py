"""The port's registration stages held to the benchmark's plain float64
reference (``slam_bench/reference/registration.py``) on the CPU, each
stage from the port's own inputs to it (captured by the benchmark's
``revisit.RegProbe``), on a batched registration of two drifted room scans
against a third (tests/test_torch_loop_anchor.py's store), 1,000 m from
the origin, in the lanes' anchored frames:

- the radius FPFH (``fpfh_stream.fpfh_radius``): the rows valid on
  either side whose descriptors are off (``check_loop.fpfh_share``: valid
  on one side only or over 30 apart in L1 of 300) are under 15 % of the
  cloud (float32 normals and radius-edge neighbours; the unanchored
  cloud at 1,000 m reads over 90 %), and the validity flags agree on 99 %;
- mutual matching (``quatro.match_features``) on the port's descriptors:
  at least 95 % of the port's matches are the reference's;
- Quatro (``quatro.solve``) on the port's matches: within 1e-4 m and
  1e-5 rad;
- the plane covariances GICP is given (from the radius moments, the
  source's rotated by the coarse rotation): under 10 % of the rows either
  side keeps differ from the reference's by over 0.1 in Frobenius norm (a
  regularized plane's normal turned; near-collinear neighbourhoods, such
  as one scan line's points, leave it to the rounding);
- GICP (``gicp.align_batched``) from the port's coarse-aligned source and
  the covariances it was given: within 1 mm and 1e-4 rad, judged at the
  source's centroid.  (From the reference's own covariances the two
  converge up to 3 cm / 0.011 rad apart on this small room scene: those
  few turned planes move its optimum.)"""
import numpy as np
import pytest
import torch

import test_torch_loop_anchor as anchor_test
from fast_lio_sam_qn_tpu_torch.models import loop_closure
from fast_lio_sam_qn_tpu_torch.ops import fpfh, fpfh_stream
from slam_bench import check_loop, revisit
from slam_bench.reference import registration as R

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cap():
    """One captured registration: lanes 1 and 2 against keyframe 0."""
    st = anchor_test._store(anchor_test.FAR)
    probe = revisit.RegProbe(seed=1, k=1)
    lc = loop_closure.LoopClosure(anchor_test._cfg(), anchor_test.CAP,
                                  anchor_test.CAP)
    with probe.wraps():
        probe.on = True
        reg = lc.perform_loop_closure_batch(st, [1, 2], [0, 0])
    assert reg.is_valid.tolist() == [True, True]
    anchor = loop_closure.anchor_of(st.poses_corrected[[0, 0], :3, 3])
    return probe.kept[0], anchor


def test_fpfh_against_the_reference(cap):
    cap, anchor = cap
    qc = anchor_test._cfg().quatro
    radii = (qc.fpfh_normal_radius, qc.fpfh_radius, qc.fpfh_cov_radius)
    for pts, mask, vp, desc, valid in cap["fpfh"]:
        for b in cap["lanes"]:
            want = R.fpfh(pts[b].double(), mask[b], vp[b].double(), *radii)
            share = check_loop.fpfh_share(desc[b], valid[b], want[0],
                                          want[1])
            agree = float((valid[b] == want[1]).double().mean())
            far = fpfh_stream.fpfh_radius(
                pts[b] + anchor[b], mask[b], *radii[:2], vp[b] + anchor[b],
                cov_radius=radii[2])
            unanchored = check_loop.fpfh_share(far[0], far[1], want[0],
                                               want[1])
            print(f"lane {b}: fpfh share {share:.4f} (unanchored "
                  f"{unanchored:.4f}), valid flags agree {agree:.4f}")
            assert share < 0.15 and agree > 0.99
            assert unanchored > 0.9


def test_matching_and_quatro_against_the_reference(cap):
    cap, _ = cap
    qc = anchor_test._cfg().quatro
    (ps, ms, _, ds, vs), (pd, md, _, dd, vd) = cap["fpfh"]
    for b in cap["lanes"]:
        fs = fpfh.distinctive(ds[b], vs[b], qc.planarity_threshold)
        fd = fpfh.distinctive(dd[b], vd[b], qc.planarity_threshold)
        ws, wd, wok = R.match(ps[b].double(), ds[b].double(), fs,
                              pd[b].double(), dd[b].double(), fd,
                              qc.distance_threshold, qc.max_num_corres)
        s, d, ok = (x[b] for x in cap["match"])

        def rows(a, c, m):
            return {tuple(np.round(torch.cat([x, y]).double().numpy(), 4))
                    for x, y in zip(a[m], c[m])}
        got, want = rows(s, d, ok), rows(ws, wd, wok)
        print(f"lane {b}: {len(got)} matches, {len(got & want)} shared")
        assert len(got) >= 20 and len(got & want) >= 0.95 * len(got)
        T = R.quatro(s.double(), d.double(), ok, qc.noise_bound,
                     qc.rot_gnc_factor, qc.rot_cost_diff_thr,
                     qc.rot_max_iter)[0]
        t, r = check_loop.transform_gap(cap["solve"][b], T,
                                        check_loop.centroid(s, ok))
        print(f"lane {b}: quatro gap {t:.3e} m / {r:.3e} rad")
        assert t < 1e-4 and r < 1e-5


def test_gicp_against_the_reference(cap):
    cap, _ = cap
    lc = anchor_test._cfg()
    qc, gc = lc.quatro, lc.gicp
    cfgj = {"pipeline": {"loop": {"gicp": {
        "max_iter": gc.max_iter, "max_corr_dist": gc.max_corr_dist,
        "transformation_epsilon": gc.transformation_epsilon}}}}
    src, src_mask, dst, dst_mask, T = cap["gicp"]
    zero = torch.zeros(3, dtype=torch.float64)
    for b in cap["lanes"]:
        s_cov, s_ok, d_cov, d_ok = (x[b] for x in cap["gicp_cov"])
        for side, pts, mask, cov, ok in (
                ("src", src, src_mask, s_cov, s_ok),
                ("dst", dst, dst_mask, d_cov, d_ok)):
            _, own_ok, own, _ = R.surface(
                pts[b].double(), mask[b], zero, qc.fpfh_normal_radius,
                qc.fpfh_cov_radius)
            both = mask[b] & ok & own_ok
            turned = float(((cov.double() - own).flatten(1).norm(dim=1)
                            > 0.1)[both].double().mean())
            print(f"lane {b} {side}: {turned:.4f} of {int(both.sum())} "
                  "covariances turned")
            assert turned < 0.1
        want = check_loop.reference_gicp(
            cfgj, src[b], src_mask[b] & s_ok, s_cov, dst[b],
            dst_mask[b] & d_ok, d_cov)
        t, r = check_loop.transform_gap(
            T[b], want, check_loop.centroid(src[b], src_mask[b]))
        print(f"lane {b}: gicp gap {t:.3e} m / {r:.3e} rad")
        assert t < 1e-3 and r < 1e-4
