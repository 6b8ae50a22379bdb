"""The port's long run (tools/longrun.py) and pose-graph profiler
(tools/profile_pgo.py) held against the JAX package's.

A prefix of the long course (PREFIX scans, the keyframe store cut to 8 so
that it doubles) through both packages.  The LIO streams: every pose
within 1e-4 m over the first CALM scans, within 1 cm over the prefix (the
two filters' fp32 rounding differs; at scan 34 of this course one scan's
plane matches part and the gap reaches 3.0e-3 m before it settles near
2e-4 m: tests/test_torch_lio.py's golden twin allows the same 1 cm).  The
pipelines, fed the same LIO stream (the JAX package's): equal keyframe
stamps and loop events, corrected keyframe poses within 1e-4 m, the store
doubled.  The full 1,600-scan CPU twin of the golden
(tests/test_golden_longrun.py's pins through the port) is marked slow, as
is the trace of its loop decisions against the JAX package's on one LIO
stream.  profile_pgo's convergence check runs at 128 nodes.

The JAX side is cached with conftest.deterministic_cache."""
import dataclasses

import numpy as np
import pytest
import torch

from fast_lio_sam_qn_tpu_torch.tools import longrun, profile_pgo
from fast_lio_sam_qn_tpu_torch.utils.config import Capacities

torch.set_num_threads(1)

PREFIX, CALM = 60, 30
CAPS = dict(max_keyframes=8, max_loop_factors=8, keyframe_points=2048,
            src_points=2048, dst_points=4096)


def _jax_prefix():
    """The JAX package's LIO stream and pipeline over the prefix: (the
    stream's items as numpy, keyframe stamps, corrected keyframe poses,
    store capacity, loop events)."""
    from conftest import deterministic_cache

    def build():
        from fast_lio_sam_qn_tpu.models.pipeline import FastLioSamQnPipeline
        from fast_lio_sam_qn_tpu.tools import longrun as jlongrun
        from fast_lio_sam_qn_tpu.utils.config import Capacities as JCaps

        import jax.numpy as jnp

        cfg = jlongrun.longrun_config()
        cfg.caps = JCaps(**CAPS)
        pipe = FastLioSamQnPipeline(cfg)
        items = list(jlongrun.longrun_feed(cfg, PREFIX))
        for pose, cloud, mask, t1, _ in items:
            pipe.feed(jnp.asarray(pose), jnp.asarray(cloud),
                      jnp.asarray(mask), float(t1))
        _, corrected = pipe.get_trajectories()
        return (items, list(pipe.kf_timestamps), np.asarray(corrected),
                int(pipe.store.capacity),
                [tuple(e) for e in pipe.loop_events])

    return deterministic_cache("torch_longrun_prefix", (PREFIX, CAPS),
                               build, extra_files=(__file__,))


def _cfg():
    cfg = longrun.longrun_config()
    cfg.caps = Capacities(**CAPS)
    return cfg


def test_longrun_config_matches_jax():
    from fast_lio_sam_qn_tpu.tools import longrun as jlongrun

    got, want = longrun.longrun_config(), jlongrun.longrun_config()
    assert dataclasses.asdict(got.lio) == dataclasses.asdict(want.lio)
    assert dataclasses.asdict(got.caps) == dataclasses.asdict(want.caps)
    assert got.loop_update_hz == want.loop_update_hz == 0.5
    assert (longrun.N_SCANS, longrun.SCAN_HZ, longrun.RADIUS,
            longrun.SPEED, longrun.WORLD_SIZE) == (
        jlongrun.N_SCANS, jlongrun.SCAN_HZ, jlongrun.RADIUS,
        jlongrun.SPEED, jlongrun.WORLD_SIZE)


def test_longrun_prefix_stream_matches_jax():
    items = _jax_prefix()[0]
    gaps = np.asarray([
        np.linalg.norm(item[0].numpy()[:3, 3] - w[0][:3, 3])
        for item, w in zip(longrun.longrun_feed(_cfg(), PREFIX,
                                                device="cpu"), items)])
    print(f"LIO gap: {gaps[:CALM].max():.3e} m over the first {CALM} "
          f"scans, {gaps.max():.3e} m over {PREFIX}")
    assert len(gaps) == PREFIX
    assert gaps[:CALM].max() < 1e-4 and gaps.max() < 1e-2


def test_longrun_prefix_pipeline_matches_jax():
    items, w_stamps, w_corr, w_cap, w_events = _jax_prefix()
    feed = ((torch.tensor(p), torch.tensor(c), torch.tensor(m), t1, gt)
            for p, c, m, t1, gt in items)
    pipe, gt_kf = longrun.run_pipeline(_cfg(), feed, device="cpu")
    assert pipe.kf_timestamps == w_stamps
    assert len(w_stamps) > CAPS["max_keyframes"]     # the store doubled
    assert pipe.store.capacity == w_cap == 2 * CAPS["max_keyframes"]
    assert [tuple(e) for e in pipe.loop_events] == w_events
    _, corrected = pipe.get_trajectories()
    assert np.abs(corrected[:, :3, 3] - w_corr[:, :3, 3]).max() < 1e-4
    assert gt_kf.shape == corrected.shape


def test_profile_pgo_converges_at_128_nodes():
    """tools/profile_pgo.py's check: 20 chained solves cut the ATE of the
    128-node drifted circle below 0.6 of the cold initial's, at 2 and 5
    Gauss-Newton steps."""
    for gn in (2, 5):
        ate0, ate1 = profile_pgo.converges(128, gn, "cpu")
        assert ate1 < 0.6 * ate0, (gn, ate0, ate1)
    rows = profile_pgo.profile([128], 1, torch.device("cpu"))
    assert [r["gn_iters"] for r in rows] == [2, 5]
    assert all(r["cold_ms"] > 0 and r["warm_ms"] > 0 for r in rows)


@pytest.mark.slow
def test_longrun_golden_twin_on_cpu():
    """The full 1,600-scan long run through the port on the CPU holds
    every pin of tests/test_golden_longrun.py.  Its loop decisions turn on
    fp summation order (PERF.md's long-run trace: the commit count moves
    with torch's thread count), so this runs at this module's one thread."""
    cfg = longrun.longrun_config()
    summary = longrun.replay(cfg, longrun.longrun_feed(cfg, device="cpu"),
                             device="cpu")
    print(summary)
    assert longrun.check_golden(summary) == [], summary


def _hooked(pipe, query, to_numpy, got, name):
    """Record (as numpy) the keyframe store ``pipe``'s tick registers
    query keyframe ``query`` against."""
    lc = pipe.loop_closure
    orig = lc.fetch_and_perform

    def hook(store, q):
        if int(q) == query and name not in got:
            got[name] = [to_numpy(x) for x in store]
        return orig(store, q)

    lc.fetch_and_perform = hook


@pytest.mark.slow
def test_longrun_decisions_follow_rounding():
    """The trace behind PERF.md's note on the long run's commits: both
    packages' pipelines on the JAX package's LIO stream (so on equal
    inputs, but for each PGO's rounding), then, at the first event whose
    decision parts, both packages' registration on the JAX pipeline's own
    keyframe store: there the decisions are equal, so the parting comes
    from the poses' fp rounding, which the stream FPFH's raw moments far
    from the origin amplify, and not from the port's registration."""
    import jax.numpy as jnp
    from conftest import deterministic_cache
    from fast_lio_sam_qn_tpu.models import keyframes as jkf
    from fast_lio_sam_qn_tpu.models import loop_closure as jlc
    from fast_lio_sam_qn_tpu.models.pipeline import \
        FastLioSamQnPipeline as JPipe
    from fast_lio_sam_qn_tpu.tools import longrun as jlongrun
    from fast_lio_sam_qn_tpu_torch import convert
    from fast_lio_sam_qn_tpu_torch.models import loop_closure as tlc
    from fast_lio_sam_qn_tpu_torch.models.pipeline import \
        FastLioSamQnPipeline as TPipe

    def events(pipe):
        return [(e.query_idx, e.closest_idx, bool(e.accepted))
                for e in pipe.loop_events]

    def build():
        cfg = jlongrun.longrun_config()
        items = list(jlongrun.longrun_feed(cfg))
        pipe = JPipe(cfg)
        for pose, cloud, mask, t1, _ in items:
            pipe.feed(jnp.asarray(pose), jnp.asarray(cloud),
                      jnp.asarray(mask), float(t1))
        return items, events(pipe), len(pipe.loop_idx_pairs)

    items, want, want_commits = deterministic_cache(
        "torch_longrun_jax_full", (longrun.N_SCANS,), build,
        extra_files=(__file__,))

    def port_feed():
        return ((torch.tensor(p), torch.tensor(c), torch.tensor(m), t1, gt)
                for p, c, m, t1, gt in items)

    pipe, _ = longrun.run_pipeline(longrun.longrun_config(), port_feed(),
                                   device="cpu")
    got = events(pipe)
    print(f"JAX stream: JAX pipeline {sum(e[2] for e in want)} accepted, "
          f"{want_commits} committed; port pipeline "
          f"{sum(e[2] for e in got)} accepted, {len(pipe.loop_idx_pairs)} "
          f"committed")
    assert len(got) == len(want) == 64
    parted = [w for g, w in zip(got, want) if g != w]
    assert parted, "the pipelines agree on every event"
    query = parted[0][0]

    jcfg = jlongrun.longrun_config()
    jpipe, stores = JPipe(jcfg), {}
    _hooked(jpipe, query, np.asarray, stores, "jax")
    for pose, cloud, mask, t1, _ in items:
        jpipe.feed(jnp.asarray(pose), jnp.asarray(cloud), jnp.asarray(mask),
                   float(t1))
        if stores:
            break
    jstore = jkf.KeyframeStore(*map(jnp.asarray, stores["jax"]))
    tstore = convert.keyframe_store_from_numpy(*stores["jax"], device="cpu")
    caps, tcfg = jcfg.caps, longrun.longrun_config()
    wreg, _ = jlc.LoopClosure(jcfg.loop, caps.src_points,
                              caps.dst_points).fetch_and_perform(jstore,
                                                                 query)
    greg, _ = tlc.LoopClosure(tcfg.loop, caps.src_points,
                              caps.dst_points).fetch_and_perform(tstore,
                                                                 query)
    print(f"query {query} on the JAX store: JAX {float(wreg.score):.4f} "
          f"valid={bool(wreg.is_valid)}, port {float(greg.score):.4f} "
          f"valid={bool(greg.is_valid)}")
    assert int(greg.closest_idx) == int(wreg.closest_idx)
    assert bool(greg.is_valid) == bool(wreg.is_valid)
