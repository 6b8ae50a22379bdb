"""Mid-run checkpoint / resume of the whole SLAM state — the port's own
module, after the JAX package's ``utils/checkpoint.py``.

The reference has output-only persistence (SURVEY §5); the JAX package
added a mid-run resume (``run.py --kitti --resume``), and the port keeps
it: the pipeline (keyframe store, pose graph, scheduler) and the LIO filter
(nav state, covariance, map, scan counters) are restored and the run
continues at the saved scan index.

Format: one compressed npz.

- ``schema``: the format's version (``SCHEMA``);
- ``host_json``: the JAX module's host block (scheduler scalars, loop
  events, pending loops, ``extra``) as UTF-8 JSON bytes;
- ``store_*``, ``graph_*``, ``last_*``, ``odom_delta``, ``realtime_poses``,
  ``odom_poses``: the JAX module's arrays under its keys;
- ``lio.<name>``: the LIO state under named keys in its fields' order
  (``lio.nav.R`` ... ``lio.grid.<field>``, ``lio.grid.res`` ...
  ``lio.ext.t``) and the host scan counter ``lio.scans``.

``load_checkpoint`` also reads a file written by the JAX package's
``save_checkpoint``: no ``schema`` key, the LIO state as ``lio_leaf_i`` in
``jax.tree.leaves`` order (a file from before the extrinsic leaves has two
fewer: they come from the template), carried over through ``convert.py``.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .. import convert
from ..models.pipeline import LoopEvent

SCHEMA = 1


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaf(x) -> np.ndarray:
    """A LIO leaf in the JAX package's dtypes: float32, int32 or bool."""
    a = _np(x)
    if a.dtype == np.bool_:
        return a
    return a.astype(np.int32 if np.issubdtype(a.dtype, np.integer)
                    else np.float32)


def lio_leaves(state) -> list:
    """(name, value) of every leaf of a LioState in its fields' order — the
    JAX package's ``jax.tree.leaves`` order of its own LioState."""
    out = [(f"nav.{k}", v) for k, v in zip(state.nav._fields, state.nav)]
    out.append(("P", state.P))
    out += [(f"grid.{k}", v) for k, v in zip(state.grid._fields, state.grid)]
    out += [("t", state.t), ("num_scans", state.num_scans),
            ("num_matches", state.num_matches)]
    out += [(f"ext.{k}", v) for k, v in zip(state.ext._fields, state.ext)]
    return out


def _host_block(pipeline, extra) -> dict:
    return {
        "initialized": pipeline.initialized,
        "current_kf_idx": pipeline.current_kf_idx,
        "loop_added_flag": pipeline.loop_added_flag,
        "latest_kf_processed": pipeline.latest_kf_processed,
        "kf_processed": pipeline._kf_processed,
        "next_loop_tick": pipeline._next_loop_tick,
        "loop_idx_pairs": pipeline.loop_idx_pairs,
        "kf_timestamps": pipeline.kf_timestamps,
        "loop_events": [
            (e.tick_time, e.query_idx, e.closest_idx, e.score, e.accepted)
            for e in pipeline.loop_events],
        "pending_loops": [
            {"query_idx": p["query_idx"], "closest_idx": p["closest_idx"],
             "meas": _np(p["meas"]).tolist(), "score": float(p["score"]),
             "corr": _np(p["corr"]).tolist(),
             "rot": _np(p["rot"]).tolist(), "committed": p["committed"]}
            for p in pipeline._pending_loops],
        "extra": extra or {},
        "schema": SCHEMA,
    }


def _pose_list(poses) -> np.ndarray:
    if not poses:
        return np.zeros((0, 4, 4), np.float32)
    return np.stack([_np(p) for p in poses]).astype(np.float32)


def save_checkpoint(pipeline, path: str, lio_state=None, extra=None):
    """Write the pipeline's state (and the LIO's, when given) to ``path``;
    ``extra`` (a JSON-able dict, e.g. ``{"scan_index": i}``) rides along."""
    st, g = pipeline.store, pipeline.graph
    lio = {}
    if lio_state is not None:
        lio = {f"lio.{k}": _leaf(v) for k, v in lio_leaves(lio_state)}
        lio["lio.scans"] = np.int64(lio_state.scans)
    host = json.dumps(_host_block(pipeline, extra)).encode()
    np.savez_compressed(
        path, schema=np.int32(SCHEMA), **lio,
        host_json=np.frombuffer(host, dtype=np.uint8),
        **{f"store_{k}": _np(v) for k, v in zip(st._fields, st)},
        **{f"graph_{k}": _np(v) for k, v in zip(g._fields, g)},
        last_odom_pose=_np(pipeline.last_odom_pose),
        odom_delta=_np(pipeline.odom_delta),
        last_corrected_pose=_np(pipeline.last_corrected_pose),
        last_kf_corrected=_np(pipeline.last_kf_corrected),
        realtime_poses=_pose_list(pipeline.realtime_poses),
        odom_poses=_pose_list(pipeline.odom_poses))


def _restore_pipeline(pipeline, z, host):
    dev = pipeline.device
    intens = z["store_intensities"] if "store_intensities" in z.files \
        else np.zeros(z["store_cloud_masks"].shape, np.float32)
    pipeline.store = convert.keyframe_store_from_numpy(
        z["store_clouds"], z["store_cloud_masks"], intens, z["store_poses"],
        z["store_poses_corrected"], z["store_timestamps"], z["store_count"],
        device=dev)
    pipeline.graph = convert.graph_state_from_numpy(
        *(z[f"graph_{k}"] for k in (
            "poses", "num_nodes", "prior_pose", "odom_meas", "loop_i",
            "loop_j", "loop_meas", "loop_var", "num_loops")), device=dev)
    pipeline.initialized = host["initialized"]
    pipeline.current_kf_idx = host["current_kf_idx"]
    pipeline.loop_added_flag = host["loop_added_flag"]
    pipeline.latest_kf_processed = host["latest_kf_processed"]
    pipeline._kf_processed = list(host.get(
        "kf_processed", [True] * host["current_kf_idx"]))
    pipeline._next_loop_tick = host["next_loop_tick"]
    pipeline.loop_idx_pairs = [tuple(p) for p in host["loop_idx_pairs"]]
    pipeline.kf_timestamps = host["kf_timestamps"]
    pipeline.loop_events = [LoopEvent(*e) for e in host["loop_events"]]
    # pending loops of files from before the frozen measurement cannot be
    # replayed faithfully: dropped, as the JAX module drops them
    pipeline._pending_loops = [
        {"query_idx": p["query_idx"], "closest_idx": p["closest_idx"],
         "meas": np.asarray(p["meas"], np.float32),
         "score": float(np.float32(p["score"])),
         "corr": np.asarray(p["corr"], np.float32),
         # files from before the rotation was kept: the identity (the
         # comparison of the translations alone)
         "rot": np.asarray(p.get("rot", np.eye(3)), np.float32),
         "committed": p["committed"]}
        for p in host.get("pending_loops", []) if "meas" in p]
    for k in ("last_odom_pose", "odom_delta", "last_corrected_pose",
              "last_kf_corrected"):
        setattr(pipeline, k, torch.tensor(z[k], dtype=torch.float32,
                                          device=dev))
    pipeline.realtime_poses = list(z["realtime_poses"].astype(np.float32))
    pipeline.odom_poses = list(torch.tensor(
        z["odom_poses"], dtype=torch.float32, device=dev))


def _saved_leaves(z, template) -> list:
    """The saved LIO leaves as numpy arrays in the template's order, shape
    checked against it, with the error the JAX module raises on a config
    mismatch.  [] when the file holds no LIO state."""
    names = [k for k, _ in lio_leaves(template)]
    tmpl = [v for _, v in lio_leaves(template)]
    if "schema" in z.files:
        if not any(k.startswith("lio.") for k in z.files):
            return []
        missing = [k for k in names if f"lio.{k}" not in z.files]
        if missing:
            raise ValueError(
                f"LIO checkpoint layout mismatch (no {missing} in the file): "
                "the checkpoint was saved with a different config/map "
                "backend")
        leaves = [z[f"lio.{k}"] for k in names]
        labels = names
    else:
        n = len([k for k in z.files if k.startswith("lio_leaf_")])
        if n == 0:
            return []
        leaves = [z[f"lio_leaf_{i}"] for i in range(n)]
        if len(tmpl) == n + 2:
            # a file from before the extrinsic leaves (appended last): the
            # configured extrinsic, what the old filter was using
            leaves += [_np(t) for t in tmpl[-2:]]
        labels = list(range(len(leaves)))
    for label, t, leaf in zip(labels, tmpl, leaves):
        ts = tuple(t.shape) if isinstance(t, torch.Tensor) else ()
        if ts != tuple(np.shape(leaf)):
            raise ValueError(
                f"LIO checkpoint leaf {label} has shape "
                f"{tuple(np.shape(leaf))} but the config expects {ts}: the "
                "checkpoint was saved with a different config (e.g. "
                "extrinsic_est_en or capacity changed) — resume with the "
                "saving config")
    if len(tmpl) != len(leaves):
        raise ValueError(
            f"LIO checkpoint layout mismatch ({len(leaves)} saved leaves vs "
            f"{len(tmpl)} in the template): the checkpoint was saved with a "
            "different config/map backend")
    return leaves


def load_checkpoint(pipeline, path: str, lio_template=None):
    """Restore a checkpoint of either package into an already-built
    pipeline on its device.  Returns the pipeline; with ``lio_template`` (a
    LioState of the saving config, from ``LIO.init_state``), returns
    (pipeline, lio_state or None, extra).  A file that does not fit the
    template raises before the pipeline is touched."""
    z = np.load(path)
    host = json.loads(bytes(z["host_json"]).decode())
    if host.get("schema", SCHEMA) > SCHEMA:
        raise ValueError(f"{path}: checkpoint schema {host['schema']} is "
                         f"newer than this package's {SCHEMA}")
    leaves = [] if lio_template is None else _saved_leaves(z, lio_template)
    _restore_pipeline(pipeline, z, host)
    if lio_template is None:
        return pipeline
    extra = host.get("extra", {})
    if not leaves:
        return pipeline, None, extra
    n_grid = len(lio_template.grid)
    nav, rest = leaves[:6], leaves[6:]
    P, grid, rest = rest[0], rest[1:1 + n_grid], rest[1 + n_grid:]
    t, num_scans, num_matches, ext = rest[0], rest[1], rest[2], rest[3:]
    grid = [*grid[:-1], float(grid[-1])]
    state = convert.lio_state_from_numpy(
        nav, P, grid, t, num_scans, num_matches, ext,
        device=lio_template.P.device)
    if "lio.scans" in z.files:
        state = state._replace(scans=int(z["lio.scans"]))
    return pipeline, state, extra
