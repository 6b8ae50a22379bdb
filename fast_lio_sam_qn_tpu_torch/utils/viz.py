"""Static visualization exports — port of fast_lio_sam_qn_tpu/utils/viz.py:
the reference's rviz products (odometry and corrected paths, loop edges,
the corrected map) rendered to a PNG with matplotlib's headless Agg
backend, for offline inspection.  matplotlib is imported when a plot is
made, never with this module; a host without it raises ImportError."""
from __future__ import annotations


def require_matplotlib() -> None:
    """Raise ImportError, naming the package, where matplotlib is
    missing (``run --plot`` checks before its run starts)."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        raise ImportError("--plot needs matplotlib, which is not installed "
                          "on this host", name="matplotlib")


def plot_results(pipeline, path: str, max_map_points: int = 100_000):
    """Render the odometry and corrected keyframe trajectories, the loop
    edges and the corrected global map (top-down) to ``path`` (PNG);
    returns ``path``."""
    require_matplotlib()
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    odom, corrected = pipeline.get_trajectories()
    fig, ax = plt.subplots(1, 1, figsize=(9, 9))

    m = pipeline.get_global_map()
    if len(m):
        if len(m) > max_map_points:
            m = m[:: len(m) // max_map_points + 1]
        ax.scatter(m[:, 0], m[:, 1], s=0.2, c=m[:, 2], cmap="viridis",
                   alpha=0.35, linewidths=0)
    if len(odom):
        ax.plot(odom[:, 0, 3], odom[:, 1, 3], "-", color="#b0b0b0", lw=1.2,
                label="odometry (/ori_path)")
    if len(corrected):
        ax.plot(corrected[:, 0, 3], corrected[:, 1, 3], "-",
                color="#1669c1", lw=1.8, label="corrected (/corrected_path)")
    for (i, j) in pipeline.loop_idx_pairs:
        p, q = corrected[i, :3, 3], corrected[j, :3, 3]
        ax.plot([p[0], q[0]], [p[1], q[1]], "-", color="#d11f1f", lw=1.0,
                alpha=0.9)
    if pipeline.loop_idx_pairs:
        ax.plot([], [], "-", color="#d11f1f",
                label=f"loop edges ({len(pipeline.loop_idx_pairs)})")

    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="best")
    ax.set_title(f"{pipeline.current_kf_idx} keyframes, "
                 f"{len(pipeline.loop_idx_pairs)} loops")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
