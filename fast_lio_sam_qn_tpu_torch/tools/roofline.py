"""Least times of the port's kernels and stages on one NVIDIA H100: the
counterpart of the JAX package's ``tools/roofline.py``, counted for the
H100 and not for the TPU v5e (whose rates this module does not carry).

A bound is the larger of two times for the same work: the operations on
this run's data over the fp32 peak, and the bytes that must move (each
valid input row read once, each output row written once) over the HBM
rate.  The H100 has no MXU / VPU split: every count is fp32 operations
against ``FP32_FLOPS`` (no tensor cores: the port keeps strict fp32), so
the dictionaries carry ``gflop`` where the JAX tool has ``mxu_gflop`` and
``vpu_gop``.  Where the work depends on the data (K2's kept (block, tile)
pairs, the FPFH kernels' in-radius pairs) the count is this run's.

- ``bound``, ``knn_bound``, ``radius_bound``, ``eigh3_bound``,
  ``propagate_bound``: the kernel table's bounds (``chip_smoke.py``'s
  ``bound_ms``).
- ``block_tile_survivors``, ``stage_budget``: K3-K5 on one cloud in the
  port's Morton order: the (block, tile) pairs the keep rule keeps, the
  work of the kernel as designed (``bound_ms``) and the in-radius work of
  any implementation (``pair_bound_ms``, the kernel table's bound).
- ``gicp_nn_budget``: K2's work per GICP iteration, unpruned.
- ``plane_assoc_budget``: one plane search of the point map
  (``ieskf._plane_correspondences``) at a scan's static sizes.
- ``insert_budget``: a census of ``ops/surfel_map.py insert`` at steady
  state: its table-scale gathers, scatters, sorts and passes, and the
  plane fits' elementwise ops.
- ``device_ms``, ``measure_kernel_ms``: the device time of a call of the
  port's wrappers (a CUDA graph's replays between CUDA events), on the
  card only.
- ``report``: all of it on ``bench.build_pair``'s two clouds, measured
  beside the bounds on the card.

Usage:

    python -m fast_lio_sam_qn_tpu_torch.tools.roofline               # card
    python -m fast_lio_sam_qn_tpu_torch.tools.roofline --device cpu  # counts
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import fpfh_stream as fs
from ..ops import knn_cuda
from ..utils import cuda_graph

# the H100 SXM's published peaks: fp32 outside
# the tensor cores, and HBM3
FP32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12

STAGES = ("moments", "spfh", "agg")
# the loop closure's radii: K3 at the normal and the covariance radius (its
# prune at the larger), K4 and K5 at the feature radius
STAGE_RADII = {"moments": (0.9, 0.6), "spfh": (1.5,), "agg": (1.5,)}
# the kernel table's bound (``radius_bound``): the useful math of a pair
# within each radius (K3: 10 adds, the 6 products shared with the smaller
# radius; K4: the pair's ~75 angle flops; K5: 33 FMAs and its weight), the
# bytes in of a valid row and out of every row
PAIR_WORK = {"moments": ((16, 10), 13, 80), "spfh": ((75,), 26, 136),
             "agg": ((68,), 146, 136)}
# fp32 operations the kernels execute (``--fmad=false`` for K4), for each
# (query row, db row) of a kept (block, tile) pair: cross3's product and two
# FMAs (5), expand_d2's product, difference and sum (3) and a compare a
# radius -- fpfh_moments.cu:146-150, fpfh_spfh.cu:152-153, fpfh_agg.cu:148-150
TEST_FLOPS = {"moments": 10, "spfh": 9, "agg": 9}
# ... and for each pair within each radius: K3, fpfh_moments.cu:153-163, the
# two column groups of the radius each form 5 products and add them; K4,
# fpfh_spfh.cu:185-213, 64 for the Darboux frame and both bins plus 5 for
# each of the theta loop's 11 edge tests; K5, fpfh_agg.cu:154, the weight
HIT_FLOPS = {"moments": (20, 20), "spfh": (119,), "agg": (2,)}
# K5's product, fpfh_agg.cu:163-168: every db row that a query of the block
# hits costs 9 FMAs in each of the CTA's 128 threads
AGG_ROW_FLOPS = 2 * 9 * 128


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the fp32
    peak and the bytes over the HBM rate."""
    t_ops = float(flops) / FP32_FLOPS * 1e3
    t_bytes = float(nbytes) / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# K6 (csrc/eigh3.cu) a matrix: six components in, 3 eigenvalues and 9
# eigenvector components out; 18 rotations of 53 fp32 ops and 3
# transcendentals (each counted as one op), then the rank pick's 6
# compares and 3 adds
EIGH3_BYTES = 4 * (6 + 12)
EIGH3_FLOPS = 18 * (53 + 3) + 9


def eigh3_bound(n):
    """K6's bound on n matrices (``bound``)."""
    return bound(n * EIGH3_FLOPS, n * EIGH3_BYTES)


# the point map's plane search (``ieskf._plane_correspondences``): a table
# slot read is its key (3 int32), occupied flag and point (3 fp32); a row
# comes in as its world point and mask and goes out as its plane's normal,
# residual and flag; a candidate's squared distance is 3 differences, 3
# products and 2 sums
ASSOC_SLOT_BYTES = 12 + 1 + 12
ASSOC_ROW_BYTES = (12 + 1) + (12 + 4 + 1)
D2_FLOPS = 8


def plane_assoc_budget(n, t, window=3, probes=4):
    """The least time of one plane search of the point map, whatever
    implements it, at its static sizes: n padded rows on a table of t
    slots.  Bytes: each row's window^3 voxels' probe slots, the table read
    at most once, plus the rows in and the planes out; operations: a
    squared distance a candidate slot and one K6 fit a row (``EIGH3_FLOPS``
    of ``eigh3_bound``).  Returns {bytes, flops, bound_ms, bound_by}."""
    slots = n * window ** 3 * probes
    nbytes = min(slots, t) * ASSOC_SLOT_BYTES + n * ASSOC_ROW_BYTES
    flops = slots * D2_FLOPS + n * EIGH3_FLOPS
    ms, by = bound(flops, nbytes)
    return dict(bytes=nbytes, flops=flops, bound_ms=ms, bound_by=by)


def propagate_bound(dim, k, n_steps):
    """K7's bound, the whole of ``ieskf.propagate`` on one scan of k IMU
    samples of which n_steps - 1 are valid (the tail is the last step):
    each step's F P F^T (2 dim^3 FMAs, 2 flops each), diag(Q) (dim^2
    adds) and ~150 flops of nav state and state-free precompute; the
    inputs (the nav state's 24 floats, P, the samples' time, gyro, acc and
    mask, t_start, t_end, 6 noise floats) read once, the outputs (R, p, v,
    P and the log's t, R, p, v, w and mask) written once."""
    flops = n_steps * (4 * dim ** 3 + dim * dim + 150)
    nbytes = (4 * (24 + dim * dim + 7 * k + 8) + k
              + 4 * (15 + dim * dim + 19 * k) + k)
    return bound(flops, nbytes)


def per_run(mask, rows):
    """Valid rows in each run of ``rows`` consecutive rows (float64)."""
    pad = torch.nn.functional.pad(mask.double(), (0, -mask.shape[0] % rows))
    return pad.view(-1, rows).sum(-1)


def knn_bound(q, qm, db, dbm, k, keep=None):
    """A kNN kernel's bound over this run's data: 2F + 2 flops (the cross
    term's F products and the d2 expansion) for each (valid query, valid db
    row) pair, or for each pair of a kept (block, tile) for K2 (``keep``,
    one bitmap per lane); each valid row's F + 1 floats and mask byte read
    once, every output row written once."""
    if q.dim() == 2:
        q, qm, db, dbm = q[None], qm[None], db[None], dbm[None]
        keep = None if keep is None else [keep]
    f = q.shape[-1]
    nq = qm.sum(-1).double()
    nd = dbm.sum(-1).double()
    if keep is None:
        pairs = float((nq * nd).sum())
    else:
        pairs = 0.0
        for qml, dml, kp in zip(qm, dbm, keep):
            cq = per_run(qml, knn_cuda.BAND_BLOCK)
            cd = per_run(dml, knn_cuda.BAND_TILE)
            pairs += float(cq @ kp.double() @ cd)
    nbytes = (float((nq + nd).sum()) * (4 * f + 5)
              + q.shape[0] * q.shape[1] * k * 8)
    return bound(pairs * (2 * f + 2), nbytes)


def radius_bound(p, qm, dbm, radii, pair_flops, hit_flops, row_in, row_out):
    """An FPFH kernel's bound over this run's data, per lane: 9 flops of
    distance test for each (valid query, valid db point) pair plus
    hit_flops[r] for each pair within radii[r]; each valid row's row_in
    bytes read once, every output row's row_out bytes written once."""
    if p.dim() == 2:
        p, qm, dbm = p[None], qm[None], dbm[None]
    flops = 0.0
    rows_in = 0.0
    for pl, ql, dl in zip(p, qm, dbm):
        a, b = pl[ql].double(), pl[dl].double()
        d2 = torch.cdist(a, b) ** 2
        flops += pair_flops * d2.numel()
        for r, hf in zip(radii, hit_flops):
            flops += hf * float((d2 <= r * r).sum())
        rows_in += float(ql.sum())
    return bound(flops, rows_in * row_in + p.shape[0] * p.shape[1] * row_out)


def stage_pair_bound(stage, p, qm, dbm, pair_flops=0):
    """``radius_bound`` of one FPFH stage as the kernel table counts it:
    the in-radius pairs' math (``pair_flops = 0``), or with 9 flops of
    distance test per valid pair (the all-pairs figure)."""
    hit, row_in, row_out = PAIR_WORK[stage]
    return radius_bound(p, qm, dbm, STAGE_RADII[stage], pair_flops, hit,
                        row_in, row_out)


def _sorted_cloud(points, mask, device=None):
    """The cloud in the port's Morton order, as ``fpfh_radius`` gives it to
    K3-K5 on the card: (points (N, 3) fp32, mask (N,))."""
    p = torch.as_tensor(points, dtype=torch.float32, device=device)
    m = torch.as_tensor(mask, dtype=torch.bool, device=p.device)
    order = knn_cuda.morton_order(p, m)
    return p[order].contiguous(), m[order].contiguous()


def _keep_matrix(p, qm, dbm, radius, block, tile):
    """The keep rule on sorted rows, over the whole padded grid, and False
    for a block without a valid query (``fp_keep_list`` returns -1 there;
    the rule alone would keep its infinite box's far2 bound)."""
    keep = fs.radius_tile_keep(p, qm, dbm, radius, block, tile)
    return keep & (per_run(qm, block) > 0)[:, None]


def block_tile_survivors(points, mask, radius, block=fs.FP_BLOCK,
                         tile=fs.FP_TILE):
    """(n_blocks, n_tiles) bool: which (query block, db tile) pairs of the
    cloud in the port's Morton order (``knn_cuda.morton_order``) K3's keep
    rule (``fs.radius_tile_keep``, csrc/tile_prune.cuh) keeps at
    ``radius``, the db set being ``mask``; blocks of ``block`` and tiles of
    ``tile`` rows over the padded cloud."""
    p, m = _sorted_cloud(points, mask)
    return _keep_matrix(p, m, m, float(radius), block, tile)


def _n_valid(p, m):
    """K4 / K5's db set beside the mask: K3's plain moments at the normal
    radius count >= 3 points (``moments_to_normals_covs``)."""
    mom = fs.moments_plain(p, m, *STAGE_RADII["moments"])
    return m & (mom[:, 0] >= 3)


def _hits(p, qm, dbm, radii, self_pairs, block):
    """(pairs within each radius, sum over query blocks of the db rows a
    valid query of the block has within radii[0]) on sorted rows, by exact
    float64 distances."""
    n = p.shape[0]
    chunk = block * max(1, 512 // block)
    pd = p.double()
    idx = torch.arange(n, device=p.device)
    hits = [0] * len(radii)
    marked = 0
    for s in range(0, n, chunk):
        d2 = torch.cdist(pd[s:s + chunk], pd) ** 2
        ok = qm[s:s + chunk, None] & dbm[None, :]
        if not self_pairs:
            ok &= idx[s:s + chunk, None] != idx[None, :]
        for i, r in enumerate(radii):
            hits[i] += int((ok & (d2 <= r * r)).sum())
        near = ok & (d2 <= radii[0] * radii[0])
        near = torch.nn.functional.pad(near, (0, 0, 0, -near.shape[0] % block))
        marked += int(near.view(-1, block, n).any(1).sum())
    return hits, marked


def stage_budget(points, mask, stage: str):
    """The work of one FPFH kernel over one cloud (its self-search) in the
    port's Morton order, at the stage's radii (``STAGE_RADII``) and the
    kernels' blocks and tiles.  ``stage``: "moments" (K3, db set ``mask``),
    "spfh" (K4) or "agg" (K5; db set ``mask & n_valid``, ``n_valid`` from
    K3's plain moments).

    ``blocks`` / ``tiles``: the grid below the query / db extent, where the
    kernel walks; ``surviving`` of its ``total`` (block, tile) pairs kept;
    ``gflop``: the operations of the kernel as designed (the distance test
    on every row pair of a kept (block, tile), the math of each pair within
    a radius, K5's product over the db rows its blocks hit); ``mb``: the
    bytes as ``radius_bound`` counts them; ``bound_ms`` of that work;
    ``pair_bound_ms``: ``radius_bound`` of the in-radius pairs' math alone,
    the least time of any implementation (the kernel table's bound);
    ``all_pairs_bound_ms``: the same with 9 flops of distance test for every
    valid pair."""
    radii, block, tile = STAGE_RADII[stage], fs.FP_BLOCK, fs.FP_TILE
    p, m = _sorted_cloud(points, mask)
    dbm = m if stage == "moments" else m & _n_valid(p, m)
    keep = _keep_matrix(p, m, dbm, max(radii), block, tile)
    blocks = -(-int(knn_cuda.lane_extents(m)) // block)
    tiles = -(-int(knn_cuda.lane_extents(dbm)) // tile)
    surviving = int(keep.sum())
    hits, marked = _hits(p, m, dbm, radii, stage == "moments", block)
    flops = (surviving * block * tile * TEST_FLOPS[stage]
             + sum(h * f for h, f in zip(hits, HIT_FLOPS[stage])))
    if stage == "agg":
        flops += marked * AGG_ROW_FLOPS
    hit, row_in, row_out = PAIR_WORK[stage]
    nbytes = float(m.sum()) * row_in + p.shape[0] * row_out
    b_ms, b_by = bound(flops, nbytes)
    pair = radius_bound(p, m, dbm, radii, 0, hit, row_in, row_out)
    every = radius_bound(p, m, dbm, radii, 9, hit, row_in, row_out)
    return dict(stage=stage, blocks=blocks, tiles=tiles,
                surviving=surviving, total=blocks * tiles,
                prune_keep=surviving / max(blocks * tiles, 1),
                in_radius=hits[0], gflop=flops / 1e9, mb=nbytes / 1e6,
                bound_ms=b_ms, bound_by=b_by, pair_bound_ms=pair[0],
                pair_bound_by=pair[1], all_pairs_bound_ms=every[0])


def gicp_nn_budget(n_src, n_dst, iters: int = 4, keep: float = 1.0):
    """K2's work for ``iters`` GICP iterations of ``n_src`` valid source
    points against ``n_dst`` valid target points, counted as ``knn_bound``
    counts it (2F + 2 = 8 flops a pair at F = 3; each valid row's 17 bytes
    and an 8-byte output row of each source row, once an iteration),
    the pairs scaled by ``keep`` (the kept share of K2's (block, tile)
    pairs; 1 = unpruned)."""
    flops = float(n_src) * n_dst * keep * 8 * iters
    nbytes = ((n_src + n_dst) * 17 + n_src * 8) * iters
    b_ms, b_by = bound(flops, nbytes)
    return dict(stage=f"gicp-nn x{iters}", gflop=flops / 1e9,
                mb=nbytes / 1e6, bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------------------
# the surfel insert's census
# ---------------------------------------------------------------------------

def _gather(rows, row_bytes):
    """Bytes of a gather (or scatter) of ``rows`` table rows: the rows
    read, their int64 indices, the rows written."""
    return rows * (2 * row_bytes + 8)


def traced_ops(fn, *args):
    """(ops, bytes a row) of ``fn`` on one-row tensors ``args``: each torch
    call that returns a new tensor (not a view of its input) is one op;
    its tensor inputs are read once and its output written once."""
    from torch.overrides import TorchFunctionMode

    count = [0, 0]

    def tensors(x):
        if torch.is_tensor(x):
            yield x
        elif isinstance(x, (list, tuple)):
            for y in x:
                yield from tensors(y)

    class Census(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = list(tensors(args)) + list(tensors(kwargs or {}))
            if (torch.is_tensor(out) and not out._is_view()
                    and not any(out is t for t in ins)):
                count[0] += 1
                count[1] += out.nbytes + sum(t.nbytes for t in ins)
            return out

    with Census():
        fn(*args)
    return count[0], count[1]


def _plane_fit_ops():
    """(ops, bytes a row) of ``surfel_map._plane_from`` as the card runs
    it: the covariance and the plane traced, the 6-sweep Jacobi eigensolve
    one launch of K6 (``EIGH3_BYTES`` a row) in place of the plain
    version's elementwise ops."""
    from ..ops import linalg3, surfel_map

    one = torch.ones(1)
    ops, row = traced_ops(surfel_map._plane_from, one, torch.ones(1, 3),
                          torch.ones(1, 6), torch.ones(1, 3))
    s_ops, s_row = traced_ops(linalg3.eigh3_soa_plain, *[one] * 6)
    return ops - s_ops + 1, row - s_row + EIGH3_BYTES


def _claim_rows(label, n, t, probes):
    """The rows of ``_claim`` (ops/surfel_map.py:356-372) for a batch of n
    rows on a table of t slots: (stage, lines, ops, rows, bytes)."""
    return [
        # per round: the bid table's fill and scatter-min, ~occupied,
        # bids != MAX and the &, two gathers at the candidates, occupied |=
        (f"{label} rounds", "ops/hashgrid.py:86-103", 8 * probes,
         probes * (5 * t + 3 * n),
         probes * (8 * t + _gather(n, 8) + 2 * t + 9 * t + 3 * t
                   + _gather(n, 8) + _gather(n, 1) + 3 * t)),
        # the winner scatter (clone + scatter-min), newly, widx, the
        # winners' coords, the coords select and the packed key
        (f"{label} winners and key", "ops/hashgrid.py:105-107, "
         "ops/surfel_map.py:364-368", 8, 7 * t + n,
         16 * t + _gather(n, 8) + 9 * t + 17 * t + _gather(t, 12) + 37 * t
         + 5 * t + 32 * t),
        # the winners' 6 face neighbours located, the nbr table copied
        # twice with a scatter into each
        (f"{label} neighbour hints", "ops/surfel_map.py:217-240", 5,
         6 * probes * n + 2 * t + 7 * n,
         _gather(6 * probes * n, 16) + 2 * 48 * t + _gather(n, 24)
         + _gather(6 * n, 4)),
        (f"{label} relocate", "ops/surfel_map.py:188-198, 371", 1,
         probes * n, _gather(probes * n, 16)),
    ]


def insert_budget(say=None):
    """Census of the port's steady-state surfel insert (``ops/surfel_map.py
    insert``) at ``tools/profile_insert.py``'s scale: N = 32,768 points, a
    2^19-slot table, hood cap 8,192, halo cap 4,096, the 27-voxel hood (the
    report's measured insert).  The port has no claim or hint-maintenance
    cap: it runs the reference's full batches (the claim over every point,
    the halo claim over the fan's 6 x halo_cap rows).

    Each row: (stage, the lines it counts, ops, rows touched, bytes moved),
    ops being the table-scale gathers, scatters, sorts, fills and passes
    (and for the two plane fits, the elementwise ops of ``_plane_from``,
    traced on one row, its eigensolve one K6 launch).  Returns {rows,
    table_ops, bytes, hbm_bound_ms}; ``say`` (e.g. print) gets one line a
    row and the total."""
    from ..ops.hashgrid import NUM_PROBES
    from . import profile_insert as pi

    n, t, p, w = pi.N, pi.TABLE, NUM_PROBES, 27
    h, c = min(pi.HOOD_CAP, n), min(pi.HALO_CAP, n)
    fit_ops, fit_row = _plane_fit_ops()
    rows = [("locate", "ops/surfel_map.py:188-198, 398", 1, n * p,
             _gather(n * p, 16))]
    rows += _claim_rows("claim", n, t, p)
    rows += [
        # cnt_before, the stable sort by slot, the lengths' fill and
        # scatter-add, the rows in slot order, segment_reduce into t + 1
        # rows, the table add
        ("moment sums (ordered segments)", "ops/surfel_map.py:375-383, "
         "405-411", 7, 5 * n + 3 * t,
         _gather(n, 4) + 16 * n + 8 * t + _gather(n, 8) + _gather(n, 40)
         + 40 * n + 48 * t + 120 * t),
        ("refit own gathers and write", "ops/surfel_map.py:288-301", 5,
         4 * n + t, _gather(n, 40) + _gather(n, 12) + _gather(n, 24)
         + 48 * t + _gather(n, 24)),
        ("refit own plane fit (Jacobi)", "ops/surfel_map.py:243-256, 291",
         fit_ops, n, fit_row * n),
        ("refit hood compaction", "ops/surfel_map.py:124-129, 305", 1, n,
         12 * n),
        (f"refit hood{w} gathers", "ops/surfel_map.py:314-328, 340",
         4, 2 * h + h * w + h * w * p,
         _gather(h, 16) + _gather(h * w * p, 16) + _gather(h * w, 40)
         + _gather(h, 24)),
        ("refit hood plane fit (Jacobi)", "ops/surfel_map.py:243-256, 338",
         fit_ops, h, fit_row * h),
        ("refit hood write", "ops/surfel_map.py:344", 2, t + h,
         48 * t + _gather(h, 24)),
        # the post-refit rows, the priority sort, the sources' rows and
        # their dirty bits cleared in a table copy
        ("halo sources", "ops/surfel_map.py:425-446", 5, 2 * n + 2 * c + t,
         _gather(n, 24) + 12 * n + _gather(c, 24) + 48 * t
         + _gather(c, 24)),
        ("halo fan hint lookup", "ops/surfel_map.py:201-214, 452", 2, 7 * c,
         _gather(c, 24) + _gather(6 * c, 16)),
    ]
    rows += _claim_rows("halo claim", 6 * c, t, p)
    # the halo voxels' counts; the score table's fill, scatter-min and
    # gather; the rank table's; the winners' planes in a table copy
    rows.append(("halo plane write", "ops/surfel_map.py:460-478", 9,
                 6 * 6 * c + 3 * t,
                 _gather(6 * c, 4) + 4 * t + _gather(6 * c, 4)
                 + _gather(6 * c, 4) + 8 * t + _gather(6 * c, 8)
                 + _gather(6 * c, 8) + 48 * t + _gather(6 * c, 24)))
    rows = [dict(stage=s, lines=li, ops=o, rows=r, bytes=b)
            for s, li, o, r, b in rows]
    total = sum(r["bytes"] for r in rows)
    out = dict(rows=rows, table_ops=sum(r["ops"] for r in rows),
               bytes=total, hbm_bound_ms=total / HBM_BYTES_S * 1e3)
    if say is not None:
        say(f"surfel insert census ({n} points, {t} slots, hood{w} cap {h}, "
            f"halo cap {c}):")
        for r in rows:
            say(f"  {r['stage']:<34}{r['ops']:>5} ops{r['rows']:>10} rows"
                f"{r['bytes'] / 1e6:>9.2f} MB  ({r['lines']})")
        say(f"  total {out['table_ops']} ops, {total / 1e6:.1f} MB -> HBM "
            f"bound {out['hbm_bound_ms']:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# device time on the card
# ---------------------------------------------------------------------------

def device_ms(fn):
    """Device time per call of ``fn``, a wrapper that launches its work on
    the current stream and reads nothing back: its kernels and the small
    torch ops it runs, without its host time.  ``fn`` is captured once in
    a CUDA graph (``cuda_graph.capture``, after a warm-up call) and
    replayed 50 times back to back between two CUDA events; the median of
    5 such runs.  (torch.profiler is not used: late in a long process it
    delivers only some of the kernel records, or none.)"""
    reps, rounds = 50, 5
    graph = cuda_graph.capture(fn, torch.device("cuda"))
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def measure_kernel_ms(stage, points, mask, device="cuda"):
    """Device time of one K3 ("moments"), K4 ("spfh") or K5 ("agg")
    launch on the card (``device_ms``) at the stage's radii, on the cloud
    in the port's Morton order with its radius prune made beforehand, so
    that the timed call launches that kernel alone.  K4 and K5 take the
    normals and SPFH that K3 and K4 give.  A CPU device raises: there is no
    kernel to time there."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"measure_kernel_ms times a kernel on the card; "
                         f"got device {device}")
    radii = STAGE_RADII[stage]
    p, m = _sorted_cloud(points, mask, device)
    if stage == "moments":
        prune = fs.radius_prune(p[None], m[None])
        return device_ms(lambda: fs.moments(p, m, *radii, prune))
    mom = fs.moments(p, m, *STAGE_RADII["moments"])
    nrm, v, _, _ = fs.moments_to_normals_covs(mom, p, m, None)
    prune = fs.radius_prune(p[None], m[None], v[None])
    if stage == "spfh":
        return device_ms(lambda: fs.spfh(p, m, nrm, v, radii[0], prune))
    raw = fs.spfh(p, m, nrm, v, radii[0], prune)
    spn = (raw[:, :33] / torch.clamp(raw[:, 33:], min=1.0)).contiguous()
    return device_ms(lambda: fs.fpfh_agg(p, m, v, spn, radii[0], prune))


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def report(device="cuda", say=print):
    """The roofline of the loop match's FPFH stages on ``bench.build_pair``'s
    two clouds: one row per cloud and stage; on a CUDA device each row's
    kernel timed (``measure_kernel_ms``) beside its two shares,
    ``bound_ms / measured`` and ``pair_bound_ms / measured``; then the GICP
    NN budget, the totals and the surfel insert's census, beside the
    insert's measured ms (``profile_insert.stages`` at one rep) on the
    card.  Every line with a time carries the card's name and power limit.
    Returns the rows."""
    from .. import bench
    from . import profile_insert

    device = torch.device(device)
    measure = device.type == "cuda"
    card = bench.card_line(device)
    (va, vma, _), (vb, vmb, _), _ = bench.build_pair(device)
    rows = []
    for cloud, cmask, name in ((va, vma, "src"), (vb, vmb, "dst")):
        for stage in STAGES:
            b = stage_budget(cloud, cmask, stage)
            b["cloud"] = name
            if measure:
                ms = measure_kernel_ms(stage, cloud, cmask, device=device)
                b["measured_ms"] = ms
                b["bound_share"] = b["bound_ms"] / ms
                b["pair_share"] = b["pair_bound_ms"] / ms
            rows.append(b)
    say(f"{'stage':<13}{'kept':>12}{'keep%':>7}{'GFLOP':>9}{'MB':>7}"
        f"{'bound ms':>11}{'pair ms':>11}{'all ms':>10}"
        + (f"{'meas ms':>10}{'bound/m':>9}{'pair/m':>9}" if measure else "")
        + f"  [{card}]")
    for b in rows:
        line = (f"{b['cloud'] + ':' + b['stage']:<13}"
                f"{b['surviving']:>6}/{b['total']:<5}"
                f"{100 * b['prune_keep']:>6.1f}%{b['gflop']:>9.4f}"
                f"{b['mb']:>7.2f}{b['bound_ms']:>11.6f}"
                f"{b['pair_bound_ms']:>11.6f}{b['all_pairs_bound_ms']:>10.6f}")
        if measure:
            line += (f"{b['measured_ms']:>10.5f} {b['bound_share']:>8.4f}"
                     f" {b['pair_share']:>8.4f}")
        say(line + f"  [{card}]")
    g = gicp_nn_budget(int(vma.sum()), int(vmb.sum()))
    say(f"{g['stage']:<13}{'(unpruned)':>12}{'':>7}{g['gflop']:>9.4f}"
        f"{g['mb']:>7.2f}{g['bound_ms']:>11.6f}  [{card}]")
    tot = sum(b["bound_ms"] for b in rows)
    tot_pair = sum(b["pair_bound_ms"] for b in rows)
    line = (f"FPFH stages: bound {tot:.6f} ms, pair bound {tot_pair:.6f} ms")
    if measure:
        meas = sum(b["measured_ms"] for b in rows)
        line += (f", measured {meas:.5f} ms (bound {tot / meas:.4f} of it, "
                 f"pair bound {tot_pair / meas:.4f})")
    say(line + f"  [{card}]")
    say(f"peaks: fp32 {FP32_FLOPS / 1e12:.0f} TFLOP/s, HBM "
        f"{HBM_BYTES_S / 1e12:.2f} TB/s (H100 SXM, published)")
    census = insert_budget(say=say)
    if measure:
        ms = profile_insert.stages(device, 1, names=("full insert (hood 27)",))
        ins = ms["full insert (hood 27)"]
        say(f"surfel insert measured {ins:.3f} ms (CUDA events, 1 rep, "
            f"{ms['occupied voxels (random volume)']} occupied voxels): the "
            f"HBM bound is {census['hbm_bound_ms'] / ins:.5f} of it, "
            f"{ins / census['table_ops']:.4f} ms an op  [{card}]")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("roofline: no CUDA device (--device cpu prints the counts "
                  "alone)", file=sys.stderr)
            return 1
        from .. import kernels

        kernels.build()
        kernels.load_library()
    report(device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
