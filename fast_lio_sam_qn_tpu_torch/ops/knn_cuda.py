"""Kernels K1 and K2 — exact masked kNN on the card (csrc/knn.cu,
csrc/knn_banded.cu).

Counterpart of fast_lio_sam_qn_tpu/ops/pallas_knn.py:

- K1 (``knn`` / ``nn``, the reference's ``knn_pallas`` / ``nn_pallas`` over
  ``_knn_kernel``): brute force over every valid db row.
- K2 (``knn_banded`` / ``nn_banded``, over ``_knn_kernel_banded``): the
  same result, searching for each query block only the db tiles that the
  bbox keep rule of ``block_tile_keep`` admits.  Both clouds should be
  Morton-sorted (``morton_order``) for the prune to skip anything.
- ``*_batched``: the same kernels over B independent clouds in one launch,
  the batch on the grid's y axis — the reference's grid-batched lowerings
  (pallas_knn.py:469 for K2; Pallas's own vmap rule for K1).  Each has its
  own launch counter, apart from the single-cloud one.

The port returns exact (d2, idx) pairs: there is no packed-key quantization
and so no ``MAX_DB`` cap.  A CPU tensor takes the plain version (ops/knn.py
``brute_knn``, restricted to the kept tiles for K2); a CUDA tensor launches
the kernel or raises.

Every launch gets each lane's extents (``lane_extents``, on the device): a
kernel skips query blocks and db rows past them.  At k = 1 the kernels may
split each lane's db range (K1) or kept tiles (K2) over ``split_count``
slices on the grid's z axis (``split_lo``) and merge the slices' (d2, idx)
partials lexicographically, so the result does not depend on the split.
"""
from __future__ import annotations

import torch

from .. import kernels
from .knn import brute_knn, sq_norms

MAX_F = 64
MAX_K = 32
MORTON_CELL = 0.75   # locality cell [m], as pallas_knn._MORTON_CELL
PRUNE_SLACK = 1.03   # as pallas_knn._PRUNE_SLACK
BAND_BLOCK = 64      # query rows per CTA, K2's keep-rule block (kNnBlock)
BAND_TILE = 128      # db rows per tile, K2's keep-rule tile (kNnTile)
BAND_MAX_TILES = 4096
MAX_SPLITS = 8             # csrc/knn_tile.cuh kMaxSplits
SPLIT_CTAS = 4 * 132       # a k = 1 launch aims at 4 CTAs on each of 132 SMs


def lane_extents(mask: torch.Tensor) -> torch.Tensor:
    """(B,) int32 of a (B, N) mask: 1 + the index of each lane's last valid
    row, 0 for a lane without one.  Every row at or past it is masked, so a
    kernel may stop there.  Computed on the mask's device: no host read."""
    n = mask.shape[-1]
    if n == 0:
        return torch.zeros(mask.shape[:-1], dtype=torch.int32,
                           device=mask.device)
    rows = torch.arange(1, n + 1, dtype=torch.int32, device=mask.device)
    return torch.amax(torch.where(mask, rows, 0), dim=-1)


def split_lo(units: int, splits: int, z: int) -> int:
    """The split plan, csrc/knn_tile.cuh split_lo: of ``units`` (K1: the
    db tiles below a lane's extent, K2: a query block's kept tiles), slice
    z of ``splits`` covers [split_lo(units, splits, z), split_lo(units,
    splits, z + 1))."""
    return units * z // splits


def split_count(b: int, m: int, n: int, k: int) -> int:
    """Grid z of a launch over B lanes of (M, .) queries and (N, .) dbs:
    at k = 1 enough slices for B * ceil(M / 64) query blocks to give
    SPLIT_CTAS CTAs, at most MAX_SPLITS and one per db tile; 1 at k > 1.
    Taken from the padded shapes, so it needs no host read."""
    if k > 1:
        return 1
    blocks = b * -(-m // BAND_BLOCK)
    return max(1, min(MAX_SPLITS, -(-n // BAND_TILE), -(-SPLIT_CTAS // blocks)))


def _extents_and_scratch(qmask, dbmask, k: int):
    """(q_end, db_end, splits, part_d, part_i) of one launch: the lanes'
    extents and, when the launch splits, its (splits, B, M) partials."""
    b, m = qmask.shape
    splits = split_count(b, m, dbmask.shape[1], k)
    part_d = part_i = None
    if splits > 1:
        part_d = torch.empty((splits, b, m), dtype=torch.float32,
                             device=qmask.device)
        part_i = torch.empty((splits, b, m), dtype=torch.int32,
                             device=qmask.device)
    return lane_extents(qmask), lane_extents(dbmask), splits, part_d, part_i


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_knn(queries, qmask, db, dbmask, k: int):
    """K1 over (B, M, F) queries and (B, N, F) dbs: one launch (and a merge
    of the slices when it splits), the batch on the grid's y axis."""
    b, m, f = queries.shape
    n = db.shape[1]
    kernels.require_batch(b)
    if not (1 <= f <= MAX_F and 1 <= k <= MAX_K and m >= 1):
        raise ValueError(f"knn kernel takes 1 <= F <= {MAX_F}, 1 <= k <= "
                         f"{MAX_K}, M >= 1; got F={f}, k={k}, M={m}")
    dev = queries.device
    for t, name, dt, shape in (
            (queries, "queries", torch.float32, (b, m, f)),
            (qmask, "qmask", torch.bool, (b, m)),
            (db, "db", torch.float32, (b, n, f)),
            (dbmask, "dbmask", torch.bool, (b, n))):
        kernels.require(t, name, dt, shape, dev)
    qq = sq_norms(queries)
    dd = sq_norms(db)
    out_d = torch.empty((b, m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, m, k), dtype=torch.int32, device=dev)
    q_end, db_end, splits, part_d, part_i = _extents_and_scratch(
        qmask, dbmask, k)
    lib = kernels.load_library()
    with torch.cuda.device(dev):
        status = lib.flsq_knn(
            queries.data_ptr(), qq.data_ptr(), qmask.data_ptr(),
            db.data_ptr(), dd.data_ptr(), dbmask.data_ptr(), q_end.data_ptr(),
            db_end.data_ptr(), b, m, n, f, k, splits, _ptr(part_d),
            _ptr(part_i), out_d.data_ptr(), out_i.data_ptr(),
            kernels.stream(queries))
    kernels.check_status(status, "knn")
    return out_d, out_i, out_i >= 0


def knn(queries: torch.Tensor, qmask: torch.Tensor, db: torch.Tensor,
        dbmask: torch.Tensor, k: int):
    """(dist2 (M, k), idx (M, k) int32, valid (M, k)) — see ops/knn.py."""
    if not kernels.on_cuda("knn", queries):
        return brute_knn(queries, qmask, db, dbmask, k)
    out = _launch_knn(queries[None], qmask[None], db[None], dbmask[None], k)
    knn.launches += 1
    return tuple(o[0] for o in out)


knn.launches = 0


def knn_batched_plain(queries, qmask, db, dbmask, k: int):
    """K1's plain batched version: ``brute_knn`` on each lane."""
    return kernels.per_lane(lambda *a: brute_knn(*a, k), queries, qmask, db,
                            dbmask)


def knn_batched(queries: torch.Tensor, qmask: torch.Tensor, db: torch.Tensor,
                dbmask: torch.Tensor, k: int):
    """K1 over B independent clouds — (B, M, F) queries against (B, N, F)
    dbs, one launch.  Each lane equals ``knn`` on that lane bit for bit
    (the reference batches K1 through Pallas's own vmap rule, which adds a
    grid axis to the call at pallas_knn.py:185)."""
    if not kernels.on_cuda("knn_batched", queries):
        return knn_batched_plain(queries, qmask, db, dbmask, k)
    out = _launch_knn(queries, qmask, db, dbmask, k)
    knn_batched.launches += 1
    return out


knn_batched.launches = 0


def nn(queries, qmask, db, dbmask):
    """Single nearest neighbour: (dist2 (M,), idx (M,), valid (M,))."""
    d2, idx, valid = knn(queries, qmask, db, dbmask, 1)
    return d2[:, 0], idx[:, 0], valid[:, 0]


def nn_batched(queries, qmask, db, dbmask):
    """Single nearest neighbour of each lane through batched K1."""
    d2, idx, valid = knn_batched(queries, qmask, db, dbmask, 1)
    return d2[..., 0], idx[..., 0], valid[..., 0]


# ---------------------------------------------------------------------------
# K2: the bbox-pruned kNN over Morton-sorted clouds
# ---------------------------------------------------------------------------

def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 x across every third bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_order_batched(points: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """(B, N) spatial-locality sort order (int64 indices) of (B, N, 3)
    points: per lane a Morton code over MORTON_CELL cells from the lane's
    valid minimum, masked points last, ties in index order (the reference's
    stable ``jnp.argsort``); one stable argsort for all lanes."""
    lo = torch.amin(torch.where(mask[..., None], points, torch.inf), dim=-2,
                    keepdim=True)
    cell = torch.clamp(((points - lo) / MORTON_CELL).to(torch.int32), 0,
                       1023)
    key = (_part1by2(cell[..., 0]) | (_part1by2(cell[..., 1]) << 1)
           | (_part1by2(cell[..., 2]) << 2))
    key = torch.where(mask, key, torch.iinfo(torch.int32).max)
    return torch.argsort(key, dim=-1, stable=True)


def morton_order(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``morton_order_batched`` of one (N, 3) cloud: (N,) indices."""
    return morton_order_batched(points[None], mask[None])[0]


def take_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Per-lane rows: x (B, N, ...) at order (B, M) -> (B, M, ...)."""
    idx = order.long().reshape(order.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def put_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The inverse of ``take_rows`` for a permutation ``order`` (B, N):
    row i of lane b of x goes back to row order[b, i]."""
    idx = order.long().reshape(order.shape + (1,) * (x.dim() - 2))
    return torch.empty_like(x).scatter_(1, idx.expand(x.shape), x)


def tile_bboxes(points: torch.Tensor, valid: torch.Tensor,
                td: int) -> torch.Tensor:
    """(n_tiles, 6) per-tile bounds [lo xyz | hi xyz] of the valid points of
    consecutive tiles of ``td`` rows; an empty tile holds (+inf, -inf)."""
    n = points.shape[0]
    pad = -(-n // td) * td - n
    p = torch.nn.functional.pad(points, (0, 0, 0, pad)).reshape(-1, td, 3)
    v = torch.nn.functional.pad(valid, (0, pad)).reshape(-1, td, 1)
    lo = torch.amin(torch.where(v, p, torch.inf), dim=1)
    hi = torch.amax(torch.where(v, p, -torch.inf), dim=1)
    return torch.cat([lo, hi], dim=1)


def block_tile_keep(q, qmask, db, dbmask, k: int, block: int = BAND_BLOCK,
                    td: int = BAND_TILE) -> torch.Tensor:
    """(n_blocks, n_tiles) bool: may db tile t hold one of the k nearest
    neighbours of some query in block b?  pallas_knn._block_tile_keep's
    rule: g2(b, t) <= PRUNE_SLACK * (k-th smallest md2(b, .)), with md2 the
    largest and g2 the smallest squared distance between the two bboxes."""
    qb = tile_bboxes(q, qmask, block)
    tb = tile_bboxes(db, dbmask, td)
    qlo, qhi = qb[:, None, :3], qb[:, None, 3:]
    tlo, thi = tb[None, :, :3], tb[None, :, 3:]
    e = torch.maximum(torch.abs(thi - qlo), torch.abs(qhi - tlo))
    md2 = torch.sum(e * e, dim=-1)
    gap = torch.clamp(torch.maximum(tlo - qhi, qlo - thi), min=0.0)
    g2 = torch.sum(gap * gap, dim=-1)
    n_tiles = md2.shape[1]
    kth = torch.sort(md2, dim=1).values[:, min(k, n_tiles) - 1]
    return g2 <= kth[:, None] * PRUNE_SLACK


def knn_banded_plain(queries, qmask, db, dbmask, k: int):
    """K2's plain version: the exact kNN over the pairs whose (query block,
    db tile) ``block_tile_keep`` admits — equal to ``brute_knn``."""
    keep = block_tile_keep(queries, qmask, db, dbmask, k)
    tile_of = torch.arange(db.shape[0], device=db.device) // BAND_TILE

    def pair_ok(start, stop):
        blk = torch.arange(start, stop, device=db.device) // BAND_BLOCK
        return keep[blk][:, tile_of]

    return brute_knn(queries, qmask, db, dbmask, k, pair_ok=pair_ok)


def _launch_banded(queries, qmask, db, dbmask, k: int):
    """K2 over (B, M, 3) queries and (B, N, 3) dbs: one tile-box launch,
    one search launch (and a merge of the slices when it splits), the batch
    on the grid's y axis."""
    b, m, _ = queries.shape
    n = db.shape[1]
    n_tiles = -(-n // BAND_TILE)
    kernels.require_batch(b)
    if not (1 <= k <= MAX_K and m >= 1 and n_tiles <= BAND_MAX_TILES):
        raise ValueError(f"knn_banded kernel takes 1 <= k <= {MAX_K}, M >= 1"
                         f", N <= {BAND_TILE * BAND_MAX_TILES}; got k={k}, "
                         f"M={m}, N={n}")
    dev = queries.device
    for t, name, dt, shape in (
            (queries, "queries", torch.float32, (b, m, 3)),
            (qmask, "qmask", torch.bool, (b, m)),
            (db, "db", torch.float32, (b, n, 3)),
            (dbmask, "dbmask", torch.bool, (b, n))):
        kernels.require(t, name, dt, shape, dev)
    qq = sq_norms(queries)
    dd = sq_norms(db)
    tbox = torch.empty((b, n_tiles, 6), dtype=torch.float32, device=dev)
    out_d = torch.empty((b, m, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, m, k), dtype=torch.int32, device=dev)
    q_end, db_end, splits, part_d, part_i = _extents_and_scratch(
        qmask, dbmask, k)
    lib = kernels.load_library()
    with torch.cuda.device(dev):
        status = lib.flsq_knn_banded(
            queries.data_ptr(), qq.data_ptr(), qmask.data_ptr(),
            db.data_ptr(), dd.data_ptr(), dbmask.data_ptr(), q_end.data_ptr(),
            db_end.data_ptr(), b, m, n, k, splits, tbox.data_ptr(),
            _ptr(part_d), _ptr(part_i), out_d.data_ptr(), out_i.data_ptr(),
            kernels.stream(queries))
    kernels.check_status(status, "knn_banded")
    return out_d, out_i, out_i >= 0


def knn_banded(queries: torch.Tensor, qmask: torch.Tensor, db: torch.Tensor,
               dbmask: torch.Tensor, k: int):
    """(dist2 (M, k), idx (M, k) int32, valid (M, k)) of 3-d points, equal
    to ``knn``; fast when both clouds are Morton-sorted.  Ties follow the
    given db order."""
    if not kernels.on_cuda("knn_banded", queries):
        return knn_banded_plain(queries, qmask, db, dbmask, k)
    out = _launch_banded(queries[None], qmask[None], db[None], dbmask[None],
                         k)
    knn_banded.launches += 1
    return tuple(o[0] for o in out)


knn_banded.launches = 0


def knn_banded_batched_plain(queries, qmask, db, dbmask, k: int):
    """K2's plain batched version: ``knn_banded_plain`` on each lane."""
    return kernels.per_lane(lambda *a: knn_banded_plain(*a, k), queries,
                            qmask, db, dbmask)


def knn_banded_batched(queries: torch.Tensor, qmask: torch.Tensor,
                       db: torch.Tensor, dbmask: torch.Tensor, k: int):
    """K2 over B independent clouds (the reference's grid-batched lowering,
    pallas_knn.py:469): (B, M, 3) queries against (B, N, 3) dbs in one
    launch; each lane's keep rule sees that lane's boxes only, and each
    lane equals ``knn_banded`` on that lane bit for bit."""
    if not kernels.on_cuda("knn_banded_batched", queries):
        return knn_banded_batched_plain(queries, qmask, db, dbmask, k)
    out = _launch_banded(queries, qmask, db, dbmask, k)
    knn_banded_batched.launches += 1
    return out


knn_banded_batched.launches = 0


def nn_banded(queries, qmask, db, dbmask):
    """Single nearest neighbour through K2."""
    d2, idx, valid = knn_banded(queries, qmask, db, dbmask, 1)
    return d2[:, 0], idx[:, 0], valid[:, 0]


def nn_banded_batched(queries, qmask, db, dbmask):
    """Single nearest neighbour of each lane through batched K2."""
    d2, idx, valid = knn_banded_batched(queries, qmask, db, dbmask, 1)
    return d2[..., 0], idx[..., 0], valid[..., 0]
