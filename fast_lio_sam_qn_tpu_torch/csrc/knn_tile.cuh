// The search bodies that K1 (knn.cu) and K2 (knn_banded.cu) share, so that
// the two cannot drift: the register-tiled k = 1 search of one query block
// against a run of db tiles, the lexicographic (d2, idx) minimum, the split
// of a db range over grid z, the merge of the split partials, the staging of
// db tiles, the warp-cooperative selection of K1's k > 1 path, and the
// per-thread sorted insert of K2's k > 1 path.
//
// k = 1 tile body (nn_block).  A CTA of 256 threads owns kNnBlock = 64
// query rows, staged once in shared memory transposed to [c][row].  It walks
// 128-row db tiles, each staged transposed to [c][row] as well.  Warp w
// covers query rows 16 (w % 4) .. +15 and db rows 64 (w / 4) .. +63 of a
// tile; lane l covers 4 query rows (4 (l / 8) + i) and 8 db rows (4 (l % 8)
// + j and 32 + 4 (l % 8) + j, ascending).  Each c step loads one float4 of
// queries and two float4 of db rows and feeds 32 independent FMA chains;
// in a warp the query float4 is a broadcast to 8 lanes and the db float4s
// are 128 contiguous bytes, one shared-memory wavefront each.  Every pair's
// cross term is __fmul_rn(q0, v0) followed by fmaf in c order, then
// expand_d2, so d2 has the bits of the one-thread-per-query kernels and of
// the other kernel.  fp32 on CUDA cores only: TF32 or 3xTF32 would round
// the cross term differently (the parity rules forbid it).
//
// Loads overlap the math: tile t + 1 is copied with cp.async while tile t
// is searched, into the other of two buffers.  The copies are 4-byte
// cp.async, not 16-byte: they transpose (row-major rows of F floats land in
// [c][row] columns), and a row of 33 floats is not 16-byte aligned.  TMA
// and clusters buy nothing here: a tile is 17 KB at F = 33, copied in a few
// hundred cycles, and no two CTAs share a tile.  |v|^2 with the mask
// applied (+inf for a masked or out-of-range row) is loaded into registers
// before the search of a tile and stored to shared memory after it.
//
// The minimum: a thread keeps, per query row, the first smallest d2 over
// its own db rows, which it visits in ascending index order (so a strict
// < keeps the lowest index among equal d2).  The 8 lanes and 2 warps that
// share a query row then merge by (d2, idx) lexicographically: smaller d2
// wins, at equal d2 the smaller index.  That is the first minimum in db
// order, as the plain version's torch.min gives, whatever the order in
// which threads, warps or CTAs finish.  A masked db row has +inf |v|^2, so
// its d2 is +inf (or NaN for non-finite padding) and never enters.
#pragma once

#include "common.cuh"

namespace flsq {

constexpr int kNnThreads = 256;          // 8 warps
constexpr int kNnBlock = 64;             // query rows per CTA (K2's keep-rule block)
constexpr int kNnTile = 128;             // db rows per tile (K2's keep-rule tile)
constexpr int kNnTQ = 4;                 // query rows per thread
constexpr int kNnTD = 8;                 // db rows per thread and tile
constexpr int kStrideQ = kNnBlock + 4;   // floats per c of the [c][row] query block
constexpr int kStrideD = kNnTile + 4;    // floats per c of a [c][row] db tile
constexpr int kMaxSplits = 8;            // grid z of the k = 1 kernels

// The split plan: of `units` (db tiles for K1, kept tiles for K2), slice z
// of `splits` covers [split_lo(units, splits, z), split_lo(units, splits,
// z + 1)).  The same formula is ops/knn_cuda.py split_lo.
__host__ __device__ __forceinline__ int split_lo(int units, int splits, int z) {
  return static_cast<int>(static_cast<long long>(units) * z / splits);
}

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// floats of dynamic shared memory that nn_block takes at feature width f
__host__ __device__ constexpr int nn_smem_floats(int f) {
  return f * kStrideQ + 2 * f * kStrideD + 2 * kNnTile + 4 * kNnBlock;
}

// The operands of step c: this thread's 4 query values and 8 db values.
__device__ __forceinline__ void nn_operands(const float* s_q, const float* s_db, int c,
                                            int qoff, int doff, float (&qa)[kNnTQ],
                                            float (&va)[kNnTD]) {
  const float4 a = *reinterpret_cast<const float4*>(s_q + c * kStrideQ + qoff);
  const float4 u = *reinterpret_cast<const float4*>(s_db + c * kStrideD + doff);
  const float4 w = *reinterpret_cast<const float4*>(s_db + c * kStrideD + doff + 32);
  qa[0] = a.x;
  qa[1] = a.y;
  qa[2] = a.z;
  qa[3] = a.w;
  va[0] = u.x;
  va[1] = u.y;
  va[2] = u.z;
  va[3] = u.w;
  va[4] = w.x;
  va[5] = w.y;
  va[6] = w.z;
  va[7] = w.w;
}

// Async copies of the db rows base.. of a tile of ROWS rows into s_db
// ([c][row], STRIDE floats per c) by the THREADS threads of the CTA; rows at
// or past row_end are zero.
template <int FC, int ROWS, int STRIDE, int THREADS>
__device__ __forceinline__ void stage_tile(const float* __restrict__ db, int f, int base,
                                           int row_end, float* s_db) {
  const int F = FC > 0 ? FC : f;
  const int rows = min(ROWS, row_end - base);
  const float* src = db + (size_t)base * F;
  for (int e = threadIdx.x; e < ROWS * F; e += THREADS) {
    const int r = e / F, c = e - r * F;
    float* dst = s_db + c * STRIDE + r;
    if (r < rows) {
      cp_async4(dst, src + e);
    } else {
      *dst = 0.0f;
    }
  }
}

// One block of kNnBlock query rows from q0 against the db tiles whose first
// rows are tile_row(0) < tile_row(1) < ... < tile_row(count - 1); db rows
// at or past row_end are out of range.  Threads 0..kNnBlock-1 return the
// (d2, idx) minimum of query row q0 + threadIdx.x ((inf, -1) if none).
// Every thread of the CTA must call it.  FC is F at compile time, or 0 to
// take f at run time.
template <int FC, class TileRow>
__device__ __forceinline__ void nn_block(const float* __restrict__ q,
                                         const float* __restrict__ qq,
                                         const float* __restrict__ db,
                                         const float* __restrict__ dd,
                                         const uint8_t* __restrict__ dbmask, int m, int f,
                                         int q0, TileRow tile_row, int count, int row_end,
                                         float* smem, float& out_d, int& out_i) {
  const int F = FC > 0 ? FC : f;
  float* s_q = smem;                          // [F][kStrideQ]
  float* s_db = s_q + F * kStrideQ;           // [2][F][kStrideD]
  float* s_dd = s_db + 2 * F * kStrideD;      // [2][kNnTile]
  float* s_bd = s_dd + 2 * kNnTile;           // [2][kNnBlock]
  int* s_bi = reinterpret_cast<int*>(s_bd + 2 * kNnBlock);  // [2][kNnBlock]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wd = warp >> 2;
  const int qoff = (warp & 3) * 16 + (lane >> 3) * kNnTQ;  // this thread's first query row
  const int doff = wd * 64 + (lane & 7) * 4;               // and its db rows doff.., doff+32..

  for (int e = tid; e < kNnBlock * F; e += kNnThreads) {
    const int r = e / F, c = e - r * F;
    s_q[c * kStrideQ + r] = q0 + r < m ? q[(size_t)q0 * F + e] : 0.0f;
  }
  float qqv[kNnTQ], bd[kNnTQ];
  int bi[kNnTQ];
#pragma unroll
  for (int i = 0; i < kNnTQ; ++i) {
    qqv[i] = q0 + qoff + i < m ? qq[q0 + qoff + i] : 0.0f;
    bd[i] = INFINITY;
    bi[i] = -1;
  }

  // |v|^2 of row tid of the next tile, +inf where masked or out of range:
  // loaded before a tile's search, stored to shared memory after it
  float nxt_dd = 0.0f;
  bool nxt_ok = false;
  if (count > 0) {
    stage_tile<FC, kNnTile, kStrideD, kNnThreads>(db, f, tile_row(0), row_end, s_db);
    const int row = tile_row(0) + tid;
    if (tid < kNnTile)
      s_dd[tid] = row < row_end && dbmask[row] != 0 ? dd[row] : INFINITY;
  }
  cp_async_commit();
  for (int t = 0; t < count; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < count;
    if (more) {
      const int base = tile_row(t + 1);
      stage_tile<FC, kNnTile, kStrideD, kNnThreads>(db, f, base, row_end,
                                                    s_db + (cur ^ 1) * F * kStrideD);
      const bool in = tid < kNnTile && base + tid < row_end;
      nxt_ok = in && dbmask[base + tid] != 0;
      nxt_dd = in ? dd[base + tid] : 0.0f;
    }
    cp_async_commit();  // empty when !more: the group count stays uniform
    cp_async_wait_prior();
    __syncthreads();

    const float* sd = s_db + cur * F * kStrideD;
    float qa[kNnTQ], va[kNnTD], acc[kNnTQ][kNnTD];
    nn_operands(s_q, sd, 0, qoff, doff, qa, va);
#pragma unroll
    for (int i = 0; i < kNnTQ; ++i)
#pragma unroll
      for (int j = 0; j < kNnTD; ++j) acc[i][j] = __fmul_rn(qa[i], va[j]);
#pragma unroll 8
    for (int c = 1; c < F; ++c) {
      nn_operands(s_q, sd, c, qoff, doff, qa, va);
#pragma unroll
      for (int i = 0; i < kNnTQ; ++i)
#pragma unroll
        for (int j = 0; j < kNnTD; ++j) acc[i][j] = fmaf(qa[i], va[j], acc[i][j]);
    }
    const float* sdd = s_dd + cur * kNnTile;
    const float4 u = *reinterpret_cast<const float4*>(sdd + doff);
    const float4 w = *reinterpret_cast<const float4*>(sdd + doff + 32);
    const float ddv[kNnTD] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
    const int base = tile_row(t) + doff;
#pragma unroll
    for (int j = 0; j < kNnTD; ++j) {
      const int row = base + (j < 4 ? j : 28 + j);
#pragma unroll
      for (int i = 0; i < kNnTQ; ++i) {
        // the clamp keeps a NaN (non-finite padding) NaN, so it never wins
        const float e = expand_d2(qqv[i], acc[i][j], ddv[j]);
        const float d2 = e < 0.0f ? 0.0f : e;
        if (d2 < bd[i]) {
          bd[i] = d2;
          bi[i] = row;
        }
      }
    }
    if (more && tid < kNnTile) s_dd[(cur ^ 1) * kNnTile + tid] = nxt_ok ? nxt_dd : INFINITY;
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kNnTQ; ++i) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd[i], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], o);
      if (lex_less(od, oi, bd[i], bi[i])) {
        bd[i] = od;
        bi[i] = oi;
      }
    }
  }
  if ((lane & 7) == 0) {
#pragma unroll
    for (int i = 0; i < kNnTQ; ++i) {
      s_bd[wd * kNnBlock + qoff + i] = bd[i];
      s_bi[wd * kNnBlock + qoff + i] = bi[i];
    }
  }
  __syncthreads();
  if (tid < kNnBlock) {
    out_d = s_bd[tid];
    out_i = s_bi[tid];
    if (lex_less(s_bd[kNnBlock + tid], s_bi[kNnBlock + tid], out_d, out_i)) {
      out_d = s_bd[kNnBlock + tid];
      out_i = s_bi[kNnBlock + tid];
    }
  }
}

// The k = 1 result of query row q0 + threadIdx.x (threads < kNnBlock): the
// output itself when grid z is 1, else slice blockIdx.z's partial, which
// merge_slices reduces.  out_d / out_i / qmask are the lane's; part_d /
// part_i are (splits, b, m).
__device__ __forceinline__ void nn_store(float d, int i, int q0, int m, int q_end,
                                         const uint8_t* __restrict__ qmask,
                                         float* __restrict__ out_d, int* __restrict__ out_i,
                                         float* __restrict__ part_d, int* __restrict__ part_i) {
  const int row = q0 + threadIdx.x;
  if (threadIdx.x >= kNnBlock || row >= m) return;
  if (gridDim.z == 1) {
    const bool ok = row < q_end && qmask[row] != 0 && d < INFINITY;
    out_d[row] = ok ? d : INFINITY;
    out_i[row] = ok ? i : -1;
  } else {
    const size_t at = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * m + row;
    part_d[at] = d;
    part_i[at] = i;
  }
}

// A query block at or past the lane's extent: (inf, -1) when grid z is 1
// (merge_slices writes those rows otherwise).
__device__ __forceinline__ void nn_store_empty(int q0, int m, float* __restrict__ out_d,
                                               int* __restrict__ out_i) {
  const int row = q0 + threadIdx.x;
  if (gridDim.z == 1 && threadIdx.x < kNnBlock && row < m) {
    out_d[row] = INFINITY;
    out_i[row] = -1;
  }
}

// out (b, m) = the lexicographic minimum over the splits partials of each
// valid query row inside its lane's extent, (inf, -1) elsewhere.
static __global__ void merge_slices(const float* __restrict__ part_d,
                                    const int* __restrict__ part_i,
                                    const uint8_t* __restrict__ qmask,
                                    const int* __restrict__ q_end, int m, int splits,
                                    float* __restrict__ out_d, int* __restrict__ out_i) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t lane = blockIdx.y;
  if (row >= m) return;
  const size_t at = lane * m + row;
  float d = INFINITY;
  int i = -1;
  if (row < q_end[lane] && qmask[at]) {
    for (int z = 0; z < splits; ++z) {
      const size_t p = ((size_t)z * gridDim.y + lane) * m + row;
      if (lex_less(part_d[p], part_i[p], d, i)) {
        d = part_d[p];
        i = part_i[p];
      }
    }
  }
  out_d[at] = d < INFINITY ? d : INFINITY;
  out_i[at] = d < INFINITY ? i : -1;
}

static inline int launch_merge(const float* part_d, const int* part_i,
                               const uint8_t* qmask, const int* q_end, int b, int m, int splits,
                               float* out_d, int* out_i, cudaStream_t stream) {
  const dim3 grid(ceil_div(m, 256), b);
  merge_slices<<<grid, 256, 0, stream>>>(part_d, part_i, qmask, q_end, m, splits, out_d, out_i);
  return launch_status();
}

// K2's k > 1 path (knn_banded.cu, one thread a query): a candidate enters
// the sorted list only if strictly smaller than the current k-th, and is
// bubbled in front of strictly larger entries only, so equal distances keep
// db index order (rows visited ascending).
template <int KMAX>
__device__ __forceinline__ void topk_insert(float (&bd)[KMAX], int (&bi)[KMAX], int k,
                                            float& worst, float d2, int idx) {
  if (!(d2 < worst)) return;
  float cd = d2;
  int ci = idx;
  bool shifting = false;
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    if (s < k && (shifting || cd < bd[s])) {
      const float td = bd[s];
      const int ti = bi[s];
      bd[s] = cd;
      bi[s] = ci;
      cd = td;
      ci = ti;
      shifting = true;
    }
  }
#pragma unroll
  for (int s = 0; s < KMAX; ++s)
    if (s == k - 1) worst = bd[s];
}

// --- K1's k > 1 path: warp-cooperative selection (WarpSelect) ---------------
//
// A warp owns one query.  Its sorted list of the smallest (d2, idx) pairs so
// far is spread over the warp, KL registers a lane: element e = 32 r + lane
// lives in register r of lane `lane`, and 32 KL >= k.  Each lane also keeps
// a queue of kSelQ candidates that beat the list's k-th element when it
// looked at them.  When any lane's queue is full the warp sorts the 32 kSelQ
// queued pairs with a bitonic network (steps between lanes by
// __shfl_xor_sync, steps between registers in place) and merges the 32 KL
// smallest into the list: the elementwise minimum of the list and the
// reversed queue holds the 32 KL smallest of both as a bitonic sequence,
// which a bitonic merge sorts.  Every comparison is lexicographic on (d2,
// idx); the pairs of one query are distinct, so they have one order, and the
// list depends neither on the order of the walk nor on where the queues
// flush.  An empty slot holds (inf, kSelIdle), after every candidate.
constexpr int kSelQ = 4;                 // queue slots a lane
constexpr int kSelIdle = 0x7fffffff;     // the index of an empty slot

// (d, i) <- the other lane's pair where keep_min and the other is smaller,
// or where !keep_min and it is not smaller: the two lanes of a step agree.
__device__ __forceinline__ void sel_keep(float& d, int& i, float od, int oi, bool keep_min) {
  if (lex_less(od, oi, d, i) == keep_min) {
    d = od;
    i = oi;
  }
}

// Registers a and b (a < b in element order) in place: ascending puts the
// smaller pair in a.
__device__ __forceinline__ void sel_order(float& da, int& ia, float& db, int& ib,
                                          bool descending) {
  if (lex_less(db, ib, da, ia) != descending) {
    const float td = da;
    const int ti = ia;
    da = db;
    ia = ib;
    db = td;
    ib = ti;
  }
}

// The bitonic steps of stride STRIDE, STRIDE / 2, .., 1 within blocks of
// SIZE elements over the warp's 32 R pairs (element e = 32 r + lane): a
// block whose first element has bit SIZE set runs descending.  Steps of 32
// and more pair registers of one lane, shorter ones pair lanes.
template <int R, int SIZE, int STRIDE>
__device__ __forceinline__ void sel_steps(float (&d)[R], int (&i)[R], int lane) {
  if constexpr (STRIDE >= 32) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = r ^ (STRIDE >> 5);
      if (p > r) sel_order(d[r], i[r], d[p], i[p], ((r << 5) & SIZE) != 0);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float od = __shfl_xor_sync(0xffffffffu, d[r], STRIDE);
      const int oi = __shfl_xor_sync(0xffffffffu, i[r], STRIDE);
      const bool descending = (((r << 5) | lane) & SIZE) != 0;
      sel_keep(d[r], i[r], od, oi, ((lane & STRIDE) == 0) != descending);
    }
  }
  if constexpr (STRIDE > 1) sel_steps<R, SIZE, STRIDE / 2>(d, i, lane);
}

// Sort the warp's 32 R pairs ascending: bitonic blocks of SIZE, 2 SIZE, ..
// 32 R (call with SIZE = 2).
template <int R, int SIZE = 2>
__device__ __forceinline__ void sel_sort(float (&d)[R], int (&i)[R], int lane) {
  sel_steps<R, SIZE, SIZE / 2>(d, i, lane);
  if constexpr (SIZE < 32 * R) sel_sort<R, SIZE * 2>(d, i, lane);
}

// The list (KL registers, sorted) <- the 32 KL smallest of the list and the
// queue (kSelQ registers, any order; left sorted).  The queue's element
// 32 KL - 1 - e sits in register KL - 1 - r of lane 31 - lane.
template <int KL>
__device__ __forceinline__ void sel_merge(float (&ld)[KL], int (&li)[KL], float (&qd)[kSelQ],
                                          int (&qi)[kSelQ]) {
  static_assert(KL <= kSelQ, "the queue must hold a list's worth");
  const int lane = threadIdx.x & 31;
  sel_sort<kSelQ>(qd, qi, lane);
#pragma unroll
  for (int r = 0; r < KL; ++r) {
    const float od = __shfl_sync(0xffffffffu, qd[KL - 1 - r], 31 - lane);
    const int oi = __shfl_sync(0xffffffffu, qi[KL - 1 - r], 31 - lane);
    if (lex_less(od, oi, ld[r], li[r])) {
      ld[r] = od;
      li[r] = oi;
    }
  }
  // a bitonic sequence of 32 KL: one ascending block
  sel_steps<KL, 32 * KL, 16 * KL>(ld, li, lane);
}

// Element e of the list (the same on every lane): (d, i) of register e / 32
// of lane e % 32.
template <int KL>
__device__ __forceinline__ void sel_element(const float (&ld)[KL], const int (&li)[KL], int e,
                                            float& d, int& i) {
  float sd = ld[0];
  int si = li[0];
#pragma unroll
  for (int r = 1; r < KL; ++r) {
    if ((e >> 5) == r) {
      sd = ld[r];
      si = li[r];
    }
  }
  d = __shfl_sync(0xffffffffu, sd, e & 31);
  i = __shfl_sync(0xffffffffu, si, e & 31);
}

// Merge the queue into the list, empty the queue and take the list's k-th
// pair as the bar a candidate must beat.
template <int KL>
__device__ __forceinline__ void sel_flush(float (&ld)[KL], int (&li)[KL], float (&qd)[kSelQ],
                                          int (&qi)[kSelQ], int& queued, int k, float& kd,
                                          int& ki) {
  sel_merge<KL>(ld, li, qd, qi);
#pragma unroll
  for (int r = 0; r < kSelQ; ++r) {
    qd[r] = INFINITY;
    qi[r] = kSelIdle;
  }
  queued = 0;
  sel_element<KL>(ld, li, k - 1, kd, ki);
}

}  // namespace flsq
