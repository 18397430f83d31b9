// Causal block-sparse attention (the paper's sparse-attention device, at
// prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/block_sparse_attn/kernel.py
// (block_sparse_attention_kernel, pallas_call at :102): query block i reads
// only the kv blocks of row i of the static (idx, valid) table (sink blocks,
// a local band, strided global blocks; models/attention.py
// sparse_block_table), with the causal mask inside them, scale d^-1/2, f32
// running max m (initialised to -1e30, the JAX NEG_INF, so a fully masked
// tile adds p = 0 rather than NaN), denominator l and accumulator, GQA by
// index, output acc / max(l, 1e-30).  Query rows sit at key positions
// q_offset + row.  The scale is the caller's, and v and o may be narrower
// than q and k (MLA's (192, 128) and (96, 64)); the call's rows (dk, dv) may
// be narrower than the compiled tile, which is zero-filled past them
// (gemma3's 240 in the 256 tile; attn_tile.cuh's note); rows that are not
// whole chunks run element by element in a square tile, rows wider than
// 256 split over a thread block cluster as in flash_attn.cu.
//
// What bounds it on the H100: at the serving prefill (B = 8, S = 896,
// H = 12, hd = 64, block 128, local 4, sink 1, stride 8, f32) query block i
// has min(i + 1, 5) active blocks, so the causal pairs inside them number
// 352,704 per (b, h) (dense causal: 401,856): 4·hd FLOP each is 8.7 GFLOP,
// 130 us on the CUDA cores in f32, against 88 MB of q, k, v and o, 26 us at
// 3.35 TB/s: bound by the operations.
//
// Design: the TPU grid walked the active slots of a q block in order on one
// core (a sequential grid axis fed by scalar prefetch).  Here one CUDA
// block owns one (batch·head, q tile inside a q block) — a 128-row block is
// two 64-row tiles — reads its q block's row of the table itself and walks
// the VALID slots only, loading nothing for an invalid one, and within a
// slot's kv block the kv tiles up to the causal diagonal.  The step is
// attn_tile.cuh's register-tiled one, shared with flash_attn.cu: the walk
// runs over slots and tiles alike, so the double-buffered cp.async ring
// loads the first tile of the next slot while the last one of this slot is
// computed, and only tiles that cross the diagonal (or a kv block's end)
// take the per-key mask.
//
// The q tile: 64 rows (kv tiles of 64 keys, 32 at hd 128) when the block
// has more than 32 rows and the 64-row grid gives every SM two blocks, else
// 32 rows (kv tiles of 32); a q tile never spans two q blocks, so a block of
// 16 rows leaves half a 32-row tile idle.  The q blocks with the most active
// slots (the last ones) are launched first.
//
// Measured (H100 80GB HBM3, 700 W; chip_smoke.py CHECK lines, cold L2,
// median of 30, f32): 0.3056 ms at the serving prefill, 28 TFLOP/s of
// needed work, against 0.8242 for the per-row step this design replaced and
// 0.7483 for SDPA with the pattern as a boolean mask.  The q tile forced
// (tools/attn_qtile_sweep.py): 64 rows 0.3051, 32 rows 0.3241.
//
// The split (flash_attn.cu's) takes rows past 256 only: heads of 512 at
// B 2, S 128, H 4, block 16 0.0348 ms against 0.0865 for the grid planes
// of the path it replaced and 0.0508 for SDPA with the pattern as a mask
// (tools/attn_split_sweep.py --trees, H100 80GB HBM3 at 700 W, f32, cold
// L2, median of 30).  The (256, 256) and (192, 128) tiles keep one block a
// (batch·head, q tile), as in flash_attn.cu.
#include <type_traits>

#include "attn_tile.cuh"

namespace {

namespace cg = cooperative_groups;

using repro::AttnTile;

template <int BKV> struct SparseWalk {
  const int* idx;      // the q block's row of the table
  const int* valid;
  int n_active, block, Sk, qpos0, qend;  // rows' key positions [qpos0, qend)
  int a = -1, j = 0, hi = 0;
  __device__ bool next(int& j0, int& h) {
    if (a >= 0 && j + BKV < hi) {
      j += BKV;
    } else {
      for (++a; a < n_active; ++a) {
        if (!valid[a]) continue;  // the same for the whole block
        const int lo = idx[a] * block;
        const int top = min(min(lo + block, Sk), qend);
        if (lo < top) {
          j = lo, hi = top;
          break;
        }
      }
      if (a >= n_active) return false;
    }
    j0 = j, h = hi;
    return true;
  }
  __device__ bool need_mask(int j0, int h) const {
    return j0 + BKV > h || j0 + BKV - 1 > qpos0;
  }
  __device__ bool allowed(int qp, int kp) const { return kp <= qp; }
};

// Grid (B·H, q tiles), or SPLIT (B·H·ranks, q tiles) in clusters of
// ``ranks`` along x: rank r takes q/k dims from r·kper·DK and v/o columns
// from r·vper·DV (attn_tile.cuh's note; ``work`` under LOOP with vper > 1).
template <typename T, int DK, int DV, int BQ, int BKV, int PATH, bool SPLIT>
__global__ void __launch_bounds__(AttnTile<DK, DV, BQ, BKV, SPLIT>::THREADS,
                                  AttnTile<DK, DV, BQ, BKV, SPLIT>::MIN_BLOCKS)
bsa_fwd(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, T* __restrict__ o,
        const int* __restrict__ idx, const int* __restrict__ valid, int Sq,
        int Sk, int H, int KH, int dk, int dv, int block, int n_active, int q_offset,
        float scale, int kper, int vper, float* __restrict__ work) {
  extern __shared__ __align__(16) float smem[];
  repro::Rank rk;
  int rank = 0;
  if constexpr (SPLIT) {
    cg::cluster_group cluster = cg::this_cluster();
    rk = {(int)cluster.num_blocks(), kper, vper, work};
    rank = cluster.block_rank();
  }
  const int n_sub = (block + BQ - 1) / BQ;
  const int y = gridDim.y - 1 - blockIdx.y;  // the last q blocks (most slots) first
  const int qb = y / n_sub, sub = y % n_sub;
  const int bh = blockIdx.x / rk.ranks, b = bh / H, h = bh % H, kvh = h / (H / KH);
  const int q0 = qb * block + sub * BQ;          // first row (q index)
  const int rows = min(BQ, block - sub * BQ);
  const int qpos0 = q_offset + q0;               // its key position
  SparseWalk<BKV> walk{idx + (size_t)qb * n_active, valid + (size_t)qb * n_active,
                       n_active, block, Sk, qpos0, qpos0 + rows};
  const size_t qrow = ((size_t)b * Sq + q0) * H + h, kvrow = (size_t)b * Sk * KH + kvh;
  const int d0 = rank * rk.kper * DK, c0 = rank * rk.vper * DV;
  repro::attend_q_tile<T, DK, DV, BQ, BKV, PATH, SPLIT>(
      q, k, v, o, {qrow * dk + d0, (size_t)H * dk}, {qrow * dv + c0, (size_t)H * dv}, rows,
      {kvrow * dk + d0, (size_t)KH * dk}, {kvrow * dv + c0, (size_t)KH * dv}, dk - d0, dv - c0,
      qpos0, scale, walk, smem, rk);
}

template <typename T, int DK, int DV, int BQ, int PATH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* idx,
                   const int* valid, int B, int Sq, int Sk, int H, int KH, int dk, int dv,
                   int block, int n_active, int q_offset, float scale, cudaStream_t s) {
  constexpr int BKV = repro::kv_tile_rows(DK, BQ);
  using L = AttnTile<DK, DV, BQ, BKV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      bsa_fwd<T, DK, DV, BQ, BKV, PATH, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (Sq / block) * ((block + BQ - 1) / BQ));
  bsa_fwd<T, DK, DV, BQ, BKV, PATH, false><<<grid, L::THREADS, L::BYTES, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), idx, valid, Sq, Sk, H, KH, dk, dv, block, n_active, q_offset,
      scale, 1, 1, nullptr);
  return cudaSuccess;
}

// Rows past 256 split over ranks of (RANK_W, RANK_W) on the PATH reads
// (LOOP past SPLIT_MAX ranks): grid (B·H·ranks, q tiles) in clusters of
// ``ranks``.
template <typename T, int PATH>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* o, float* work,
                         const int* idx, const int* valid, int B, int Sq, int Sk, int H,
                         int KH, int dk, int dv, int block, int n_active, int q_offset,
                         float scale, cudaStream_t s) {
  constexpr int R = repro::RANK_W, BQ = repro::SPLIT_BQ, BKV = repro::kv_tile_rows(R, BQ);
  using L = AttnTile<R, R, BQ, BKV, true>;
  static const cudaError_t attr =
      repro::split_attributes(bsa_fwd<T, R, R, BQ, BKV, PATH, true>, L::BYTES);
  if (attr != cudaSuccess) return attr;
  const repro::SplitPlan sp = repro::split_plan(dk, dv);
  if ((PATH == repro::LOOP) != (sp.kper > 1 || sp.vper > 1) || (sp.vper > 1 && !work))
    return cudaErrorInvalidValue;
  return repro::launch_cluster(
      bsa_fwd<T, R, R, BQ, BKV, PATH, true>,
      dim3(B * H * sp.ranks, (Sq / block) * ((block + BQ - 1) / BQ)), L::THREADS, L::BYTES,
      sp.ranks, s, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), idx, valid, Sq, Sk, H, KH, dk, dv, block,
      n_active, q_offset, scale, sp.kper, sp.vper, work);
}

template <typename T, int PATH>
cudaError_t split(const void* q, const void* k, const void* v, void* o, float* work,
                  const int* idx, const int* valid, int B, int Sq, int Sk, int H, int KH,
                  int dk, int dv, int block, int n_active, int q_offset, float scale,
                  cudaStream_t s) {
  const repro::SplitPlan sp = repro::split_plan(dk, dv);
  if (sp.kper > 1 || sp.vper > 1)
    return launch_split<T, repro::LOOP>(q, k, v, o, work, idx, valid, B, Sq, Sk, H, KH, dk,
                                        dv, block, n_active, q_offset, scale, s);
  return launch_split<T, PATH>(q, k, v, o, work, idx, valid, B, Sq, Sk, H, KH, dk, dv, block,
                               n_active, q_offset, scale, s);
}

template <typename T, int DK, int DV, int PATH>
cudaError_t pick_tile(const void* q, const void* k, const void* v, void* o, const int* idx,
                      const int* valid, int B, int Sq, int Sk, int H, int KH, int dk, int dv,
                      int block, int n_active, int q_offset, float scale, cudaStream_t s) {
  // the q-tile rule of the source note (ELEM: 32 rows)
  const long long blocks64 = (long long)(Sq / block) * ((block + 63) / 64) * B * H;
  if (PATH <= repro::CHUNK && block > 32 && blocks64 >= 2LL * repro::sm_count())
    return launch<T, DK, DV, PATH <= repro::CHUNK ? 64 : 32, PATH>(
        q, k, v, o, idx, valid, B, Sq, Sk, H, KH, dk, dv, block, n_active, q_offset, scale, s);
  return launch<T, DK, DV, 32, PATH>(q, k, v, o, idx, valid, B, Sq, Sk, H, KH, dk, dv, block,
                                     n_active, q_offset, scale, s);
}

// The (q/k, v) tile widths compiled, flash_attn.cu's: REPRO_ATTN_WIDTHS for
// whole chunks, the square ones for ELEM rows.
template <typename T, int PATH>
cudaError_t dispatch(int DK, int DV, const void* q, const void* k, const void* v, void* o,
                     const int* idx, const int* valid, int B, int Sq, int Sk, int H, int KH,
                     int dk, int dv, int block, int n_active, int q_offset, float scale,
                     cudaStream_t s) {
#define REPRO_WIDTH(wk, wv)                                                              \
  if (DK == wk && DV == wv)                                                              \
    return pick_tile<T, wk, wv, PATH>(q, k, v, o, idx, valid, B, Sq, Sk, H, KH, dk, dv,  \
                                      block, n_active, q_offset, scale, s);
  if constexpr (PATH == repro::ELEM) {
    REPRO_ATTN_SQUARE(REPRO_WIDTH)
  } else {
    REPRO_ATTN_WIDTHS(REPRO_WIDTH)
  }
#undef REPRO_WIDTH
  return cudaErrorInvalidValue;
}

// The instance family of the call's ``rows`` path (and, for whole chunks,
// of its type and the operands' alignment); rows past 256 split from
// (256, 256), read by chunks where they are whole.
template <typename T>
cudaError_t by_rows(int rows, bool vec, int HD, int HDV, float* work, const void* q,
                    const void* k, const void* v, void* o, const int* idx, const int* valid,
                    int B, int Sq, int Sk, int H, int KH, int dk, int dv, int block,
                    int n_active, int q_offset, float scale, cudaStream_t s) {
#define REPRO_ROUTE(P)                                                                     \
  return rows == 2 ? split<T, P>(q, k, v, o, work, idx, valid, B, Sq, Sk, H, KH, dk, dv,  \
                                 block, n_active, q_offset, scale, s)                    \
                   : dispatch<T, P>(HD, HDV, q, k, v, o, idx, valid, B, Sq, Sk, H, KH, dk, \
                                    dv, block, n_active, q_offset, scale, s);
  if (rows == 1 || (rows == 2 && !repro::whole_chunks<T>(dk, dv))) REPRO_ROUTE(repro::ELEM)
  if constexpr (std::is_same_v<T, float>) {
    if (vec) REPRO_ROUTE(repro::ASYNC)
  }
  REPRO_ROUTE(repro::CHUNK)
#undef REPRO_ROUTE
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  q (B,Sq,H,dk), k (B,Sk,KH,dk), v (B,Sk,KH,dv),
// o (B,Sq,H,dv), contiguous, run in the compiled (HD, HDV) tile on the
// ``rows`` path (flash_attn's: 0 whole 4-element chunks up to the tile's
// widths, 1 any widths up to a square tile's, 2 any, split from (256,
// 256)); ``work``: flash_attn's f32 workspace where the split loops over
// more than one v slice a rank; idx/valid (Sq/block, n_active) int32 on
// the device.  Sq and Sk are multiples of block; query row i sits at key
// position q_offset + i.  Returns the first error of the launch, else
// cudaGetLastError() after it.
extern "C" int block_sparse_attn(int dtype, const void* q, const void* k,
                                 const void* v, void* o, void* work, const void* idx,
                                 const void* valid, int B, int Sq, int Sk, int H,
                                 int KH, int HD, int HDV, int rows, int dk, int dv,
                                 int block, int n_active, int q_offset, float scale,
                                 void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0 || block < 1 ||
      !repro::row_widths_fit(rows, dk, dv, HD, HDV) ||
      Sq % block != 0 || Sk % block != 0 || n_active < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const int* vp = static_cast<const int*>(valid);
  const bool vec = repro::aligned16(q) && repro::aligned16(k) && repro::aligned16(v) &&
                   repro::aligned16(o);
  float* w = static_cast<float*>(work);
  cudaError_t e;
  if (dtype == 0) {
    e = by_rows<float>(rows, vec, HD, HDV, w, q, k, v, o, ip, vp, B, Sq, Sk, H, KH, dk, dv,
                       block, n_active, q_offset, scale, s);
  } else if (dtype == 1) {
    e = by_rows<__nv_bfloat16>(rows, vec, HD, HDV, w, q, k, v, o, ip, vp, B, Sq, Sk, H, KH,
                               dk, dv, block, n_active, q_offset, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
