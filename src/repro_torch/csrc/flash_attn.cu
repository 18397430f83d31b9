// Causal / windowed / non-causal GQA flash attention (prefill) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py
// (flash_attention_kernel, pallas_call at :85): online-softmax attention with
// scale d^-1/2, f32 running max m, denominator l and accumulator, causal and
// optional sliding-window masks, GQA by index (query head h reads kv head
// h / (H/K)), output acc / max(l, 1e-30).  The scale is the caller's (the
// model's d^-1/2, or MLA's (nope + rope)^-1/2), and v and o may be narrower
// than q and k (MLA's (192, 128)).  The compiled (DK, DV) is a tile width:
// the call's rows (dk, dv) may be narrower, the tile zero-filled past them
// (gemma3's 240 in the 256 tile, 16 in the 32 one; attn_tile.cuh's note).
// Rows that are not whole chunks run element by element in a square tile;
// rows wider than 256 split over a thread block cluster, ranks of (128,
// 128) (attn_tile.cuh's note).
//
// What bounds it on the H100: at the serving prefill (B = 8, S = 128,
// H = 12, hd = 64, f32) it reads q, k, v and writes o once — 12.6 MB, 3.8 us
// at 3.35 TB/s — and does 4·hd FLOP per causal (q, k) pair, 0.2 GFLOP, 3.0 us
// on the CUDA cores in f32: the bytes bound it, the operations close behind.
//
// Design: the TPU grid walked kv blocks in order on one core, carrying m, l
// and acc in VMEM scratch.  CUDA blocks run in no order, so here one block
// owns one (batch·head, q tile) and walks the kv tiles itself, keeping m, l
// and acc in registers; the step is attn_tile.cuh's register-tiled one,
// shared with the block-sparse kernel (Qᵀ staged once, K/V through a double-
// buffered cp.async ring, 4 rows × BKV/16 keys of S and 4 rows × hd/16 dims
// of O per thread, one softmax rescale per kv tile, masks only in tiles
// that cross the causal diagonal, the window's left edge or the end of the
// keys).  kv tiles wholly above the diagonal or left of the window are never
// loaded.  Ragged Sq and Sk are masked (the TPU kernel required
// Sq % bq == 0).  q, k, v and o stay in the model layout (B, S, H, hd): no
// transposes around the call.
//
// The q tile: 64 rows (kv tiles of 64 keys, 32 at hd 128) where that grid
// gives every SM two blocks, else 32 rows (kv tiles of 32): at the serving
// prefill the 64-row grid is 192 blocks for 132 SMs, two of them a
// (b, h) pair's whole work, the 32-row grid 384 blocks of 128 threads that
// fit four to an SM.  Under the causal mask the heavy q tiles (the last
// ones) are launched first.
//
// Measured (H100 80GB HBM3, 700 W; chip_smoke.py CHECK lines, cold L2,
// median of 30, f32): 0.0222 ms at the serving prefill, against 0.0541 for
// the per-row step this design replaced and 0.0298 for SDPA (whose f32 runs
// on the tensor cores as 3×TF32); non-causal B 8, S 32, H 4, hd 32 0.0082
// (SDPA 0.0126).  The q tile forced (tools/attn_qtile_sweep.py): at the
// serving shape 32 rows 0.0222, 64 rows 0.0230; at S 512 64 rows 0.1321,
// 32 rows 0.1360.
//
// The split (attn_tile.cuh's note) takes rows past 256 only: heads of 512
// at B 2, S 128, H 4 causal 0.0299 ms against 0.1025 for the grid planes
// of the path it replaced and 0.0420 for SDPA; at S 1024 0.4073 against
// 0.9419 and SDPA's 0.4222; (528, 512) 0.0344 against 0.1408 (SDPA
// 0.0431; tools/attn_split_sweep.py --trees, H100 80GB HBM3 at 700 W, f32,
// cold L2, median of 30).  The (256, 256) and (192, 128) tiles keep one
// block a (batch·head, q tile): at SERVE-GEMMA3's and SERVE-MLA's shapes
// the split of those heads loses to it (attn_tile.cuh's note).
#include <type_traits>

#include "attn_tile.cuh"

namespace {

namespace cg = cooperative_groups;

using repro::AttnTile;

template <int BKV> struct FlashWalk {
  int j, hi, causal, window, qpos0, qlast;
  __device__ bool next(int& j0, int& h) {
    if (j >= hi) return false;
    j0 = j, h = hi;
    j += BKV;
    return true;
  }
  __device__ bool need_mask(int j0, int h) const {
    return j0 + BKV > h || (causal && j0 + BKV - 1 > qpos0) ||
           (window > 0 && j0 <= qlast - window);
  }
  __device__ bool allowed(int qp, int kp) const {
    return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
  }
};

// Grid (B·H, q tiles), or SPLIT (B·H·ranks, q tiles) in clusters of
// ``ranks`` along x: rank r takes q/k dims from r·kper·DK and v/o columns
// from r·vper·DV (attn_tile.cuh's note; ``work`` under LOOP with vper > 1).
template <typename T, int DK, int DV, int BQ, int BKV, int PATH, bool SPLIT>
__global__ void __launch_bounds__(AttnTile<DK, DV, BQ, BKV, SPLIT>::THREADS,
                                  AttnTile<DK, DV, BQ, BKV, SPLIT>::MIN_BLOCKS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int KH, int dk, int dv, int causal, int window, float scale, int kper, int vper,
          float* __restrict__ work) {
  extern __shared__ __align__(16) float smem[];
  repro::Rank rk;
  int rank = 0;
  if constexpr (SPLIT) {
    cg::cluster_group cluster = cg::this_cluster();
    rk = {(int)cluster.num_blocks(), kper, vper, work};
    rank = cluster.block_rank();
  }
  const int bh = blockIdx.x / rk.ranks, b = bh / H, h = bh % H, kvh = h / (H / KH);
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heavy tiles first
  const int q0 = qt * BQ, rows = min(BQ, Sq - q0), qlast = q0 + rows - 1;
  FlashWalk<BKV> walk{window > 0 ? max(0, q0 - window + 1) : 0,
                      causal ? min(Sk, qlast + 1) : Sk, causal, window, q0, qlast};
  const size_t qrow = ((size_t)b * Sq + q0) * H + h, kvrow = (size_t)b * Sk * KH + kvh;
  const int d0 = rank * rk.kper * DK, c0 = rank * rk.vper * DV;
  repro::attend_q_tile<T, DK, DV, BQ, BKV, PATH, SPLIT>(
      q, k, v, o, {qrow * dk + d0, (size_t)H * dk}, {qrow * dv + c0, (size_t)H * dv}, rows,
      {kvrow * dk + d0, (size_t)KH * dk}, {kvrow * dv + c0, (size_t)KH * dv}, dk - d0, dv - c0,
      q0, scale, walk, smem, rk);
}

template <typename T, int DK, int DV, int BQ, int PATH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int H, int KH, int dk, int dv, int causal, int window,
                   float scale, cudaStream_t s) {
  constexpr int BKV = repro::kv_tile_rows(DK, BQ);
  using L = AttnTile<DK, DV, BQ, BKV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<T, DK, DV, BQ, BKV, PATH, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd<T, DK, DV, BQ, BKV, PATH, false><<<grid, L::THREADS, L::BYTES, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KH, dk, dv, causal, window, scale, 1, 1, nullptr);
  return cudaSuccess;
}

// Rows past 256 split over ranks of (RANK_W, RANK_W) on the PATH reads
// (LOOP past SPLIT_MAX ranks): grid (B·H·ranks, q tiles) in clusters of
// ``ranks``.
template <typename T, int PATH>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* o, float* work,
                         int B, int Sq, int Sk, int H, int KH, int dk, int dv, int causal,
                         int window, float scale, cudaStream_t s) {
  constexpr int R = repro::RANK_W, BQ = repro::SPLIT_BQ, BKV = repro::kv_tile_rows(R, BQ);
  using L = AttnTile<R, R, BQ, BKV, true>;
  static const cudaError_t attr =
      repro::split_attributes(flash_fwd<T, R, R, BQ, BKV, PATH, true>, L::BYTES);
  if (attr != cudaSuccess) return attr;
  const repro::SplitPlan sp = repro::split_plan(dk, dv);
  if ((PATH == repro::LOOP) != (sp.kper > 1 || sp.vper > 1) || (sp.vper > 1 && !work))
    return cudaErrorInvalidValue;
  return repro::launch_cluster(
      flash_fwd<T, R, R, BQ, BKV, PATH, true>, dim3(B * H * sp.ranks, (Sq + BQ - 1) / BQ),
      L::THREADS, L::BYTES, sp.ranks, s, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KH, dk, dv, causal, window,
      scale, sp.kper, sp.vper, work);
}

template <typename T, int PATH>
cudaError_t split(const void* q, const void* k, const void* v, void* o, float* work, int B,
                  int Sq, int Sk, int H, int KH, int dk, int dv, int causal, int window,
                  float scale, cudaStream_t s) {
  const repro::SplitPlan sp = repro::split_plan(dk, dv);
  if (sp.kper > 1 || sp.vper > 1)
    return launch_split<T, repro::LOOP>(q, k, v, o, work, B, Sq, Sk, H, KH, dk, dv, causal,
                                        window, scale, s);
  return launch_split<T, PATH>(q, k, v, o, work, B, Sq, Sk, H, KH, dk, dv, causal, window,
                               scale, s);
}

template <typename T, int DK, int DV, int PATH>
cudaError_t pick_tile(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Sk, int H, int KH, int dk, int dv, int causal, int window,
                      float scale, cudaStream_t s) {
  // the q-tile rule of the source note (ELEM: 32 rows)
  const long long blocks64 = (long long)((Sq + 63) / 64) * B * H;
  if (PATH <= repro::CHUNK && blocks64 >= 2LL * repro::sm_count())
    return launch<T, DK, DV, PATH <= repro::CHUNK ? 64 : 32, PATH>(
        q, k, v, o, B, Sq, Sk, H, KH, dk, dv, causal, window, scale, s);
  return launch<T, DK, DV, 32, PATH>(q, k, v, o, B, Sq, Sk, H, KH, dk, dv, causal, window,
                                     scale, s);
}

// The (q/k, v) tile widths compiled (attn_tile.cuh): for whole chunks
// (REPRO_ATTN_WIDTHS) the square heads 32, 64, 128 and 256, and MLA's (192,
// 128) (deepseek-v2's published widths) and (96, 64) (its reduced d-256
// variant, q/k 80); for ELEM rows the square ones.
template <typename T, int PATH>
cudaError_t dispatch(int DK, int DV, const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int KH, int dk, int dv, int causal,
                     int window, float scale, cudaStream_t s) {
#define REPRO_WIDTH(wk, wv)                                                              \
  if (DK == wk && DV == wv)                                                              \
    return pick_tile<T, wk, wv, PATH>(q, k, v, o, B, Sq, Sk, H, KH, dk, dv, causal, window, \
                                      scale, s);
  if constexpr (PATH == repro::ELEM) {
    REPRO_ATTN_SQUARE(REPRO_WIDTH)
  } else {
    REPRO_ATTN_WIDTHS(REPRO_WIDTH)
  }
#undef REPRO_WIDTH
  return cudaErrorInvalidValue;
}

// Blocks an SM of the f32 instance (DK, DV, BQ) by the occupancy call, and
// its dynamic shared memory.
template <int DK, int DV, int BQ>
cudaError_t occupancy(int* blocks, int* smem) {
  constexpr int BKV = repro::kv_tile_rows(DK, BQ);
  using L = AttnTile<DK, DV, BQ, BKV>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<float, DK, DV, BQ, BKV, repro::ASYNC, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return e;
  *smem = L::BYTES;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flash_fwd<float, DK, DV, BQ, BKV, repro::ASYNC, false>, L::THREADS, L::BYTES);
}

// The same for the f32 split instance, and the clusters of ``ranks`` the
// card holds at once.
cudaError_t split_occupancy(int ranks, int* blocks, int* clusters, int* smem) {
  constexpr int R = repro::RANK_W, BQ = repro::SPLIT_BQ, BKV = repro::kv_tile_rows(R, BQ);
  using L = AttnTile<R, R, BQ, BKV, true>;
  auto kernel = flash_fwd<float, R, R, BQ, BKV, repro::ASYNC, true>;
  cudaError_t e = repro::split_attributes(kernel, L::BYTES);
  if (e != cudaSuccess) return e;
  *smem = L::BYTES;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, L::THREADS, L::BYTES);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks * 1024);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = ranks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// The instance family of the call's ``rows`` path (and, for whole chunks,
// of its type and the operands' alignment); rows past 256 split from
// (256, 256), read by chunks where they are whole.
template <typename T>
cudaError_t by_rows(int rows, bool vec, int HD, int HDV, float* work, const void* q,
                    const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
                    int KH, int dk, int dv, int causal, int window, float scale,
                    cudaStream_t s) {
#define REPRO_ROUTE(P)                                                                  \
  return rows == 2 ? split<T, P>(q, k, v, o, work, B, Sq, Sk, H, KH, dk, dv, causal, window, \
                                 scale, s)                                               \
                   : dispatch<T, P>(HD, HDV, q, k, v, o, B, Sq, Sk, H, KH, dk, dv, causal, \
                                    window, scale, s);
  if (rows == 1 || (rows == 2 && !repro::whole_chunks<T>(dk, dv))) REPRO_ROUTE(repro::ELEM)
  if constexpr (std::is_same_v<T, float>) {
    if (vec) REPRO_ROUTE(repro::ASYNC)
  }
  REPRO_ROUTE(repro::CHUNK)
#undef REPRO_ROUTE
}

}  // namespace

// The f32 (aligned) instance of widths (HD, HDV) with a BQ-row q tile:
// blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and bytes of
// dynamic shared memory a block.
extern "C" int flash_attn_occupancy(int HD, int HDV, int BQ, int* blocks, int* smem) {
#define REPRO_WIDTH(wk, wv)                                                   \
  if (HD == wk && HDV == wv)                                                  \
    return (int)(BQ == 64 ? occupancy<wk, wv, 64>(blocks, smem)               \
                          : occupancy<wk, wv, 32>(blocks, smem));
  REPRO_ATTN_WIDTHS(REPRO_WIDTH)
#undef REPRO_WIDTH
  return (int)cudaErrorInvalidValue;
}

// The f32 (aligned) split instance rows past 256 run in: blocks an SM,
// clusters of ``ranks`` resident at once (cudaOccupancyMaxActiveClusters),
// bytes of dynamic shared memory a block.
extern "C" int flash_attn_split_occupancy(int ranks, int* blocks, int* clusters, int* smem) {
  if (ranks < 1 || ranks > repro::SPLIT_MAX) return (int)cudaErrorInvalidValue;
  return (int)split_occupancy(ranks, blocks, clusters, smem);
}

// dtype: 0 = f32, 1 = bf16.  q (B,Sq,H,dk), k (B,Sk,KH,dk), v (B,Sk,KH,dv),
// o (B,Sq,H,dv), contiguous, run in the compiled (HD, HDV) tile on the
// ``rows`` path (attn_tile.cuh: 0 whole 4-element chunks, dk ≤ HD, dv ≤
// HDV; 1 any widths up to a square tile's; 2 any widths, split from (256,
// 256)); ``work``: an f32 (B,Sq,H,dv) workspace where the split loops over
// more than one v slice a rank (dv past 16 · 128), else unused.  Query row
// i sits at key position i.  Returns the first error of the launch, else
// cudaGetLastError() after it.
extern "C" int flash_attn(int dtype, const void* q, const void* k, const void* v,
                          void* o, void* work, int B, int Sq, int Sk, int H, int KH, int HD,
                          int HDV, int rows, int dk, int dv, int causal, int window,
                          float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0 ||
      !repro::row_widths_fit(rows, dk, dv, HD, HDV))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = repro::aligned16(q) && repro::aligned16(k) && repro::aligned16(v) &&
                   repro::aligned16(o);
  float* w = static_cast<float*>(work);
  cudaError_t e;
  if (dtype == 0) {
    e = by_rows<float>(rows, vec, HD, HDV, w, q, k, v, o, B, Sq, Sk, H, KH, dk, dv, causal,
                       window, scale, s);
  } else if (dtype == 1) {
    e = by_rows<__nv_bfloat16>(rows, vec, HD, HDV, w, q, k, v, o, B, Sq, Sk, H, KH, dk, dv,
                               causal, window, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
