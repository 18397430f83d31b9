// Causal / windowed / non-causal GQA flash attention (prefill) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn/kernel.py
// (flash_attention_kernel, pallas_call at :85): online-softmax attention with
// scale d^-1/2, f32 running max m, denominator l and accumulator, causal and
// optional sliding-window masks, GQA by index (query head h reads kv head
// h / (H/K)), output acc / max(l, 1e-30).
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
#include "attn_tile.cuh"

namespace {

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

template <typename T, int HD, int BQ, int BKV, bool ASYNC>
__global__ void __launch_bounds__(AttnTile<HD, BQ, BKV>::THREADS,
                                  AttnTile<HD, BQ, BKV>::MIN_BLOCKS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int KH, int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KH);
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heavy tiles first
  const int q0 = qt * BQ, rows = min(BQ, Sq - q0), qlast = q0 + rows - 1;
  FlashWalk<BKV> walk{window > 0 ? max(0, q0 - window + 1) : 0,
                      causal ? min(Sk, qlast + 1) : Sk, causal, window, q0, qlast};
  repro::attend_q_tile<T, HD, BQ, BKV, ASYNC>(
      q, k, v, o, ((size_t)b * Sq + q0) * H * HD + (size_t)h * HD, (size_t)H * HD, rows,
      ((size_t)b * Sk * KH + kvh) * HD, (size_t)KH * HD, q0, scale, walk, smem);
}

template <typename T, int HD, int BQ, bool ASYNC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int H, int KH, int causal, int window, float scale,
                   cudaStream_t s) {
  constexpr int BKV = repro::kv_tile_rows(HD, BQ);
  using L = AttnTile<HD, BQ, BKV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<T, HD, BQ, BKV, ASYNC>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_fwd<T, HD, BQ, BKV, ASYNC><<<grid, L::THREADS, L::BYTES, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KH, causal, window, scale);
  return cudaSuccess;
}

template <typename T, int HD, bool ASYNC>
cudaError_t pick_tile(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Sk, int H, int KH, int causal, int window, float scale,
                      cudaStream_t s) {
  // the q-tile rule of the source note
  const long long blocks64 = (long long)((Sq + 63) / 64) * B * H;
  if (blocks64 >= 2LL * repro::sm_count())
    return launch<T, HD, 64, ASYNC>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
  return launch<T, HD, 32, ASYNC>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
}

template <typename T, bool ASYNC>
cudaError_t dispatch(int HD, const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Sk, int H, int KH, int causal, int window, float scale,
                     cudaStream_t s) {
  switch (HD) {
    case 32: return pick_tile<T, 32, ASYNC>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
    case 64: return pick_tile<T, 64, ASYNC>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
    case 128: return pick_tile<T, 128, ASYNC>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  q/o (B,Sq,H,HD), k/v (B,Sk,KH,HD), contiguous.
// Query row i sits at key position i.  Returns the first error of the
// launch, else cudaGetLastError() after it.
extern "C" int flash_attn(int dtype, const void* q, const void* k, const void* v,
                          void* o, int B, int Sq, int Sk, int H, int KH, int HD,
                          int causal, int window, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = repro::aligned16(q) && repro::aligned16(k) && repro::aligned16(v) &&
                   repro::aligned16(o);
  cudaError_t e;
  if (dtype == 0 && vec) {
    e = dispatch<float, true>(HD, q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
  } else if (dtype == 0) {
    e = dispatch<float, false>(HD, q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
  } else if (dtype == 1) {
    e = dispatch<__nv_bfloat16, false>(HD, q, k, v, o, B, Sq, Sk, H, KH, causal, window,
                                       scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
