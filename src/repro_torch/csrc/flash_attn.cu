// Causal / windowed GQA flash attention (prefill) for Hopper (sm_90a).
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
// owns one (batch·head, 64-row q tile) and loops over the kv tiles itself,
// keeping m, l and acc in registers; the per-tile step (four threads per
// query row, one rescale per 16 keys) is attn_tile.cuh's, shared with the
// block-sparse kernel.  kv tiles wholly above the causal diagonal
// or left of the window are never loaded.  Ragged Sq and Sk are masked (the
// TPU kernel required Sq % bq == 0).  q, k, v and o stay in the model layout
// (B, S, H, hd): no transposes around the call.  Tensor cores and TMA are
// later work.
#include "attn_tile.cuh"

namespace {

using repro::attend_tile;
using repro::from_f32;
using repro::load_kv_tile;
using repro::NEG_INF;
using repro::to_f32;
using repro::TPR;

constexpr int BQ = 64;                   // query rows per block
constexpr int THREADS = BQ * TPR;        // 256

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int KH, int causal, int window, float scale) {
  constexpr int BKV = repro::kv_tile_rows<HD>();
  constexpr int DPT = HD / TPR;          // dims per thread
  static_assert(BKV % repro::CH == 0, "tile must hold whole chunks");
  __shared__ float ks[BKV][HD];
  __shared__ float vs[BKV][HD];

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, row = tid / TPR, part = tid % TPR;
  const int qpos = q0 + row;
  const bool active = qpos < Sq;

  const size_t q_off = ((size_t)(b * Sq + qpos) * H + h) * HD;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    qr[t] = active ? to_f32(q[q_off + part + TPR * t]) * scale : 0.f;
    acc[t] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const int qlast = min(q0 + BQ, Sq) - 1;
  const int kv_hi = causal ? min(Sk, qlast + 1) : Sk;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const size_t pos_stride = (size_t)KH * HD;
  const size_t kv_base = ((size_t)b * Sk * KH + kvh) * HD;

  for (int j0 = kv_lo; j0 < kv_hi; j0 += BKV) {
    __syncthreads();  // the previous tile is consumed
    load_kv_tile<T, HD, BKV, THREADS>(ks, vs, k, v, kv_base, pos_stride, j0, kv_hi, tid);
    __syncthreads();
    // every thread runs it (shuffles need the whole warp); rows past Sq
    // compute on q = 0 and write nothing
    attend_tile<HD>(ks, vs, j0, min(BKV, kv_hi - j0), part, qr, acc, m, l, [&](int kp) {
      return (!causal || kp <= qpos) && (window <= 0 || kp > qpos - window);
    });
  }
  if (active) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int t = 0; t < DPT; ++t) o[q_off + part + TPR * t] = from_f32<T>(acc[t] / den);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
            int Sk, int H, int KH, int causal, int window, float scale,
            cudaStream_t s) {
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd<T, HD><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KH, causal, window, scale);
}

template <typename T>
int dispatch(int HD, const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int H, int KH, int causal, int window, float scale,
             cudaStream_t s) {
  switch (HD) {
    case 32: launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s); break;
    case 64: launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s); break;
    case 128: launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  q/o (B,Sq,H,HD), k/v (B,Sk,KH,HD), contiguous.
// Query row i sits at key position i.  Returns cudaGetLastError().
extern "C" int flash_attn(int dtype, const void* q, const void* k, const void* v,
                          void* o, int B, int Sq, int Sk, int H, int KH, int HD,
                          int causal, int window, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch<float>(HD, q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
  } else if (dtype == 1) {
    rc = dispatch<__nv_bfloat16>(HD, q, k, v, o, B, Sq, Sk, H, KH, causal, window, scale, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
