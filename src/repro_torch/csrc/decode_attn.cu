// Flash-decode: one query token against the KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attn/kernel.py
// (decode_attention_kernel, pallas_call at :92): online-softmax attention of
// q (B,1,H,hd) over caches (B,Sc,K,hd), f32 statistics, optional window,
// GQA by index.  Convention: the valid positions are kpos < cache_len (the
// model layer's contract, cache_len including the token just written); the
// TPU kernel took pos = cache_len - 1 and kept kpos <= pos.  With block > 0
// it also applies the paper's block-sparse pattern as a position mask, as
// models/attention.py decode_attention(sparse=...) does: a position is read
// only if its block is a sink block, lies in the local band of the query's
// block, or is a multiple of the stride.
//
// What bounds it on the H100: each step reads the valid part of both caches
// once — at the serving shape (B = 8, K = 12, hd = 64, f32) 49 KB per
// position, 9.4 MB at cache_len 192, about 2.8 us at 3.35 TB/s — against
// 4·hd FLOP per (head, position): bound by the bytes.
//
// Design: one block per (batch, query head), eight warps.  The warps take
// the valid positions in turns, four at a time: a warp loads four K rows
// and four V rows (each lane reads hd/32 neighbouring dims, so a row is one
// coalesced read), reduces the four q·k dots by shuffles, and folds them
// into its running m, l and acc with one rescale.  The eight partial states
// are merged through shared memory at the end.  Positions past cache_len
// (and before the window) are never read, nor are positions of inactive
// blocks under the sparse mask (a warp's group of four with no active
// position is skipped whole), so a step's cost follows the positions it
// attends to, not the cache's size.  cache_len arrives as a plain int
// argument: the host never reads a device scalar in the decode loop.
// Splitting the cache across blocks (split-KV) is later work.
#include "common.cuh"

namespace {

using repro::from_f32;
using repro::NEG_INF;
using repro::to_f32;

constexpr int NW = 8;               // warps per block
constexpr int THREADS = NW * 32;
constexpr int U = 4;                // positions per warp step

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_fwd(const T* __restrict__ q, const T* __restrict__ kc,
           const T* __restrict__ vc, T* __restrict__ o, int Sc, int H, int KH,
           int cache_len, int window, int block, int sink, int local,
           int stride, float scale) {
  constexpr int DPL = HD / 32;      // dims per lane: lane, lane + 32, ...
  __shared__ float wm[NW], wl[NW];
  __shared__ float wacc[NW][HD];

  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hi = min(cache_len, Sc);
  const int lo = window > 0 ? max(0, cache_len - window) : 0;
  const int qblk = block > 0 ? (cache_len - 1) / block : 0;
  auto allowed = [&](int j) {
    if (j >= hi) return false;
    if (block <= 0) return true;
    const int blk = j / block;
    return blk < sink || blk > qblk - local || blk % stride == 0;
  };

  float qr[DPL], acc[DPL];
#pragma unroll
  for (int t = 0; t < DPL; ++t) {
    qr[t] = to_f32(q[(size_t)bh * HD + lane + 32 * t]) * scale;
    acc[t] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  const size_t pos_stride = (size_t)KH * HD;
  const size_t base = ((size_t)b * Sc * KH + kvh) * HD;

  for (int j0 = lo + warp * U; j0 < hi; j0 += NW * U) {
    bool ok[U];
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = allowed(j0 + u);
      any |= ok[u];
    }
    if (!any) continue;  // the same for the whole warp
    float kr[U][DPL], vr[U][DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t g = base + (size_t)(j0 + u) * pos_stride + lane;
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        kr[u][t] = ok[u] ? to_f32(kc[g + 32 * t]) : 0.f;
        vr[u][t] = ok[u] ? to_f32(vc[g + 32 * t]) : 0.f;
      }
    }
    float s[U];
    float cmax = NEG_INF;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < DPL; ++t) dot = fmaf(qr[t], kr[u][t], dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u] = dot;
      if (ok[u]) cmax = fmaxf(cmax, dot);
    }
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = ok[u] ? expf(s[u] - m_new) : 0.f;
      psum += s[u];
    }
    l = l * corr + psum;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      float a = acc[t] * corr;
#pragma unroll
      for (int u = 0; u < U; ++u) a = fmaf(s[u], vr[u][t], a);
      acc[t] = a;
    }
    m = m_new;
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int t = 0; t < DPL; ++t) wacc[warp][lane + 32 * t] = acc[t];
  __syncthreads();
  if (tid < HD) {
    float mt = NEG_INF;
    for (int w = 0; w < NW; ++w) mt = fmaxf(mt, wm[w]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float c = expf(wm[w] - mt);
      lt = fmaf(wl[w], c, lt);
      at = fmaf(wacc[w][tid], c, at);
    }
    o[(size_t)bh * HD + tid] = from_f32<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* o, int B, int Sc,
            int H, int KH, int cache_len, int window, const int* sp, float scale,
            cudaStream_t s) {
  decode_fwd<T, HD><<<B * H, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sc, H, KH, cache_len, window, sp[0], sp[1], sp[2], sp[3],
      scale);
}

template <typename T>
int dispatch(int HD, const void* q, const void* k, const void* v, void* o, int B,
             int Sc, int H, int KH, int cache_len, int window, const int* sp,
             float scale, cudaStream_t s) {
  switch (HD) {
    case 32: launch<T, 32>(q, k, v, o, B, Sc, H, KH, cache_len, window, sp, scale, s); break;
    case 64: launch<T, 64>(q, k, v, o, B, Sc, H, KH, cache_len, window, sp, scale, s); break;
    case 128: launch<T, 128>(q, k, v, o, B, Sc, H, KH, cache_len, window, sp, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  q/o (B,1,H,HD), caches (B,Sc,KH,HD), contiguous;
// positions < cache_len are valid.  block > 0 adds the sparse mask of
// (block, sink, local, stride); block = 0 is dense.  Returns
// cudaGetLastError().
extern "C" int decode_attn(int dtype, const void* q, const void* k, const void* v,
                           void* o, int B, int Sc, int H, int KH, int HD,
                           int cache_len, int window, int block, int sink,
                           int local, int stride, float scale, void* stream) {
  if (B < 1 || Sc < 1 || KH < 1 || H % KH != 0 || cache_len < 1 ||
      (block > 0 && stride < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sp[4] = {block, sink, local, stride};
  int rc;
  if (dtype == 0) {
    rc = dispatch<float>(HD, q, k, v, o, B, Sc, H, KH, cache_len, window, sp, scale, s);
  } else if (dtype == 1) {
    rc = dispatch<__nv_bfloat16>(HD, q, k, v, o, B, Sc, H, KH, cache_len, window, sp, scale, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
