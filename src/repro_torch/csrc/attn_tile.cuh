// The kv-tile step shared by the prefill attention kernels (flash_attn.cu,
// block_sparse_attn.cu): stage a tile of K and V rows in shared memory as
// f32, and fold it into each query row's online softmax — running max m
// (starting at NEG_INF), denominator l and accumulator acc, all f32.
//
// Four threads share a query row, each holding an interleaved quarter of q
// and acc (dims part, part + 4, ...) so reads of the tiles are
// conflict-free; the partial q·k dots meet by warp shuffles, and acc is
// rescaled once per 16 keys.  A masked key adds p = 0 exactly, so a tile
// with no allowed key leaves (m, l, acc) as they were.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int TPR = 4;    // threads per query row
constexpr int CH = 16;    // keys per online-softmax update

// kv rows per tile: 32 KB of K and V in f32
template <int HD> __host__ __device__ constexpr int kv_tile_rows() { return 4096 / HD; }

// All threads of the block: K and V rows [j0, min(j0 + BKV, kv_hi)) of one
// kv head (row j at kv_base + j * pos_stride) into ks/vs, zeros past kv_hi.
template <typename T, int HD, int BKV, int THREADS>
__device__ __forceinline__ void load_kv_tile(float (*ks)[HD], float (*vs)[HD],
                                             const T* __restrict__ k,
                                             const T* __restrict__ v, size_t kv_base,
                                             size_t pos_stride, int j0, int kv_hi,
                                             int tid) {
  for (int i = tid; i < BKV * HD; i += THREADS) {
    const int jj = i / HD, d = i % HD, kp = j0 + jj;
    const bool ok = kp < kv_hi;
    const size_t g = kv_base + (size_t)kp * pos_stride + d;
    ks[jj][d] = ok ? to_f32(k[g]) : 0.f;
    vs[jj][d] = ok ? to_f32(v[g]) : 0.f;
  }
}

// Thread `part` of a query row: fold the tile's first nj keys (key
// positions j0, j0 + 1, ...) for which allowed(position) holds into
// (m, l, acc).  Every thread of a warp calls it: the shuffles need them all.
template <int HD, typename Allowed>
__device__ __forceinline__ void attend_tile(const float (*ks)[HD], const float (*vs)[HD],
                                            int j0, int nj, int part,
                                            const float (&qr)[HD / TPR],
                                            float (&acc)[HD / TPR], float& m, float& l,
                                            Allowed allowed) {
  constexpr int DPT = HD / TPR;
  for (int c = 0; c < nj; c += CH) {
    float s[CH];
    unsigned okm = 0;
    float cmax = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t) dot = fmaf(qr[t], ks[c + jj][part + TPR * t], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const bool ok = c + jj < nj && allowed(j0 + c + jj);
      okm |= (unsigned)ok << jj;
      s[jj] = dot;
      if (ok) cmax = fmaxf(cmax, dot);
    }
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      s[jj] = (okm >> jj) & 1u ? expf(s[jj] - m_new) : 0.f;
      psum += s[jj];
    }
    l = l * corr + psum;
#pragma unroll
    for (int t = 0; t < DPT; ++t) {
      float a = acc[t] * corr;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) a = fmaf(s[jj], vs[c + jj][part + TPR * t], a);
      acc[t] = a;
    }
    m = m_new;
  }
}

}  // namespace repro
