// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk/kernel.py
// (ssd_chunk_kernel, pallas_call at :76).  For each (batch, head) and each
// chunk of L positions, with cs the in-chunk prefix sum of dt·a:
//   y_intra[l] = sum_{m <= l} (C_l · B_m) exp(cs_l - cs_m) dt_m x_m
//   y_inter[l] = exp(cs_l) C_l · state
//   state      = exp(cs_L) state + sum_m x_m (B_m dt_m exp(cs_L - cs_m))
// with the (P, N) state carried from chunk to chunk in f32 and written out
// at the end.  Beyond the TPU kernel it takes the model contract of
// models/ssm.py ssd_chunk_scan: an optional initial state h0, and a length
// S that is not a multiple of the chunk (positions >= S act as dt = 0: the
// state passes through and no output is written).  y excludes the D-skip
// term, which the mixer adds.
//
// What bounds it on the H100: at the mamba2-1.3b serve prefill (B 4, S 512,
// H 64, P 64, N 128, chunk 256, f32) the causal score products, the two
// output products and the state update are about 11 GFLOP, 0.16 ms on the
// CUDA cores in f32, against 78 MB of x, B, C, dt, y and state, 23 us at
// 3.35 TB/s: bound by the operations.
//
// Design: the TPU walked the chunks on a sequential grid axis, carrying the
// state in VMEM scratch.  Here one CUDA block owns one (batch, head) and
// loops over the chunks itself, the state in shared memory (32 KB at
// P 64, N 128).  At chunk 256 the L x L f32 score tile alone would be
// 256 KB, over the 227 KB a block may use, so the chunk is cut into 64-row
// sub-blocks: for each row sub-block of C the block computes the inter-chunk
// term against the carried state, then loops over the column sub-blocks of
// B and x at or left of it (the causal skip), forming a 64 x 64 score tile,
// decaying and masking it, and multiplying it into x.  The last row
// sub-block's pass over all column sub-blocks also accumulates the state
// update in registers, which is applied after every output row has used the
// old state.  The decay is exp of a difference of prefix sums, never a ratio
// of exponentials: sum dt·a over 256 positions reaches hundreds below zero
// and exp of it underflows.  The prefix sum is the block's own scan (warp
// shuffles, then across warps).  B and C come in with their own strides, so
// the mixer's stride-0 broadcast of one group over the heads is read in
// place.  256 threads in a 16 x 16 grid, each with a 4-row micro-tile;
// f32 throughout (bf16 operands are widened).  Tensor cores are later work.
#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int THREADS = 256;   // a 16 x 16 grid of threads
constexpr int TS = 64;         // rows of a chunk sub-block
constexpr int LMAX = 1024;     // longest chunk
constexpr int RPT = TS / 16;   // rows of a sub-block per thread

struct Strides {
  long long b, s, h;   // elements; the last axis (P or N) is contiguous
};

// Dynamic shared memory, in floats.  Padded rows keep the two half warps of
// a warp on different banks.
template <int P, int N>
struct Layout {
  static constexpr int PS = (P % 32 == 0) ? P + 16 : P;   // state row
  static constexpr int TP = TS + 1;                        // transposed B/C row
  static constexpr int SSW = TS + 4;                       // score row
  static constexpr int cs = 0;
  static constexpr int dts = cs + LMAX;
  static constexpr int Cs = dts + LMAX;
  static constexpr int Bs = Cs + N * TP;
  static constexpr int xs = Bs + N * TP;
  static constexpr int Ss = xs + TS * P;
  static constexpr int St = Ss + TS * SSW;
  static constexpr int total = St + N * PS;
  static constexpr size_t bytes = sizeof(float) * total;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ a_coef, const T* __restrict__ bm,
        const T* __restrict__ cm, const float* __restrict__ h0,
        T* __restrict__ y, float* __restrict__ h_out, int S, int H, int L,
        Strides xst, Strides bst, Strides cst) {
  using Ly = Layout<P, N>;
  constexpr int PJ = P / 16, NI = N / 16;
  extern __shared__ float smem[];
  float* cs = smem + Ly::cs;
  float* dts = smem + Ly::dts;
  float (*Cs)[Ly::TP] = reinterpret_cast<float (*)[Ly::TP]>(smem + Ly::Cs);
  float (*Bs)[Ly::TP] = reinterpret_cast<float (*)[Ly::TP]>(smem + Ly::Bs);
  float (*xs)[P] = reinterpret_cast<float (*)[P]>(smem + Ly::xs);
  float (*Ss)[Ly::SSW] = reinterpret_cast<float (*)[Ly::SSW]>(smem + Ly::Ss);
  float (*St)[Ly::PS] = reinterpret_cast<float (*)[Ly::PS]>(smem + Ly::St);
  __shared__ float wsum[THREADS / 32];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const float a = a_coef[h];
  const T* xb = x + b * xst.b + h * xst.h;
  const T* bb = bm + b * bst.b + h * bst.h;
  const T* cb = cm + b * cst.b + h * cst.h;
  const size_t state_off = (size_t)bh * P * N;

  for (int i = tid; i < P * N; i += THREADS)   // the state, transposed
    St[i % N][i / N] = h0 != nullptr ? h0[state_off + i] : 0.f;

  const int nsub = (L + TS - 1) / TS;
  const int E = (L + THREADS - 1) / THREADS;   // scan elements per thread (<= 4)
  for (int c0 = 0; c0 < S; c0 += L) {
    // ---- dt of the chunk and the inclusive prefix sum of dt·a
    for (int r = tid; r < L; r += THREADS) {
      const int pos = c0 + r;
      dts[r] = pos < S ? dt[((size_t)b * S + pos) * H + h] : 0.f;
    }
    __syncthreads();
    float loc[4], run = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = tid * E + e;
      if (e < E && r < L) run += dts[r] * a;
      loc[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      float w = lane < THREADS / 32 ? wsum[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < THREADS / 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += up;
      }
      if (lane < THREADS / 32) wsum[lane] = w;
    }
    __syncthreads();
    const float before = incl - run + (warp > 0 ? wsum[warp - 1] : 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = tid * E + e;
      if (e < E && r < L) cs[r] = before + loc[e];
    }
    __syncthreads();
    const float total = cs[L - 1];

    float hacc[NI][PJ];   // the state update, owned (n = ty + 16 i, p = tx + 16 j)
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) hacc[i][j] = 0.f;

    for (int lb = 0; lb < nsub; ++lb) {
      const int l0 = lb * TS;
      for (int i = tid; i < TS * N; i += THREADS) {
        const int r = i / N, n = i % N, row = l0 + r, pos = c0 + row;
        Cs[n][r] = (row < L && pos < S) ? to_f32(cb[pos * cst.s + n]) : 0.f;
      }
      __syncthreads();
      // inter-chunk term: exp(cs_l) · C_l · state
      float yacc[RPT][PJ];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) yacc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RPT], sv[PJ];
#pragma unroll
        for (int i = 0; i < RPT; ++i) cv[i] = Cs[n][ty * RPT + i];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sv[j] = St[n][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) yacc[i][j] = fmaf(cv[i], sv[j], yacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = l0 + ty * RPT + i;
        const float e = row < L ? expf(cs[row]) : 0.f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) yacc[i][j] *= e;
      }
      const bool last = lb == nsub - 1;
      for (int mb = 0; mb <= lb; ++mb) {
        const int m0 = mb * TS;
        for (int i = tid; i < TS * N; i += THREADS) {
          const int r = i / N, n = i % N, row = m0 + r, pos = c0 + row;
          Bs[n][r] = (row < L && pos < S) ? to_f32(bb[pos * bst.s + n]) : 0.f;
        }
        for (int i = tid; i < TS * P; i += THREADS) {
          const int r = i / P, p = i % P, row = m0 + r, pos = c0 + row;
          xs[r][p] = (row < L && pos < S) ? to_f32(xb[pos * xst.s + p]) : 0.f;
        }
        __syncthreads();
        // the decayed, masked score tile: S[l][m] = C_l·B_m exp(cs_l - cs_m) dt_m
        float sc[RPT][4];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[RPT], bv[4];
#pragma unroll
          for (int i = 0; i < RPT; ++i) cv[i] = Cs[n][ty * RPT + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[n][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int l = l0 + ty * RPT + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = m0 + tx + 16 * j;
            Ss[ty * RPT + i][tx + 16 * j] =
                (m <= l && l < L) ? sc[i][j] * expf(cs[l] - cs[m]) * dts[m] : 0.f;
          }
        }
        __syncthreads();
        // intra-chunk term: S · x
        for (int mm = 0; mm < TS; ++mm) {
          float sv[RPT], xv[PJ];
#pragma unroll
          for (int i = 0; i < RPT; ++i) sv[i] = Ss[ty * RPT + i][mm];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = xs[mm][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) yacc[i][j] = fmaf(sv[i], xv[j], yacc[i][j]);
        }
        if (last) {  // state update: x_m (B_m dt_m exp(cs_L - cs_m)), over every m
          for (int mm = 0; mm < TS; ++mm) {
            const int m = m0 + mm;
            const float w = m < L ? dts[m] * expf(total - cs[m]) : 0.f;
            float xv[PJ], bv[NI];
#pragma unroll
            for (int j = 0; j < PJ; ++j) xv[j] = xs[mm][tx + 16 * j] * w;
#pragma unroll
            for (int i = 0; i < NI; ++i) bv[i] = Bs[ty + 16 * i][mm];
#pragma unroll
            for (int i = 0; i < NI; ++i)
#pragma unroll
              for (int j = 0; j < PJ; ++j) hacc[i][j] = fmaf(bv[i], xv[j], hacc[i][j]);
          }
        }
        __syncthreads();  // Bs, xs and Ss are reloaded next
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = l0 + ty * RPT + i, pos = c0 + row;
        if (row < L && pos < S) {
          T* yr = y + (((size_t)b * S + pos) * H + h) * P;
#pragma unroll
          for (int j = 0; j < PJ; ++j) yr[tx + 16 * j] = from_f32<T>(yacc[i][j]);
        }
      }
    }
    // every output row of the chunk has read the old state: update it
    const float et = expf(total);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        float& st = St[ty + 16 * i][tx + 16 * j];
        st = fmaf(et, st, hacc[i][j]);
      }
    __syncthreads();
  }
  for (int i = tid; i < P * N; i += THREADS) h_out[state_off + i] = St[i % N][i / N];
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, const float* h0, void* y, float* h_out, int B, int S,
           int H, int L, Strides xs, Strides bs, Strides cs, cudaStream_t s) {
  static_assert(P % 16 == 0 && N % 16 == 0, "16 x 16 thread grid");
  const size_t bytes = Layout<P, N>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd<T, P, N><<<B * H, THREADS, bytes, s>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), h0, static_cast<T*>(y), h_out, S, H, L, xs, bs, cs);
  return 0;
}

template <typename T>
int dispatch(int P, int N, const void* x, const float* dt, const float* a,
             const void* bm, const void* cm, const float* h0, void* y, float* h_out,
             int B, int S, int H, int L, Strides xs, Strides bs, Strides cs,
             cudaStream_t s) {
#define SSD_CASE(PP, NN)                                                        \
  if (P == PP && N == NN)                                                       \
    return launch<T, PP, NN>(x, dt, a, bm, cm, h0, y, h_out, B, S, H, L, xs, bs, \
                             cs, s);
  SSD_CASE(16, 16)
  SSD_CASE(32, 32)
  SSD_CASE(64, 64)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x, B, C and y); dt (B,S,H), a (H,), h0 and
// h_out (B,H,P,N) are f32 and contiguous, h0 may be null.  x (B,S,H,P) and
// B/C (B,S,H,N) are read through their (batch, seq, head) strides in
// elements, the last axis contiguous; y (B,S,H,P) is contiguous.  L is the
// chunk (<= 1024).  Returns cudaGetLastError().
extern "C" int ssd_chunk(int dtype, const void* x, const void* dt, const void* a,
                         const void* bm, const void* cm, const void* h0, void* y,
                         void* h_out, int B, int S, int H, int P, int N, int L,
                         long long xsb, long long xss, long long xsh,
                         long long bsb, long long bss, long long bsh,
                         long long csb, long long css, long long csh, void* stream) {
  if (B < 1 || S < 1 || H < 1 || L < 1 || L > LMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides xs{xsb, xss, xsh}, bs{bsb, bss, bsh}, cs{csb, css, csh};
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(a);
  const float* h0p = static_cast<const float*>(h0);
  float* hop = static_cast<float*>(h_out);
  int rc;
  if (dtype == 0) {
    rc = dispatch<float>(P, N, x, dtp, ap, bm, cm, h0p, y, hop, B, S, H, L, xs, bs, cs, s);
  } else if (dtype == 1) {
    rc = dispatch<__nv_bfloat16>(P, N, x, dtp, ap, bm, cm, h0p, y, hop, B, S, H, L, xs, bs,
                                 cs, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
