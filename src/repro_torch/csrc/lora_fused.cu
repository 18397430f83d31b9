// Fused LoRA projection  y = x·W + scale·((x·A)·B)  for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lora_fused/kernel.py
// (lora_fused_kernel, pallas_call at :69): one pass that accumulates x·W and
// x·A in f32 over K and applies the rank-r correction in the epilogue, so
// the (d_in × d_out) LoRA delta is never formed and x is read once.
//
// What bounds it on the H100: at the serving shapes (K = N = 768, r = 8)
// the decode call has M = 8 rows, 2·M·K·N = 9.4 MFLOP against 2.4 MB of W
// in f32 — 4 FLOP/byte, far below the card's ridge — so it is bound by
// reading W once from HBM.  The prefill call (M = 1024) does 1.2 GFLOP on
// 8.7 MB: on CUDA cores in exact f32 (no TF32, 67 TFLOP/s) it is bound by
// the operations.
//
// Design, two kernels chosen by M:
// * lora_skinny (M ≤ 16, the decode rows): a block owns 16 output columns
//   and all M rows, so N = 768 gives 48 blocks.  Its 512 threads form 32
//   k-groups (half warps).  K is walked in chunks of 256 rows: for each
//   chunk a thread issues all its loads at once — 8 rows of W (lane c
//   reads W[k][n0 + c], 64-byte row segments) and of A, and its share of
//   the chunk of x into shared memory — then waits once.  The lanes < r
//   accumulate x·A beside x·W.  The per-group partial sums are reduced
//   through shared memory once, at the end.
// * lora_tiled (M > 16): a block owns a 64×64 output tile; 256 threads each
//   accumulate a 4×4 sub-tile over K in 16-deep slices of x, W and A staged
//   in shared memory (read as float4), the next slice loaded into
//   registers while the current one is computed.
// Both round x·A to the operand type before the rank-r product, as the
// TPU kernel does (kernel.py:40), and write y in the operand type.  f32 is
// exact IEEE f32 FMA: no tensor cores, no TF32.  Tensor cores (wgmma) and
// TMA staging are later work.
#include "common.cuh"

namespace {

using repro::from_f32;
using repro::round_to;
using repro::to_f32;

constexpr int RMAX = 32;  // largest rank; the wrapper checks it

// ----------------------------------------------------------------- skinny
constexpr int STHREADS = 512;
constexpr int SBN = 16;               // output columns per block (a half warp)
constexpr int SKG = STHREADS / SBN;   // 32 k-groups (half warps)
constexpr int SKU = 8;                // rows of K per group per chunk
constexpr int SKC = SKG * SKU;        // 256 rows of K per chunk

template <typename T, int MR, int RT>
__global__ void __launch_bounds__(STHREADS)
lora_skinny(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ y, int M, int N, int K, int R, float scale) {
  static_assert(MR * SBN <= STHREADS, "reduction mapping");
  static_assert(MR * SKC <= SKG * MR * SBN, "x chunk fits the shared buffer");
  // one buffer: the x chunk [MR][SKC] during the K loop, then the per-group
  // partial sums [SKG][MR][SBN] of the reduction
  __shared__ float buf[SKG * MR * SBN];
  __shared__ float xa_s[MR][RMAX];
  __shared__ float bs[RMAX][SBN];
  float (*xs)[SKC] = reinterpret_cast<float (*)[SKC]>(buf);
  float (*red)[MR][SBN] = reinterpret_cast<float (*)[MR][SBN]>(buf);

  const int tid = threadIdx.x, c = tid % SBN, kg = tid / SBN;
  const int n0 = blockIdx.x * SBN, gn = n0 + c;
  const bool col_ok = gn < N;

  // thread (c, kg): W column n0 + c and A columns c + SBN·t, over the rows
  // kg, kg + SKG, ... of each chunk
  float acc[MR], acc_a[RT][MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    acc[m] = 0.f;
#pragma unroll
    for (int t = 0; t < RT; ++t) acc_a[t][m] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += SKC) {
    // every load of the chunk is issued before any is used: SKU rows of W
    // (and A) per thread, and the chunk of x staged in shared memory
    float wv[SKU], av[RT][SKU];
#pragma unroll
    for (int u = 0; u < SKU; ++u) {
      const int k = k0 + kg + u * SKG;
      wv[u] = (k < K && col_ok) ? to_f32(w[(size_t)k * N + gn]) : 0.f;
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const int j = c + SBN * t;
        av[t][u] = (k < K && j < R) ? to_f32(a[(size_t)k * R + j]) : 0.f;
      }
    }
    for (int i = tid; i < MR * SKC; i += STHREADS) {
      const int m = i / SKC, k = k0 + i % SKC;
      xs[m][i % SKC] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < SKU; ++u) {
      const int kk = kg + u * SKG;
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float xv = xs[m][kk];
        acc[m] = fmaf(xv, wv[u], acc[m]);
#pragma unroll
        for (int t = 0; t < RT; ++t) acc_a[t][m] = fmaf(xv, av[t][u], acc_a[t][m]);
      }
    }
    __syncthreads();
  }

  // reduce over the k-groups; thread tid < MR·SBN owns (m, c') = (tid / SBN, tid % SBN)
  const bool owner = tid < MR * SBN;
  const int om = tid / SBN, oc = tid % SBN;
#pragma unroll
  for (int m = 0; m < MR; ++m) red[kg][m][c] = acc[m];
  __syncthreads();
  float base = 0.f;
  if (owner)
    for (int g = 0; g < SKG; ++g) base += red[g][om][oc];
#pragma unroll
  for (int t = 0; t < RT; ++t) {  // x·A, SBN columns per pass, rounded to T
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MR; ++m) red[kg][m][c] = acc_a[t][m];
    __syncthreads();
    const int j = oc + SBN * t;
    if (owner && j < R) {
      float s = 0.f;
      for (int g = 0; g < SKG; ++g) s += red[g][om][oc];
      xa_s[om][j] = round_to<T>(s);
    }
  }
  for (int i = tid; i < R * SBN; i += STHREADS) {
    const int j = i / SBN, cc = i % SBN;
    bs[j][cc] = n0 + cc < N ? to_f32(b[(size_t)j * N + n0 + cc]) : 0.f;
  }
  __syncthreads();
  if (owner && om < M && n0 + oc < N) {
    float l = 0.f;
    for (int j = 0; j < R; ++j) l = fmaf(xa_s[om][j], bs[j][oc], l);
    y[(size_t)om * N + n0 + oc] = from_f32<T>(base + scale * l);
  }
}

// ------------------------------------------------------------------ tiled
constexpr int TBM = 64, TBN = 64, TBK = 16, TTM = 4, TTN = 4;
constexpr int TTHREADS = (TBM / TTM) * (TBN / TTN);  // 256
constexpr int XL = TBM * TBK / TTHREADS;             // x values each thread stages
constexpr int WL = TBK * TBN / TTHREADS;             // W values each thread stages
constexpr int AL = TBK * RMAX / TTHREADS;            // A slots each thread stages
constexpr int XA_PER = TBM * RMAX / TTHREADS;

template <typename T>
__global__ void __launch_bounds__(TTHREADS, 2)
lora_tiled(const T* __restrict__ x, const T* __restrict__ w,
           const T* __restrict__ a, const T* __restrict__ b,
           T* __restrict__ y, int M, int N, int K, int R, float scale) {
  // x stored transposed; the +4 pad keeps rows 16-byte aligned for float4
  // reads and spreads the column-wise stores over the banks
  __shared__ __align__(16) float xs[TBK][TBM + 4];
  __shared__ __align__(16) float ws[TBK][TBN];
  __shared__ float as[TBK][RMAX];
  __shared__ float xa_s[TBM][RMAX];
  __shared__ float bs[RMAX][TBN];

  const int tid = threadIdx.x;
  const int tx = tid % (TBN / TTN), ty = tid / (TBN / TTN);
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int n_xa = TBM * R;

  float acc[TTM][TTN];
#pragma unroll
  for (int i = 0; i < TTM; ++i)
#pragma unroll
    for (int j = 0; j < TTN; ++j) acc[i][j] = 0.f;
  float xa[XA_PER];
#pragma unroll
  for (int t = 0; t < XA_PER; ++t) xa[t] = 0.f;

  // the next K slice is loaded into registers while the current one is
  // computed from shared memory
  float xn[XL], wn[WL], an[AL];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < XL; ++l) {
      const int i = tid + l * TTHREADS, r = i / TBK, gm = m0 + r, gk = k0 + i % TBK;
      xn[l] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < WL; ++l) {
      const int i = tid + l * TTHREADS, gk = k0 + i / TBN, gn = n0 + i % TBN;
      wn[l] = (gk < K && gn < N) ? to_f32(w[(size_t)gk * N + gn]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < AL; ++l) {
      const int i = tid + l * TTHREADS, gk = k0 + i / RMAX, j = i % RMAX;
      an[l] = (gk < K && j < R) ? to_f32(a[(size_t)gk * R + j]) : 0.f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += TBK) {
#pragma unroll
    for (int l = 0; l < XL; ++l) {
      const int i = tid + l * TTHREADS;
      xs[i % TBK][i / TBK] = xn[l];
    }
#pragma unroll
    for (int l = 0; l < WL; ++l) {
      const int i = tid + l * TTHREADS;
      ws[i / TBN][i % TBN] = wn[l];
    }
#pragma unroll
    for (int l = 0; l < AL; ++l) {
      const int i = tid + l * TTHREADS;
      as[i / RMAX][i % RMAX] = an[l];
    }
    __syncthreads();
    if (k0 + TBK < K) load(k0 + TBK);
#pragma unroll
    for (int kk = 0; kk < TBK; ++kk) {
      static_assert(TTM == 4 && TTN == 4, "float4 reads of the sub-tile");
      const float4 x4 = *reinterpret_cast<const float4*>(&xs[kk][ty * TTM]);
      const float4 w4 = *reinterpret_cast<const float4*>(&ws[kk][tx * TTN]);
      const float xr[TTM] = {x4.x, x4.y, x4.z, x4.w};
      const float wr[TTN] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < TTM; ++i)
#pragma unroll
        for (int j = 0; j < TTN; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
    }
#pragma unroll
    for (int t = 0; t < XA_PER; ++t) {
      const int e = tid + t * TTHREADS;
      if (e < n_xa) {
        const int r = e / R, j = e % R;
        float s = xa[t];
#pragma unroll
        for (int kk = 0; kk < TBK; ++kk) s = fmaf(xs[kk][r], as[kk][j], s);
        xa[t] = s;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < XA_PER; ++t) {
    const int e = tid + t * TTHREADS;
    if (e < n_xa) xa_s[e / R][e % R] = round_to<T>(xa[t]);
  }
  for (int i = tid; i < R * TBN; i += TTHREADS) {
    const int j = i / TBN, c = i % TBN;
    bs[j][c] = n0 + c < N ? to_f32(b[(size_t)j * N + n0 + c]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TTM; ++i) {
    const int r = ty * TTM + i, gm = m0 + r;
#pragma unroll
    for (int j = 0; j < TTN; ++j) {
      const int c = tx * TTN + j, gn = n0 + c;
      if (gm < M && gn < N) {
        float l = 0.f;
        for (int q = 0; q < R; ++q) l = fmaf(xa_s[r][q], bs[q][c], l);
        y[(size_t)gm * N + gn] = from_f32<T>(acc[i][j] + scale * l);
      }
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* a, const void* b, void* y,
            int M, int N, int K, int R, float scale, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  const int nb = (N + SBN - 1) / SBN;
  if (M <= 8 && R <= SBN) {
    lora_skinny<T, 8, 1><<<nb, STHREADS, 0, s>>>(xp, wp, ap, bp, yp, M, N, K, R, scale);
  } else if (M <= 8) {
    lora_skinny<T, 8, 2><<<nb, STHREADS, 0, s>>>(xp, wp, ap, bp, yp, M, N, K, R, scale);
  } else if (M <= 16 && R <= SBN) {
    lora_skinny<T, 16, 1><<<nb, STHREADS, 0, s>>>(xp, wp, ap, bp, yp, M, N, K, R, scale);
  } else if (M <= 16) {
    lora_skinny<T, 16, 2><<<nb, STHREADS, 0, s>>>(xp, wp, ap, bp, yp, M, N, K, R, scale);
  } else {
    dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
    lora_tiled<T><<<grid, TTHREADS, 0, s>>>(xp, wp, ap, bp, yp, M, N, K, R, scale);
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  x (M,K), w (K,N), a (K,R), b (R,N), y (M,N),
// all row-major and contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int lora_fused(int dtype, const void* x, const void* w, const void* a,
                          const void* b, void* y, int M, int N, int K, int R,
                          float scale, void* stream) {
  if (R < 1 || R > RMAX || M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, a, b, y, M, N, K, R, scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, a, b, y, M, N, K, R, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
