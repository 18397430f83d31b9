// Mamba-2 SSD chunked scan for Hopper (sm_90a), in the state-passing form.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk/kernel.py
// (ssd_chunk_kernel, pallas_call at :76).  For each (batch, head) and each
// chunk of L positions, with cs the in-chunk prefix sum of dt·a:
//   y[l]  = exp(cs_l) C_l · h_start + sum_{m <= l} (C_l · B_m) exp(cs_l - cs_m) dt_m x_m
//   s_c   = sum_m x_m (B_m dt_m exp(cs_L - cs_m))          (the chunk's own end state)
//   h_c   = exp(cs_L) h_{c-1} + s_c                         (h_start of chunk c is h_{c-1})
// with the (P, N) state in f32 and the last one written out.  Beyond the TPU
// kernel it takes the model contract of models/ssm.py ssd_chunk_scan: an
// optional initial state h0, and a length S that is not a multiple of the
// chunk (positions >= S act as dt = 0: the state passes through and no
// output is written).  y excludes the D-skip term, which the mixer adds.
//
// What bounds it on the H100: operations.  At the mamba2-1.3b serve prefill
// (B 4, S 512, H 64, P 64, N 128, chunk 256, f32) the per-head work the data
// needs (causal S·x, the chunk states, and C·h_startᵀ for chunk 1, chunk 0
// starting from zero with no h0) is 5.38 GFLOP; the causal half of C·Bᵀ is
// 0.067 GFLOP once per (batch, chunk) with the mixer's one group.  That is
// 0.081 ms at 67 TFLOP/s of f32 FMA (the first port's count, C·Bᵀ per head
// and C·h_startᵀ for every chunk: 0.161 ms), against 78 MB of x, B, C, dt,
// y and state, 23 us at 3.35 TB/s.  This design takes 0.263 ms there (0.31
// of the bound; the first port's 0.929 ms; chip_smoke.py CHECK rows, H100
// 80GB HBM3 at 700 W).
//
// Design.  The TPU walked the chunks on a sequential grid axis with the
// state in VMEM; the first port kept that as a loop inside one block
// per (batch, head).  This one runs the chunks in parallel and passes the
// state between them (arXiv:2405.21060 §6), in three or four launches on the
// stream:
//   ssd_cb     G = C·Bᵀ over a chunk, its lower-triangle 64 x 64 tiles,
//              once per (b, chunk) when B and C are a stride-0 broadcast
//              over the heads (the mixer's one group), else per (b, h, chunk).
//   ssd_state  per (b, h, chunk, 64 state rows n): the prefix sum cs of dt·a
//              (written to the workspace with dt) and the chunk's own end
//              state s_c[n][p] = Σ_m B_m[n] dt_m exp(cs_L - cs_m) x_m[p].
//   ssd_pass   per element of the state, walks the chunks in order,
//              overwriting each chunk's slot with the state at its start,
//              and writes h_out (h0 and h_out are [P][N], the slots [N][P]:
//              a 32 x 32 tile transposes them in shared memory).
//   ssd_out    per (b, h, chunk, 64-row tile): the inter-chunk term from the
//              starting state (skipped for chunk 0 without h0), then the
//              causal sum over 32-column tiles of G, each decayed by the
//              head's exp(cs_l - cs_m) dt_m as it is moved into shared memory.
// The workspace (states, prefix sums, dt, G; 19 MB at the serve prefill)
// comes from the wrapper; the kernels allocate nothing and use no atomics,
// so a result is the same bits from run to run.
// What the first port lost time on, and what this one does:
// 1. Serial chunks in 256 blocks of 146 KB (one 8-warp block an SM, two
//    waves): at the serve prefill 2048 output blocks of 128 threads, 46 KB
//    each, four an SM (16 warps), and 1024 state blocks.  The output grid
//    numbers the last row tile of every chunk (the most columns) first.
// 2. 4 x 4 micro-tiles, two FMAs per shared-memory load: every product is an
//    8 x 4 register tile (rows 4·ty + i and 32 + 4·ty + i, columns 4·tx + j;
//    C·Bᵀ's tile columns tx + 16·j).  S·x and the chunk state read two
//    float4 of the k-major left operand and one of x per 32 FMAs;
//    C·h_startᵀ and C·Bᵀ read float4 along k, 12 loads per 128 FMAs.  The
//    chunk states are stored [n][p], so the inter-chunk term reads them k
//    major like x.
// 3. C·Bᵀ per head: formed once per group; each head's output block reads
//    its G tile from L2 (2.1 MB at the serve prefill) and applies its own
//    decay and dt while transposing it into shared memory.  Per-head B and
//    C (several groups, copied per head by the mixer) keep the per-head
//    product, in ssd_cb as well.
// 4. No copy overlapped compute: every 32-deep k slice goes through a
//    double-buffered 16-byte cp.async ring when the operands are f32 and
//    16-byte aligned (G and the states always are), one barrier a slice
//    (two in the slices that build a score tile); bf16 and unaligned f32
//    operands are staged through registers.
// 5. Spills of the 64-float state accumulator: no accumulator is wider than
//    32 floats; P 64 blocks are held to 128 registers a thread, and no
//    instance spills.
// The decay stays the exp of a difference of prefix sums, never a ratio of
// exponentials: sum dt·a over 256 positions reaches hundreds below zero.
// Exact IEEE f32 FMA on the CUDA cores throughout (bf16 operands widened).
//
// Plan.  ssd_fuse (below) runs C·Bᵀ's tiles as the first blocks of
// ssd_state's grid, one launch fewer, when the state blocks have the tile's
// 128 threads (P 64); ssd_chunk_plan reports it.  Times (tools/
// ssd_plan_sweep.py, the rule against a copy built with ssd_fuse false;
// f32 unless marked, B/C shared over the heads unless marked; H100 80GB
// HBM3 at 700 W, cold L2, median of 30; an empty kernel takes 0.0049 ms
// under this timer):
//     shape (P 64, N 128, chunk 256)         separate   fused
//     B 4, S 512, H 64 (serve prefill)       0.2710     0.2621
//     the same, bf16                         0.3271     0.3176
//     the same, B/C per head                 0.4455     0.4427
//     B 1, S 2048, H 64 (8 chunks)           0.3009     0.2919
//     B 1, S 512, H 8                        0.0725     0.0618
// A split of the output blocks over halves of P was tried as the plan and
// removed: slower at every row (earlier kernels of this design, f32: serve
// prefill 0.2892 unsplit against 0.3638 split, B 1 S 2048 0.3091 / 0.3911,
// and 0.0774 / 0.0864 even at B 1, H 8, a grid of 64 output blocks).
// Workspace: per-head B and C (several groups) store C·Bᵀ per head, about
// B·H·S·L floats (134 MB at the serve prefill's shape, 2.1 GB at B 4,
// S 2048, chunk 1024); no configuration has more than one group.
#include <cstdint>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int LMAX = 1024;   // longest chunk
constexpr int TR = 64;       // rows of a block tile
constexpr int KS = 32;       // depth of a staged k slice
constexpr int RS = KS + 4;   // row stride of a k-contiguous slice [row][RS]
constexpr int SR = TR + 4;   // row stride of a k-major slice [k][SR] of TR rows

struct Strides {
  long long b, s, h;   // elements; the last axis (P or N) is contiguous
};

// cp.async with zero-fill: ``ok`` false reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The double-buffered ring's step for job j (of ``jobs``; job 0 was issued
// before the loop): wait for job j's slice, a barrier (every thread is done
// with job j - 1, whose stage job j + 1 reuses), then issue job j + 1.  One
// barrier a job; job j + 1's copies run while job j computes.
template <typename Load>
__device__ __forceinline__ void ring_next(int j, int jobs, Load& load) {
  cp_async_wait0();
  __syncthreads();
  if (j + 1 < jobs) load(j + 1);
  cp_async_commit();
}

// Row r of a thread's 8 rows: 4·ty + r, then TR/2 + 4·ty + r - 4.
__device__ __forceinline__ int row_of(int ty, int r) {
  return r < 4 ? 4 * ty + r : TR / 2 + 4 * ty + r - 4;
}

// Stages ROWS x COLS floats (COLS % 4 == 0) at dst[r·LD + c]: row r, columns
// [c, c + 4) from src + r·rstride + c when r < nrows and c < ncols, else
// zeros.  ASYNC: 16-byte cp.async (T float, 16-byte aligned rows); else
// element loads through registers.
template <int ROWS, int COLS, int LD, int THREADS, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rstride, int nrows,
                                      int ncols, bool async, int tid) {
  constexpr int CPR = COLS / 4;
  for (int q = tid; q < ROWS * CPR; q += THREADS) {
    const int r = q / CPR, c = (q % CPR) * 4;
    const bool ok = r < nrows && c < ncols;
    float* d = dst + r * LD + c;
    if constexpr (sizeof(T) == 4) {
      if (async) {
        cp_async16(d, ok ? static_cast<const void*>(src + r * rstride + c)
                         : static_cast<const void*>(src), ok);
        continue;
      }
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      const T* s = src + r * rstride + c;
      v = make_float4(to_f32(s[0]), to_f32(s[1]), to_f32(s[2]), to_f32(s[3]));
    }
    *reinterpret_cast<float4*>(d) = v;
  }
}

// acc[i][j] += Σ_k A[row_i][k] · B[col_j][k], k < KS: both operands
// k-contiguous rows of stride RS; col_j = tx + 16·j (the C·Bᵀ tile).
__device__ __forceinline__ void mma_kk(float (&acc)[8][4], const float* A, const float* B,
                                       int ty, int tx) {
#pragma unroll 1
  for (int k = 0; k < KS; k += 4) {
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * RS + k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(A + row_of(ty, i) * RS + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = fmaf(a.x, b[j].x, acc[i][j]);
        v = fmaf(a.y, b[j].y, v);
        v = fmaf(a.z, b[j].z, v);
        acc[i][j] = fmaf(a.w, b[j].w, v);
      }
    }
  }
}

// acc[i][j] += Σ_k A[row_i][k] · B[k][col_j], k < KS: A k-contiguous rows of
// stride RS, B k-major of row stride LDB; col_j = 4·tx + j.
template <int LDB>
__device__ __forceinline__ void mma_kc(float (&acc)[8][4], const float* A, const float* B,
                                       int ty, int tx) {
#pragma unroll 1
  for (int k = 0; k < KS; k += 4) {
    float4 b[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      b[kk] = *reinterpret_cast<const float4*>(B + (k + kk) * LDB + 4 * tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(A + row_of(ty, i) * RS + k);
      const float bj[4][4] = {{b[0].x, b[1].x, b[2].x, b[3].x}, {b[0].y, b[1].y, b[2].y, b[3].y},
                              {b[0].z, b[1].z, b[2].z, b[3].z}, {b[0].w, b[1].w, b[2].w, b[3].w}};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = fmaf(a.x, bj[j][0], acc[i][j]);
        v = fmaf(a.y, bj[j][1], v);
        v = fmaf(a.z, bj[j][2], v);
        acc[i][j] = fmaf(a.w, bj[j][3], v);
      }
    }
  }
}

// acc[i][j] += Σ_k A[k][row_i] · B[k][col_j], k < KS: both operands
// k-major, A of row stride SR, B of row stride LDB; col_j = 4·tx + j.
template <int LDB>
__device__ __forceinline__ void mma_km(float (&acc)[8][4], const float* A, const float* B,
                                       int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < KS; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + k * SR + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(A + k * SR + TR / 2 + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(B + k * LDB + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
  }
}

// dts[l] = dt of row l of the chunk (0 at and past lend) and cs[l] its
// inclusive prefix sum of dt·a, l < L.  Each thread sums a contiguous run of
// rows, then the runs' totals are scanned across the lanes and the warps.
// Ends with a barrier.
template <int THREADS>
__device__ void chunk_scan(float* cs, float* dts, const float* dtp, int stride, float a,
                           int L, int lend, int tid) {
  __shared__ float wsum[THREADS / 32];
  const int lane = tid % 32, warp = tid / 32;
  const int E = (L + THREADS - 1) / THREADS;
  for (int l = tid; l < L; l += THREADS) dts[l] = l < lend ? dtp[(size_t)l * stride] : 0.f;
  __syncthreads();
  float run = 0.f;
  for (int e = 0; e < E; ++e) {
    const int l = tid * E + e;
    if (l < L) run += dts[l] * a;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float before = incl - run;
  if constexpr (THREADS > 32) {
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
    if (warp > 0) before += wsum[warp - 1];
  }
  float loc = 0.f;
  for (int e = 0; e < E; ++e) {
    const int l = tid * E + e;
    if (l < L) {
      loc += dts[l] * a;
      cs[l] = before + loc;
    }
  }
  __syncthreads();
}

// One 64 x 64 tile of G[b][g][c] = C·Bᵀ over the chunk, row stride LP, by
// 128 threads: tile ``blk`` numbers (b, g, c) and then the lower-triangle
// tiles row by row.  g is the head whose B and C are read: 0 with the
// one-group broadcast (ng 1), else the head.
template <typename T>
__device__ __forceinline__ void cb_tile(int blk, float* smem, const T* __restrict__ bm,
                                        const T* __restrict__ cm, float* __restrict__ G, int S,
                                        int N, int L, int LP, int nc, int ng, bool async,
                                        Strides bst, Strides cst) {
  constexpr int THREADS = 128, STAGE = 2 * TR * RS;
  const int tt = (L + TR - 1) / TR, ntri = tt * (tt + 1) / 2;
  int t = blk % ntri, lt = 0;
  while (t > lt) t -= ++lt;
  const int mt = t, bgc = blk / ntri;
  const int c = bgc % nc, bg = bgc / nc, g = bg % ng, b = bg / ng;
  const int c0 = c * L, lend = min(L, S - c0), l0 = lt * TR, m0 = mt * TR;
  if (l0 >= lend) return;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* cb = cm + b * cst.b + (long long)(c0 + l0) * cst.s + g * cst.h;
  // (a column tile past S reads nothing; its origin is kept inside B)
  const T* bb = bm + b * bst.b + (long long)(c0 + min(m0, lend - 1)) * bst.s + g * bst.h;
  const int jobs = (N + KS - 1) / KS;
  auto load = [&](int j) {
    float* st = smem + (j & 1) * STAGE;
    const int n0 = j * KS;
    stage<TR, KS, RS, THREADS>(st, cb + n0, cst.s, lend - l0, N - n0, async, tid);
    stage<TR, KS, RS, THREADS>(st + TR * RS, bb + n0, bst.s, lend - m0, N - n0, async, tid);
  };
  float acc[8][4] = {};
  load(0);
  cp_async_commit();
  for (int j = 0; j < jobs; ++j) {
    ring_next(j, jobs, load);
    const float* st = smem + (j & 1) * STAGE;
    mma_kk(acc, st, st + TR * RS, ty, tx);
  }
  float* out = G + ((size_t)(b * ng + g) * nc + c) * L * LP;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = l0 + row_of(ty, i);
    if (l >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx + 16 * j;
      if (m < L) out[(size_t)l * LP + m] = acc[i][j];
    }
  }
}

constexpr int CB_BYTES = 2 * 2 * TR * RS * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(128, 4)
ssd_cb(const T* __restrict__ bm, const T* __restrict__ cm, float* __restrict__ G, int S,
       int N, int L, int LP, int nc, int ng, bool async, Strides bst, Strides cst) {
  extern __shared__ __align__(16) float smem[];
  cb_tile<T>(blockIdx.x, smem, bm, cm, G, S, N, L, LP, nc, ng, async, bst, cst);
}

// The chunk's prefix sums (and dt) into wcs / wdt [bhc][LP], and its own end
// state s[n][p] = Σ_m B[m][n] dt_m exp(cs_L - cs_m) x[m][p] into hs
// [bhc][N][P], for the 64 state rows n of the block's n tile.  Fused (P 64,
// ncb > 0): the first ncb blocks of the grid are ssd_cb's tiles instead.
// (At P 64 four blocks an SM, 128 registers a thread; below, the blocks are
// of one or two warps and run the reduced configurations and tests.)
template <typename T, int P>
__global__ void __launch_bounds__(2 * P, P == 64 ? 4 : 2)
ssd_state(const T* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ a_coef, const T* __restrict__ bm, const T* __restrict__ cm,
          float* __restrict__ hs, float* __restrict__ wcs, float* __restrict__ wdt,
          float* __restrict__ G, int S, int H, int N, int L, int LP, int nc, int ng, int ncb,
          bool async, Strides xst, Strides bst, Strides cst) {
  constexpr int THREADS = 2 * P, TX = P / 4, STAGE = KS * SR + KS * P;
  extern __shared__ __align__(16) float smem[];
  if constexpr (THREADS == 128) {
    if ((int)blockIdx.x < ncb) {
      cb_tile<T>(blockIdx.x, smem, bm, cm, G, S, N, L, LP, nc, ng, async, bst, cst);
      return;
    }
  }
  float* cs = smem;          // [LP]
  float* w = cs + LP;        // [LP] dt, then the weight dt_m exp(cs_L - cs_m)
  float* ring = w + LP;      // 2 x {B slice [KS][SR] (n columns), x slice [KS][P]}
  const int ntiles = (N + TR - 1) / TR, blk = blockIdx.x - ncb;
  const int nt = blk % ntiles, bhc = blk / ntiles;
  const int c = bhc % nc, bh = bhc / nc, h = bh % H, b = bh / H;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int c0 = c * L, lend = min(L, S - c0), n0 = nt * TR;

  chunk_scan<THREADS>(cs, w, dt + ((size_t)b * S + c0) * H + h, H, a_coef[h], L, lend, tid);
  const float total = cs[L - 1];
  for (int l = tid; l < L; l += THREADS) {
    const float d = w[l];
    if (nt == 0) {
      wcs[(size_t)bhc * LP + l] = cs[l];
      wdt[(size_t)bhc * LP + l] = d;
    }
    w[l] = d * expf(total - cs[l]);
  }
  __syncthreads();

  const T* xb = x + b * xst.b + (long long)c0 * xst.s + h * xst.h;
  const T* bb = bm + b * bst.b + (long long)c0 * bst.s + h * bst.h + n0;
  const int jobs = (lend + KS - 1) / KS;
  auto load = [&](int j) {
    float* st = ring + (j & 1) * STAGE;
    const int m0 = j * KS;
    stage<KS, TR, SR, THREADS>(st, bb + m0 * bst.s, bst.s, lend - m0, N - n0, async, tid);
    stage<KS, P, P, THREADS>(st + KS * SR, xb + m0 * xst.s, xst.s, lend - m0, P, async, tid);
  };
  float acc[8][4] = {};
  load(0);
  cp_async_commit();
  for (int j = 0; j < jobs; ++j) {
    ring_next(j, jobs, load);
    float* st = ring + (j & 1) * STAGE;
    float* xs = st + KS * SR;
    for (int q = tid; q < KS * P; q += THREADS) {   // x_m · w_m
      const int m = j * KS + q / P;
      xs[q] = m < lend ? xs[q] * w[m] : 0.f;
    }
    __syncthreads();
    mma_km<P>(acc, st, xs, ty, tx);
  }
  // acc[i][j] = s[n = n0 + row_i][p = 4·tx + j]
  float* out = hs + (size_t)bhc * N * P + 4 * tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + row_of(ty, i);
    if (n < N)
      *reinterpret_cast<float4*>(out + (size_t)n * P) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// The state passing over one 32 x 32 tile (n, p) of the state of one (b, h):
// h_c = exp(cs_L of chunk c) h_{c-1} + s_c from h0 (or zero), chunk by
// chunk.  Each chunk's slot of hs [N][P] is overwritten with the state at
// its start (chunk 0's only when ``keep_first``: with no h0 it is zero and
// never read); the last state goes to h_out.  h0 and h_out are [P][N]:
// they pass through a transposing tile in shared memory.
__global__ void __launch_bounds__(256)
ssd_pass(float* __restrict__ hs, const float* __restrict__ wcs, const float* __restrict__ h0,
         float* __restrict__ h_out, int P, int N, int L, int LP, int nc, bool keep_first) {
  __shared__ float tile[32][33];
  const int tn = (N + 31) / 32, tp = (P + 31) / 32;
  const int bh = blockIdx.x / (tn * tp), t = blockIdx.x % (tn * tp);
  const int n0 = (t / tp) * 32, p0 = (t % tp) * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  float h[4] = {0.f, 0.f, 0.f, 0.f};   // (n = n0 + ty + 8k, p = p0 + tx)
  if (h0 != nullptr) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = p0 + ty + 8 * k, n = n0 + tx;
      tile[ty + 8 * k][tx] = p < P && n < N ? h0[((size_t)bh * P + p) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = tile[tx][ty + 8 * k];
    __syncthreads();
  }
  bool ok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) ok[k] = p0 + tx < P && n0 + ty + 8 * k < N;
  for (int c = 0; c < nc; ++c) {
    const size_t bhc = (size_t)bh * nc + c;
    float* slot = hs + (bhc * N + n0 + ty) * P + p0 + tx;   // + 8k rows
    const float d = expf(wcs[bhc * LP + L - 1]);
    float sv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) sv[k] = ok[k] ? slot[8 * k * P] : 0.f;   // all loads first
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (ok[k] && (c > 0 || keep_first)) slot[8 * k * P] = h[k];
      h[k] = fmaf(d, h[k], sv[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) tile[tx][ty + 8 * k] = h[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = p0 + ty + 8 * k, n = n0 + tx;
    if (p < P && n < N) h_out[((size_t)bh * P + p) * N + n] = tile[ty + 8 * k][tx];
  }
}

// y for one (b, h, chunk) and 64-row tile, all P columns.  Jobs, each one k
// slice through the ring: first the inter-chunk term C·h_startᵀ over N (when
// the chunk has a nonzero starting state), scaled by exp(cs_l); then the
// causal sum over 32-column tiles m0 of the chunk up to the tile's last
// row: S[m][l] = G[l][m] exp(cs_l - cs_m) dt_m (m <= l) transposed into
// shared memory, times x.
template <typename T, int P>
__global__ void __launch_bounds__(2 * P, P == 64 ? 4 : 2)
ssd_out(const T* __restrict__ x, const T* __restrict__ cm, const float* __restrict__ G,
        const float* __restrict__ hs, const float* __restrict__ wcs,
        const float* __restrict__ wdt, T* __restrict__ y, int S, int H, int N, int L, int LP,
        int nc, int ng, int nbhc, int rt, bool has_h0, bool async, Strides xst, Strides cst) {
  constexpr int THREADS = 2 * P, TX = P / 4, STAGE = TR * RS + KS * P;
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;           // [LP]
  float* dts = cs + LP;       // [LP]
  float* St = dts + LP;       // [KS][SR]: the decayed score tile, transposed
  float* ring = St + KS * SR; // 2 x {C or G slice [TR][RS], h_start or x slice [KS][P]}

  const int bhc = blockIdx.x % nbhc, r = rt - 1 - blockIdx.x / nbhc;  // last row tiles first
  const int c = bhc % nc, bh = bhc / nc, h = bh % H, b = bh / H;
  const int c0 = c * L, lend = min(L, S - c0), l0 = r * TR;
  if (l0 >= lend) return;
  const int rows = min(TR, lend - l0), mend = l0 + rows;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;

  for (int l = tid; l < mend; l += THREADS) {
    cs[l] = wcs[(size_t)bhc * LP + l];
    dts[l] = wdt[(size_t)bhc * LP + l];
  }
  const int ja = (c > 0 || has_h0) ? (N + KS - 1) / KS : 0;
  const int jobs = ja + (mend + KS - 1) / KS;
  const T* cb = cm + b * cst.b + (long long)(c0 + l0) * cst.s + h * cst.h;
  const float* hb = hs + (size_t)bhc * N * P;
  const float* gb = G + ((size_t)(b * ng + (ng == 1 ? 0 : h)) * nc + c) * L * LP +
                    (size_t)l0 * LP;
  const T* xb = x + b * xst.b + (long long)c0 * xst.s + h * xst.h;
  auto load = [&](int j) {
    float* st = ring + (j & 1) * STAGE;
    if (j < ja) {
      const int n0 = j * KS;
      stage<TR, KS, RS, THREADS>(st, cb + n0, cst.s, rows, N - n0, async, tid);
      stage<KS, P, P, THREADS>(st + TR * RS, hb + (size_t)n0 * P, P, N - n0, P, true, tid);
    } else {
      const int m0 = (j - ja) * KS;
      stage<TR, KS, RS, THREADS>(st, gb + m0, LP, rows, L - m0, true, tid);
      stage<KS, P, P, THREADS>(st + TR * RS, xb + m0 * xst.s, xst.s, mend - m0, P, async, tid);
    }
  };
  float acc[8][4] = {};
  load(0);
  cp_async_commit();
  for (int j = 0; j < jobs; ++j) {
    ring_next(j, jobs, load);
    const float* st = ring + (j & 1) * STAGE;
    if (j < ja) {
      mma_kc<P>(acc, st, st + TR * RS, ty, tx);
      if (j == ja - 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int rr = row_of(ty, i);
          const float e = rr < rows ? expf(cs[l0 + rr]) : 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] *= e;
        }
      }
    } else {
      const int m0 = (j - ja) * KS;
      for (int q = tid; q < TR * KS / 4; q += THREADS) {
        const int rr = q % TR, m4 = (q / TR) * 4, l = l0 + rr;
        const float4 gv = *reinterpret_cast<const float4*>(st + rr * RS + m4);
        const float g[4] = {gv.x, gv.y, gv.z, gv.w};
        const bool lok = rr < rows;
        const float csl = lok ? cs[l] : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int m = m0 + m4 + k;
          float s = 0.f;
          if (lok && m <= l) s = g[k] * expf(csl - cs[m]) * dts[m];
          St[(m4 + k) * SR + rr] = s;
        }
      }
      __syncthreads();
      mma_km<P>(acc, St, st + TR * RS, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = row_of(ty, i);
    if (rr >= rows) continue;
    T* yr = y + (((size_t)b * S + c0 + l0 + rr) * H + h) * P + 4 * tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) yr[j] = from_f32<T>(acc[i][j]);
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The plan rule of the source note: C·Bᵀ's tiles run as the first blocks of
// ssd_state's grid (one launch fewer) when its blocks have the tile's 128
// threads (P 64); tools/ssd_plan_sweep.py times a copy that returns false.
bool ssd_fuse(int P) { return 2 * P == 128; }

struct Sizes {
  int nc, LP;
  size_t states, cs, g;
};

Sizes sizes(int B, int S, int H, int P, int N, int L, bool shared) {
  Sizes z;
  z.nc = cdiv(S, L);
  z.LP = (L + 3) / 4 * 4;
  z.states = (size_t)B * H * z.nc * P * N;
  z.cs = (size_t)B * H * z.nc * z.LP;
  z.g = (size_t)B * (shared ? 1 : H) * z.nc * L * z.LP;
  return z;
}

// Floats of workspace a call needs: the chunk states, prefix sums and dt,
// and C·Bᵀ (per (b, chunk) when ``shared``, else per head); as
// ops.workspace_floats computes it.
long long workspace_floats(int B, int S, int H, int P, int N, int L, bool shared) {
  const Sizes z = sizes(B, S, H, P, N, L, shared);
  return (long long)(z.states + 2 * z.cs + z.g);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

template <typename T, int P>
cudaError_t run(const T* x, const float* dt, const float* a, const T* bm, const T* cm,
                const float* h0, T* y, float* h_out, float* ws, int B, int S, int H, int N,
                int L, bool shared, bool async, Strides xs, Strides bs, Strides cs,
                cudaStream_t s) {
  const Sizes z = sizes(B, S, H, P, N, L, shared);
  const bool fuse = ssd_fuse(P);
  float* hs = ws;
  float* wcs = hs + z.states;
  float* wdt = wcs + z.cs;
  float* G = wdt + z.cs;
  const int ng = shared ? 1 : H, tt = cdiv(L, TR), nbhc = B * H * z.nc;
  const int ncb = B * ng * z.nc * tt * (tt + 1) / 2;
  cudaError_t e;

  if (!fuse) {
    ssd_cb<T><<<ncb, 128, CB_BYTES, s>>>(bm, cm, G, S, N, L, z.LP, z.nc, ng, async, bs, cs);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  int st_bytes = (2 * z.LP + 2 * (KS * SR + KS * P)) * (int)sizeof(float);
  if (fuse) st_bytes = st_bytes > CB_BYTES ? st_bytes : CB_BYTES;
  if ((e = allow_smem(ssd_state<T, P>, st_bytes)) != cudaSuccess) return e;
  ssd_state<T, P><<<(fuse ? ncb : 0) + nbhc * cdiv(N, TR), 2 * P, st_bytes, s>>>(
      x, dt, a, bm, cm, hs, wcs, wdt, G, S, H, N, L, z.LP, z.nc, ng, fuse ? ncb : 0, async,
      xs, bs, cs);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  ssd_pass<<<B * H * cdiv(N, 32) * cdiv(P, 32), 256, 0, s>>>(hs, wcs, h0, h_out, P, N, L,
                                                               z.LP, z.nc, h0 != nullptr);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int out_bytes = (2 * z.LP + KS * SR + 2 * (TR * RS + KS * P)) * (int)sizeof(float);
  if ((e = allow_smem(ssd_out<T, P>, out_bytes)) != cudaSuccess) return e;
  ssd_out<T, P><<<nbhc * tt, 2 * P, out_bytes, s>>>(x, cm, G, hs, wcs, wdt, y, S, H, N, L,
                                                     z.LP, z.nc, ng, nbhc, tt, h0 != nullptr,
                                                     async, xs, cs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int P, const void* x, const float* dt, const float* a, const void* bm,
                     const void* cm, const float* h0, void* y, float* h_out, float* ws, int B,
                     int S, int H, int N, int L, bool shared, bool async,
                     Strides xs, Strides bs, Strides cs, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(bm);
  const T* cp = static_cast<const T*>(cm);
  T* yp = static_cast<T*>(y);
  switch (P) {
    case 16: return run<T, 16>(xp, dt, a, bp, cp, h0, yp, h_out, ws, B, S, H, N, L, shared, async, xs, bs, cs, s);
    case 32: return run<T, 32>(xp, dt, a, bp, cp, h0, yp, h_out, ws, B, S, H, N, L, shared, async, xs, bs, cs, s);
    case 64: return run<T, 64>(xp, dt, a, bp, cp, h0, yp, h_out, ws, B, S, H, N, L, shared, async, xs, bs, cs, s);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_shape(int B, int S, int H, int P, int N, int L) {
  return B >= 1 && S >= 1 && H >= 1 && L >= 1 && L <= LMAX && L <= S && N >= 16 &&
         N % 16 == 0 && (P == 16 || P == 32 || P == 64);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x, B, C and y); dt (B,S,H), a (H,), h0 and
// h_out (B,H,P,N) are f32 and contiguous, h0 may be null.  x (B,S,H,P) and
// B/C (B,S,H,N) are read through their (batch, seq, head) strides in
// elements, the last axis contiguous; y (B,S,H,P) is contiguous.  L is the
// chunk (<= min(S, 1024)).  shared: B and C are a stride-0 broadcast over
// the heads (C·Bᵀ formed once per (b, chunk)).  ws: ws_floats floats of f32
// workspace, 16-byte aligned (ops.workspace_floats).  Returns the first
// launch error, else 0.
extern "C" int ssd_chunk(int dtype, const void* x, const void* dt, const void* a,
                         const void* bm, const void* cm, const void* h0, void* y,
                         void* h_out, void* ws, long long ws_floats, int B, int S, int H,
                         int P, int N, int L, int shared, long long xsb,
                         long long xss, long long xsh, long long bsb, long long bss,
                         long long bsh, long long csb, long long css, long long csh,
                         void* stream) {
  if (!valid_shape(B, S, H, P, N, L) || (shared && H > 1 && (bsh != 0 || csh != 0)) ||
      !aligned16(ws) ||
      ws_floats < workspace_floats(B, S, H, P, N, L, shared != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides xs{xsb, xss, xsh}, bs{bsb, bss, bsh}, cs{csb, css, csh};
  const bool strides4 = xsb % 4 == 0 && xss % 4 == 0 && xsh % 4 == 0 && bsb % 4 == 0 &&
                        bss % 4 == 0 && bsh % 4 == 0 && csb % 4 == 0 && css % 4 == 0 &&
                        csh % 4 == 0;
  const bool async = dtype == 0 && strides4 && aligned16(x) && aligned16(bm) && aligned16(cm);
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(a);
  const float* h0p = static_cast<const float*>(h0);
  float* hop = static_cast<float*>(h_out);
  float* wsp = static_cast<float*>(ws);
  cudaError_t e;
  if (dtype == 0) {
    e = dispatch<float>(P, x, dtp, ap, bm, cm, h0p, y, hop, wsp, B, S, H, N, L, shared != 0,
                        async, xs, bs, cs, s);
  } else if (dtype == 1) {
    e = dispatch<__nv_bfloat16>(P, x, dtp, ap, bm, cm, h0p, y, hop, wsp, B, S, H, N, L,
                                shared != 0, false, xs, bs, cs, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

// Whether the rule fuses C·Bᵀ into the chunk states' launch (1) or gives it
// a launch of its own (0) for a call of this shape.
extern "C" int ssd_chunk_plan(int B, int S, int H, int P, int N, int L, int* fused) {
  if (!valid_shape(B, S, H, P, N, L)) return (int)cudaErrorInvalidValue;
  *fused = ssd_fuse(P) ? 1 : 0;
  return 0;
}
