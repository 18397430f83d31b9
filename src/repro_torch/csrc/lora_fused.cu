// Fused LoRA projection  y = x·W + scale·((x·A)·B)  for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lora_fused/kernel.py
// (lora_fused_kernel, pallas_call at :69): one pass that accumulates x·W and
// x·A in f32 over K and applies the rank-r correction in the epilogue, so
// the (d_in × d_out) LoRA delta is never formed and x is read once.  Both
// branches round x·A to the operand type before the rank-r product, as the
// TPU kernel does (kernel.py:40), and write y in the operand type.  f32 is
// exact IEEE f32 FMA on the CUDA cores: no tensor cores, no TF32.
//
// What bounds it on the H100.  At decode rows (M ≤ 16) the call is bound by
// bytes: gpt2's M 8, K = N = 768 does 9.4 MFLOP on 2.4 MB of W, 4 FLOP/byte,
// far below the ridge.  At prefill rows it is bound by operations: gpt2's
// M 1024 does 1.2 GFLOP on 8.7 MB, mamba2's in_proj (M 2048, K 2048,
// N 8512) 71 GFLOP on 103 MB, against 67 TFLOP/s of f32 FMA.
//
// lora_skinny (M ≤ 16, the decode rows): a block owns 16 output columns and
// all M rows, so N = 768 gives 48 blocks.  Its 512 threads form 32 k-groups
// (half warps).  K is walked in chunks of 256 rows: for each chunk a thread
// issues all its loads at once — 8 rows of W (lane c reads W[k][n0 + c],
// 64-byte row segments) and of A, and its share of the chunk of x into
// shared memory — then waits once.  The lanes < r accumulate x·A beside x·W.
// The per-group partial sums are reduced through shared memory once, at the
// end.
//
// lora_tiled (M > 16, the prefill rows): one template of 256 threads over a
// BM×BN output tile, each thread a (BM/16)×(BN/16) piece of it at rows
// ty + 16·i and columns 4·tx + 64·j: 64×128 (4×8), 96×64 (6×4) and
// 64×64 (4×4).  What the earlier 64×64 design (4×4 per thread) lost time
// on, and what this one does instead:
// 1. x·A inside the main loop from shared memory (two scalar loads per FMA,
//    tripling the shared-load count): x·A is now taken from the x values a
//    thread already holds in registers.  The 16 threads that share a row set
//    split its ranks (thread tx owns ranks tx + 16·t), so each k costs
//    (BM/16)·ceil(r/16) FMAs and one A load; a warp whose ranks are all ≥ r
//    runs a copy of the slice loop without them (at r ≤ 8 half the warps,
//    one per sub-partition): 6% of the FMAs at r 8, 25% at r 32.
// 2. Every column block repeating x·A: it still does (one launch per call,
//    x read once), at that 6–25%, no longer at 3× the main product's loads.
// 3. A 4×4 micro-tile (16 FMAs per 32 bytes read from shared memory): 4×8
//    does 32 per 48, 6×4 24 per 40.  x is read along k (ptxas
//    merges the float2 reads into float4: four k per read; a warp spans 4
//    rows, a 4-address broadcast), W as float4 (8 addresses a warp).
// 4. One K slice in flight, staged through registers with two barriers per
//    slice: a 3-stage cp.async ring in dynamic shared memory (x BM×BK,
//    W BK×BN, A BK×r per stage; BK 16, 32 at 64×64) with one __syncthreads
//    per slice.  x is copied as rows [m][BK + pad] (cp.async cannot
//    transpose); a row stride of BK + 4 floats (BK + 8 bf16) puts the 4 rows
//    a warp reads on distinct banks.  16-byte copies with zero-fill past the
//    edges when K, N, r and the pointers allow; otherwise element copies
//    (4-byte cp.async for f32; bf16 has no 2-byte cp.async and goes through a
//    register) in the 64×64 tile.  Each thread's copy addresses are fixed
//    over K but for k0, so a slice costs a few instructions beside its FMAs.
// The epilogue rounds x·A to T into shared memory (over the ring), loads the
// r×BN tile of B, adds scale·Σ_q xa[row][q]·B[q][col] row by row and stores
// 16-byte vectors where aligned.  bf16 runs the same template: tiles copied
// as bf16, widened to f32 on the shared → register read, f32 FMA.
//
// Tile choice (SM count from cudaDeviceGetAttribute): 64×128 when its grid
// fills the SMs twice (two blocks an SM), else 96×64 when its grid has a
// block for every SM, else 64×64: the larger tile where the grid still
// fills the card, a smaller one where it would leave SMs idle.  Times that
// chose it, each tile forced (f32, r 8, H100 80GB HBM3 at 700 W, cold L2,
// median of 30; the TILES phase chip_smoke.py had when the rule was chosen,
// PERF.md):
//   M × K × N          64×128   96×64    64×64    128×128   (ms)
//   512 × 768 × 768    0.0591   0.0539   0.0383   0.1045
//   1024 × 768 × 768   0.0597   0.0541   0.0604   0.1156
//   2048 × 768 × 768   0.1004   0.0871   0.1129   0.1251
//   7168 × 768 × 768   0.2855   0.2893   0.3037   0.3242
//   2048 × 4096 × 2048 0.9632   1.2311   1.0962   1.1385
//   2048 × 2048 × 8512 2.0421   2.3540   2.2796   2.4124
// The design's 8×8 tile (128×128, 2×2 sub-tiles of 4×4, 64 FMAs per 64
// bytes) fits two blocks an SM only at 128 registers, where ptxas spilled;
// at one block an SM (168–225 registers) it was slower than 64×128 at every
// serving shape, as the last column shows, so it is not built.

#include <cstdint>

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
constexpr int TTHREADS = 256;
constexpr int TSTAGES = 3;  // ring depth: two slices in flight while one is computed

// Element layout of one ring stage and of the epilogue, per type and tile.
// BK: the K depth of a stage.
template <typename T, int BM, int BN, int BK>
struct TileShape {
  static constexpr int XS = sizeof(T) == 4 ? BK + 4 : BK + 8;  // x row stride (elements)
  static constexpr int X_ELEMS = BM * XS, W_ELEMS = BK * BN, A_ELEMS = BK * RMAX;
  static constexpr int STAGE = X_ELEMS + W_ELEMS + A_ELEMS;
  static constexpr int RING_BYTES = TSTAGES * STAGE * (int)sizeof(T);
  static constexpr int XA_STRIDE = RMAX + 1;  // epilogue: xa [BM][RMAX + 1], B [RMAX][BN], f32
  static constexpr int EPI_BYTES = (BM * XA_STRIDE + RMAX * BN) * 4;
  static constexpr int BYTES = RING_BYTES > EPI_BYTES ? RING_BYTES : EPI_BYTES;
  static constexpr int TM = BM / 16, TN = BN / 16, NJ = BN / 64;  // a thread's rows, columns, float4 groups
  static_assert((X_ELEMS * sizeof(T)) % 16 == 0 && (W_ELEMS * sizeof(T)) % 16 == 0 &&
                (A_ELEMS * sizeof(T)) % 16 == 0, "16-byte aligned stage parts");
  static_assert(BM % 16 == 0 && BN % 64 == 0 && BK % 8 == 0, "thread layout");
};

// cp.async with zero-fill: ``ok`` false reads nothing and writes zeros.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One element of a tile whose rows are not 16-byte aligned: an async 4-byte
// copy for f32; bf16 has no 2-byte cp.async and goes through a register.
__device__ __forceinline__ void copy_elem(float* dst, const float* src, bool ok) {
  cp4(dst, src, ok);
}
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst, const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __ushort_as_bfloat16(0);
}

// Shared → registers, widened to f32.
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// Four outputs in one store (16 bytes f32, 8 bytes bf16).
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
}

// One K slice from shared memory into the thread's accumulators.  x is read
// as float2 along k (ptxas merges pairs into 16-byte reads), W as float4.
// XA: this warp also accumulates x·A for ranks tx + 16·t from the same x
// registers (a column ≥ r is summed but never stored).
template <typename T, int BM, int BN, int BK, int RT, bool XA>
__device__ __forceinline__ void slice(const T* xs, const T* ws, const T* as, int tx, int ty,
                                      float (&acc)[BM / 16][BN / 16], float (&xa)[RT][BM / 16]) {
  using S = TileShape<T, BM, BN, BK>;
  constexpr int TM = S::TM, NJ = S::NJ, XS = S::XS;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 2) {
    float2 xv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) xv[i] = ld2(xs + (ty + 16 * i) * XS + kk);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float wv[4 * NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 v = ld4(ws + (kk + h) * BN + tx * 4 + 64 * j);
        wv[4 * j] = v.x, wv[4 * j + 1] = v.y, wv[4 * j + 2] = v.z, wv[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float xi = h ? xv[i].y : xv[i].x;
#pragma unroll
        for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = fmaf(xi, wv[j], acc[i][j]);
      }
      if constexpr (XA) {
#pragma unroll
        for (int t = 0; t < RT; ++t) {
          const float av = to_f32(as[(kk + h) * RMAX + tx + 16 * t]);
#pragma unroll
          for (int i = 0; i < TM; ++i) xa[t][i] = fmaf(h ? xv[i].y : xv[i].x, av, xa[t][i]);
        }
      }
    }
  }
}

// WIDE: 16-byte copies and stores (K, N, r multiples of 16 bytes' worth of
// elements, pointers 16-byte aligned); otherwise element copies.  RT: rank
// slots a thread owns (ranks tx and tx + 16), ceil(r / 16).
template <typename T, int BM, int BN, int BK, bool WIDE, int RT>
__global__ void __launch_bounds__(TTHREADS, 2)
lora_tiled(const T* __restrict__ x, const T* __restrict__ w,
           const T* __restrict__ a, const T* __restrict__ b,
           T* __restrict__ y, int M, int N, int K, int R, float scale) {
  using S = TileShape<T, BM, BN, BK>;
  constexpr int TM = S::TM, TN = S::TN, NJ = S::NJ, XS = S::XS;
  constexpr int CW = WIDE ? 16 / sizeof(T) : 1;  // elements per copy
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  // warp w spans tx 8·(w/4) .. +7 and ty 4·(w%4) .. +3: its W reads hit 8
  // float4 addresses and its x reads 4 rows, one wavefront each; the warps
  // whose ranks tx ≥ r idle in x·A are one per sub-partition (w % 4)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = lane % 8 + 8 * (warp / 4), ty = lane / 8 + 4 * (warp % 4);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const bool owns_rank = 8 * (warp / 4) < R;  // warp-uniform

  // The thread's copies, fixed over K (only k0 moves): x rows xr + XSTEP·l
  // at column xk, W rows wr + WSTEP·l at column wn, one A row piece.
  constexpr int XCH = BK / CW, XSTEP = TTHREADS / XCH, XL = (BM + XSTEP - 1) / XSTEP;
  constexpr int WCH = BN / CW, WSTEP = TTHREADS / WCH, WL = (BK + WSTEP - 1) / WSTEP;
  static_assert(TTHREADS % XCH == 0 && TTHREADS % WCH == 0, "copy layout");
  const int xr = tid / XCH, xk = (tid % XCH) * CW;
  const int wr = tid / WCH, wn = (tid % WCH) * CW;
  const bool wcol = n0 + wn < N;
  // a copy whose source lies past an edge (ok false) is handed the tensor's
  // base address and reads nothing
  const T* xg = x + (size_t)(m0 + xr) * K + xk;
  const T* wg = w + (size_t)wr * N + n0 + wn;
  const int ach = WIDE ? R / CW : R;  // copies per A row
  constexpr int AL = (BK * RMAX / CW + TTHREADS - 1) / TTHREADS;

  auto load_stage = [&](int st, int k0) {
    T* xs = ring + st * S::STAGE;
    T* ws = xs + S::X_ELEMS;
    T* as = ws + S::W_ELEMS;
#pragma unroll
    for (int l = 0; l < XL; ++l) {
      const int r = xr + XSTEP * l;
      if (BM % XSTEP == 0 || r < BM) {
        const bool ok = m0 + r < M && k0 + xk < K;
        const T* src = xg + (size_t)XSTEP * l * K + k0;
        if constexpr (WIDE) cp16(xs + r * XS + xk, ok ? src : x, ok);
        else copy_elem(xs + r * XS + xk, ok ? src : x, ok);
      }
    }
#pragma unroll
    for (int l = 0; l < WL; ++l) {
      const int kr = wr + WSTEP * l;
      if (BK % WSTEP == 0 || kr < BK) {
        const bool ok = wcol && k0 + kr < K;
        const T* src = wg + (size_t)(k0 + WSTEP * l) * N;
        if constexpr (WIDE) cp16(ws + kr * BN + wn, ok ? src : w, ok);
        else copy_elem(ws + kr * BN + wn, ok ? src : w, ok);
      }
    }
#pragma unroll
    for (int l = 0; l < AL; ++l) {
      const int c = tid + l * TTHREADS;
      if (c < BK * ach) {
        const int kr = c / ach, q = (c % ach) * CW;
        const bool ok = k0 + kr < K;
        const T* src = a + (size_t)(k0 + kr) * R + q;
        if constexpr (WIDE) cp16(as + kr * RMAX + q, ok ? src : a, ok);
        else copy_elem(as + kr * RMAX + q, ok ? src : a, ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float xa[RT][TM];
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int i = 0; i < TM; ++i) xa[t][i] = 0.f;

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // slice kt has landed; every thread is done with slice kt - 1, whose
    // stage the next copy overwrites
    cp_wait<TSTAGES - 2>();
    __syncthreads();
    if (kt + TSTAGES - 1 < nk) load_stage((kt + TSTAGES - 1) % TSTAGES, (kt + TSTAGES - 1) * BK);
    cp_commit();
    const T* xs = ring + (kt % TSTAGES) * S::STAGE;
    const T* ws = xs + S::X_ELEMS;
    const T* as = ws + S::W_ELEMS;
    if (owns_rank)
      slice<T, BM, BN, BK, RT, true>(xs, ws, as, tx, ty, acc, xa);
    else
      slice<T, BM, BN, BK, RT, false>(xs, ws, as, tx, ty, acc, xa);
  }

  // epilogue, over the ring: x·A rounded to T, then the r×BN tile of B
  cp_wait<0>();
  __syncthreads();
  float* xa_s = reinterpret_cast<float*>(smem);
  float* bs = xa_s + BM * S::XA_STRIDE;
#pragma unroll
  for (int t = 0; t < RT; ++t) {
    const int q = tx + 16 * t;
    if (q < R)
#pragma unroll
      for (int i = 0; i < TM; ++i) xa_s[(ty + 16 * i) * S::XA_STRIDE + q] = round_to<T>(xa[t][i]);
  }
  for (int c = tid; c < R * BN; c += TTHREADS) {
    const int q = c / BN, gn = n0 + c % BN;
    bs[c] = gn < N ? to_f32(b[(size_t)q * N + gn]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + 16 * i, gm = m0 + r;
    float l[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) l[j] = 0.f;
    for (int q = 0; q < R; ++q) {
      const float xq = xa_s[r * S::XA_STRIDE + q];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(bs + q * BN + tx * 4 + 64 * j);
        l[4 * j] = fmaf(xq, v.x, l[4 * j]);
        l[4 * j + 1] = fmaf(xq, v.y, l[4 * j + 1]);
        l[4 * j + 2] = fmaf(xq, v.z, l[4 * j + 2]);
        l[4 * j + 3] = fmaf(xq, v.w, l[4 * j + 3]);
      }
    }
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int gn = n0 + tx * 4 + 64 * j;
      const float4 v = make_float4(acc[i][4 * j] + scale * l[4 * j],
                                   acc[i][4 * j + 1] + scale * l[4 * j + 1],
                                   acc[i][4 * j + 2] + scale * l[4 * j + 2],
                                   acc[i][4 * j + 3] + scale * l[4 * j + 3]);
      T* out = y + (size_t)gm * N + gn;
      if constexpr (WIDE) {
        if (gn < N) st4(out, v);  // N is a multiple of 4: the whole vector is in
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (gn + u < N) out[u] = from_f32<T>(e[u]);
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, bool WIDE, int RT>
cudaError_t launch_tiled(const T* x, const T* w, const T* a, const T* b, T* y,
                         int M, int N, int K, int R, float scale, cudaStream_t s) {
  constexpr int bytes = TileShape<T, BM, BN, BK>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      lora_tiled<T, BM, BN, BK, WIDE, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lora_tiled<T, BM, BN, BK, WIDE, RT><<<grid, TTHREADS, bytes, s>>>(x, w, a, b, y, M, N, K, R, scale);
  return cudaSuccess;
}

// 16-byte copies: the tile given; element copies (ragged rows): 64×64.
template <typename T, int BM, int BN, int BK>
cudaError_t tiled(bool wide, const T* x, const T* w, const T* a, const T* b, T* y,
                  int M, int N, int K, int R, float scale, cudaStream_t s) {
  if (wide)
    return R <= 16 ? launch_tiled<T, BM, BN, BK, true, 1>(x, w, a, b, y, M, N, K, R, scale, s)
                   : launch_tiled<T, BM, BN, BK, true, 2>(x, w, a, b, y, M, N, K, R, scale, s);
  return R <= 16 ? launch_tiled<T, 64, 64, 32, false, 1>(x, w, a, b, y, M, N, K, R, scale, s)
                 : launch_tiled<T, 64, 64, 32, false, 2>(x, w, a, b, y, M, N, K, R, scale, s);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b, void* y,
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
    constexpr int vec = 16 / sizeof(T);
    const bool wide = K % vec == 0 && N % vec == 0 && R % vec == 0 && aligned16(x) &&
                      aligned16(w) && aligned16(a) && aligned16(y);
    // the tile rule of the source note
    const long long sms = sm_count();
    const auto blocks = [&](int bm, int bn) {
      return (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
    };
    if (blocks(64, 128) >= 2 * sms)
      return tiled<T, 64, 128, 16>(wide, xp, wp, ap, bp, yp, M, N, K, R, scale, s);
    if (blocks(96, 64) >= sms)
      return tiled<T, 96, 64, 16>(wide, xp, wp, ap, bp, yp, M, N, K, R, scale, s);
    return tiled<T, 64, 64, 32>(wide, xp, wp, ap, bp, yp, M, N, K, R, scale, s);
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  x (M,K), w (K,N), a (K,R), b (R,N), y (M,N),
// all row-major and contiguous.  Returns the first error of the launch, else
// cudaGetLastError() after it.
extern "C" int lora_fused(int dtype, const void* x, const void* w, const void* a,
                          const void* b, void* y, int M, int N, int K, int R,
                          float scale, void* stream) {
  if (R < 1 || R > RMAX || M < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(x, w, a, b, y, M, N, K, R, scale, s);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(x, w, a, b, y, M, N, K, R, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
