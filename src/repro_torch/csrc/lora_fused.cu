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
// lora_skinny (M ≤ 16, the decode rows) is bound by bytes: it streams W
// once (mamba2's out_proj decode, M 4, K 4096, N 2048, reads 33.5 MB, 10 µs
// at 3.35 TB/s).  The earlier design lost 1.7× to cuBLAS there: 16-column
// blocks read W as 64-byte row pieces with 4-byte loads, 16 KB a block in
// flight between two barriers a chunk, every block redid x·A over all of K
// (A half as many bytes as its slice of W), and gpt2's N 768 gave 48 blocks.
// This one:
// - A warp reads a 512-byte row segment of W, one 16-byte load a lane (4 f32
//   or 8 bf16 columns), so a block owns a strip of 128 f32 (256 bf16)
//   columns and A is r/128 of its bytes.  A warp loads U rows (4 at MR 4
//   and in bf16, else 8) before it uses any; the first batch is in flight while
//   the block stages its rows of x in shared memory, one barrier pair per
//   block.  Double-buffering the batches in registers was slower: it spilled
//   at 80 registers or, at 128, left too few blocks an SM for the clusters.
// - K is split across the `split` blocks of a thread block cluster, each
//   block over a range of rows, its 8 warps over every 8th row of it.  Every
//   block computes x·A over its own rows beside x·W (lane q < r, one FMA per
//   x value, from the same x registers).  The partial sums meet in a fixed
//   order, so a result is the same from run to run: over the warps through
//   shared memory, then over the cluster through distributed shared memory
//   (cluster.map_shared_rank): every block sums x·A over the ranks and
//   rounds it to T, and block `rank` finishes its share of the strip's
//   columns, y = Σ x·W + scale·round_T(x·A)·B, with B prefetched into L2 at
//   the start.  One launch, no workspace, no atomics, nothing to reset.
//   (Pushing the partial sums into the owner block instead of reading them
//   cost the same and needed more shared memory.)
// - What bounds the streaming is how many warps an SM keeps loading, and
//   that every cluster of a grid is resident at once: a cluster's blocks
//   must share one GPC.  So MR 4 in f32 is held to 80 registers, three
//   blocks an SM (MINB), which is what lets 16 clusters of 16 or 67 of 4
//   run in one wave.
// - Split rule (SM count from cudaDeviceGetAttribute): the split doubles
//   from 1 while the strips give fewer than two blocks an SM, up to 16 (the
//   largest cluster Hopper allows, non-portable above 8), while each warp
//   keeps at least 4 rows: 16 at gpt2's N 768 and mamba2's out_proj
//   (N 2048), 4 at its in_proj (N 8512).  Times that chose it, each split
//   forced (tools/lora_skinny_sweep.py; f32, r 8, H100 80GB HBM3 at 700 W,
//   cold L2, median of 30), beside torch.sum of W, a plain read of the bytes
//   the call must stream:
//     M × K × N          1        2        4        8        16       read W
//     8 × 768 × 768      0.0316   0.0203   0.0150   0.0131   0.0119   0.0132
//     12 × 768 × 768     0.0438   0.0270   0.0183   0.0151   0.0132   0.0134
//     4 × 2048 × 8512    0.0757   0.0517   0.0427   0.0478   0.0567   0.0420
//     4 × 4096 × 2048    0.1247   0.0707   0.0430   0.0316   0.0268   0.0263
//   At the rule's split the call reads W about as fast as torch.sum does.
//   chip_smoke.py's timer flushes the L2 by a write, and a call that streams
//   tens of MB first writes those dirty lines back; with a read flush the
//   out_proj row takes 0.0221 ms and the in_proj row 0.0350, a marginal
//   rate near 2.8 TB/s over a fixed 10 µs.
// - W loads are 16-byte vectors when N is a multiple of the vector and W is
//   16-byte aligned; otherwise element loads (the WIDE flag).  x, A, B and
//   y go through element loads and stores, so their alignment is free.
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

#include <cooperative_groups.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

using repro::from_f32;
using repro::round_to;
using repro::to_f32;

constexpr int RMAX = 32;  // largest rank; the wrapper checks it

// ----------------------------------------------------------------- skinny
constexpr int STHREADS = 256;
constexpr int SWARPS = STHREADS / 32;   // k-groups of a block, one warp each
constexpr int SPLIT_MAX = 16;           // largest cluster on Hopper (non-portable above 8)
constexpr int SMIN_ROWS = 4;            // fewest K rows a warp is split down to
constexpr int XS_BYTES = 32 * 1024;     // the x slab, then the reduction buffer

// Per type and row bound MR: a lane reads VEC columns with one 16-byte load,
// a warp a 512-byte row segment, which is the block's strip (BN columns);
// U rows of W are loaded by a warp before any is used.  MINB blocks an SM
// bound the registers (80 at 3, 128 at 2) where ptxas fits them unspilled:
// 3 at f32 MR 4, 2 at 32 accumulators a thread, else 1.
template <typename T, int MR>
struct SkinnyShape {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int BN = 32 * VEC;
  static constexpr int MINB = VEC == 4 && MR == 4 ? 3 : MR * VEC <= 32 ? 2 : 1;
  static constexpr int U = MR == 4 || VEC == 8 ? 4 : 8;
  static constexpr int KX = XS_BYTES / (MR * 4);                 // x rows per pass
  static constexpr int MG0 = XS_BYTES / (SWARPS * BN * 4);
  static constexpr int MG = MG0 < MR ? MG0 : MR;                 // output rows per reduction step
  static constexpr int BYTES = XS_BYTES + (MR * BN + 2 * MR * RMAX) * 4;
  static_assert(SWARPS * MR * RMAX * 4 <= XS_BYTES && MR % MG == 0, "reduction buffer");
};

// VEC elements of one W row from column ``col`` as raw bits, zero past N or
// when ``ok`` is false.  WIDE: one 16-byte load (N a multiple of VEC, W
// 16-byte aligned); otherwise element loads.
template <typename T, bool WIDE>
__device__ __forceinline__ uint4 load_w(const T* row, int col, int N, bool ok) {
  constexpr int VEC = 16 / sizeof(T);
  if constexpr (WIDE) {
    return ok && col < N ? __ldg(reinterpret_cast<const uint4*>(row + col)) : make_uint4(0, 0, 0, 0);
  } else {
    using Bits = std::conditional_t<sizeof(T) == 4, unsigned, unsigned short>;
    Bits e[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      e[v] = ok && col + v < N ? reinterpret_cast<const Bits*>(row)[col + v] : Bits(0);
    uint4 r;
    memcpy(&r, e, 16);
    return r;
  }
}

// Raw bits → VEC f32 values (bf16 is the high half of an f32).
__device__ __forceinline__ void unpack(uint4 r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x), f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z), f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(uint4 r, float (&f)[8]) {
  const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// A cluster of ``split`` blocks owns one BN-column strip; block ``rank``
// owns K rows [rank·kr, (rank+1)·kr), warp w of it the rows w, w + 8, ...
// of that range.  Rows ≥ M of x are zero.
template <typename T, int MR, bool WIDE>
__global__ void __launch_bounds__(STHREADS, SkinnyShape<T, MR>::MINB)
lora_skinny(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ y, int M, int N, int K, int R, float scale) {
  using S = SkinnyShape<T, MR>;
  constexpr int VEC = S::VEC, BN = S::BN, U = S::U, MG = S::MG;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // x rows [KX][MR], then the reduction buffer
  float* blk = xs + XS_BYTES / 4;              // [MR][BN]: the block's x·W over its rows
  float* xa_blk = blk + MR * BN;               // [MR][RMAX]: its x·A over them
  float* xa = xa_blk + MR * RMAX;              // [MR][RMAX]: x·A over all K, rounded to T

  cg::cluster_group cluster = cg::this_cluster();
  const int split = cluster.num_blocks(), rank = cluster.block_rank();
  const int n0 = blockIdx.x / split * BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int col = n0 + lane * VEC;
  const int kr = (K + split - 1) / split;
  const int kb0 = rank * kr, kb1 = min(K, kb0 + kr);
  const int cw = ((BN + split - 1) / split + 3) / 4 * 4;  // the block's output columns
  const int c0 = rank * cw, c1 = min(BN, c0 + cw);

  // B for the block's columns into L2 now, so the epilogue does not wait on
  // memory: one prefetch per 128-byte line
  {
    constexpr int LINE = 128 / sizeof(T);
    const int lines = (cw + LINE - 1) / LINE;
    for (int i = tid; i < R * lines; i += STHREADS) {
      const int n = n0 + c0 + (i % lines) * LINE;
      if (n < N) asm volatile("prefetch.global.L2 [%0];" ::"l"(b + (size_t)(i / lines) * N + n));
    }
  }

  float acc[MR][VEC], acc_a[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    acc_a[m] = 0.f;
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[m][v] = 0.f;
  }
  uint4 wv[U];
  float av[U];
  // batch i0 of this warp: its rows i0 .. i0 + U - 1 (row i is p0 + warp + SWARPS·i)
  auto load = [&](int p0, int nw, int i0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = p0 + warp + SWARPS * (i0 + u);
      const bool ok = i0 + u < nw;
      wv[u] = load_w<T, WIDE>(w + (size_t)k * N, col, N, ok);
      av[u] = ok && lane < R ? to_f32(a[(size_t)k * R + lane]) : 0.f;
    }
  };

  for (int p0 = kb0; p0 < kb1; p0 += S::KX) {  // one pass unless K/split > KX
    const int rows = min(kb1 - p0, S::KX);
    const int nw = (rows - warp + SWARPS - 1) / SWARPS;  // this warp's rows in the pass
    load(p0, nw, 0);  // in flight while x is staged
    __syncthreads();  // the previous pass is done with xs
    for (int i = tid; i < MR * rows; i += STHREADS) {
      const int m = i / rows, k = i % rows;
      xs[k * MR + m] = m < M ? to_f32(x[(size_t)m * K + p0 + k]) : 0.f;
    }
    __syncthreads();
    for (int i0 = 0; i0 < nw; i0 += U) {
      if (i0) load(p0, nw, i0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u < nw) {  // warp-uniform
          float wf[VEC];
          unpack(wv[u], wf);
          const float4* xr = reinterpret_cast<const float4*>(xs + (warp + SWARPS * (i0 + u)) * MR);
#pragma unroll
          for (int q = 0; q < MR / 4; ++q) {
            const float4 x4 = xr[q];
            const float xm[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc[4 * q + e][v] = fmaf(xm[e], wf[v], acc[4 * q + e][v]);
              acc_a[4 * q + e] = fmaf(xm[e], av[u], acc_a[4 * q + e]);
            }
          }
        }
      }
    }
  }

  // The block's partial sums over its warps, in warp order: x·A first, then
  // x·W, MG output rows at a time through the reduction buffer.
  float* red = xs;
  __syncthreads();
  if (lane < R)
#pragma unroll
    for (int m = 0; m < MR; ++m) red[(warp * MR + m) * RMAX + lane] = acc_a[m];
  __syncthreads();
  for (int i = tid; i < MR * R; i += STHREADS) {
    const int j = i / R * RMAX + i % R;  // (m, q)
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < SWARPS; ++g) s += red[g * MR * RMAX + j];
    xa_blk[j] = s;
  }
#pragma unroll
  for (int mg = 0; mg < MR; mg += MG) {
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < MG; ++mm)
#pragma unroll
      for (int v = 0; v < VEC; v += 4)
        *reinterpret_cast<float4*>(red + (warp * MG + mm) * BN + lane * VEC + v) =
            make_float4(acc[mg + mm][v], acc[mg + mm][v + 1], acc[mg + mm][v + 2], acc[mg + mm][v + 3]);
    __syncthreads();
    for (int i = tid; i < MG * BN; i += STHREADS) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < SWARPS; ++g) s += red[g * MG * BN + i];
      blk[mg * BN + i] = s;
    }
  }

  // Across the cluster, in rank order, through distributed shared memory:
  // every block forms x·A over all K (the same value in each), then block
  // ``rank`` finishes its share of the strip's columns.
  cluster.sync();
  for (int i = tid; i < MR * RMAX; i += STHREADS) {  // ranks ≥ r are zero
    float part[SPLIT_MAX];
#pragma unroll
    for (int r = 0; r < SPLIT_MAX; ++r)
      part[r] = r < split && i % RMAX < R ? cluster.map_shared_rank(xa_blk, r)[i] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < SPLIT_MAX; ++r) s += part[r];
    xa[i] = round_to<T>(s);
  }
  __syncthreads();
  for (int i = tid; i < MR * cw; i += STHREADS) {
    const int m = i / cw, c = c0 + i % cw, n = n0 + c;
    if (m < M && c < c1 && n < N) {
      // every load of the output is issued before any is used
      float bq[RMAX], part[SPLIT_MAX];
#pragma unroll
      for (int q = 0; q < RMAX; ++q) bq[q] = q < R ? to_f32(b[(size_t)q * N + n]) : 0.f;
#pragma unroll
      for (int r = 0; r < SPLIT_MAX; ++r)
        part[r] = r < split ? cluster.map_shared_rank(blk, r)[m * BN + c] : 0.f;
      float base = 0.f, l = 0.f;
#pragma unroll
      for (int r = 0; r < SPLIT_MAX; ++r) base += part[r];
#pragma unroll
      for (int q = 0; q < RMAX; ++q) l = fmaf(xa[m * RMAX + q], bq[q], l);
      y[(size_t)m * N + n] = from_f32<T>(base + scale * l);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
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

// The split rule of the source note: K is halved across more blocks of a
// cluster until the strips give two blocks an SM, up to SPLIT_MAX, while a
// warp keeps at least SMIN_ROWS rows.
int skinny_split(int strips, int K, int sms) {
  int split = 1;
  while (split < SPLIT_MAX && (long long)strips * split < 2LL * sms &&
         K >= 2 * split * SWARPS * SMIN_ROWS)
    split *= 2;
  return split;
}

template <typename T, int MR, bool WIDE>
cudaError_t launch_skinny(int split, const T* x, const T* w, const T* a, const T* b, T* y,
                          int M, int N, int K, int R, float scale, cudaStream_t s) {
  using S = SkinnyShape<T, MR>;
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        lora_skinny<T, MR, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        lora_skinny<T, MR, WIDE>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + S::BN - 1) / S::BN * split);
  cfg.blockDim = dim3(STHREADS);
  cfg.dynamicSmemBytes = S::BYTES;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, lora_skinny<T, MR, WIDE>, x, w, a, b, y, M, N, K, R, scale);
}

template <typename T, int MR>
cudaError_t skinny(bool wide, int split, const T* x, const T* w, const T* a, const T* b, T* y,
                   int M, int N, int K, int R, float scale, cudaStream_t s) {
  return wide ? launch_skinny<T, MR, true>(split, x, w, a, b, y, M, N, K, R, scale, s)
              : launch_skinny<T, MR, false>(split, x, w, a, b, y, M, N, K, R, scale, s);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b, void* y,
                   int M, int N, int K, int R, float scale, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if (M <= 16) {
    const bool wide = N % (16 / (int)sizeof(T)) == 0 && aligned16(w);
    const int strips = (N + SkinnyShape<T, 4>::BN - 1) / SkinnyShape<T, 4>::BN;
    const int split = skinny_split(strips, K, sm_count());
    if (M <= 4) return skinny<T, 4>(wide, split, xp, wp, ap, bp, yp, M, N, K, R, scale, s);
    if (M <= 8) return skinny<T, 8>(wide, split, xp, wp, ap, bp, yp, M, N, K, R, scale, s);
    return skinny<T, 16>(wide, split, xp, wp, ap, bp, yp, M, N, K, R, scale, s);
  }
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

// The decode branch's plan for a call with M ≤ 16: the strip width in
// columns and the K split the rule takes on the current device.
extern "C" int lora_skinny_plan(int dtype, int N, int K, int* strip, int* split) {
  if ((dtype != 0 && dtype != 1) || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int bn = dtype == 0 ? SkinnyShape<float, 4>::BN : SkinnyShape<__nv_bfloat16, 4>::BN;
  *strip = bn;
  *split = skinny_split((N + bn - 1) / bn, K, sm_count());
  return 0;
}
