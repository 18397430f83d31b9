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
// What bounds it on the H100: each step reads the positions it attends to
// once, in both caches — at the serving shape (B = 8, K = 12, hd = 64, f32)
// 49 KB per position: 9.4 MB at cache_len 192, 31.5 MB for the 640
// positions of SERVE-SPARSE's cache_len 1024, 9.4 us at 3.35 TB/s — against
// 4·hd FLOP per (head, position): bound by the bytes.
//
// What held the earlier design (one 256-thread block per (b, h): 96 blocks
// on 132 SMs; each warp read 4 positions a step with 4-byte loads and used
// them before loading more; the sparse mask tested position by position
// over the whole range) to 0.58 TB/s.  This one is split-KV over the
// positions read, merged inside one launch:
// - The active positions are contiguous segments: [lo, hi) in dense mode
//   (lo = cache_len - window with a window, hi = min(cache_len, Sc)), which
//   every thread knows; under the sparse mask one segment per active kv
//   block, clipped to [lo, hi), which each block enumerates once, in shared
//   memory, at the start (one warp: a ballot and a scan over the kv blocks).
//   No position of an inactive block costs a loop trip, and no position is
//   tested: the query's own, partial block is a segment clipped at hi.
// - Each (b, h) gets a thread block cluster of `split` blocks.  Rank r takes
//   the r-th even, contiguous share of the active positions, its 4 warps a
//   contiguous quarter of that.  A K or V row is read with 16-byte loads (4
//   f32 or 8 bf16 a lane), so one warp load covers 32·16/(hd·size) rows (2
//   at hd 64 in f32, 4 in bf16), each a "group" of lanes with its own
//   running m, l and acc; a q·k dot meets over its group by log2(lanes) xor
//   shuffles (a lane holds hd/lanes-a-row values, so the shuffles are 4 a
//   row at hd 64 in f32, and a layout with one lane a position would need
//   a row's 256 bytes from one lane, 16 loads).  A warp step loads U rows a
//   group (2 in f32, 1 in bf16: 1 KB of K and 1 KB of V a warp either way),
//   and the next step's loads are issued before this step's dots and expfs
//   (register double buffering, unspilled at the 64 registers that 8 blocks
//   an SM allow; bf16 at U 2 spilled).  q is kept raw and d^-1/2 scales each
//   dot, so the first K and V loads do not wait on q's.
// - The merge is deterministic: groups meet in a warp by shuffles in a fixed
//   order, warps in the block through shared memory in warp order, and
//   rank 0 reads the ranks' (m, l, acc) through distributed shared memory
//   (cluster.map_shared_rank) in rank order and writes o (and, when the
//   caller asks, the log-sum-exp m + log l of the scaled logits it read, so
//   that outputs over disjoint position ranges merge exactly: the sparse-KV
//   cache's persistent prefix and ring); a second cluster
//   barrier keeps every block alive until rank 0 has read it (a relaxed
//   arrival, since rank 0 has used what it read; a full cluster.sync() there
//   was slower).  One
//   launch, no workspace, no atomics: two calls on the same inputs give the
//   same bits.  An empty share (cache_len 1 at split 16) contributes
//   m = NEG_INF, l = 0, acc = 0: NEG_INF is finite, so exp(m - m') is 1 or
//   0 and never NaN, and a merge with an empty state is exact.
// - The streaming wants every cluster of the grid resident at once (a
//   cluster's blocks share one GPC), hence 8 blocks an SM: at 6 (80
//   registers) SERVE-SPARSE's call (96 clusters of 8) was slower, as if they
//   no longer fit one wave.  Prefetching a warp's rows into L2 before its
//   first load was slower too, and is not done.
// - The split comes from decode_split (below) on B·H, the most positions a
//   call can read (Sc, the sparse pattern's most blocks, or the window) and
//   the SM count, never on cache_len: every decode step of a run launches
//   the same grid (a CUDA graph can capture it once the length lives on the
//   device), and each block derives its share from cache_len itself.  The
//   split doubles from 1, up to 16 (the largest cluster Hopper allows,
//   non-portable above 8), while the grid still fits one wave and either
//   each rank keeps at least MIN_POS = 32 of the most positions a call can
//   read or the grid would still fill at most half the SMs: 8 at
//   SERVE-SPARSE's decode (640 positions at most, 80 a rank), 4 at SERVE's
//   (192, 48 a rank), 16 at B·H 1.  cache_len arrives as a plain int
//   argument: the host never reads a device scalar in the decode loop.
//   Times that chose it, each split forced (tools/decode_split_sweep.py;
//   f32 unless marked, H100 80GB HBM3 at 700 W, cold L2, median of 30),
//   beside torch.sum over the K and V positions the call reads:
//     row (B 8, H = K 12, hd 64)   1       2       4       8       16      read
//     dense, cache 192 of 192      0.0187  0.0144  0.0135  0.0140  0.0193  0.0156
//     sparse, cache_len 897        0.0436  0.0289  0.0236  0.0223  0.0288  0.0352
//     sparse, cache_len 1024       0.0518  0.0337  0.0265  0.0250  0.0317  0.0378
//     bf16 sparse, cache_len 1024  0.0376  0.0250  0.0196  0.0181  0.0258  0.0362
//     GQA: B 2, H 8, K 4, hd 128,
//       cache_len 201, window 64   0.0130  0.0101  0.0087  0.0091  0.0106  0.0138
//   The rule takes 4, 8, 8, 8 and 4.  Past it, a larger cluster costs more
//   in its merge than it gains in streaming.  Every row streams its K and V
//   faster than torch.sum reads the same positions; what is left at the
//   dense row is fixed cost: the launch (the sweep's `empty` row times an
//   empty kernel under the same timer), the first DRAM round trip, and the
//   cluster's merge.
// - K and V loads are 16-byte vectors when both caches are 16-byte aligned
//   (on the whole-chunk path a row is a multiple of 16 bytes); otherwise
//   element loads (the WIDE flag).  q and o go through element loads and stores.
// - The compiled HD (32, 64, 128, 256) is a lane layout, not a row width:
//   the call's rows are d ≤ HD wide, whole 16-byte chunks (d·size a
//   multiple of 16), read at their true stride; a lane's q dims past d are
//   zero and its chunks past d read the row's first chunk (exact zeros in
//   every dot; an accumulator column that is never stored, and the same
//   sectors as lane 0's load), so gemma3's heads of 240 run at HD 256 and
//   heads of 16 at HD 32.  At HD 256 in f32 a row is 64 chunks, two a lane (chunk c
//   of a lane at dims 4·(lane + 32·c), so a warp load still covers 512
//   contiguous bytes), one row a group and U = 1: 1 KB of K and V a warp
//   load, as at every other width.  Its lane holds 8 accumulator floats and
//   four 32-byte load buffers, more than 64 registers hold, so the HD-256
//   instances run at 4 blocks an SM (128 registers) and the split rule
//   reads 4 in its one-wave test; every other instance keeps 8.  The block
//   merge and rank 0's cluster merge give a thread two dims at HD 256 (a
//   loop of constant trips: one with a trip count read at run time put
//   300 bytes of every instance in local memory), rank 0's weights once
//   for both.
// - Any head width runs (kernels/flash_attn/ops.py plan, the ``rows``
//   argument).  Rows that are not whole chunks (f32 heads of 18; bf16 rows
//   of odd width) are not 16-byte aligned from one row to the next, and
//   the chunk a lane reads past d would be the next row's: ``rows`` 1 reads
//   a lane's chunks element by element, each element past d zero (ELEM, at
//   the same layouts, element loads).  Rows wider than 256 (``rows`` 2,
//   SLICED) run at the HD 256 layout: q, f32, in shared memory (zero past
//   d up to a whole slice), and a warp step reads one position's V chunks
//   of its column plane (a grid y plane a 256 columns of v and o, every
//   plane recomputing the same dots and weights) and sums the q·k dot over
//   the 256-wide slices of K in turn, a loop of run-time trips over a
//   lane's constant two chunks (f32) or one (bf16), element reads, no
//   register double buffering: a slow path, kept simple.  Every plane's
//   cluster takes part in the split rule's one-wave test.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

using repro::from_f32;
using repro::NEG_INF;
using repro::to_f32;
using repro::unpack;

constexpr int NW = 4;               // warps per block
constexpr int THREADS = NW * 32;
constexpr int SPLIT_MAX = 16;       // largest cluster on Hopper (non-portable above 8)
constexpr int MIN_POS = 32;         // fewest positions a rank is split down to
constexpr unsigned FULL = 0xffffffffu;

// How a lane reads its rows: whole 16-byte chunks, elements, or sliced
// (the note above; the C entry point's ``rows``).
constexpr int CHUNK_ROWS = 0, ELEM_ROWS = 1, SLICED_ROWS = 2;
constexpr int SLICE_W = 256;        // the SLICED layout and slice width

// Blocks an SM the registers are held to: 8 (64 registers a thread), or 4
// (128) at HD 256 and on the ELEM_ROWS and SLICED_ROWS paths (at 64
// registers their bf16 element reads spilled 4 bytes).
constexpr int min_blocks(int HD, int rows) {
  return HD > 128 || rows != CHUNK_ROWS ? 4 : 8;
}

// Per type and head width: VEC elements per 16-byte load, CPL 16-byte
// chunks a lane holds of a row, LPR lanes per row, RPI rows (groups) per
// warp load, U rows a group loads per step (1 KB of K and V a warp load:
// 2 where a lane's share of a row is 16 bytes in f32, else 1), STEP
// positions per warp step, MINB blocks an SM (on path ROWS).
template <typename T, int HD, int ROWS = CHUNK_ROWS>
struct Shape {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CHUNKS = HD / VEC;
  static constexpr int CPL = CHUNKS > 32 ? CHUNKS / 32 : 1;
  static constexpr int LPR = CHUNKS / CPL;
  static constexpr int RPI = 32 / LPR;
  static constexpr int U = VEC * CPL == 4 ? 2 : 1;
  static constexpr int STEP = RPI * U;
  static constexpr int MINB = min_blocks(HD, ROWS);
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0 && CHUNKS == LPR * CPL, "lane layout");
};

// VEC elements from ``p`` as raw bits, zero when ``ok`` is false.  WIDE: one
// 16-byte load (p 16-byte aligned); otherwise element loads.
template <typename T, bool WIDE>
__device__ __forceinline__ uint4 load16(const T* p, bool ok) {
  if constexpr (WIDE) {
    return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  } else {
    constexpr int VEC = 16 / sizeof(T);
    using Bits = std::conditional_t<sizeof(T) == 4, unsigned, unsigned short>;
    Bits e[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) e[v] = ok ? reinterpret_cast<const Bits*>(p)[v] : Bits(0);
    uint4 r;
    memcpy(&r, e, 16);
    return r;
  }
}

// The first n (the rest zero) of the VEC elements from ``p`` as raw bits,
// element loads.
template <typename T>
__device__ __forceinline__ uint4 load_upto(const T* p, int n) {
  constexpr int VEC = 16 / sizeof(T);
  using Bits = std::conditional_t<sizeof(T) == 4, unsigned, unsigned short>;
  Bits e[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) e[v] = v < n ? reinterpret_cast<const Bits*>(p)[v] : Bits(0);
  uint4 r;
  memcpy(&r, e, 16);
  return r;
}

// Segments a sparse call can have: one per kv block (dense mode keeps none).
__host__ __device__ __forceinline__ int max_segments(int Sc, int block) {
  return block > 0 ? (Sc + block - 1) / block : 0;
}

// Ints of dynamic shared memory before SLICED's q: the segment table,
// rounded up to 16 bytes.
__host__ __device__ __forceinline__ int seg_ints(int Sc, int block) {
  return (2 * max_segments(Sc, block) + 3) / 4 * 4;
}

// The grid is ((B·H)·split, planes) blocks, one cluster of ``split`` per
// (b, h) and plane (one plane but under SLICED).  Rows are d ≤ HD elements
// wide (any d under SLICED).  Dynamic shared memory: the segment table,
// max_segments ints of position bases (position = base + active index) and
// as many ends (exclusive, in active-index space); under SLICED then q.
template <typename T, int HD, bool WIDE, int ROWS>
__global__ void __launch_bounds__(THREADS, (Shape<T, HD, ROWS>::MINB))
decode_fwd(const T* __restrict__ q, const T* __restrict__ kc,
           const T* __restrict__ vc, T* __restrict__ o, float* __restrict__ lse,
           int Sc, int H, int KH, int d,
           int cache_len, int offset, int window, int block, int sink, int local,
           int stride, float scale) {
  using S = Shape<T, HD, ROWS>;
  constexpr int VEC = S::VEC, CPL = S::CPL, LPR = S::LPR, RPI = S::RPI, U = S::U,
                STEP = S::STEP;
  constexpr bool SL = ROWS == SLICED_ROWS;
  extern __shared__ __align__(16) int seg[];
  __shared__ float wm[NW], wl[NW];
  __shared__ float wacc[NW][HD];
  __shared__ float rm, rl;          // the rank's state, read by rank 0
  __shared__ float racc[HD];
  __shared__ int n_active;
  int* seg_base = seg;
  int* seg_end = seg + max_segments(Sc, block);

  cg::cluster_group cluster = cg::this_cluster();
  const int split = cluster.num_blocks(), rank = cluster.block_rank();
  const int bh = blockIdx.x / split, b = bh / H, h = bh % H, kvh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the lane's chunk c covers dims col + LPR·VEC·c
  const int grp = lane / LPR, col = (lane % LPR) * VEC;
  // Slot i holds position offset + i: the slots below cl are valid.
  const int cl = cache_len - offset;
  const int hi = min(cl, Sc);
  const int lo = window > 0 ? max(0, cl - window) : 0;

  // Under the sparse mask, the segment table, by warp 0: kv blocks in
  // chunks of 32, one a lane; the active ones are compacted by a ballot,
  // their lengths summed by a scan.  (Dense mode has one segment, [lo, hi),
  // which every thread knows.)
  if (block > 0 && warp == 0) {
    const int boff = offset / block;  // offset is a multiple of block
    const int qblk = (cl - 1) / block;
    const int nblk = (hi + block - 1) / block;
    int n = 0, k = 0;  // active positions and segments so far
    for (int c = lo / block; c < nblk; c += 32) {  // the same trips for the whole warp
      const int blk = c + lane;
      const int a = max(blk * block, lo), e = min(blk * block + block, hi);
      const bool on = blk < nblk && e > a &&
                      (blk + boff < sink || blk > qblk - local || (blk + boff) % stride == 0);
      const int len = on ? e - a : 0;
      int incl = len;
#pragma unroll
      for (int sh = 1; sh < 32; sh <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, sh);
        if (lane >= sh) incl += v;
      }
      const unsigned ball = __ballot_sync(FULL, on);
      if (on) {
        const int i = k + __popc(ball & ((1u << lane) - 1));
        seg_end[i] = n + incl;
        seg_base[i] = a - (n + incl - len);
      }
      n += __shfl_sync(FULL, incl, 31);
      k += __popc(ball);
    }
    if (lane == 0) n_active = n;
  }

  // q stays raw (its loads need not land before the first K and V loads
  // go out); d^-1/2 scales each dot.  Dims past d are zero.  SLICED: q in
  // shared memory, f32, zero past d up to a whole slice.
  [[maybe_unused]] T qv[CPL][VEC];
  [[maybe_unused]] float* qs = reinterpret_cast<float*>(seg + seg_ints(Sc, block));
  if constexpr (SL) {
    for (int i = tid; i < (d + HD - 1) / HD * HD; i += THREADS)
      qs[i] = i < d ? to_f32(q[(size_t)bh * d + i]) : 0.f;
  } else {
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int dim = col + LPR * VEC * c + v;
        qv[c][v] = dim < d ? q[(size_t)bh * d + dim] : from_f32<T>(0.f);
      }
  }
  if (SL || block > 0) __syncthreads();

  // The rank's share of the active indices, and the warp's part of it.
  const int n = block > 0 ? n_active : max(hi - lo, 0);
  const int t0 = (int)((long long)n * rank / split);
  const int ns = (int)((long long)n * (rank + 1) / split) - t0;
  const int w0 = t0 + ns * warp / NW, w1 = t0 + ns * (warp + 1) / NW;

  const size_t pos_stride = (size_t)KH * d;
  const size_t row0 = ((size_t)b * Sc * KH + kvh) * d + col;  // (b, kvh) at position 0
  const T* kp = kc + row0;
  const T* vp = vc + row0;
  // The lane's chunk c at kp + cofs[c].  A chunk past the row's d dims
  // reads the row's first chunk instead: its q dims are zero, so it adds
  // exact zeros to the dot, and its accumulator dims are never stored; no
  // load waits on a test of the row width.  ELEMS: the chunk's own place,
  // its first lim[c] elements read.
  int cofs[CPL];
  [[maybe_unused]] int lim[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    if constexpr (ROWS == ELEM_ROWS) {
      cofs[c] = LPR * VEC * c, lim[c] = d - col - LPR * VEC * c;
    } else {
      cofs[c] = col + LPR * VEC * c < d ? LPR * VEC * c : -col;
    }
  }
  int s = 0;  // the lane's segment: its active indices only grow
  uint4 kr[U][CPL], vr[U][CPL], kn[U][CPL], vn[U][CPL];
  // step ``i0``: the group's rows i0 + grp + RPI·u, zero past w1
  auto load = [&](int i0, uint4 (&kb)[U][CPL], uint4 (&vb)[U][CPL]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = i0 + grp + RPI * u;
      const bool ok = t < w1;
      size_t off = 0;
      if (ok) {
        if (block > 0) {
          while (t >= seg_end[s]) ++s;
          off = (size_t)(seg_base[s] + t) * pos_stride;
        } else {
          off = (size_t)(lo + t) * pos_stride;
        }
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        if constexpr (ROWS == ELEM_ROWS) {
          kb[u][c] = load_upto(kp + off + cofs[c], ok ? lim[c] : 0);
          vb[u][c] = load_upto(vp + off + cofs[c], ok ? lim[c] : 0);
        } else {
          kb[u][c] = load16<T, WIDE>(kp + off + cofs[c], ok);
          vb[u][c] = load16<T, WIDE>(vp + off + cofs[c], ok);
        }
      }
    }
  };

  constexpr int NA = CPL * VEC;  // accumulator floats a lane: chunk c's at c·VEC
  float acc[NA];
#pragma unroll
  for (int v = 0; v < NA; ++v) acc[v] = 0.f;
  float m = NEG_INF, l = 0.f;
  // SLICED: plane z's columns [z0, z0 + HD) of v and o
  const int z0 = SL ? (int)blockIdx.y * HD : 0;
  if constexpr (SL) {
    static_assert(HD == SLICE_W && LPR == 32 && U == 1 && STEP == 1, "sliced layout");
    for (int t = w0; t < w1; ++t) {  // warp-uniform trips, a position a step
      if (block > 0) while (t >= seg_end[s]) ++s;
      const size_t off = (size_t)((block > 0 ? seg_base[s] : lo) + t) * pos_stride;
      uint4 vb[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        vb[c] = load_upto(vp + off + z0 + LPR * VEC * c, d - z0 - col - LPR * VEC * c);
      float dot = 0.f;
#pragma unroll 2
      for (int s0 = 0; s0 < d; s0 += HD) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int dim = s0 + col + LPR * VEC * c;
          float kf[VEC];
          unpack(load_upto(kp + off + s0 + LPR * VEC * c, d - dim), kf);
#pragma unroll
          for (int v = 0; v < VEC; v += 4) {
            const float4 qf = *reinterpret_cast<const float4*>(qs + dim + v);
            dot = fmaf(qf.x, kf[v], dot);
            dot = fmaf(qf.y, kf[v + 1], dot);
            dot = fmaf(qf.z, kf[v + 2], dot);
            dot = fmaf(qf.w, kf[v + 3], dot);
          }
        }
      }
#pragma unroll
      for (int o_ = 16; o_ > 0; o_ >>= 1) dot += __shfl_xor_sync(FULL, dot, o_);
      const float sc = dot * scale;
      const float m_new = fmaxf(m, sc);
      const float corr = expf(m - m_new), p = expf(sc - m_new);
      l = fmaf(l, corr, p);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float vf[VEC];
        unpack(vb[c], vf);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[c * VEC + v] = fmaf(p, vf[v], acc[c * VEC + v] * corr);
      }
      m = m_new;
    }
  } else {
    if (w0 < w1) load(w0, kr, vr);
    for (int i0 = w0; i0 < w1; i0 += STEP) {  // warp-uniform trips
      if (i0 + STEP < w1) load(i0 + STEP, kn, vn);  // in flight while this step computes
      float sc[U];
      float cmax = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float kf[VEC];
          unpack(kr[u][c], kf);
#pragma unroll
          for (int v = 0; v < VEC; ++v) dot = fmaf(to_f32(qv[c][v]), kf[v], dot);
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
        sc[u] = dot * scale;
        if (i0 + grp + RPI * u < w1) cmax = fmaxf(cmax, sc[u]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u] = i0 + grp + RPI * u < w1 ? expf(sc[u] - m_new) : 0.f;
        psum += sc[u];
      }
      l = fmaf(l, corr, psum);
#pragma unroll
      for (int v = 0; v < NA; ++v) acc[v] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float vf[VEC];
          unpack(vr[u][c], vf);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[c * VEC + v] = fmaf(sc[u], vf[v], acc[c * VEC + v]);
        }
      m = m_new;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CPL; ++c) kr[u][c] = kn[u][c], vr[u][c] = vn[u][c];
    }
  }

  // Groups of the warp meet in lanes 0 .. LPR-1, by shuffles down.
#pragma unroll
  for (int off = 16; off >= LPR; off >>= 1) {
    const float mo = __shfl_down_sync(FULL, m, off), lo_ = __shfl_down_sync(FULL, l, off);
    const float mn = fmaxf(m, mo), c = expf(m - mn), co = expf(mo - mn);
    l = fmaf(l, c, lo_ * co);
#pragma unroll
    for (int v = 0; v < NA; ++v) {
      const float ao = __shfl_down_sync(FULL, acc[v], off);
      acc[v] = fmaf(acc[v], c, ao * co);
    }
    m = mn;
  }
  if (lane < LPR) {
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int v = 0; v < VEC; ++v) wacc[warp][col + LPR * VEC * c + v] = acc[c * VEC + v];
    if (lane == 0) wm[warp] = m, wl[warp] = l;
  }
  __syncthreads();
  // The block's warps, in warp order: the rank's (m, l, acc), a dim a
  // thread (DPT dims a thread at HD 256; a loop of constant trips, so that
  // nothing of it reaches local memory).
  constexpr int DPT = (HD + THREADS - 1) / THREADS;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int dim = tid + THREADS * j;
    if (dim >= HD) break;
    float mt = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mt = fmaxf(mt, wm[w]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(wm[w] - mt);
      lt = fmaf(wl[w], c, lt);
      at = fmaf(wacc[w][dim], c, at);
    }
    racc[dim] = at;
    if (dim == 0) rm = mt, rl = lt;
  }
  cluster.sync();
  // The ranks, in rank order, through distributed shared memory: their
  // maxima and weights first, then each dim's weighted sum; the row's d
  // dims (SLICED: the plane's) are stored.
  const int dout = SL ? min(HD, d - z0) : d;
  if (rank == 0 && tid < dout) {
    float c[SPLIT_MAX];
#pragma unroll
    for (int r = 0; r < SPLIT_MAX; ++r) c[r] = r < split ? *cluster.map_shared_rank(&rm, r) : NEG_INF;
    float mt = NEG_INF;
#pragma unroll
    for (int r = 0; r < SPLIT_MAX; ++r) mt = fmaxf(mt, c[r]);
    float lt = 0.f;
#pragma unroll
    for (int r = 0; r < SPLIT_MAX; ++r) {
      if (r < split) {
        c[r] = expf(c[r] - mt);
        lt = fmaf(*cluster.map_shared_rank(&rl, r), c[r], lt);
      }
    }
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int dim = tid + THREADS * j;
      if (dim >= dout) break;
      float at = 0.f;
#pragma unroll
      for (int r = 0; r < SPLIT_MAX; ++r)
        if (r < split) at = fmaf(cluster.map_shared_rank(racc, r)[dim], c[r], at);
      o[(size_t)bh * d + z0 + dim] = from_f32<T>(at / fmaxf(lt, 1e-30f));
    }
    if (lse != nullptr && tid == 0 && z0 == 0) lse[bh] = mt + logf(lt);
  }
  // No block leaves while rank 0 reads its shared memory.  Rank 0 arrives
  // after it has used what it read, so the arrival orders nothing (relaxed).
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The most positions a call over this cache can read, whatever its
// cache_len: Sc, at most sink + local + ceil(blocks / stride) kv blocks
// under the sparse mask, at most ``window`` with a window.
int most_positions(int Sc, int window, int block, int sink, int local, int stride) {
  int p = Sc;
  if (block > 0) {
    const long long nblk = (Sc + block - 1) / block;
    const long long blocks = (long long)sink + local + (nblk + stride - 1) / stride;
    p = (int)std::min<long long>(p, std::min(nblk, blocks) * block);
  }
  if (window > 0) p = std::min(p, window);
  return p;
}

// The split rule of the source note: the cluster doubles from 1, up to
// SPLIT_MAX, while the grid still fits one wave at ``minb`` blocks an SM (the
// instance's MINB), and either each rank keeps at least MIN_POS of the most
// positions a call can read or the grid would still fill at most half the
// SMs.
int decode_split(int bh, int positions_max, int sms, int minb) {
  int split = 1;
  while (split < SPLIT_MAX && 2LL * bh * split <= (long long)minb * sms &&
         (positions_max >= 2 * split * MIN_POS || 4LL * bh * split <= sms))
    split *= 2;
  return split;
}

template <typename T, int HD, bool WIDE, int ROWS>
cudaError_t launch(int split, int planes, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int Sc, int H, int KH, int d, int cache_len,
                   int offset, int window, const int* sp, float scale, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_fwd<T, HD, WIDE, ROWS>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (attr != cudaSuccess) return attr;
  const int smem = (ROWS == SLICED_ROWS ? seg_ints(Sc, sp[0]) + (d + HD - 1) / HD * HD
                                   : 2 * max_segments(Sc, sp[0])) * (int)sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_fwd<T, HD, WIDE, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * split, planes);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_fwd<T, HD, WIDE, ROWS>, static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v),
                            static_cast<T*>(o), lse, Sc, H, KH, d, cache_len, offset, window,
                            sp[0], sp[1], sp[2], sp[3], scale);
}

// Column planes of a call: one, or a plane a SLICE_W columns under SLICED.
int planes_of(int rows, int d) {
  return rows == SLICED_ROWS ? (d + SLICE_W - 1) / SLICE_W : 1;
}

template <typename T, int HD, int ROWS>
cudaError_t launch_hd(bool wide, const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int Sc, int H, int KH, int d, int cache_len, int offset,
                      int window, const int* sp, float scale, cudaStream_t s) {
  const int planes = planes_of(ROWS, d);
  const int split =
      decode_split(B * H * planes, most_positions(Sc, window, sp[0], sp[1], sp[2], sp[3]),
                   sm_count(), Shape<T, HD, ROWS>::MINB);
  if constexpr (ROWS == CHUNK_ROWS) {
    if (wide)
      return launch<T, HD, true, ROWS>(split, planes, q, k, v, o, lse, B, Sc, H, KH, d,
                                       cache_len, offset, window, sp, scale, s);
  }
  return launch<T, HD, false, ROWS>(split, planes, q, k, v, o, lse, B, Sc, H, KH, d, cache_len,
                                    offset, window, sp, scale, s);
}

// The compiled head widths (lane layouts): 32, 64, 128, 256 for whole
// chunks and ELEM_ROWS, 256 SLICED_ROWS.
template <typename T>
cudaError_t dispatch(int HD, int rows, const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Sc, int H, int KH, int d, int cache_len, int offset,
                     int window, const int* sp, float scale, cudaStream_t s) {
  const bool wide = aligned16(k) && aligned16(v);
  if (rows == SLICED_ROWS)
    return HD == SLICE_W ? launch_hd<T, SLICE_W, SLICED_ROWS>(false, q, k, v, o, lse, B, Sc, H,
                                                              KH, d, cache_len, offset, window,
                                                              sp, scale, s)
                         : cudaErrorInvalidValue;
  switch (HD) {
#define REPRO_HD(w)                                                                         \
  case w:                                                                                   \
    return rows == ELEM_ROWS                                                                \
               ? launch_hd<T, w, ELEM_ROWS>(wide, q, k, v, o, lse, B, Sc, H, KH, d,         \
                                            cache_len, offset, window, sp, scale, s)        \
               : launch_hd<T, w, CHUNK_ROWS>(wide, q, k, v, o, lse, B, Sc, H, KH, d,        \
                                             cache_len, offset, window, sp, scale, s);
    REPRO_HD(32) REPRO_HD(64) REPRO_HD(128) REPRO_HD(256)
#undef REPRO_HD
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  q/o (B,1,H,d), caches (B,Sc,KH,d), contiguous,
// run at the compiled head width HD on the ``rows`` path: 0, HD ≥ d, d a
// whole number of 16-byte chunks; 1, HD ≥ d ≥ 1; 2, HD 256, any d ≥ 1,
// sliced (the note above); slot i holds position offset + i (offset ≥ 0,
// a multiple of block when block > 0: a segment of a sequence-split
// cache); positions < cache_len are valid.  block > 0 adds the sparse mask of
// (block, sink, local, stride); block = 0 is dense.  lse, when not null,
// (B,H) f32, gets m + log l of the scaled logits over the positions read
// (-inf when none is).  Returns the first error of the launch, else
// cudaGetLastError() after it.
extern "C" int decode_attn(int dtype, const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int Sc, int H, int KH, int HD, int rows,
                           int d, int cache_len, int offset, int window, int block, int sink,
                           int local, int stride, float scale, void* stream) {
  const int vec = dtype == 0 ? 4 : 8;  // elements a 16-byte chunk
  const bool fits = rows == CHUNK_ROWS    ? d >= vec && d <= HD && d % vec == 0
                    : rows == ELEM_ROWS   ? d >= 1 && d <= HD
                    : rows == SLICED_ROWS ? d >= 1 && HD == SLICE_W
                                          : false;
  if (B < 1 || Sc < 1 || KH < 1 || H % KH != 0 || offset < 0 || cache_len - offset < 1 ||
      !fits || (block > 0 && (stride < 1 || offset % block != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sp[4] = {block, sink, local, stride};
  cudaError_t e;
  if (dtype == 0) {
    e = dispatch<float>(HD, rows, q, k, v, o, static_cast<float*>(lse), B, Sc, H, KH, d,
                        cache_len, offset, window, sp, scale, s);
  } else if (dtype == 1) {
    e = dispatch<__nv_bfloat16>(HD, rows, q, k, v, o, static_cast<float*>(lse), B, Sc, H, KH,
                                d, cache_len, offset, window, sp, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The cluster size (split) the rule takes on the current device for a call
// over this cache and pattern at compiled head width HD on the ``rows``
// path with ``planes`` column planes; it does not depend on cache_len.
extern "C" int decode_attn_plan(int HD, int rows, int planes, int B, int Sc, int H, int window,
                                int block, int sink, int local, int stride, int* split) {
  if (B < 1 || Sc < 1 || H < 1 || HD < 1 || planes < 1 || (block > 0 && stride < 1))
    return (int)cudaErrorInvalidValue;
  *split = decode_split(B * H * planes, most_positions(Sc, window, block, sink, local, stride),
                        sm_count(), min_blocks(HD, rows));
  return 0;
}
