// The q-tile step shared by the prefill attention kernels (flash_attn.cu,
// block_sparse_attn.cu): one CUDA block folds a sequence of kv tiles into
// the online softmax of BQ query rows — running max m (starting at
// NEG_INF), denominator l and accumulator acc, all f32, exact IEEE FMA (no
// TF32, no tensor cores) — and writes acc / max(l, 1e-30).  The kernel
// supplies the walk: which kv tiles, in what order, and which keys a query
// row may see.
//
// What held the step it replaces: four threads shared a query row, each
// held a quarter of q and acc, and every FMA of q·k and of p·v read its
// operand from shared memory one float at a time (one load per FMA) and met
// the partial dots by shuffles; the load pipe, not the FMA pipes, set the
// pace at about a quarter of the f32 peak.  The step here is register-tiled:
// - Q is staged once per block, scaled by d^-1/2, transposed (d-major
//   Qᵀ[HD][BQ + 4]), so one 16-byte load gives a thread 4 query rows.
// - K and V are staged key-major ([BKV][HD + 4]; cp.async cannot transpose,
//   and a 16-byte load of K along d serves 4 of a key's dims, so K read this
//   way costs the same loads per FMA as Kᵀ would).  The row stride HD + 4
//   puts the 8 keys a quarter-warp reads on distinct banks.  f32 tiles with
//   16-byte aligned operands go through 16-byte cp.async copies, double-
//   buffered, so kv tile t + 1 loads while tile t is computed; rows past the
//   tile's end are zero-filled (src-size 0, given the tensor's base
//   address).  bf16 tiles, and f32 ones that are not 16-byte aligned, load
//   through registers (f32 on the way in) before the tile is computed.
//   Each thread's copy addresses are fixed outside the kv loop but for the
//   tile's first position.
// - S = Q·Kᵀ: thread (ty, tx) of the BQ/4 × 16 grid holds rows 4·ty .. +3 and
//   keys tx + 16·j (j < BKV/16) in registers: per 4 dims, 4 + BKV/16 vector
//   loads for 16·BKV/16 · 4 FMAs (hd 64, BKV 64: 8 loads for 64 FMAs).
// - Softmax once per kv tile: a row's max meets across the 16 threads that
//   share it by 4 xor shuffles; l is kept per thread and met once at the
//   end; acc is rescaled once a tile.  The mask is evaluated only in tiles
//   the walk says cross an edge (the causal diagonal, a window's left edge,
//   the end of the kv range); a masked key gets s = -inf, so p = 0 exactly
//   and a tile with no allowed key for a row leaves (m, l, acc) unchanged.
// - O += P·V: P goes to shared memory key-major (Pᵀ[BKV][BQ + 4]); the thread
//   owns the same 4 rows of O and dims VW·tx + 16·VW·c (VW = 4, or 2 at hd
//   32): per key one P load and HD/64 (hd 32: one) V loads for 4·HD/16 FMAs.
// Shared memory: Qᵀ, two K and two V stages and Pᵀ, in f32 (dynamic; the
// kernels set its limit once per instance): 102 KB at hd 64 with 64-row q
// and kv tiles (two blocks an SM), 48 KB with 32-row ones (four).  Measured
// on an H100 80GB HBM3 at 700 W: the block-sparse kernel at its serving
// prefill runs 28 TFLOP/s of needed work, 42% of the f32 FMA peak (2.7× the
// step it replaced); times in the notes of the two kernels.
//
// q and k may be wider than v and o (MLA: q/k nope + rope, v its own width):
// DK is the width of Qᵀ, the K stages and the q·k dots, DV that of the V
// stages, P·V and the O registers; the square heads have DK = DV.  A copy of
// a DK- or DV-wide tile hands each thread 16-byte chunks c = tid + T·l (row
// c / (D/4), dims 4·(c mod D/4)), so a width need not divide the thread
// count (192/4 = 48 chunks a row against 128 threads).  At (192, 128) the
// tile holds Qᵀ 192 wide, K stages 196 floats a row and V stages 132: 116 KB
// with 32-row q and kv tiles, 145 KB with 64-row q tiles, one block an SM
// either way, so those instances are held to one block an SM (255
// registers a thread).
//
// The compiled widths (DK, DV) are tile widths, not row widths: a call
// passes its rows' own (dk, dv) ≤ (DK, DV) at run time.  Operands are read
// at their true row stride; the tile's dims from dk up to DK of Qᵀ and K,
// and from dv up to DV of V, are zero-filled (cp.async with src-size 0, or
// a zero register), so a pad dim adds an exact zero to every q·k dot and
// its O column is never stored: heads of 16 run in the (32, 32) tile, MLA's
// (80, 64) in (96, 64).  Rows that are not whole 16-byte chunks (f32 heads
// of 18: rows 72 bytes apart; bf16 rows of odd width) run ELEM, the register
// path with a bound per element (zeros past the row) and O stored element
// by element, in the square tiles and with the 32-row q tile.  The register
// rule is one for every instance: the 128 registers that 512 threads an SM
// allow, or, where shared memory holds fewer blocks than that, as many
// registers as those blocks leave.
//
// Rows past 256: one head split over a thread block cluster.  The widest
// one-block tile, (256, 256), holds 174,592 B with 32-row q and kv tiles
// (one block an SM, 64 O floats and 164–232 registers a thread).  Past 256
// the earlier path cut v into 256-column grid planes, each recomputing the
// same S, and restaged Qᵀ every kv tile (0.102 ms at heads of 512, B 2,
// S 128, H 4 causal, against SDPA's 0.042; H100 80GB HBM3 at 700 W).  Here a
// (batch·head, q tile) gets a cluster of n ranks along grid x (grid
// (B·H·n, q tiles)), each a block of the narrow (RANK_W, RANK_W) = (128,
// 128) tile.
// - Rank r owns q/k dims [r·kper·128, (r + 1)·kper·128) and v/o columns
//   [r·vper·128, (r + 1)·vper·128), clipped to the rows; n is what the
//   wider side needs, kper = vper = 1 up to SPLIT_MAX = 16 ranks (2048
//   wide); past that every rank loops over kper (vper) slices (LOOP).  A
//   rank may own no v columns ((528, 512): rank 4 holds dims 512–527) or no
//   q/k dims: its zero-filled tile adds exact zeros.
// - Each kv tile: the rank computes its partial S (4 rows × KPT keys a
//   thread, f32) over its dims, writes it to its own shared memory (thread
//   t's floats contiguous) and arrives at the cluster barrier; after the
//   barrier's wait every rank reads the n partials through distributed
//   shared memory (cluster.map_shared_rank) and adds them in rank order
//   from zero: every rank holds the same S bit for bit, hence the same
//   masks, m, l and P, and multiplies P by its own V columns.  Nothing is
//   recomputed; Q and K are read once a (q tile, kv tile) across the
//   cluster; Qᵀ is staged once a rank (per slice under LOOP with kper > 1).
// - One cluster barrier a kv tile, pipelined: the arrival for tile t + 1
//   follows its partial dots, and the wait comes after the next tile's
//   dots, so the barrier and the other ranks' stores land behind a tile of
//   FMAs.  The partial-S buffer is double-buffered for that: a rank writes
//   buffer b again two tiles later, after the wait of the tile between,
//   which no rank passes before every rank has read buffer b.  K runs one
//   tile ahead of V in the two-stage ring (iteration t copies K(t + 2) and
//   V(t + 1)), so the ring holds no more stages than the one-block loop's.
//   A last barrier keeps every rank's shared memory alive until the others
//   have read it.
// - Reads by row kind: whole 16-byte chunks through the cp.async ring
//   (f32, 16-byte aligned operands) or 4-element register copies, other
//   rows element by element (ELEM); LOOP reads element by element without
//   the pipeline, its accumulators past one v slice in an f32 workspace of
//   o's layout (thread-owned, no barrier).  It copies into the first K and
//   V stages only, yet keeps the tile's two: their shared memory holds the
//   instance to two blocks an SM, which leaves its registers room (at three
//   it spilled).
// - The split instance keeps the 32-row q tile (kv tiles of 32): with the
//   two partial-S buffers it is 98,816 B, two blocks an SM.
// - The (256, 256) and (192, 128) tiles (gemma3's 240, MLA's (192, 128))
//   hold one block an SM too, but keep it: at SERVE's shapes their split
//   loses.  Measured (tools/attn_split_sweep.py, the split forced through
//   the C entry points' rows-past-256 path; H100 80GB HBM3 at 700 W, f32,
//   causal, cold L2, median of 30; ms): SERVE-GEMMA3's global layer (B 2,
//   S 1152, H 16, K 8, heads of 240) one block 0.7537, split 0.8465, ranks
//   of 64 q rows 1.0161, the split without its exchange (each rank its own
//   partial S and no barrier in the loop: a wrong S, timed for its cost)
//   0.8758; SERVE-MLA's prefill (B 4, S 256, H 128; a rank of 128 dims and
//   one of 64 with no v columns) 0.5628, 0.8614, 1.1056, 0.8854; heads of
//   512 at B 2, S 1024, H 4 (split, 64-row ranks, no exchange) 0.4025,
//   0.5142, 0.3771.  A (128, 128) rank at heads of 240 loses to the (256,
//   256) block before any exchange: it does the softmax, masks, Pᵀ and
//   copies of a tile for half the FMAs, both paced by shared-memory loads
//   (one 16-byte load per four FMAs in S); at MLA's widths the first rank
//   holds two thirds of q·k and all of P·V and sets the pace, exchange or
//   none.  Past 256 the exchange costs 7 % and the split removes all
//   recomputation.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace repro {

// kv rows per tile: 64 with the 64-row q tile at q/k widths below 96; 32 at
// wider ones (Qᵀ, two K/V stages and Pᵀ then fit two blocks an SM at hd 128)
// and with the 32-row q tile (four blocks an SM at hd 64).
constexpr int kv_tile_rows(int DK, int BQ) { return DK >= 96 || BQ == 32 ? 32 : 64; }

constexpr int SM_SMEM = 233472;   // shared memory an H100 SM holds (228 KB)

// How a q tile reads its rows (the note above); LOOP: a split rank that
// loops over more than one slice.
constexpr int ASYNC = 0, CHUNK = 1, ELEM = 2, LOOP = 3;
constexpr int SLICE_W = 256;      // the widest one-block tile
constexpr int SPLIT_MAX = 16;     // largest cluster on Hopper (non-portable above 8)
constexpr int SPLIT_BQ = 32;      // the split instance's q tile
constexpr int RANK_W = 128;       // a split rank's tile: (RANK_W, RANK_W)

// The (q/k, v) tile widths both prefill kernels compile, X(DK, DV) each:
// the square heads and MLA's (kernels/flash_attn/ops.py WIDTHS, the same
// list, picks one for a call's row widths).
#define REPRO_ATTN_WIDTHS(X) \
  X(32, 32) X(64, 64) X(128, 128) X(256, 256) X(96, 64) X(192, 128)

// The square tiles, the only ones ELEM rows run in.
#define REPRO_ATTN_SQUARE(X) X(32, 32) X(64, 64) X(128, 128) X(256, 256)

// Row widths (dk, dv) the (DK, DV) tile runs on the C entry points' ``rows``
// path: 0, whole 4-element chunks, at least one, at most the tile's; 1,
// any width at most a square tile's; 2, any width, split from (256, 256).
inline bool row_widths_fit(int rows, int dk, int dv, int DK, int DV) {
  if (dk < 1 || dv < 1) return false;
  if (rows == 0) return dk <= DK && dv <= DV && dk % 4 == 0 && dv % 4 == 0;
  if (rows == 1) return dk <= DK && dv <= DV && DK == DV;
  return rows == 2 && DK == SLICE_W && DV == SLICE_W;
}

// The split of rows (dk, dv) over ranks of RANK_W: the ranks, and the
// slices of RANK_W dims (columns) a rank loops over (1 up to SPLIT_MAX
// ranks).
struct SplitPlan {
  int ranks, kper, vper;
};
inline SplitPlan split_plan(int dk, int dv) {
  const int sk = (dk + RANK_W - 1) / RANK_W, sv = (dv + RANK_W - 1) / RANK_W;
  if (sk <= SPLIT_MAX && sv <= SPLIT_MAX) return {sk > sv ? sk : sv, 1, 1};
  const int kper = (sk + SPLIT_MAX - 1) / SPLIT_MAX, vper = (sv + SPLIT_MAX - 1) / SPLIT_MAX;
  const int nk = (sk + kper - 1) / kper, nv = (sv + vper - 1) / vper;
  return {nk > nv ? nk : nv, kper, vper};
}

// Tile geometry of one (DK, DV, BQ, BKV) instance: two K and two V stages
// (and, SPLIT, the two partial-S buffers); 4·BQ threads.
template <int DK, int DV, int BQ, int BKV, bool SPLIT = false> struct AttnTile {
  static constexpr int THREADS = 4 * BQ;
  static constexpr int QS = BQ + 4;       // row stride of Qᵀ and Pᵀ (floats)
  static constexpr int KS = DK + 4;       // row stride of the K stages
  static constexpr int VS = DV + 4;       // row stride of the V stages
  static constexpr int KPT = BKV / 16;    // keys per thread in S
  static constexpr int VW = DV >= 64 ? 4 : 2, NC = DV / (16 * VW);  // O dims per thread: NC groups of VW
  static constexpr int Q_ELEMS = DK * QS, K_ELEMS = BKV * KS, V_ELEMS = BKV * VS,
                       P_ELEMS = BKV * QS, S_ELEMS = SPLIT ? BQ * BKV : 0;
  static constexpr int BYTES =
      4 * (Q_ELEMS + 2 * K_ELEMS + 2 * V_ELEMS + P_ELEMS + 2 * S_ELEMS);
  // copies: 16-byte chunks, CK (CV) a row of q/k (v); QL, KL, VL chunks a thread
  static constexpr int CK = DK / 4, CV = DV / 4;
  static constexpr int QL = BQ * CK / THREADS, KL = BKV * CK / THREADS, VL = BKV * CV / THREADS;
  static constexpr int SMEM_BLOCKS = SM_SMEM / (BYTES + 1024);
  static constexpr int MIN_BLOCKS =   // 128 registers a thread, or what shared memory allows
      SMEM_BLOCKS >= 512 / THREADS ? 512 / THREADS : (SMEM_BLOCKS > 0 ? SMEM_BLOCKS : 1);
  static_assert(DK % 32 == 0 && DV % 32 == 0 && BQ % 32 == 0 && BKV % 16 == 0, "tile shape");
  static_assert(DV % (16 * VW) == 0, "O dims per thread");
  static_assert((BQ * CK) % THREADS == 0 && (BKV * CK) % THREADS == 0 &&
                (BKV * CV) % THREADS == 0, "copy layout");
};

// Row and first dim of the 16-byte chunk c = tid + T·l of a tile C chunks
// wide; where T is a multiple of C every pass keeps the thread's dims.
template <int T, int C> struct Chunk {
  int row, col;
  __device__ __forceinline__ Chunk(int tid, int l) {
    if constexpr (T % C == 0) {
      row = tid / C + (T / C) * l, col = (tid % C) * 4;
    } else {
      const int c = tid + T * l;
      row = c / C, col = (c % C) * 4;
    }
  }
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four consecutive elements as f32: one 16-byte load when VEC (f32, 16-byte
// aligned), else four element loads.
template <bool VEC, typename T> __device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (VEC) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
  }
}

// The first n (the rest zero) of four consecutive elements as f32, element
// loads.
template <typename T> __device__ __forceinline__ float4 load4_upto(const T* p, int n) {
  return make_float4(n > 0 ? to_f32(p[0]) : 0.f, n > 1 ? to_f32(p[1]) : 0.f,
                     n > 2 ? to_f32(p[2]) : 0.f, n > 3 ? to_f32(p[3]) : 0.f);
}

// Where one operand's rows lie: row r of the tile at base + r·stride.
struct Rows {
  size_t base, stride;
};

// Register copies of a tile (the path without cp.async): chunks l < N of
// rows [j0, hi) of a C-chunk-wide tile, dims < w read (f32 on the way in),
// the rest zero (TAIL: a bound per element, any w; else w a multiple of
// 4); then their store to shared memory at row stride S.
template <int N, int TH, int C, bool TAIL = false, typename T>
__device__ __forceinline__ void fetch(float4 (&r)[N], const T* p, Rows rl, int j0, int hi,
                                      int w, int tid) {
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const Chunk<TH, C> c(tid, l);
    const T* src = p + rl.base + (size_t)(j0 + c.row) * rl.stride + c.col;
    if constexpr (TAIL) {
      r[l] = j0 + c.row < hi && c.col < w ? load4_upto(src, w - c.col)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      r[l] = j0 + c.row < hi && c.col < w ? load4<false>(src)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}
template <int N, int TH, int C>
__device__ __forceinline__ void put(float* s, int S, const float4 (&r)[N], int tid) {
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const Chunk<TH, C> c(tid, l);
    *reinterpret_cast<float4*>(s + c.row * S + c.col) = r[l];
  }
}

// A split rank's run-time arguments: its cluster's size, the slices of its
// tile it loops over (LOOP) and, where it owns more than one v slice, the
// f32 workspace of its accumulators (o's layout).
struct Rank {
  int ranks = 1, kper = 1, vper = 1;
  float* work = nullptr;
};

// The q tile: rows [0, rows) of q at ql (key position qpos0 + r) and of o
// at ol; kv row j of k at kl and of v at vl; rows of q and k dk wide from
// the block's first dim, of v and o dv wide from its first column (the
// tile takes DK and DV of them; multiples of 4 but under ELEM and LOOP;
// zero or less: a split rank that owns none).  PATH: ASYNC (T is float and
// every operand is 16-byte aligned), CHUNK, ELEM or LOOP (the note above).
// SPLIT: one rank of a cluster of rk.ranks (the note above).  Walk
// (block-uniform, the same for every rank): next(j0, hi) yields the kv
// tiles [j0, min(j0 + BKV, hi)) in order; need_mask(j0, hi) says whether a
// tile crosses an edge; allowed(qpos, kpos) is the test inside such a tile
// (kpos < hi is tested here).  Every thread of the block calls it.
template <typename T, int DK, int DV, int BQ, int BKV, int PATH, bool SPLIT, typename Walk>
__device__ __forceinline__ void attend_q_tile(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, Rows ql, Rows ol, int rows, Rows kl, Rows vl, int dk, int dv,
    int qpos0, float scale, Walk& walk, float* smem, Rank rk = {}) {
  using L = AttnTile<DK, DV, BQ, BKV, SPLIT>;
  constexpr bool VEC = PATH == ASYNC, TAIL = PATH >= ELEM, LP = PATH == LOOP;
  static_assert(SPLIT || !LP, "LOOP is a split path");
  constexpr int QS = L::QS, KS = L::KS, VS = L::VS, KPT = L::KPT, VW = L::VW, NC = L::NC;
  constexpr int TH = L::THREADS;
  float* qt = smem;                            // Qᵀ [DK][QS]
  float* kst = qt + L::Q_ELEMS;                // K stages [2][BKV][KS]
  float* vst = kst + 2 * L::K_ELEMS;           // V stages [2][BKV][VS]
  float* pt = vst + 2 * L::V_ELEMS;            // Pᵀ [BKV][QS]
  float* sx = pt + L::P_ELEMS;                 // SPLIT: partial S [2][TH][4·KPT]

  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = lane & 15, ty = 2 * (tid >> 5) + (lane >> 4);

  // Q's dims [d0, d0 + DK), scaled, transposed; rows past `rows` and dims
  // past dk are zero
  auto load_q = [&](int d0) {
#pragma unroll
    for (int l = 0; l < L::QL; ++l) {
      const Chunk<TH, L::CK> c(tid, l);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c.row < rows && c.col < dk - d0) {
        const T* src = q + ql.base + (size_t)c.row * ql.stride + d0 + c.col;
        if constexpr (TAIL) x = load4_upto(src, dk - d0 - c.col);
        else x = load4<VEC>(src);
      }
      qt[(c.col + 0) * QS + c.row] = x.x * scale;
      qt[(c.col + 1) * QS + c.row] = x.y * scale;
      qt[(c.col + 2) * QS + c.row] = x.z * scale;
      qt[(c.col + 3) * QS + c.row] = x.w * scale;
    }
  };
  if constexpr (!LP) load_q(0);

  // K/V copies of the tile [j0, hi) into stage st; dims past dk (dv) zero
  auto stage = [&](int st, int j0, int hi) {
    float* ks = kst + st * L::K_ELEMS;
    float* vs = vst + st * L::V_ELEMS;
    if constexpr (VEC) {
#pragma unroll
      for (int l = 0; l < L::KL; ++l) {
        const Chunk<TH, L::CK> c(tid, l);
        const bool ok = j0 + c.row < hi && c.col < dk;
        const T* src = k + kl.base + (size_t)(j0 + c.row) * kl.stride + c.col;
        cp_async16(ks + c.row * KS + c.col, ok ? (const void*)src : (const void*)k, ok);
      }
#pragma unroll
      for (int l = 0; l < L::VL; ++l) {
        const Chunk<TH, L::CV> c(tid, l);
        const bool ok = j0 + c.row < hi && c.col < dv;
        const T* src = v + vl.base + (size_t)(j0 + c.row) * vl.stride + c.col;
        cp_async16(vs + c.row * VS + c.col, ok ? (const void*)src : (const void*)v, ok);
      }
      cp_async_commit();
    } else if constexpr (L::KL + L::VL <= 24) {
      // K's and V's loads in flight together
      float4 kr[L::KL], vr[L::VL];
      fetch<L::KL, TH, L::CK, TAIL>(kr, k, kl, j0, hi, dk, tid);
      fetch<L::VL, TH, L::CV, TAIL>(vr, v, vl, j0, hi, dv, tid);
      put<L::KL, TH, L::CK>(ks, KS, kr, tid);
      put<L::VL, TH, L::CV>(vs, VS, vr, tid);
    } else {
      // the (256, 256) tile's 32 chunks a thread: K, then V, so that 64 and
      // not 128 registers hold a copy beside the 64 O floats
      {
        float4 kr[L::KL];
        fetch<L::KL, TH, L::CK, TAIL>(kr, k, kl, j0, hi, dk, tid);
        put<L::KL, TH, L::CK>(ks, KS, kr, tid);
      }
      float4 vr[L::VL];
      fetch<L::VL, TH, L::CV, TAIL>(vr, v, vl, j0, hi, dv, tid);
      put<L::VL, TH, L::CV>(vs, VS, vr, tid);
    }
  };

  // The split loop's copies: K's (V's) of the tile [j0, hi) into stage
  // st; under VEC cp.async, committed by the caller
  auto stage_k = [&](int st, int j0, int hi) {
    float* ks = kst + st * L::K_ELEMS;
    if constexpr (VEC) {
#pragma unroll
      for (int l = 0; l < L::KL; ++l) {
        const Chunk<TH, L::CK> c(tid, l);
        const bool ok = j0 + c.row < hi && c.col < dk;
        const T* src = k + kl.base + (size_t)(j0 + c.row) * kl.stride + c.col;
        cp_async16(ks + c.row * KS + c.col, ok ? (const void*)src : (const void*)k, ok);
      }
    } else {
      float4 r[L::KL];
      fetch<L::KL, TH, L::CK, TAIL>(r, k, kl, j0, hi, dk, tid);
      put<L::KL, TH, L::CK>(ks, KS, r, tid);
    }
  };
  auto stage_v = [&](int st, int j0, int hi) {
    float* vs = vst + st * L::V_ELEMS;
    if constexpr (VEC) {
#pragma unroll
      for (int l = 0; l < L::VL; ++l) {
        const Chunk<TH, L::CV> c(tid, l);
        const bool ok = j0 + c.row < hi && c.col < dv;
        const T* src = v + vl.base + (size_t)(j0 + c.row) * vl.stride + c.col;
        cp_async16(vs + c.row * VS + c.col, ok ? (const void*)src : (const void*)v, ok);
      }
    } else {
      float4 r[L::VL];
      fetch<L::VL, TH, L::CV, TAIL>(r, v, vl, j0, hi, dv, tid);
      put<L::VL, TH, L::CV>(vs, VS, r, tid);
    }
  };

  // S += Qᵀ·K over the DK dims staged
  auto dots = [&](float (&s)[4][KPT], const float* ks) {
#pragma unroll
    for (int d = 0; d < DK; d += 4) {
      float qv[4][4];  // [dim][row]
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(qt + (d + u) * QS + 4 * ty);
        qv[u][0] = x.x, qv[u][1] = x.y, qv[u][2] = x.z, qv[u][3] = x.w;
      }
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * KS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = s[i][j];
          a = fmaf(qv[0][i], kv.x, a);
          a = fmaf(qv[1][i], kv.y, a);
          a = fmaf(qv[2][i], kv.z, a);
          a = fmaf(qv[3][i], kv.w, a);
          s[i][j] = a;
        }
      }
    }
  };

  // SPLIT: the partial S into buffer b and this rank's arrival at the
  // cluster barrier (post); after the barrier, S = the ranks' partials in
  // buffer b added in rank order from zero, the same bits in every rank
  // (sum).  Thread t's 4·KPT floats lie contiguous, at the same place in
  // every rank (every rank's thread t holds the same rows and keys).
  auto post = [&](const float (&s)[4][KPT], int b) {
    float4* w = reinterpret_cast<float4*>(sx + b * L::S_ELEMS + tid * 4 * KPT);
#pragma unroll
    for (int f = 0; f < 4 * KPT; f += 4)
      w[f / 4] = make_float4(s[f / KPT][f % KPT], s[(f + 1) / KPT][(f + 1) % KPT],
                             s[(f + 2) / KPT][(f + 2) % KPT], s[(f + 3) / KPT][(f + 3) % KPT]);
    asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  };
  auto sum = [&](float (&s)[4][KPT], int b) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
    float* mine = sx + b * L::S_ELEMS + tid * 4 * KPT;
#pragma unroll 4
    for (int r = 0; r < rk.ranks; ++r) {
      const float4* p = reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, r));
#pragma unroll
      for (int f = 0; f < 4 * KPT; f += 4) {
        const float4 x = p[f / 4];
        s[f / KPT][f % KPT] += x.x;
        s[(f + 1) / KPT][(f + 1) % KPT] += x.y;
        s[(f + 2) / KPT][(f + 2) % KPT] += x.z;
        s[(f + 3) / KPT][(f + 3) % KPT] += x.w;
      }
    }
  };

  float acc[4][NC * VW], m[4], lsum[4], corr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    lsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * VW; ++c) acc[i][c] = 0.f;
  }

  // O += P·V over the staged V columns, P from Pᵀ
  auto pv = [&](const float* vs) {
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + kk * QS + 4 * ty);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float* vp = vs + kk * VS + VW * tx + 16 * VW * c;
        float vv[VW];
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vp);
          vv[0] = x.x, vv[1] = x.y, vv[2] = x.z, vv[3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vp);
          vv[0] = x.x, vv[1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < VW; ++u) acc[i][c * VW + u] = fmaf(p[i], vv[u], acc[i][c * VW + u]);
      }
    }
  };

  // the masks and the online softmax of tile [j0, hi): s becomes P, m, l
  // and acc are rescaled (corr the factor)
  auto softmax = [&](float (&s)[4][KPT], int j0, int hi) {
    if (walk.need_mask(j0, hi)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int kp = j0 + tx + 16 * j;
          if (!(kp < hi && walk.allowed(qpos0 + 4 * ty + i, kp))) s[i][j] = __int_as_float(0xff800000);  // -inf
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KPT; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        ps += s[i][j];
      }
      lsum[i] = lsum[i] * corr[i] + ps;
#pragma unroll
      for (int c = 0; c < NC * VW; ++c) acc[i][c] *= corr[i];
    }
  };
  auto put_p = [&](const float (&s)[4][KPT]) {
#pragma unroll
    for (int j = 0; j < KPT; ++j)
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * QS + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
  };

  // LOOP with more than one v slice: the column (from the rank's first) of
  // the thread's accumulator c of the v slice at c0, or -1 past the rows;
  // it sits in the workspace at o's place
  auto work_col = [&](int i, int c0, int c) {
    const int col = c0 + VW * tx + 16 * VW * (c / VW) + c % VW;
    return 4 * ty + i < rows && col < dv ? col : -1;
  };
  auto work_row = [&](int i) { return rk.work + ol.base + (size_t)(4 * ty + i) * ol.stride; };

  if constexpr (SPLIT && !LP) {
    // The split loop, pipelined by one tile: iteration t waits for tile
    // t's barrier only after tile t + 1's partial dots (the barrier's
    // arrivals and the other ranks' partials land meanwhile).  K runs a
    // tile ahead of V in the two-stage ring: iteration t copies K(t + 2)
    // into the stage dots(t) left and V(t + 1) into the one PV(t - 1) left.
    // One cluster barrier a tile, its arrival (post) and wait (sum) apart;
    // post(t + 1) writes the buffer of tile t - 1, which every rank has read
    // before its arrival for tile t, and sum(t) has seen all of those.
    int j[3], h[3];
    bool on[3];
    on[0] = walk.next(j[0], h[0]);
    on[1] = on[0] && walk.next(j[1], h[1]);
    if (on[0]) {
      stage_k(0, j[0], h[0]);
      stage_v(0, j[0], h[0]);
      if (on[1]) stage_k(1, j[1], h[1]);
      if constexpr (VEC) cp_async_commit();
      float s[4][KPT] = {};
      if constexpr (VEC) cp_async_wait_all();
      __syncthreads();
      if (dk > 0) dots(s, kst);
      post(s, 0);
    }
    for (int t = 0; on[0]; ++t) {
      const int b = t & 1;
      on[2] = on[1] && walk.next(j[2], h[2]);
      if constexpr (VEC) cp_async_wait_all();
      // K(t + 1) and V(t) have landed; every thread is done with dots(t)
      // and PV(t - 1) (their stages and Pᵀ)
      __syncthreads();
      if (on[2]) stage_k(b, j[2], h[2]);
      if (on[1]) stage_v(b ^ 1, j[1], h[1]);
      if constexpr (VEC) cp_async_commit();
      float sn[4][KPT] = {};
      if (on[1] && dk > 0) dots(sn, kst + (b ^ 1) * L::K_ELEMS);
      float s[4][KPT];
      sum(s, b);
      softmax(s, j[0], h[0]);
      if (dv > 0) {  // a rank with no v columns stops at S
        put_p(s);
        __syncthreads();
        pv(vst + b * L::V_ELEMS);
      }
      if (on[1]) post(sn, b ^ 1);
      j[0] = j[1], h[0] = h[1], on[0] = on[1];
      j[1] = j[2], h[1] = h[2], on[1] = on[2];
    }
  } else {
    int j0, hi, st = 0, tl = 0;
    bool have = walk.next(j0, hi), first = true;
    if (VEC && have) stage(0, j0, hi);
    while (have) {
      float s[4][KPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
      int nj0 = 0, nhi = 0;
      bool have_next;
      const float* ks = kst + st * L::K_ELEMS;
      const float* vs = vst + st * L::V_ELEMS;
      if constexpr (LP) {
        // the rank's q/k slices in turn through Qᵀ and the one K stage;
        // every thread is done with the last slice's (or tile's) Qᵀ and K
        // first
        const int kend = dk < rk.kper * DK ? dk : rk.kper * DK;
        for (int d0 = 0; d0 < kend; d0 += DK) {
          __syncthreads();
          if (first || rk.kper > 1) load_q(d0);
          float4 kr[L::KL];
          fetch<L::KL, TH, L::CK, true>(kr, k + d0, kl, j0, hi, dk - d0, tid);
          put<L::KL, TH, L::CK>(kst, KS, kr, tid);
          __syncthreads();
          dots(s, kst);
        }
        have_next = walk.next(nj0, nhi);
        post(s, tl & 1);  // one barrier a tile, as in the split loop above
        sum(s, tl & 1);
      } else {
        if constexpr (VEC) cp_async_wait_all();
        else stage(st, j0, hi);
        // tile t is in stage st; every thread is done with tile t - 1 (its
        // stage and Pᵀ)
        __syncthreads();
        have_next = walk.next(nj0, nhi);
        if (VEC && have_next) stage(st ^ 1, nj0, nhi);
        dots(s, ks);
      }
      softmax(s, j0, hi);
      if (!LP || dv > 0) {  // a split rank with no v columns stops at S
        put_p(s);
        if constexpr (LP) {
          // the rank's v slices in turn through the one V stage
          const int vend = dv < rk.vper * DV ? dv : rk.vper * DV;
          for (int c0 = 0; c0 < vend; c0 += DV) {
            __syncthreads();  // Pᵀ written; every thread done with the last V slice
            float4 vr[L::VL];
            fetch<L::VL, TH, L::CV, true>(vr, v + c0, vl, j0, hi, dv - c0, tid);
            put<L::VL, TH, L::CV>(vst, VS, vr, tid);
            __syncthreads();
            if (rk.vper > 1) {
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < NC * VW; ++c) {
                  const int col = work_col(i, c0, c);
                  acc[i][c] = first || col < 0 ? 0.f : work_row(i)[col] * corr[i];
                }
            }
            pv(vst);
            if (rk.vper > 1) {
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < NC * VW; ++c) {
                  const int col = work_col(i, c0, c);
                  if (col >= 0) work_row(i)[col] = acc[i][c];
                }
            }
          }
        } else {
          __syncthreads();
          pv(vs);
        }
      }
      if constexpr (!LP) st ^= 1;
      first = false;
      ++tl;
      j0 = nj0, hi = nhi, have = have_next;
    }
  }
  if constexpr (SPLIT) asm volatile("barrier.cluster.arrive;\n" ::: "memory");

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = lsum[i];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + ol.base + (size_t)r * ol.stride;
    if (LP && rk.vper > 1) {
      const int vend = dv < rk.vper * DV ? dv : rk.vper * DV;
      for (int c0 = 0; c0 < vend; c0 += DV)
#pragma unroll
        for (int c = 0; c < NC * VW; ++c) {
          const int col = work_col(i, c0, c);
          if (col >= 0) orow[col] = from_f32<T>(work_row(i)[col] / den);
        }
      continue;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = VW * tx + 16 * VW * c;
      if (d >= dv) continue;  // the tile's pad dims (or a rank's none)
      if constexpr (VEC && VW == 4) {
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[i][4 * c] / den, acc[i][4 * c + 1] / den,
                        acc[i][4 * c + 2] / den, acc[i][4 * c + 3] / den);
      } else if constexpr (VEC) {
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(acc[i][2 * c] / den, acc[i][2 * c + 1] / den);
      } else {
#pragma unroll
        for (int u = 0; u < VW; ++u)
          if (!TAIL || d + u < dv) orow[d + u] = from_f32<T>(acc[i][c * VW + u] / den);
      }
    }
  }
  if constexpr (SPLIT) asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// SMs of the current device, for the kernels' q-tile rule.
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether rows (dk, dv) of T are whole 16-byte chunks (ops.py's ``aligned``).
template <typename T> inline bool whole_chunks(int dk, int dv) {
  return (dk * sizeof(T)) % 16 == 0 && (dv * sizeof(T)) % 16 == 0;
}

// The attributes of a split instance: its dynamic shared memory and
// clusters past 8 blocks.
template <typename K> cudaError_t split_attributes(K kernel, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// The launch of a split instance: grid (B·H·ranks, q tiles), a cluster of
// ``ranks`` blocks along x.
template <typename K, typename... Args>
cudaError_t launch_cluster(K kernel, dim3 grid, int threads, int bytes, int ranks,
                           cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = ranks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace repro
