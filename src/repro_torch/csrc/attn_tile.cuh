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
// passes its rows' own (dk, dv) ≤ (DK, DV) at run time, whole 16-byte
// chunks (dk·4 bytes a row in f32).  Operands are read at their true row
// stride; the tile's dims from dk up to DK of Qᵀ and K, and from dv up to
// DV of V, are zero-filled (cp.async with src-size 0, or a zero register),
// so a pad dim adds an exact zero to every q·k dot and its O column is
// never stored: gemma3's heads of 240 run in the (256, 256) tile, heads of
// 16 in the (32, 32) one, MLA's (80, 64) in (96, 64).  At (256, 256) the
// tile holds 174,592 B with 32-row q and kv tiles and 211,456 B with 64-row
// q tiles: one block an SM, 255 registers for a thread's 64 O floats.  The
// register rule is one for every instance: the 128 registers that 512
// threads an SM allow, or, where shared memory holds fewer blocks than
// that, as many registers as those blocks leave.
//
// Any row width runs (kernels/flash_attn/ops.py plan; the C entry points'
// ``rows`` argument, 0, 1 or 2):
// - 0, whole 4-element chunks (16-byte chunks in f32) up to the tile's
//   widths: the paths above (ASYNC where f32 operands are 16-byte aligned,
//   else CHUNK: register copies of 4-element chunks).
// - 1, rows that are not whole chunks (f32 heads of 18: rows 72 bytes apart,
//   never 16-byte aligned past the first; bf16 rows of odd width, 2-byte
//   aligned): ELEM, the register path with a bound per element (zeros past
//   the row) and O stored element by element, in the square tiles only
//   (REPRO_ATTN_SQUARE; a call runs in the smallest that holds the wider of
//   dk and dv) and with the 32-row q tile only.
// - 2, rows wider than 256: SLICED, in the (256, 256) tile.  The q·k dot
//   must be whole before the softmax, so each kv tile sums it over the
//   256-wide slices of q and k, staged in turn through Qᵀ and the one K
//   stage (two barriers a slice; Qᵀ restaged every kv tile unless dk fits
//   one slice); P is the same for every column of O, so v and o are cut
//   into 256-column planes, one grid z each, every plane recomputing the
//   same S and P from the same inputs in the same order (the planes agree
//   exactly).  Element reads (ELEM's) copied in batches of 8 chunks (a
//   whole K slice's 16 chunks a thread spilled the block-sparse instance at
//   255 registers), one K and one V stage (108,032 B: two blocks an SM),
//   the 32-row q tile.  Q and K are read once per plane, Q once more per
//   kv tile when dk is sliced: a slow path, kept simple (chip_smoke.py
//   CHECK lines, H100 80GB HBM3 at 700 W: heads of 512 at B 2, S 128, H 4
//   causal take 0.102 ms, SDPA 0.042).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro {

// kv rows per tile: 64 with the 64-row q tile at q/k widths below 96; 32 at
// wider ones (Qᵀ, two K/V stages and Pᵀ then fit two blocks an SM at hd 128)
// and with the 32-row q tile (four blocks an SM at hd 64).
constexpr int kv_tile_rows(int DK, int BQ) { return DK >= 96 || BQ == 32 ? 32 : 64; }

constexpr int SM_SMEM = 233472;   // shared memory an H100 SM holds (228 KB)

// How a q tile reads its rows (the note above).
constexpr int ASYNC = 0, CHUNK = 1, ELEM = 2, SLICED = 3;
constexpr int SLICE_W = 256;      // the SLICED tile's (DK, DV) and slice width

// The (q/k, v) tile widths both prefill kernels compile, X(DK, DV) each:
// the square heads and MLA's (kernels/flash_attn/ops.py WIDTHS, the same
// list, picks one for a call's row widths).
#define REPRO_ATTN_WIDTHS(X) \
  X(32, 32) X(64, 64) X(128, 128) X(256, 256) X(96, 64) X(192, 128)

// The square tiles, the only ones ELEM rows run in.
#define REPRO_ATTN_SQUARE(X) X(32, 32) X(64, 64) X(128, 128) X(256, 256)

// Row widths (dk, dv) the (DK, DV) tile runs on the C entry points' ``rows``
// path: 0, whole 4-element chunks, at least one, at most the tile's; 1,
// any width at most a square tile's; 2, any width, in the SLICED tile.
inline bool row_widths_fit(int rows, int dk, int dv, int DK, int DV) {
  if (dk < 1 || dv < 1) return false;
  if (rows == 0) return dk <= DK && dv <= DV && dk % 4 == 0 && dv % 4 == 0;
  if (rows == 1) return dk <= DK && dv <= DV && DK == DV;
  return rows == 2 && DK == SLICE_W && DV == SLICE_W;
}

// Tile geometry of one (DK, DV, BQ, BKV) instance with NST K and V stages;
// 4·BQ threads.
template <int DK, int DV, int BQ, int BKV, int NST = 2> struct AttnTile {
  static constexpr int THREADS = 4 * BQ;
  static constexpr int QS = BQ + 4;       // row stride of Qᵀ and Pᵀ (floats)
  static constexpr int KS = DK + 4;       // row stride of the K stages
  static constexpr int VS = DV + 4;       // row stride of the V stages
  static constexpr int KPT = BKV / 16;    // keys per thread in S
  static constexpr int VW = DV >= 64 ? 4 : 2, NC = DV / (16 * VW);  // O dims per thread: NC groups of VW
  static constexpr int Q_ELEMS = DK * QS, K_ELEMS = BKV * KS, V_ELEMS = BKV * VS,
                       P_ELEMS = BKV * QS;
  static constexpr int BYTES = 4 * (Q_ELEMS + NST * K_ELEMS + NST * V_ELEMS + P_ELEMS);
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

// The tile of a PATH instance: SLICED keeps one K and one V stage.
template <int DK, int DV, int BQ, int BKV, int PATH>
using TileOf = AttnTile<DK, DV, BQ, BKV, PATH == SLICED ? 1 : 2>;

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

// SLICED's copies: fetch (TAIL) and put in batches of B chunks, so that a
// copy holds 4·B registers beside the 64 O floats and the dots carried
// across slices.
template <int N, int TH, int C, int B, typename T>
__device__ __forceinline__ void copy_tail(float* s, int S, const T* p, Rows rl, int j0, int hi,
                                          int w, int tid) {
  static_assert(N % B == 0, "batches");
#pragma unroll
  for (int l0 = 0; l0 < N; l0 += B) {
    float4 r[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const Chunk<TH, C> c(tid, l0 + b);
      r[b] = j0 + c.row < hi && c.col < w
                 ? load4_upto(p + rl.base + (size_t)(j0 + c.row) * rl.stride + c.col, w - c.col)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const Chunk<TH, C> c(tid, l0 + b);
      *reinterpret_cast<float4*>(s + c.row * S + c.col) = r[b];
    }
  }
}

// The q tile: rows [0, rows) of q at ql (key position qpos0 + r) and of o
// at ol; kv row j of k at kl and of v at vl; rows of q and k dk wide, of v
// and o dv wide (dk ≤ DK, dv ≤ DV, multiples of 4 but under ELEM; under
// SLICED dk any width, summed over DK-wide slices, and dv the columns left
// from the plane's first, of which the tile takes DV).  PATH: ASYNC (T is
// float and every operand is 16-byte aligned), CHUNK, ELEM or SLICED (the
// note above).  Walk (block-uniform): next(j0, hi) yields the kv tiles
// [j0, min(j0 + BKV, hi)) in order; need_mask(j0, hi) says whether a tile
// crosses an edge; allowed(qpos, kpos) is the test inside such a tile
// (kpos < hi is tested here).  Every thread of the block calls it.
template <typename T, int DK, int DV, int BQ, int BKV, int PATH, typename Walk>
__device__ __forceinline__ void attend_q_tile(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, Rows ql, Rows ol, int rows, Rows kl, Rows vl, int dk, int dv,
    int qpos0, float scale, Walk& walk, float* smem) {
  using L = TileOf<DK, DV, BQ, BKV, PATH>;
  constexpr bool VEC = PATH == ASYNC, TAIL = PATH >= ELEM, SL = PATH == SLICED;
  constexpr int QS = L::QS, KS = L::KS, VS = L::VS, KPT = L::KPT, VW = L::VW, NC = L::NC;
  constexpr int TH = L::THREADS;
  constexpr int NST = SL ? 1 : 2;
  float* qt = smem;                            // Qᵀ [DK][QS]
  float* kst = qt + L::Q_ELEMS;                // K stages [NST][BKV][KS]
  float* vst = kst + NST * L::K_ELEMS;         // V stages [NST][BKV][VS]
  float* pt = vst + NST * L::V_ELEMS;          // Pᵀ [BKV][QS]

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
  if constexpr (!SL) load_q(0);

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

  float acc[4][NC * VW], m[4], lsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    lsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * VW; ++c) acc[i][c] = 0.f;
  }

  int j0, hi, st = 0;
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
    if constexpr (SL) {
      // slice by slice: every thread is done with the last slice's (or
      // tile's) Qᵀ, K, V and Pᵀ before they are overwritten
      for (int d0 = 0; d0 < dk; d0 += DK) {
        __syncthreads();
        if (first || dk > DK) load_q(d0);
        copy_tail<L::KL, TH, L::CK, 8>(kst, KS, k + d0, kl, j0, hi, dk - d0, tid);
        if (d0 == 0) copy_tail<L::VL, TH, L::CV, 8>(vst, VS, v, vl, j0, hi, dv, tid);
        __syncthreads();
        dots(s, kst);
      }
      first = false;
      have_next = walk.next(nj0, nhi);
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
      const float corr = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        ps += s[i][j];
      }
      lsum[i] = lsum[i] * corr + ps;
#pragma unroll
      for (int c = 0; c < NC * VW; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j)
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * QS + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

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
    if constexpr (!SL) st ^= 1;
    j0 = nj0, hi = nhi, have = have_next;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = lsum[i];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + ol.base + (size_t)r * ol.stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = VW * tx + 16 * VW * c;
      if (d >= dv) continue;  // the tile's pad dims
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
}

// SMs of the current device, for the kernels' q-tile rule.
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace repro
