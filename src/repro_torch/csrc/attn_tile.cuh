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
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro {

// kv rows per tile: 64 with the 64-row q tile at hd ≤ 64; 32 at hd 128 (Qᵀ,
// two K/V stages and Pᵀ then fit two blocks an SM) and with the 32-row q
// tile (four blocks an SM).
constexpr int kv_tile_rows(int HD, int BQ) { return HD == 128 || BQ == 32 ? 32 : 64; }

// Tile geometry of one (HD, BQ, BKV) instance; 4·BQ threads.
template <int HD, int BQ, int BKV> struct AttnTile {
  static constexpr int THREADS = 4 * BQ;
  static constexpr int QS = BQ + 4;       // row stride of Qᵀ and Pᵀ (floats)
  static constexpr int KS = HD + 4;       // row stride of the K and V stages
  static constexpr int KPT = BKV / 16;    // keys per thread in S
  static constexpr int VW = HD >= 64 ? 4 : 2, NC = HD / (16 * VW);  // O dims per thread: NC groups of VW
  static constexpr int Q_ELEMS = HD * QS, KV_ELEMS = BKV * KS, P_ELEMS = BKV * QS;
  static constexpr int BYTES = 4 * (Q_ELEMS + 4 * KV_ELEMS + P_ELEMS);
  // copies: 4 consecutive dims per thread; RS rows per pass
  static constexpr int CH = HD / 4, RS = THREADS / CH, KL = BKV / RS, QL = BQ / RS;
  static constexpr int MIN_BLOCKS = 512 / THREADS;  // 128 registers a thread
  static_assert(HD % 32 == 0 && BQ % 32 == 0 && BKV % 16 == 0, "tile shape");
  static_assert(THREADS % CH == 0 && BKV % RS == 0 && BQ % RS == 0, "copy layout");
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

// The q tile: rows [0, rows) of q at q + q_base + r·row_stride (key
// position qpos0 + r), kv row j at kv_base + j·pos_stride, the same row
// layout for o.  ASYNC: T is float and every operand is 16-byte aligned.
// Walk (block-uniform): next(j0, hi) yields the kv tiles [j0, min(j0 + BKV,
// hi)) in order; need_mask(j0, hi) says whether a tile crosses an edge;
// allowed(qpos, kpos) is the test inside such a tile (kpos < hi is tested
// here).  Every thread of the block calls it.
template <typename T, int HD, int BQ, int BKV, bool ASYNC, typename Walk>
__device__ __forceinline__ void attend_q_tile(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, size_t q_base, size_t row_stride, int rows, size_t kv_base,
    size_t pos_stride, int qpos0, float scale, Walk& walk, float* smem) {
  using L = AttnTile<HD, BQ, BKV>;
  constexpr int QS = L::QS, KS = L::KS, KPT = L::KPT, VW = L::VW, NC = L::NC;
  float* qt = smem;                            // Qᵀ [HD][QS]
  float* kst = qt + L::Q_ELEMS;                // K stages [2][BKV][KS]
  float* vst = kst + 2 * L::KV_ELEMS;          // V stages [2][BKV][KS]
  float* pt = vst + 2 * L::KV_ELEMS;           // Pᵀ [BKV][QS]

  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = lane & 15, ty = 2 * (tid >> 5) + (lane >> 4);
  const int cr = tid / L::CH, cc = (tid % L::CH) * 4;   // this thread's copy row, dim

  // Q, scaled, transposed; rows past `rows` are zero
#pragma unroll
  for (int l = 0; l < L::QL; ++l) {
    const int r = cr + L::RS * l;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = load4<ASYNC>(q + q_base + (size_t)r * row_stride + cc);
    qt[(cc + 0) * QS + r] = x.x * scale;
    qt[(cc + 1) * QS + r] = x.y * scale;
    qt[(cc + 2) * QS + r] = x.z * scale;
    qt[(cc + 3) * QS + r] = x.w * scale;
  }

  // K/V copies: rows cr + RS·l of the tile at dims cc .. cc + 3
  const T* kg = k + kv_base + (size_t)cr * pos_stride + cc;
  const T* vg = v + kv_base + (size_t)cr * pos_stride + cc;
  const size_t step = (size_t)L::RS * pos_stride;
  auto stage = [&](int st, int j0, int hi) {
    float* ks = kst + st * L::KV_ELEMS + cr * KS + cc;
    float* vs = vst + st * L::KV_ELEMS + cr * KS + cc;
    const size_t base = (size_t)j0 * pos_stride;
    if constexpr (ASYNC) {
#pragma unroll
      for (int l = 0; l < L::KL; ++l) {
        const bool ok = j0 + cr + L::RS * l < hi;
        const size_t g = base + step * l;
        cp_async16(ks + L::RS * l * KS, ok ? (const void*)(kg + g) : (const void*)k, ok);
        cp_async16(vs + L::RS * l * KS, ok ? (const void*)(vg + g) : (const void*)v, ok);
      }
      cp_async_commit();
    } else {
      float4 kr[L::KL], vr[L::KL];
#pragma unroll
      for (int l = 0; l < L::KL; ++l) {
        const bool ok = j0 + cr + L::RS * l < hi;
        const size_t g = base + step * l;
        kr[l] = ok ? load4<false>(kg + g) : make_float4(0.f, 0.f, 0.f, 0.f);
        vr[l] = ok ? load4<false>(vg + g) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int l = 0; l < L::KL; ++l) {
        *reinterpret_cast<float4*>(ks + L::RS * l * KS) = kr[l];
        *reinterpret_cast<float4*>(vs + L::RS * l * KS) = vr[l];
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
  bool have = walk.next(j0, hi);
  if (ASYNC && have) stage(0, j0, hi);
  while (have) {
    if constexpr (ASYNC) cp_async_wait_all();
    else stage(st, j0, hi);
    // tile t is in stage st; every thread is done with tile t - 1 (its
    // stage and Pᵀ)
    __syncthreads();
    int nj0 = 0, nhi = 0;
    const bool have_next = walk.next(nj0, nhi);
    if (ASYNC && have_next) stage(st ^ 1, nj0, nhi);

    const float* ks = kst + st * L::KV_ELEMS;
    const float* vs = vst + st * L::KV_ELEMS;
    float s[4][KPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
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
        const float* vp = vs + kk * KS + VW * tx + 16 * VW * c;
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
    st ^= 1;
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
    T* orow = o + q_base + (size_t)r * row_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = VW * tx + 16 * VW * c;
      if constexpr (ASYNC && VW == 4) {
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[i][4 * c] / den, acc[i][4 * c + 1] / den,
                        acc[i][4 * c + 2] / den, acc[i][4 * c + 3] / den);
      } else if constexpr (ASYNC) {
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(acc[i][2 * c] / den, acc[i][2 * c + 1] / den);
      } else {
#pragma unroll
        for (int u = 0; u < VW; ++u) orow[d + u] = from_f32<T>(acc[i][c * VW + u] / den);
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
