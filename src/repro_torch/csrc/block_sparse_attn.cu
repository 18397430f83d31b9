// Causal block-sparse attention (the paper's sparse-attention device, at
// prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/block_sparse_attn/kernel.py
// (block_sparse_attention_kernel, pallas_call at :102): query block i reads
// only the kv blocks of row i of the static (idx, valid) table (sink blocks,
// a local band, strided global blocks; models/attention.py
// sparse_block_table), with the causal mask inside them, scale d^-1/2, f32
// running max m (initialised to -1e30, the JAX NEG_INF, so a fully masked
// tile adds p = 0 rather than NaN), denominator l and accumulator, GQA by
// index, output acc / max(l, 1e-30).  Query rows sit at key positions
// q_offset + row.
//
// What bounds it on the H100: at the serving prefill (B = 8, S = 896,
// H = 12, hd = 64, block 128, local 4, sink 1, stride 8, f32) query block i
// has min(i + 1, 5) active blocks, so the causal pairs inside them number
// 352,704 per (b, h) (dense causal: 401,856): 4·hd FLOP each is 8.7 GFLOP,
// 130 us on the CUDA cores in f32, against 88 MB of q, k, v and o, 26 us at
// 3.35 TB/s: bound by the operations.
//
// Design: the TPU grid walked the active slots of a q block in order on one
// core (a sequential grid axis fed by scalar prefetch).  Here one CUDA
// block owns one (batch·head, 64-row slice of a q block) — a 128-row block
// is two slices — reads its q block's row of the table itself and loops over
// the VALID slots only, loading nothing for an invalid one.  Within a kv
// block it takes kv tiles of 4096/hd rows through shared memory (32 KB of
// K and V in f32) and skips tiles wholly above the causal diagonal.  The
// per-tile step is attn_tile.cuh's, shared with flash_attn.cu: four threads
// per query row, one rescale per 16 keys.  Tensor cores and TMA are later
// work.
#include "attn_tile.cuh"

namespace {

using repro::attend_tile;
using repro::from_f32;
using repro::load_kv_tile;
using repro::NEG_INF;
using repro::to_f32;
using repro::TPR;

constexpr int BQ = 64;                   // query rows per CUDA block
constexpr int THREADS = BQ * TPR;        // 256

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
bsa_fwd(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, T* __restrict__ o,
        const int* __restrict__ idx, const int* __restrict__ valid, int Sq,
        int Sk, int H, int KH, int block, int n_active, int q_offset,
        float scale) {
  constexpr int BKV = repro::kv_tile_rows<HD>();
  constexpr int DPT = HD / TPR;          // dims per thread
  static_assert(BKV % repro::CH == 0, "tile must hold whole chunks");
  __shared__ float ks[BKV][HD];
  __shared__ float vs[BKV][HD];

  const int n_sub = (block + BQ - 1) / BQ;
  const int qb = blockIdx.x / n_sub, sub = blockIdx.x % n_sub;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KH);
  const int q0 = qb * block + sub * BQ;                 // first row (q index)
  const int rows = min(BQ, block - sub * BQ);
  const int tid = threadIdx.x, row = tid / TPR, part = tid % TPR;
  const bool active = row < rows;
  const int qpos = q_offset + q0 + row;                 // key position of the row
  const int qlast = q_offset + q0 + rows - 1;

  const size_t q_off = ((size_t)(b * Sq + q0 + row) * H + h) * HD;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    qr[t] = active ? to_f32(q[q_off + part + TPR * t]) * scale : 0.f;
    acc[t] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  const size_t pos_stride = (size_t)KH * HD;
  const size_t kv_base = ((size_t)b * Sk * KH + kvh) * HD;
  const int* idx_row = idx + (size_t)qb * n_active;
  const int* valid_row = valid + (size_t)qb * n_active;

  for (int a = 0; a < n_active; ++a) {
    if (!valid_row[a]) continue;         // the same for the whole block
    const int kv_lo = idx_row[a] * block;
    const int kv_hi = min(min(kv_lo + block, Sk), qlast + 1);
    for (int j0 = kv_lo; j0 < kv_hi; j0 += BKV) {
      __syncthreads();  // the previous tile is consumed
      load_kv_tile<T, HD, BKV, THREADS>(ks, vs, k, v, kv_base, pos_stride, j0, kv_hi, tid);
      __syncthreads();
      // every thread runs it (shuffles need the whole warp); rows past the
      // slice compute on q = 0 and write nothing
      attend_tile<HD>(ks, vs, j0, min(BKV, kv_hi - j0), part, qr, acc, m, l,
                      [&](int kp) { return kp <= qpos; });
    }
  }
  if (active) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int t = 0; t < DPT; ++t) o[q_off + part + TPR * t] = from_f32<T>(acc[t] / den);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* o, const int* idx,
            const int* valid, int B, int Sq, int Sk, int H, int KH, int block,
            int n_active, int q_offset, float scale, cudaStream_t s) {
  dim3 grid((Sq / block) * ((block + BQ - 1) / BQ), B * H);
  bsa_fwd<T, HD><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), idx, valid, Sq, Sk, H, KH, block, n_active, q_offset, scale);
}

template <typename T>
int dispatch(int HD, const void* q, const void* k, const void* v, void* o,
             const int* idx, const int* valid, int B, int Sq, int Sk, int H, int KH,
             int block, int n_active, int q_offset, float scale, cudaStream_t s) {
  switch (HD) {
    case 32: launch<T, 32>(q, k, v, o, idx, valid, B, Sq, Sk, H, KH, block, n_active, q_offset, scale, s); break;
    case 64: launch<T, 64>(q, k, v, o, idx, valid, B, Sq, Sk, H, KH, block, n_active, q_offset, scale, s); break;
    case 128: launch<T, 128>(q, k, v, o, idx, valid, B, Sq, Sk, H, KH, block, n_active, q_offset, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  q/o (B,Sq,H,HD), k/v (B,Sk,KH,HD), contiguous;
// idx/valid (Sq/block, n_active) int32 on the device.  Sq and Sk are
// multiples of block; query row i sits at key position q_offset + i.
// Returns cudaGetLastError().
extern "C" int block_sparse_attn(int dtype, const void* q, const void* k,
                                 const void* v, void* o, const void* idx,
                                 const void* valid, int B, int Sq, int Sk, int H,
                                 int KH, int HD, int block, int n_active,
                                 int q_offset, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0 || block < 1 ||
      Sq % block != 0 || Sk % block != 0 || n_active < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const int* vp = static_cast<const int*>(valid);
  int rc;
  if (dtype == 0) {
    rc = dispatch<float>(HD, q, k, v, o, ip, vp, B, Sq, Sk, H, KH, block, n_active, q_offset, scale, s);
  } else if (dtype == 1) {
    rc = dispatch<__nv_bfloat16>(HD, q, k, v, o, ip, vp, B, Sq, Sk, H, KH, block, n_active, q_offset, scale, s);
  } else {
    rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
