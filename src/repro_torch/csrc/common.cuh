// Shared helpers of the port's CUDA kernels: f32 <-> storage-type
// conversions and the unpacking of a 16-byte load.  Every kernel computes in
// f32 and stores in the operand type (f32 or bf16); the bf16 store rounds to
// nearest even.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float NEG_INF = -1e30f;  // the masked-logit value of the JAX package

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round an f32 value through the storage type (identity for f32).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// 16 raw bytes → their 4 f32 or 8 bf16 values as f32 (bf16 is the high half
// of an f32).
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

}  // namespace repro
