// Helpers shared by the f32 flash-attention FMA kernels (K1, K2 and K3;
// their bf16 versions run on wgmma, see hopper.cuh) and the mask value all
// of them use: load8 reads 8 consecutive floats with one 32-byte load,
// store8 writes 8, round_to rounds to the input type (q' = q * sm_scale is
// rounded to it, as the TPU kernels fold the scale into q), store1 writes
// one element in the output type.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;   // the TPU kernels' mask value

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ float round_to(float x, const float*) { return x; }

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage `rows` rows of D elements, starting at row r0 of a (seq, heads, D)
// tensor whose rows are `stride` elements apart, into a padded f32 tile
// (row stride DP) by `nthreads` threads; rows at or past `n` are zero.
// With `scale` != 1 each element is multiplied and rounded to T (q').
template <int D, int DP, typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, long stride,
                                           int r0, int rows, int n, float scale,
                                           int tid, int nthreads) {
  for (int c = tid; c < rows * D / 8; c += nthreads) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (r0 + r < n) {
      load8(src + (long)(r0 + r) * stride + col, x);
      if (scale != 1.f) {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = round_to(x[e] * scale, src);
      }
    }
    store8(dst + r * DP + col, x);
  }
}

}  // namespace flash
