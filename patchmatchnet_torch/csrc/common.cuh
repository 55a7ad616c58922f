// Shared device helpers for the PatchmatchNet kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pmn {

constexpr int kThreads = 256;

// VecLoad<T>::load reads N consecutive elements of T from a 16-byte aligned
// address in one 16-byte transaction and widens them to f32.
template <typename T>
struct VecLoad;

template <>
struct VecLoad<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct VecLoad<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// align_corners=False unnormalization of a grid coordinate, clamped to the
// border: ((g + 1) * size - 1) / 2 in [0, size - 1]. Rounded op by op (no
// FMA contraction) so it matches the PyTorch/JAX element-wise formulas.
__device__ __forceinline__ float unnormalize_border(float g, int size) {
  const float t = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)size), 1.0f), 0.5f);
  return fminf(fmaxf(t, 0.0f), (float)(size - 1));
}

inline unsigned int num_blocks(long long total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace pmn
