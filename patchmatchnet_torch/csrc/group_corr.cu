// K1 warp_group_corr and K3 neighbor_group_corr: bilinear taps of a feature
// map at per-sample coordinates, times the reference feature, reduced to
// group means.
//
// Replaces two TPU kernels (patchmatchnet_tpu/ops/pallas/):
// - K1: windowed_similarity.py `_kernel_proj` (launched by
//   `_pallas_windowed_proj`). Warp coordinates come from the [B,12]
//   projection and the depth hypotheses; zeros padding, align_corners=True;
//   samples with pz <= 1e-3 are pushed to (W, H) and read zero.
// - K3: similarity_kernel.py `_kernel` (launched by `_pallas_impl`) as used
//   by `_feature_weight_corr`: coordinates from the eval grid (gx, gy),
//   align_corners=False with border clamping, the reference feature as the
//   source and the Ke neighbours in the depth slot. The [P, 4C] taps array
//   the TPU path gathers first never exists here.
//
// What bounds it on an H100: the tap reads. Each output sample reads
// 4 corners x C channels of the source plus C reference channels (stage 3
// bf16: 640 B) to produce G f32 values (32 B), so the kernel is bound by
// L1/L2 load throughput, not by HBM or arithmetic. The source maps are at
// most 8 MB (stage 1, 432x576x16 bf16) and stay resident in the 50 MB L2.
// Design: one thread per (b, d, pixel) with x fastest, so the G output
// stores of a warp are coalesced and neighbouring threads read neighbouring
// source pixels; channels are read in 16-byte vectors; the group sums live
// in registers. The TPU kernel's source window (and its escape counter)
// does not exist: every sample reads the source directly, so none is lost.

#include "common.cuh"

namespace pmn {

template <typename T, int C, int G, bool kWarp>
__global__ void __launch_bounds__(kThreads) group_corr_kernel(
    const T* __restrict__ src, const T* __restrict__ ref,
    const float* __restrict__ mat12, const float* __restrict__ depth,
    const float* __restrict__ gx, const float* __restrict__ gy,
    float* __restrict__ out, int B, int D, int H, int W, int Hs, int Ws) {
  constexpr int V = VecLoad<T>::N;
  constexpr int CG = C / G;
  static_assert(C % V == 0 && C % G == 0, "channel layout");

  const long long hw = (long long)H * W;
  const long long total = (long long)B * D * hw;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long pix = idx % hw;
  const int x = (int)(pix % W);
  const int y = (int)(pix / W);
  const long long bd = idx / hw;
  const int d = (int)(bd % D);
  const int b = (int)(bd / D);

  Taps taps;
  if constexpr (kWarp) {
    taps = warp_taps(mat12 + b * 12, (float)x, (float)y, depth[idx], Hs, Ws);
  } else {
    taps = border_taps(unnormalize_border(gx[idx], Ws), unnormalize_border(gy[idx], Hs),
                       Hs, Ws);
  }
  const float* w = taps.w;
  const bool* valid = taps.valid;
  const long long x0 = taps.x0, y0 = taps.y0;

  const T* base = src + (long long)b * Hs * Ws * C;
  const T* corner[4] = {
      base + (y0 * Ws + x0) * C,
      base + (y0 * Ws + x0 + 1) * C,
      base + ((y0 + 1) * Ws + x0) * C,
      base + ((y0 + 1) * Ws + x0 + 1) * C,
  };
  const T* r = ref + ((long long)b * hw + pix) * C;

  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;

#pragma unroll
  for (int c = 0; c < C; c += V) {
    float warped[V], tap[V], rv[V];
#pragma unroll
    for (int i = 0; i < V; ++i) warped[i] = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!valid[t]) continue;
      VecLoad<T>::load(corner[t] + c, tap);
#pragma unroll
      for (int i = 0; i < V; ++i) warped[i] += tap[i] * w[t];
    }
    VecLoad<T>::load(r + c, rv);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[(c + i) / CG] += warped[i] * rv[i];
  }

  float* o = out + ((long long)b * G * D + d) * hw + pix;
#pragma unroll
  for (int g = 0; g < G; ++g) o[(long long)g * D * hw] = acc[g] * (1.0f / CG);
}

template <typename T, int C, int G, bool kWarp>
cudaError_t launch(const void* src, const void* ref, const void* mat12, const void* depth,
                   const void* gx, const void* gy, void* out, int B, int D, int H, int W,
                   int Hs, int Ws, cudaStream_t stream) {
  const long long total = (long long)B * D * H * W;
  if (total == 0) return cudaSuccess;
  group_corr_kernel<T, C, G, kWarp><<<num_blocks(total), kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref),
      static_cast<const float*>(mat12), static_cast<const float*>(depth),
      static_cast<const float*>(gx), static_cast<const float*>(gy),
      static_cast<float*>(out), B, D, H, W, Hs, Ws);
  return cudaGetLastError();
}

template <bool kWarp>
cudaError_t dispatch(const void* src, const void* ref, const void* mat12, const void* depth,
                     const void* gx, const void* gy, void* out, int B, int D, int H, int W,
                     int Hs, int Ws, int C, int G, int bf16, cudaStream_t stream) {
#define PMN_CASE(CC, GG)                                                              \
  if (C == CC && G == GG) {                                                           \
    return bf16 ? launch<__nv_bfloat16, CC, GG, kWarp>(src, ref, mat12, depth, gx, gy, \
                                                       out, B, D, H, W, Hs, Ws, stream) \
                : launch<float, CC, GG, kWarp>(src, ref, mat12, depth, gx, gy, out, B, \
                                               D, H, W, Hs, Ws, stream);               \
  }
  PMN_CASE(16, 4)
  PMN_CASE(32, 8)
  PMN_CASE(64, 8)
#undef PMN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace pmn

// src [B,Hs,Ws,C], ref [B,H,W,C] (f32 or bf16), mat12 [B,12] f32,
// depth [B,D,H,W] f32 -> out [B,G,D,H,W] f32.
extern "C" int pmn_warp_group_corr(const void* src, const void* ref, const void* mat12,
                                   const void* depth, void* out, int B, int D, int H, int W,
                                   int Hs, int Ws, int C, int G, int bf16, void* stream) {
  return (int)pmn::dispatch<true>(src, ref, mat12, depth, nullptr, nullptr, out, B, D, H, W,
                                  Hs, Ws, C, G, bf16, static_cast<cudaStream_t>(stream));
}

// ref [B,H,W,C] (f32 or bf16), gx/gy [B,K,H,W] f32 -> out [B,G,K,H,W] f32.
extern "C" int pmn_neighbor_group_corr(const void* ref, const void* gx, const void* gy,
                                       void* out, int B, int K, int H, int W, int C, int G,
                                       int bf16, void* stream) {
  return (int)pmn::dispatch<false>(ref, ref, nullptr, nullptr, gx, gy, out, B, K, H, W, H, W,
                                   C, G, bf16, static_cast<cudaStream_t>(stream));
}

extern "C" const char* pmn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
