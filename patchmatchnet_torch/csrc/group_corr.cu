// K1 warp_group_corr, K3 neighbor_group_corr, K6 warp_group_corr_views and
// K7 coord_group_corr: bilinear taps of a feature map at per-sample
// coordinates, times the reference feature, reduced to group means.
//
// Replaces four TPU kernels (patchmatchnet_tpu/ops/pallas/):
// - K1: windowed_similarity.py `_kernel_proj` (launched by
//   `_pallas_windowed_proj`). Warp coordinates come from the [B,12]
//   projection and the depth hypotheses; zeros padding, align_corners=True;
//   samples with pz <= 1e-3 are pushed to (W, H) and read zero.
// - K3: similarity_kernel.py `_kernel` (launched by `_pallas_impl`) as used
//   by `_feature_weight_corr`: coordinates from the eval grid (gx, gy),
//   align_corners=False with border clamping, the reference feature as the
//   source and the Ke neighbours in the depth slot. The [P, 4C] taps array
//   the TPU path gathers first never exists here.
// - K6: windowed_similarity.py `_kernel_proj_views` (launched by
//   `_pallas_windowed_proj_views`), the fused-views inference path: K1 for
//   all V source views, weighted by per-pixel view weights and summed,
//   out = sum_v vw[b, v] * K1(src[b, v], mats[b, v]). The TPU kernel walked
//   the views along a sequential grid axis and revisited its output block
//   once per view; here the view loop runs inside the thread, and each
//   view's K1 value is multiplied by its weight with __fmul_rn and added to
//   a register sum with __fadd_rn in view order 0..V-1, so K6 equals, bit
//   for bit, the per-view route it replaces (V K1 volumes, each times its
//   weights, added to a zeroed sum as separate tensor ops).
// - K7: windowed_similarity.py `_kernel` (launched by `_pallas_windowed`):
//   K1 with the source pixel coordinates (ix, iy) given per sample instead
//   of computed from the projection. K1 is "warp, then K7": both pick a
//   sample's cell with `coord_taps`.
//
// What bounds it on an H100: the tap reads. Each output sample reads
// 4 corners x C channels of the source plus C reference channels (stage 3
// bf16: 640 B) per view to produce G f32 values (32 B), so the kernel is
// bound by L1/L2 load throughput, not by HBM or arithmetic. The source maps
// are at most 8 MB per view (stage 1, 432x576x16 bf16; 32 MB for K6's four)
// and stay resident in the 50 MB L2.
// Design: one thread per (b, d, pixel) with x fastest, so the G output
// stores of a warp are coalesced and neighbouring threads read neighbouring
// source pixels; channels are read in 16-byte vectors; the group sums live
// in registers. The TPU kernel's source window (and its escape counter)
// does not exist: every sample reads the source directly, so none is lost.

#include "common.cuh"

namespace pmn {

// Where a sample's coordinates come from.
enum class Coords {
  kWarp,    // K1: warp of (x, y) at depth[idx] through mat12[b]
  kBorder,  // K3: normalized grid (gx, gy)[idx], align_corners=False, border
  kPixels,  // K7: source pixel coordinates (ix, iy)[idx], align_corners=True
  kViews,   // K6: kWarp for each of V views, weighted by vw and summed
};

template <typename T, int C, int G, Coords kMode>
__global__ void __launch_bounds__(kThreads) group_corr_kernel(
    const T* __restrict__ src, const T* __restrict__ ref,
    const float* __restrict__ mat12, const float* __restrict__ depth,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ vw, float* __restrict__ out, int B, int V, int D, int H,
    int W, int Hs, int Ws) {
  constexpr int CG = C / G;

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
  const T* r = ref + ((long long)b * hw + pix) * C;

  float res[G];
  if constexpr (kMode == Coords::kViews) {
#pragma unroll
    for (int g = 0; g < G; ++g) res[g] = 0.0f;
    const float dep = depth[idx];
    for (int v = 0; v < V; ++v) {
      const long long bv = (long long)b * V + v;
      const Taps taps = warp_taps(mat12 + bv * 12, (float)x, (float)y, dep, Hs, Ws);
      float acc[G];
      group_sums<T, C, G>(src + bv * Hs * Ws * C, Ws, taps, r, acc);
      const float weight = vw[bv * hw + pix];
#pragma unroll
      for (int g = 0; g < G; ++g)
        res[g] = __fadd_rn(res[g], __fmul_rn(__fmul_rn(acc[g], 1.0f / CG), weight));
    }
  } else {
    Taps taps;
    if constexpr (kMode == Coords::kWarp) {
      taps = warp_taps(mat12 + b * 12, (float)x, (float)y, depth[idx], Hs, Ws);
    } else if constexpr (kMode == Coords::kBorder) {
      taps = border_taps(unnormalize_border(gx[idx], Ws), unnormalize_border(gy[idx], Hs),
                         Hs, Ws);
    } else {
      taps = coord_taps(gx[idx], gy[idx], Hs, Ws);
    }
    group_sums<T, C, G>(src + (long long)b * Hs * Ws * C, Ws, taps, r, res);
#pragma unroll
    for (int g = 0; g < G; ++g) res[g] *= 1.0f / CG;
  }

  float* o = out + ((long long)b * G * D + d) * hw + pix;
#pragma unroll
  for (int g = 0; g < G; ++g) o[(long long)g * D * hw] = res[g];
}

template <typename T, int C, int G, Coords kMode>
cudaError_t launch(const void* src, const void* ref, const void* mat12, const void* depth,
                   const void* gx, const void* gy, const void* vw, void* out, int B, int V,
                   int D, int H, int W, int Hs, int Ws, cudaStream_t stream) {
  const long long total = (long long)B * D * H * W;
  if (total == 0) return cudaSuccess;
  group_corr_kernel<T, C, G, kMode><<<num_blocks(total), kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref),
      static_cast<const float*>(mat12), static_cast<const float*>(depth),
      static_cast<const float*>(gx), static_cast<const float*>(gy),
      static_cast<const float*>(vw), static_cast<float*>(out), B, V, D, H, W, Hs, Ws);
  return cudaGetLastError();
}

template <Coords kMode>
cudaError_t dispatch(const void* src, const void* ref, const void* mat12, const void* depth,
                     const void* gx, const void* gy, const void* vw, void* out, int B, int V,
                     int D, int H, int W, int Hs, int Ws, int C, int G, int bf16,
                     cudaStream_t stream) {
#define PMN_CASE(CC, GG)                                                                    \
  if (C == CC && G == GG) {                                                                 \
    return bf16 ? launch<__nv_bfloat16, CC, GG, kMode>(src, ref, mat12, depth, gx, gy, vw,   \
                                                       out, B, V, D, H, W, Hs, Ws, stream)  \
                : launch<float, CC, GG, kMode>(src, ref, mat12, depth, gx, gy, vw, out, B,   \
                                               V, D, H, W, Hs, Ws, stream);                 \
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
  return (int)pmn::dispatch<pmn::Coords::kWarp>(src, ref, mat12, depth, nullptr, nullptr,
                                                nullptr, out, B, 1, D, H, W, Hs, Ws, C, G, bf16,
                                                static_cast<cudaStream_t>(stream));
}

// ref [B,H,W,C] (f32 or bf16), gx/gy [B,K,H,W] f32 -> out [B,G,K,H,W] f32.
extern "C" int pmn_neighbor_group_corr(const void* ref, const void* gx, const void* gy,
                                       void* out, int B, int K, int H, int W, int C, int G,
                                       int bf16, void* stream) {
  return (int)pmn::dispatch<pmn::Coords::kBorder>(ref, ref, nullptr, nullptr, gx, gy, nullptr,
                                                  out, B, 1, K, H, W, H, W, C, G, bf16,
                                                  static_cast<cudaStream_t>(stream));
}

// src [B,Hs,Ws,C], ref [B,H,W,C] (f32 or bf16), ix/iy [B,D,H,W] f32 source
// pixel coordinates (align_corners=True, may be off the image)
// -> out [B,G,D,H,W] f32.
extern "C" int pmn_coord_group_corr(const void* src, const void* ref, const void* ix,
                                    const void* iy, void* out, int B, int D, int H, int W,
                                    int Hs, int Ws, int C, int G, int bf16, void* stream) {
  return (int)pmn::dispatch<pmn::Coords::kPixels>(src, ref, nullptr, nullptr, ix, iy, nullptr,
                                                  out, B, 1, D, H, W, Hs, Ws, C, G, bf16,
                                                  static_cast<cudaStream_t>(stream));
}

// src [B,V,Hs,Ws,C], ref [B,H,W,C] (f32 or bf16), mats [B,V,12] f32,
// depth [B,D,H,W] f32, vw [B,V,H,W] f32 -> out [B,G,D,H,W] f32.
extern "C" int pmn_warp_group_corr_views(const void* src, const void* ref, const void* mats,
                                         const void* depth, const void* vw, void* out, int B,
                                         int V, int D, int H, int W, int Hs, int Ws, int C, int G,
                                         int bf16, void* stream) {
  return (int)pmn::dispatch<pmn::Coords::kViews>(src, ref, mats, depth, nullptr, nullptr, vw,
                                                 out, B, V, D, H, W, Hs, Ws, C, G, bf16,
                                                 static_cast<cudaStream_t>(stream));
}

extern "C" const char* pmn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
