// K4 warp_group_corr_backward and K5 neighbor_group_corr_backward: the
// backward passes of K1 and K3 (csrc/group_corr.cu).
//
// Replaces two TPU kernels (patchmatchnet_tpu/ops/pallas/):
// - K4: windowed_similarity.py `_kernel_proj_bwd` (launched by
//   `_pallas_windowed_proj_bwd`, VJP `_wgsp_bwd`). Cotangents of the source
//   and reference features; the warp coordinates carry no gradient (the
//   reference builds its warp grid under no_grad), so depth and the
//   projection get none.
// - K5: similarity_kernel.py `_bwd_kernel` (launched by `_pallas_bwd`) as
//   `_feature_weight_corr` uses it in training: the caller detaches the
//   reference feature, so the only live cotangent is the one that reaches
//   the eval grid through the bilinear weights and the border clamp. K5
//   computes d_gx, d_gy and nothing else.
//
// With dout [B,G,D,H,W] the incoming cotangent and gm the group-mean matrix
// (1/CG on the channels of each group):
//   d_prod[c]  = dout[g(c)] / CG
//   d_ref[c]   = sum_d d_prod[c] * warped[c]
//   d_src[tap] += w_t * ref[c] * d_prod[c]          (K4; scatter over taps)
//   d_w_t      = sum_c d_prod[c] * ref[c] * tap_t[c]  (K5)
//
// K4 design: one thread per (b, chunk of up to kDepthChunk hypotheses,
// pixel, 4 consecutive channels), channels fastest, so the lanes of a warp
// cover whole pixels: their tap loads and their atomics on a corner are one
// contiguous run of C values. Nothing needs reducing across channels: a
// lane's 4 channels lie in one group, so d_prod is one dout value. Each
// lane keeps its 4 reference-gradient sums in registers across the chunk
// and adds them to d_ref once (so the atomics on d_ref collide only
// D / kDepthChunk ways), and scatters its four corner contributions into
// d_src with 16-byte f32 atomics (float4 atomicAdd, sm_90). Both buffers
// are f32 and zeroed by the caller, which casts them to the payload dtype
// afterwards: a source pixel collects up to 4 x D x (views' overlap)
// terms, and a bf16 running sum would swamp the small ones (the reference
// accumulates its scatter in f32 for the same reason). What bounds it on
// an H100: the atomics into d_src, 4 corners x C values per sample (stage
// 3, D=64, B=2 at 640x512: 168M f32 adds). Corners the forward did not
// read (zeros padding, samples behind the camera) receive nothing.
// Coordinates come from the forward's own helper (common.cuh
// `warp_taps`), so a sample cannot change cell between forward and
// backward.
//
// K5 design: one thread per (b, k, pixel); it re-reads the four taps and
// the centre feature, forms the four d_w_t, chains them through the
// bilinear weights and the border clamp, and writes d_gx, d_gy. No atomics.

#include "common.cuh"

namespace pmn {

constexpr int kDepthChunk = 8;

// Four consecutive channels of T as f32 (16 bytes of f32, 8 of bf16).
template <typename T>
struct Load4;

template <>
struct Load4<float> {
  __device__ __forceinline__ static float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
};

template <>
struct Load4<__nv_bfloat16> {
  __device__ __forceinline__ static float4 load(const __nv_bfloat16* p) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

template <typename T, int C, int G>
__global__ void __launch_bounds__(kThreads) warp_corr_bwd_kernel(
    const T* __restrict__ src, const T* __restrict__ ref, const float* __restrict__ mat12,
    const float* __restrict__ depth, const float* __restrict__ dout,
    float* __restrict__ d_src, float* __restrict__ d_ref, int B, int D, int H, int W,
    int Hs, int Ws) {
  constexpr int L = C / 4;  // lanes per pixel, 4 channels each
  constexpr int CG = C / G;
  static_assert(C % 4 == 0 && CG % 4 == 0, "a lane's 4 channels lie in one group");

  const long long hw = (long long)H * W;
  const int chunks = (D + kDepthChunk - 1) / kDepthChunk;
  const long long total = (long long)B * chunks * hw * L;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int lane = (int)(idx % L);
  const long long rest = idx / L;
  const long long pix = rest % hw;
  const int x = (int)(pix % W);
  const int y = (int)(pix / W);
  const long long bc = rest / hw;
  const int chunk = (int)(bc % chunks);
  const int b = (int)(bc / chunks);
  const int c0 = lane * 4;
  const int g = c0 / CG;
  const int d_end = min(D, (chunk + 1) * kDepthChunk);

  const float* m = mat12 + b * 12;
  const T* base = src + (long long)b * Hs * Ws * C + c0;
  float* dbase = d_src + (long long)b * Hs * Ws * C + c0;
  const float4 rv = Load4<T>::load(ref + ((long long)b * hw + pix) * C + c0);
  const float* gdp = dout + ((long long)b * G + g) * D * hw + pix;

  float4 dref = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int d = chunk * kDepthChunk; d < d_end; ++d) {
    const Taps taps = warp_taps(m, (float)x, (float)y, depth[((long long)b * D + d) * hw + pix],
                                Hs, Ws);
    if (!(taps.valid[0] || taps.valid[1] || taps.valid[2] || taps.valid[3])) continue;
    const float gd = gdp[(long long)d * hw] * (1.0f / CG);
    const float4 dw = make_float4(rv.x * gd, rv.y * gd, rv.z * gd, rv.w * gd);  // d_warped
    const long long x0 = taps.x0, y0 = taps.y0;
    const long long corner[4] = {
        (y0 * Ws + x0) * C,
        (y0 * Ws + x0 + 1) * C,
        ((y0 + 1) * Ws + x0) * C,
        ((y0 + 1) * Ws + x0 + 1) * C,
    };
    float4 warped = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!taps.valid[t]) continue;
      const float wt = taps.w[t];
      const float4 tap = Load4<T>::load(base + corner[t]);
      warped.x += tap.x * wt;
      warped.y += tap.y * wt;
      warped.z += tap.z * wt;
      warped.w += tap.w * wt;
      atomicAdd(reinterpret_cast<float4*>(dbase + corner[t]),
                make_float4(wt * dw.x, wt * dw.y, wt * dw.z, wt * dw.w));
    }
    dref.x += gd * warped.x;
    dref.y += gd * warped.y;
    dref.z += gd * warped.z;
    dref.w += gd * warped.w;
  }

  atomicAdd(reinterpret_cast<float4*>(d_ref + ((long long)b * hw + pix) * C + c0), dref);
}

template <typename T, int C, int G>
__global__ void __launch_bounds__(kThreads) neighbor_corr_bwd_kernel(
    const T* __restrict__ ref, const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ dout, float* __restrict__ d_gx, float* __restrict__ d_gy,
    int B, int K, int H, int W) {
  constexpr int V = VecLoad<T>::N;
  constexpr int CG = C / G;
  static_assert(C % V == 0 && C % G == 0, "channel layout");

  const long long hw = (long long)H * W;
  const long long total = (long long)B * K * hw;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long pix = idx % hw;
  const long long bk = idx / hw;
  const int k = (int)(bk % K);
  const int b = (int)(bk / K);

  // the clamp of the unnormalized coordinate passes the gradient only
  // where it does not bind
  const float tx = unnormalize(gx[idx], W), ty = unnormalize(gy[idx], H);
  const bool pass_x = tx > 0.0f && tx < (float)(W - 1);
  const bool pass_y = ty > 0.0f && ty < (float)(H - 1);
  const Taps taps = border_taps(fminf(fmaxf(tx, 0.0f), (float)(W - 1)),
                                fminf(fmaxf(ty, 0.0f), (float)(H - 1)), H, W);

  float gd[G];
#pragma unroll
  for (int g = 0; g < G; ++g)
    gd[g] = dout[(((long long)b * G + g) * K + k) * hw + pix] * (1.0f / CG);

  const T* base = ref + (long long)b * hw * C;
  const long long x0 = taps.x0, y0 = taps.y0;
  const T* corner[4] = {
      base + (y0 * W + x0) * C,
      base + (y0 * W + x0 + 1) * C,
      base + ((y0 + 1) * W + x0) * C,
      base + ((y0 + 1) * W + x0 + 1) * C,
  };
  const T* r = base + pix * C;

  float dw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < C; c += V) {
    float rv[V], tap[V];
    VecLoad<T>::load(r + c, rv);
#pragma unroll
    for (int i = 0; i < V; ++i) rv[i] *= gd[(c + i) / CG];  // d_warped
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      VecLoad<T>::load(corner[t] + c, tap);
#pragma unroll
      for (int i = 0; i < V; ++i) dw[t] += rv[i] * tap[i];
    }
  }
  // w = [(1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy]; fx = sx - x0 with x0
  // piecewise constant
  const float dfx = (dw[1] - dw[0]) * (1.0f - taps.fy) + (dw[3] - dw[2]) * taps.fy;
  const float dfy = (dw[2] - dw[0]) * (1.0f - taps.fx) + (dw[3] - dw[1]) * taps.fx;
  // d sx / d gx = W / 2 (align_corners=False unnormalization)
  d_gx[idx] = pass_x ? dfx * (0.5f * (float)W) : 0.0f;
  d_gy[idx] = pass_y ? dfy * (0.5f * (float)H) : 0.0f;
}

template <typename T, int C, int G>
cudaError_t launch_warp_bwd(const void* src, const void* ref, const void* mat12,
                            const void* depth, const void* dout, void* d_src, void* d_ref,
                            int B, int D, int H, int W, int Hs, int Ws, cudaStream_t stream) {
  const long long total =
      (long long)B * ((D + kDepthChunk - 1) / kDepthChunk) * H * W * (C / 4);
  if (total == 0) return cudaSuccess;
  warp_corr_bwd_kernel<T, C, G><<<num_blocks(total), kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref),
      static_cast<const float*>(mat12), static_cast<const float*>(depth),
      static_cast<const float*>(dout), static_cast<float*>(d_src), static_cast<float*>(d_ref),
      B, D, H, W, Hs, Ws);
  return cudaGetLastError();
}

template <typename T, int C, int G>
cudaError_t launch_neighbor_bwd(const void* ref, const void* gx, const void* gy,
                                const void* dout, void* d_gx, void* d_gy, int B, int K, int H,
                                int W, cudaStream_t stream) {
  const long long total = (long long)B * K * H * W;
  if (total == 0) return cudaSuccess;
  neighbor_corr_bwd_kernel<T, C, G><<<num_blocks(total), kThreads, 0, stream>>>(
      static_cast<const T*>(ref), static_cast<const float*>(gx),
      static_cast<const float*>(gy), static_cast<const float*>(dout),
      static_cast<float*>(d_gx), static_cast<float*>(d_gy), B, K, H, W);
  return cudaGetLastError();
}

}  // namespace pmn

#define PMN_BWD_CASES(LAUNCH, ...)                                              \
  if (C == 16 && G == 4)                                                        \
    return (int)(bf16 ? LAUNCH<__nv_bfloat16, 16, 4>(__VA_ARGS__)               \
                      : LAUNCH<float, 16, 4>(__VA_ARGS__));                     \
  if (C == 32 && G == 8)                                                        \
    return (int)(bf16 ? LAUNCH<__nv_bfloat16, 32, 8>(__VA_ARGS__)               \
                      : LAUNCH<float, 32, 8>(__VA_ARGS__));                     \
  if (C == 64 && G == 8)                                                        \
    return (int)(bf16 ? LAUNCH<__nv_bfloat16, 64, 8>(__VA_ARGS__)               \
                      : LAUNCH<float, 64, 8>(__VA_ARGS__));                     \
  return (int)cudaErrorInvalidValue;

// src [B,Hs,Ws,C], ref [B,H,W,C] (f32 or bf16), mat12 [B,12] f32,
// depth [B,D,H,W] f32, dout [B,G,D,H,W] f32 -> d_src [B,Hs,Ws,C] f32 and
// d_ref [B,H,W,C] f32, both zeroed by the caller and accumulated into.
extern "C" int pmn_warp_group_corr_backward(const void* src, const void* ref, const void* mat12,
                                            const void* depth, const void* dout, void* d_src,
                                            void* d_ref, int B, int D, int H, int W, int Hs,
                                            int Ws, int C, int G, int bf16, void* stream) {
  PMN_BWD_CASES(pmn::launch_warp_bwd, src, ref, mat12, depth, dout, d_src, d_ref, B, D, H, W,
                Hs, Ws, static_cast<cudaStream_t>(stream))
}

// ref [B,H,W,C] (f32 or bf16), gx/gy [B,K,H,W] f32, dout [B,G,K,H,W] f32
// -> d_gx, d_gy [B,K,H,W] f32 (every element written).
extern "C" int pmn_neighbor_group_corr_backward(const void* ref, const void* gx, const void* gy,
                                                const void* dout, void* d_gx, void* d_gy, int B,
                                                int K, int H, int W, int C, int G, int bf16,
                                                void* stream) {
  PMN_BWD_CASES(pmn::launch_neighbor_bwd, ref, gx, gy, dout, d_gx, d_gy, B, K, H, W,
                static_cast<cudaStream_t>(stream))
}
