// K8 variance_volume: CasMVSNet's variance cost volume, fused.
//
// Replaces no TPU kernel: the JAX package has no cost-volume network. It
// was added for CasMVSNet (Gu et al., CVPR 2020), whose published code
// (`cas_mvsnet.py` `DepthNet`) warps every source feature map to every
// depth plane with grid_sample, materialising N - 1 warped volumes [B, C,
// D, H, W] in f32 (510 MB each at stage 2 of DTU's 1152x864), and sums
// them and their squares into two more before taking the variance.
//
//   var[b, d, y, x, c] = sum_v f_v^2 / N - (sum_v f_v / N)^2
//
// over the N views, the reference view's feature f_0 = ref[b, y, x, c]
// counted at every plane and each source view's f_v the bilinear tap
// (zeros padding, align_corners=True) of src[b, v] at the homography warp
// of (x, y) at depth[b, d, y, x].
//
// What bounds it on an H100: the volume written once, at 2 bytes a value
// (stage 2: 255 MB, 76 us at 3.35 TB/s), against ~11 f32 operations a value
// and view (the bilinear taps and the two sums: 105 us at 67 TFLOP/s). The
// source maps (4-16 MB a view) are read through L2 many times over, once
// for each plane.
// Design: one thread per (b, d, pixel, 16-byte vector of channels); the
// C / N threads of a sample are neighbouring lanes, so a warp writes one
// contiguous run of the [B, D, H, W, C] volume. Each thread warps its pixel
// through common.cuh's `warp_taps` (the projection, rounding and validity
// K1 and K6 use), reads its vector of the four corners with `load_taps`,
// keeps sum and sum of squares of its channels in f32 registers over the
// views, and stores the variance once in the payload dtype. Nothing of
// the warped volumes reaches device memory.
// Departure from the published code, shared with K1/K6: a point at or
// behind the source camera (pz <= 1e-3) reads zero.

#include "common.cuh"

namespace pmn {

// N consecutive floats stored as one 16-byte vector of T (round to nearest
// even for bf16).
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v);

template <>
__device__ __forceinline__ void store_vec<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16>(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    variance_volume_kernel(const T* __restrict__ ref, const T* __restrict__ src,
                           const float* __restrict__ mats, const float* __restrict__ depth,
                           T* __restrict__ out, int V, int D, int H, int W, long long total) {
  constexpr int N = VecLoad<T>::N;
  constexpr int L = C / N;  // lanes of one sample
  static_assert(C % N == 0, "channels in whole 16-byte vectors");
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int c = (int)(t % L) * N;
  const long long voxel = t / L;  // (b, d, pixel), the index of depth [B, D, H, W]
  const long long hw = (long long)H * W;
  const long long pix = voxel % hw;
  const int b = (int)(voxel / hw / D);
  const float u = (float)(pix % W), v = (float)(pix / W);
  const float dep = __ldg(depth + voxel);

  float sum[N], sq[N], tap[N];
  VecLoad<T>::load(ref + ((long long)b * hw + pix) * C + c, sum);
#pragma unroll
  for (int i = 0; i < N; ++i) sq[i] = __fmul_rn(sum[i], sum[i]);
  for (int s = 0; s < V; ++s) {
    const long long view = (long long)b * V + s;
    float m[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) m[k] = __ldg(mats + view * 12 + k);
    const Taps taps = warp_taps(m, u, v, dep, H, W);
    const Corners<T, C> corner(src + view * hw * C, (long long)taps.y0 * W + taps.x0, W);
    uint4 raw[4];
    load_taps(corner, c, taps, raw);
    float warped[N];
#pragma unroll
    for (int i = 0; i < N; ++i) warped[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!taps.valid[k]) continue;
      VecLoad<T>::widen(raw[k], tap);
#pragma unroll
      for (int i = 0; i < N; ++i) warped[i] = __fmaf_rn(tap[i], taps.w[k], warped[i]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sum[i] = __fadd_rn(sum[i], warped[i]);
      sq[i] = __fadd_rn(sq[i], __fmul_rn(warped[i], warped[i]));
    }
  }
  const float n = (float)(V + 1);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float mean = __fdiv_rn(sum[i], n);
    sum[i] = __fsub_rn(__fdiv_rn(sq[i], n), __fmul_rn(mean, mean));
  }
  store_vec<T>(out + voxel * C + c, sum);
}

template <typename T, int C>
cudaError_t launch_variance(const void* ref, const void* src, const void* mats,
                            const void* depth, void* out, int B, int V, int D, int H, int W,
                            cudaStream_t stream) {
  const long long total = (long long)B * D * H * W * (C / VecLoad<T>::N);
  if (total == 0) return cudaSuccess;
  variance_volume_kernel<T, C><<<num_blocks(total), kThreads, 0, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src), static_cast<const float*>(mats),
      static_cast<const float*>(depth), static_cast<T*>(out), V, D, H, W, total);
  return cudaGetLastError();
}

}  // namespace pmn

// ref [B,H,W,C], src [B,V,H,W,C] (f32 or bf16), mats [B,V,12] f32,
// depth [B,D,H,W] f32 -> out [B,D,H,W,C] in the payload dtype; C of 8, 16,
// 32 or 64 (CasMVSNet's FPN gives 32, 16, 8).
extern "C" int pmn_variance_volume(const void* ref, const void* src, const void* mats,
                                   const void* depth, void* out, int B, int V, int D, int H,
                                   int W, int C, int bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define PMN_CASE(CC)                                                                         \
  if (C == CC) {                                                                             \
    return (int)(bf16 ? pmn::launch_variance<__nv_bfloat16, CC>(ref, src, mats, depth, out, \
                                                                 B, V, D, H, W, s)           \
                      : pmn::launch_variance<float, CC>(ref, src, mats, depth, out, B, V, D, \
                                                        H, W, s));                           \
  }
  PMN_CASE(8)
  PMN_CASE(16)
  PMN_CASE(32)
  PMN_CASE(64)
#undef PMN_CASE
  return (int)cudaErrorInvalidValue;
}
