// K2 eval_grid_score: the adaptive spatial aggregation tail of PatchMatch
// evaluation, before the softmax.
//
// Replaces patchmatchnet_tpu/ops/pallas/eval_tail.py `_kernel` (launched by
// `_pallas_score`). At each of the K learned eval-grid neighbours
// (align_corners=False, border padding) it samples the normalized inverse
// depth x and the matching cost, weights the neighbour by
// sigmoid(4 - 2 * clip(|x_k - x_c| / interval, 0, 4)) * feature_weight_k and
// returns score = sum_k w_k c_k / sum_k w_k.
//
// What bounds it on an H100: L1 requests and issue, not HBM. The [B,H,W,D]
// inputs (stage 1: 8 MB of x) stay in L2. Per (pixel, neighbour) a thread
// reads 4 corner rows of its run of x and of the cost wherever the
// neighbour's cell lies; at D = 8 a warp's load touches up to 32 cache
// lines. Per (pixel, hypothesis, neighbour) it issues 8 bilinear
// multiply-adds, the sigmoid (an accurate expf and an IEEE division) and
// the two sums, ~35 instructions.
// Design: one thread per (b, pixel, run of R consecutive d), R = 8 where
// D % 8 == 0 (every D of the main path), else 4 where D % 4 == 0, else 1;
// the D / R threads of a pixel are neighbouring lanes.
// - Each neighbour's grid coordinates, feature weight and cell are read
//   and computed once per thread, not once per d: the planar [B, K, H, W]
//   reads coalesce over the pixels of a warp and broadcast within a
//   pixel's lanes, and the cell is common.cuh's `border_taps`, the routine
//   K3 and K5 pick their cells with.
// - Taps are 16-byte vectors of consecutive d: per corner two float4 of x
//   and one 16-byte vector of bf16 cost (two float4 of an f32 cost) at R =
//   8, 3 load instructions for 8 hypotheses where the thread-per-(pixel,
//   d) design issued 16. The centre x is read once, the R sums stay in
//   registers and the output is stored as float4s. Runs of 4 at every D
//   (one float4 of x per corner, so a load touches fewer lines at D = 8,
//   but each cell computed twice as often) measured the same on the main
//   path (PERF.md).
// - The per-d arithmetic is the thread-per-(pixel, d) design's, expression
//   for expression and in the same order, so the two give the same bits.
// The TPU version's u16 fixed-point x and bf16-bit cost packing and its
// lane packing of neighbours are gone: x is sampled in f32, the cost in its
// own dtype, and any D works.

#include "common.cuh"

namespace pmn {

// R consecutive values of T at p as f32, in 16-byte vectors where R allows
// (p is then 16-byte aligned, 8-byte for R = 4 of bf16).
template <typename T, int R>
__device__ __forceinline__ void load_run(const T* p, float (&v)[R]) {
  if constexpr (R == 1) {
    v[0] = to_float(p[0]);
  } else if constexpr (R % VecLoad<T>::N == 0) {
#pragma unroll
    for (int i = 0; i < R; i += VecLoad<T>::N) VecLoad<T>::load(p + i, v + i);
  } else {  // four bf16
    static_assert(R == 4 && sizeof(T) == 2, "run length");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

template <typename TC, int R>
__global__ void __launch_bounds__(kThreads) eval_grid_score_kernel(
    const float* __restrict__ xnorm, const TC* __restrict__ cost,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ fw, float* __restrict__ out, int B, int K, int H, int W, int D,
    float inv_interval) {
  const int L = D / R;  // threads of one pixel
  const long long hw = (long long)H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * hw * L) return;
  const int d0 = (int)(idx % L) * R;
  const long long bp = idx / L;  // b * hw + pixel
  const long long pix = bp % hw;
  const int b = (int)(bp / hw);

  float xc[R], num[R], den[R];
  load_run<float, R>(xnorm + bp * D + d0, xc);
#pragma unroll
  for (int i = 0; i < R; ++i) num[i] = den[i] = 0.0f;
  const long long plane = (long long)b * hw * D + d0;  // (b, pixel 0, d0)
  for (int k = 0; k < K; ++k) {
    const long long gi = ((long long)b * K + k) * hw + pix;
    const Taps t = border_taps(unnormalize_border(gx[gi], W), unnormalize_border(gy[gi], H),
                               H, W);
    const float fwk = fw[gi];
    const long long t00 = plane + ((long long)t.y0 * W + t.x0) * D;
    const long long t01 = t00 + D;
    const long long t10 = t00 + (long long)W * D;
    const long long t11 = t10 + D;
    float x00[R], x01[R], x10[R], x11[R], c00[R], c01[R], c10[R], c11[R];
    load_run<float, R>(xnorm + t00, x00);
    load_run<float, R>(xnorm + t01, x01);
    load_run<float, R>(xnorm + t10, x10);
    load_run<float, R>(xnorm + t11, x11);
    load_run<TC, R>(cost + t00, c00);
    load_run<TC, R>(cost + t01, c01);
    load_run<TC, R>(cost + t10, c10);
    load_run<TC, R>(cost + t11, c11);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float xs = x00[i] * t.w[0] + x01[i] * t.w[1] + x10[i] * t.w[2] + x11[i] * t.w[3];
      const float cs = c00[i] * t.w[0] + c01[i] * t.w[1] + c10[i] * t.w[2] + c11[i] * t.w[3];
      const float diff = fminf(fmaxf(fabsf(xs - xc[i]) * inv_interval, 0.0f), 4.0f);
      const float dw = 1.0f / (1.0f + expf(-(4.0f - 2.0f * diff)));
      const float wk = dw * fwk;
      num[i] += wk * cs;
      den[i] += wk;
    }
  }
  float* o = out + bp * D + d0;
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4)
      *reinterpret_cast<float4*>(o + i) = make_float4(num[i] / den[i], num[i + 1] / den[i + 1],
                                                      num[i + 2] / den[i + 2],
                                                      num[i + 3] / den[i + 3]);
  } else {
    o[0] = num[0] / den[0];
  }
}

template <typename TC, int R>
cudaError_t launch_score(const void* xnorm, const void* cost, const void* gx, const void* gy,
                         const void* fw, void* out, int B, int K, int H, int W, int D,
                         float inv_interval, cudaStream_t stream) {
  const long long threads = (long long)B * H * W * (D / R);
  if (threads == 0) return cudaSuccess;
  eval_grid_score_kernel<TC, R><<<num_blocks(threads), kThreads, 0, stream>>>(
      static_cast<const float*>(xnorm), static_cast<const TC*>(cost),
      static_cast<const float*>(gx), static_cast<const float*>(gy),
      static_cast<const float*>(fw), static_cast<float*>(out), B, K, H, W, D, inv_interval);
  return cudaGetLastError();
}

// The longest run of 8, 4 or 1 that divides D.
template <typename TC>
cudaError_t launch_score_runs(const void* xnorm, const void* cost, const void* gx,
                              const void* gy, const void* fw, void* out, int B, int K, int H,
                              int W, int D, float inv_interval, cudaStream_t stream) {
  if (D % 8 == 0)
    return launch_score<TC, 8>(xnorm, cost, gx, gy, fw, out, B, K, H, W, D, inv_interval, stream);
  if (D % 4 == 0)
    return launch_score<TC, 4>(xnorm, cost, gx, gy, fw, out, B, K, H, W, D, inv_interval, stream);
  return launch_score<TC, 1>(xnorm, cost, gx, gy, fw, out, B, K, H, W, D, inv_interval, stream);
}

}  // namespace pmn

// xnorm [B,H,W,D] f32, cost [B,H,W,D] (f32 or bf16), gx/gy/fw [B,K,H,W] f32
// -> out [B,H,W,D] f32.
extern "C" int pmn_eval_grid_score(const void* xnorm, const void* cost, const void* gx,
                                   const void* gy, const void* fw, void* out, int B, int K,
                                   int H, int W, int D, float inv_interval, int cost_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(cost_bf16
                   ? pmn::launch_score_runs<__nv_bfloat16>(xnorm, cost, gx, gy, fw, out, B, K, H,
                                                           W, D, inv_interval, s)
                   : pmn::launch_score_runs<float>(xnorm, cost, gx, gy, fw, out, B, K, H, W, D,
                                                   inv_interval, s));
}
