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
// What bounds it on an H100: loads. Per output it reads 4 taps of x (f32)
// and of the cost for each of the 9 neighbours, plus the neighbour's grid
// coordinates and feature weight, against ~30 flops of arithmetic; the
// [B,H,W,D] inputs (stage 1: 8 MB of x) stay in L2. Design: one thread per
// (b, pixel, d) with d fastest, so a warp's tap loads of one neighbour hit
// contiguous D-runs and the per-pixel grid/weight loads are broadcast. The
// TPU version's u16 fixed-point x and bf16-bit cost packing and its lane
// packing of neighbours are gone: x is sampled in f32, the cost in its own
// dtype, and any D works.

#include "common.cuh"

namespace pmn {

template <typename TC>
__global__ void __launch_bounds__(kThreads) eval_grid_score_kernel(
    const float* __restrict__ xnorm, const TC* __restrict__ cost,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ fw, float* __restrict__ out, int B, int K, int H, int W, int D,
    float inv_interval) {
  const long long hw = (long long)H * W;
  const long long total = (long long)B * hw * D;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = (int)(idx % D);
  const long long bp = idx / D;
  const long long pix = bp % hw;
  const int b = (int)(bp / hw);

  const float xc = xnorm[idx];
  const long long plane = (long long)b * hw * D + d;  // (b, pixel 0, d)
  float num = 0.0f, den = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long gi = ((long long)b * K + k) * hw + pix;
    const float sx = unnormalize_border(gx[gi], W);
    const float sy = unnormalize_border(gy[gi], H);
    // border cell: x0 in [0, W-2], so fx may be 1 at the last column
    const float x0f = fminf(fmaxf(floorf(sx), 0.0f), (float)(W - 2));
    const float y0f = fminf(fmaxf(floorf(sy), 0.0f), (float)(H - 2));
    const float fx = sx - x0f, fy = sy - y0f;
    const float w00 = (1.0f - fx) * (1.0f - fy);
    const float w01 = fx * (1.0f - fy);
    const float w10 = (1.0f - fx) * fy;
    const float w11 = fx * fy;
    const long long t00 = plane + ((long long)y0f * W + (long long)x0f) * D;
    const long long t01 = t00 + D;
    const long long t10 = t00 + (long long)W * D;
    const long long t11 = t10 + D;
    const float xs = xnorm[t00] * w00 + xnorm[t01] * w01 + xnorm[t10] * w10 + xnorm[t11] * w11;
    const float cs = to_float(cost[t00]) * w00 + to_float(cost[t01]) * w01 +
                     to_float(cost[t10]) * w10 + to_float(cost[t11]) * w11;
    const float diff = fminf(fmaxf(fabsf(xs - xc) * inv_interval, 0.0f), 4.0f);
    const float dw = 1.0f / (1.0f + expf(-(4.0f - 2.0f * diff)));
    const float wk = dw * fw[gi];
    num += wk * cs;
    den += wk;
  }
  out[idx] = num / den;
}

template <typename TC>
cudaError_t launch_score(const void* xnorm, const void* cost, const void* gx, const void* gy,
                         const void* fw, void* out, int B, int K, int H, int W, int D,
                         float inv_interval, cudaStream_t stream) {
  const long long total = (long long)B * H * W * D;
  if (total == 0) return cudaSuccess;
  eval_grid_score_kernel<TC><<<num_blocks(total), kThreads, 0, stream>>>(
      static_cast<const float*>(xnorm), static_cast<const TC*>(cost),
      static_cast<const float*>(gx), static_cast<const float*>(gy),
      static_cast<const float*>(fw), static_cast<float*>(out), B, K, H, W, D, inv_interval);
  return cudaGetLastError();
}

}  // namespace pmn

// xnorm [B,H,W,D] f32, cost [B,H,W,D] (f32 or bf16), gx/gy/fw [B,K,H,W] f32
// -> out [B,H,W,D] f32.
extern "C" int pmn_eval_grid_score(const void* xnorm, const void* cost, const void* gx,
                                   const void* gy, const void* fw, void* out, int B, int K,
                                   int H, int W, int D, float inv_interval, int cost_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(cost_bf16 ? pmn::launch_score<__nv_bfloat16>(xnorm, cost, gx, gy, fw, out, B, K,
                                                             H, W, D, inv_interval, s)
                         : pmn::launch_score<float>(xnorm, cost, gx, gy, fw, out, B, K, H, W,
                                                    D, inv_interval, s));
}
