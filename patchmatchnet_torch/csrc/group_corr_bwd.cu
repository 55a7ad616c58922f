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
// K4: `warp_corr_bwd_merge_kernel`. A pixel's L = C / 4 lanes each own 4
// consecutive channels, so one 16-byte f32 atomic (float4 atomicAdd, sm_90)
// adds a lane's share of a corner and the L lanes add one whole corner row
// (the design before's layout; 8-channel lanes, tried first, split each
// atomic instruction across twice the sectors). A block holds 256 / L
// consecutive pixels, and a pixel's lanes walk all D of it in order:
// - Cells. Lane p warps samples p, p + L, ... with the forward's
//   `warp_taps` (so forward and backward drop the same samples), and the L
//   lanes take each cell in turn by shuffle, as K1 does.
// - Merged samples. d_warped[c] = ref[c] * dout[g(c)] / CG, and ref is
//   fixed per pixel, so every term a sample adds is ref times a scalar per
//   corner. The lanes merge consecutive samples with a valid corner that
//   fall in one cell (the same first pixel and valid corners) into
//   A[t] = sum of w_t * dout / CG; where the cell changes, and after the
//   last sample, the merged cell reads its taps once (d_ref += tap * A)
//   and adds ref * A to each valid corner of d_src with one atomic. The
//   training path's hypotheses are sorted, so consecutive ones mostly share
//   a cell; `k4_scatter_counts` (ops/warp_similarity.py) counts the merged
//   cells and the atomics.
// - d_ref. Each lane keeps its 4 channels' sums in registers over all D and
//   stores them once, in the payload dtype: no zeroing, no atomics, no
//   cast, deterministic.
// - d_src stays an f32 buffer zeroed by the caller and cast to the payload
//   dtype afterwards: a source pixel collects terms of many reference
//   pixels, and a bf16 running sum would swamp the small ones (the
//   reference accumulates its scatter in f32 for the same reason).
// - What bounds it on an H100 (PERF.md, PR 7; ptxas: 63-64 registers, no
//   spill): not its atomics, since a 2x2 window of per-position sums that
//   follows the cell halved them on the training path's layout and ran
//   slower; not occupancy, since capping the registers at 80 or 64 moved
//   a train step's K4 by under 2%. What is left is not measured (no
//   counters here): each pixel's serial walk over D, where a merged
//   cell's tap loads and each sample's dout load wait in turn.
// - Tried and dropped (PERF.md, PR 7), both slower on the training step's
//   own calls: a block per pixel tile and run of 8 hypotheses adding into
//   a shared-memory f32 accumulator over the run's box of source cells
//   (shared f32 atomics compile to compare-and-swap loops, ATOMS.CAST.SPIN,
//   and the block's serial walk left too little in flight); and the 2x2
//   window above. dout prefetched per 16 samples took 76-105 registers
//   and was 7% slower on the training step's calls than a load per sample.
//
// K5: `neighbor_corr_bwd_tile_kernel`, on K3's layout (common.cuh
// `TileLayout`: a lane owns KC consecutive channels, whole 16-byte
// vectors and whole groups; L = C / KC lanes hold one sample). A block owns TX
// consecutive reference pixels and all 9 eval-grid neighbours
// (`kGridChunk`), with (gx, gy) staged in shared memory. Each lane reads its
// KC reference channels once per pixel, and per sample its own groups'
// dout. Lane p of a pixel computes the border cell (`border_taps`, as K2 and
// K3) of samples p, p + L, ... and shares it by shuffle; every lane reduces
// its channels to partial d_fx, d_fy (the four d_w_t chained through the
// bilinear weights), the L lanes sum them with `__shfl_xor_sync`, and the
// lane that computed the cell applies the border-clamp masks and writes d_gx
// and d_gy. No atomics: deterministic, in another summation order than the
// design before. ptxas: 63-72 registers, no spill. What bounds it (PERF.md,
// PR 7): on random eval grids it takes 0.84 of the design before's time;
// on the training step's own grids, which are smooth, the same time, as
// the thread-per-sample loads coalesce there too (K3 at stage 1 in PR 6).
// Stage 1 (C = 16, 2 lanes a sample) is 0.049 of its 0.077 ms per step.

#include "common.cuh"

namespace pmn {

// Four consecutive channels of T as f32 (16 bytes of f32, 8 of bf16), and
// back.
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  __device__ __forceinline__ static float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void store(float* p, const float4& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  __device__ __forceinline__ static float4 load(const __nv_bfloat16* p) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float4& v) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  }
};

template <typename T, int C, int G>
__global__ void __launch_bounds__(kThreads) warp_corr_bwd_merge_kernel(
    const T* __restrict__ src, const T* __restrict__ ref, const float* __restrict__ mat12,
    const float* __restrict__ depth, const float* __restrict__ dout, float* __restrict__ d_src,
    T* __restrict__ d_ref, int D, int H, int W, int Hs, int Ws) {
  constexpr int L = C / 4;          // lanes of a pixel, 4 channels each
  constexpr int TX = kThreads / L;  // pixels of a block
  constexpr int CG = C / G;
  static_assert(C % 4 == 0 && CG % 4 == 0 && 32 % L == 0, "a lane's 4 channels lie in one group");
  __shared__ float m_s[12];

  const long long hw = (long long)H * W;
  const int b = blockIdx.y;
  const long long pix0 = (long long)blockIdx.x * TX;
  const int slot = threadIdx.x / L, part = threadIdx.x % L;
  if (threadIdx.x < 12) m_s[threadIdx.x] = mat12[b * 12 + threadIdx.x];
  __syncthreads();

  // Lanes of a slot past the end of H x W take part in the shuffles on the
  // last pixel, with no valid sample: they add and store nothing.
  const bool inside = pix0 + slot < hw;
  const long long pix = min(pix0 + slot, hw - 1);
  const float x = (float)(int)(pix % W), y = (float)(int)(pix / W);
  const float4 rv = Vec4<T>::load(ref + ((long long)b * hw + pix) * C + part * 4);
  const T* sbase = src + (long long)b * Hs * Ws * C + part * 4;
  float* dbase = d_src + (long long)b * Hs * Ws * C + part * 4;
  const float* gdp = dout + ((long long)b * G + part * 4 / CG) * D * hw + pix;
  const float* dp = depth + (long long)b * D * hw + pix;

  // The cell being merged (first pixel and valid corners; bits 0: none)
  // and, per corner t, A[t] = sum over its samples of w_t * dout / CG.
  int cur_cell = 0;
  unsigned int cur_bits = 0;
  float A[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float4 dref = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // One merged cell: its taps read once, d_ref += sum_t tap_t * A[t], and
  // ref * A[t] added to corner t of d_src (16-byte f32 atomics).
  auto flush = [&]() {
    float4 tap[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long at = ((long long)cur_cell + (t & 1) + (t >> 1) * Ws) * C;
      tap[t] = (cur_bits >> t) & 1u ? Vec4<T>::load(sbase + at)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!((cur_bits >> t) & 1u)) continue;
      const float a = A[t];
      dref.x = fmaf(tap[t].x, a, dref.x);
      dref.y = fmaf(tap[t].y, a, dref.y);
      dref.z = fmaf(tap[t].z, a, dref.z);
      dref.w = fmaf(tap[t].w, a, dref.w);
      const long long at = ((long long)cur_cell + (t & 1) + (t >> 1) * Ws) * C;
      atomicAdd(reinterpret_cast<float4*>(dbase + at),
                make_float4(rv.x * a, rv.y * a, rv.z * a, rv.w * a));
    }
  };

  for (int s0 = 0; s0 < D; s0 += L) {
    // lane `part` warps sample s0 + part
    int cell = 0;
    unsigned int bits = 0;
    float fx = 0.0f, fy = 0.0f;
    if (s0 + part < D && inside) {
      const Taps t = warp_taps(m_s, x, y, dp[(long long)(s0 + part) * hw], Hs, Ws);
      cell = t.y0 * Ws + t.x0;
      bits = t.valid[0] | t.valid[1] << 1 | t.valid[2] << 2 | t.valid[3] << 3;
      fx = t.fx;
      fy = t.fy;
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (s0 + i >= D) break;  // the same for the whole warp
      Taps taps;
      taps.fx = __shfl_sync(0xffffffffu, fx, i, L);
      taps.fy = __shfl_sync(0xffffffffu, fy, i, L);
      const int c = __shfl_sync(0xffffffffu, cell, i, L);
      const unsigned int v = __shfl_sync(0xffffffffu, bits, i, L);
      if (v == 0) continue;  // no valid corner (the same for a pixel's lanes)
      if (c != cur_cell || v != cur_bits) {  // a new cell: add the merged one
        if (cur_bits != 0) flush();
        cur_cell = c;
        cur_bits = v;
#pragma unroll
        for (int t = 0; t < 4; ++t) A[t] = 0.0f;
      }
      set_weights(taps);  // the forward's weights, to the bit
      const float g = gdp[(long long)(s0 + i) * hw] * (1.0f / CG);
#pragma unroll
      for (int t = 0; t < 4; ++t) A[t] = fmaf(taps.w[t], g, A[t]);
    }
  }
  if (cur_bits != 0) flush();
  if (inside) Vec4<T>::store(d_ref + ((long long)b * hw + pix) * C + part * 4, dref);
}

template <typename T, int C, int G>
__global__ void __launch_bounds__(kThreads, 3) neighbor_corr_bwd_tile_kernel(
    const T* __restrict__ ref, const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ dout, float* __restrict__ d_gx, float* __restrict__ d_gy, int K,
    int H, int W) {
  using Layout = TileLayout<T, C, G>;
  constexpr int N = Layout::N, CG = Layout::CG, KC = Layout::KC, L = Layout::L;
  constexpr int GL = Layout::GL, TX = Layout::TX;
  __shared__ float grid_s[2][kGridChunk][TX];

  const long long hw = (long long)H * W;
  const int b = blockIdx.z;
  const int k0 = blockIdx.y * kGridChunk;
  const int nk = min(kGridChunk, K - k0);
  const long long pix0 = (long long)blockIdx.x * TX;
  const int slot = threadIdx.x / L, part = threadIdx.x % L;

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float* in = a == 0 ? gx : gy;
    for (int i = threadIdx.x; i < kGridChunk * TX; i += kThreads) {
      const int j = i / TX;
      const long long p = pix0 + i % TX;
      grid_s[a][j][i % TX] = j < nk && p < hw ? in[((long long)b * K + k0 + j) * hw + p] : 0.0f;
    }
  }
  __syncthreads();

  // Lanes of a slot past the end of H x W compute on the last pixel (the
  // shuffles need every lane) and write nothing.
  const bool inside = pix0 + slot < hw;
  const long long pix = min(pix0 + slot, hw - 1);
  float rv[KC];
  const T* r = ref + ((long long)b * hw + pix) * C + part * KC;
#pragma unroll
  for (int k = 0; k < KC; k += N) VecLoad<T>::load(r + k, rv + k);
  const T* base = ref + (long long)b * hw * C + part * KC;
  const float* gdp = dout + (((long long)b * G + part * GL) * K + k0) * hw + pix;
  const long long out0 = ((long long)b * K + k0) * hw + pix;

  for (int s0 = 0; s0 < nk; s0 += L) {
    // lane `part` takes the cell of sample s0 + part
    int cell = 0;
    float fx = 0.0f, fy = 0.0f;
    bool pass_x = false, pass_y = false;
    if (s0 + part < nk) {
      const float tx = unnormalize(grid_s[0][s0 + part][slot], W);
      const float ty = unnormalize(grid_s[1][s0 + part][slot], H);
      // the clamp of the unnormalized coordinate passes the gradient only
      // where it does not bind
      pass_x = tx > 0.0f && tx < (float)(W - 1);
      pass_y = ty > 0.0f && ty < (float)(H - 1);
      const Taps t = border_taps(fminf(fmaxf(tx, 0.0f), (float)(W - 1)),
                                 fminf(fmaxf(ty, 0.0f), (float)(H - 1)), H, W);
      cell = t.y0 * W + t.x0;
      fx = t.fx;
      fy = t.fy;
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (s0 + i >= nk) break;
      const float sfx = __shfl_sync(0xffffffffu, fx, i, L);
      const float sfy = __shfl_sync(0xffffffffu, fy, i, L);
      const Corners<T, C> corner(base, __shfl_sync(0xffffffffu, cell, i, L), W);
      float gd[GL];
#pragma unroll
      for (int k = 0; k < GL; ++k) gd[k] = gdp[((long long)k * K + s0 + i) * hw] * (1.0f / CG);
      uint4 raw[KC / N][4];  // every corner is valid (border clamping)
#pragma unroll
      for (int k = 0; k < KC / N; ++k)
#pragma unroll
        for (int t = 0; t < 4; ++t) raw[k][t] = VecLoad<T>::raw(corner.p[t] + k * N);
      float dw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < KC / N; ++k) {
        float dv[N], tap[N];
#pragma unroll
        for (int e = 0; e < N; ++e) dv[e] = rv[k * N + e] * gd[(k * N + e) / CG];  // d_warped
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          VecLoad<T>::widen(raw[k][t], tap);
#pragma unroll
          for (int e = 0; e < N; ++e) dw[t] = fmaf(dv[e], tap[e], dw[t]);
        }
      }
      // w = [(1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy]; fx = sx - x0 with x0
      // piecewise constant; partial sums over this lane's channels
      float dfx = (dw[1] - dw[0]) * (1.0f - sfy) + (dw[3] - dw[2]) * sfy;
      float dfy = (dw[2] - dw[0]) * (1.0f - sfx) + (dw[3] - dw[1]) * sfx;
#pragma unroll
      for (int o = L / 2; o > 0; o /= 2) {
        dfx += __shfl_xor_sync(0xffffffffu, dfx, o, L);
        dfy += __shfl_xor_sync(0xffffffffu, dfy, o, L);
      }
      if (part == i && inside) {
        // d sx / d gx = W / 2 (align_corners=False unnormalization)
        d_gx[out0 + (long long)(s0 + i) * hw] = pass_x ? dfx * (0.5f * (float)W) : 0.0f;
        d_gy[out0 + (long long)(s0 + i) * hw] = pass_y ? dfy * (0.5f * (float)H) : 0.0f;
      }
    }
  }
}

template <typename T, int C, int G>
cudaError_t launch_warp_bwd(const void* src, const void* ref, const void* mat12,
                            const void* depth, const void* dout, void* d_src, void* d_ref,
                            int B, int D, int H, int W, int Hs, int Ws, cudaStream_t stream) {
  constexpr int TX = kThreads / (C / 4);
  const long long hw = (long long)H * W;
  if (B == 0 || hw == 0) return cudaSuccess;
  const dim3 grid((unsigned int)((hw + TX - 1) / TX), B);
  warp_corr_bwd_merge_kernel<T, C, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref),
      static_cast<const float*>(mat12), static_cast<const float*>(depth),
      static_cast<const float*>(dout), static_cast<float*>(d_src), static_cast<T*>(d_ref), D,
      H, W, Hs, Ws);
  return cudaGetLastError();
}

template <typename T, int C, int G>
cudaError_t launch_neighbor_bwd(const void* ref, const void* gx, const void* gy,
                                const void* dout, void* d_gx, void* d_gy, int B, int K, int H,
                                int W, cudaStream_t stream) {
  constexpr int TX = TileLayout<T, C, G>::TX;
  const long long hw = (long long)H * W;
  if (B == 0 || K == 0 || hw == 0) return cudaSuccess;
  const dim3 grid((unsigned int)((hw + TX - 1) / TX), (K + kGridChunk - 1) / kGridChunk, B);
  neighbor_corr_bwd_tile_kernel<T, C, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(ref), static_cast<const float*>(gx),
      static_cast<const float*>(gy), static_cast<const float*>(dout),
      static_cast<float*>(d_gx), static_cast<float*>(d_gy), K, H, W);
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
// depth [B,D,H,W] f32, dout [B,G,D,H,W] f32 -> d_src [B,Hs,Ws,C] f32,
// zeroed by the caller and accumulated into, and d_ref [B,H,W,C] in the
// payload dtype (every element written).
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
