// K1 warp_group_corr, K3 neighbor_group_corr, K6 warp_group_corr_views and
// K7 coord_group_corr: bilinear taps of a feature map at per-sample
// coordinates, times the reference feature, reduced to group means.
//
// Replaces four TPU kernels (patchmatchnet_tpu/ops/pallas/):
// - K1: windowed_similarity.py `_kernel_proj` (launched by
//   `_pallas_windowed_proj`). Warp coordinates come from the [B,12]
//   projection and the depth hypotheses; zeros padding, align_corners=True;
//   samples with pz <= 1e-3 are pushed to (W, H) and read zero.
// - K6: windowed_similarity.py `_kernel_proj_views` (launched by
//   `_pallas_windowed_proj_views`), the fused-views inference path: K1 for
//   all V source views, weighted by per-pixel view weights and summed,
//   out = sum_v vw[b, v] * K1(src[b, v], mats[b, v]). Each view's K1 value
//   is multiplied by its weight with __fmul_rn and added to a register sum
//   with __fadd_rn in view order 0..V-1, so K6 equals, bit for bit, the
//   per-view route it replaces (V K1 volumes, each times its weights, added
//   to a zeroed sum as separate tensor ops).
// - K3: similarity_kernel.py `_kernel` (launched by `_pallas_impl`) as used
//   by `_feature_weight_corr`: coordinates from the eval grid (gx, gy),
//   align_corners=False with border clamping, the reference feature as the
//   source and the Ke neighbours in the depth slot. The [P, 4C] taps array
//   the TPU path gathers first never exists here.
// - K7: windowed_similarity.py `_kernel` (launched by `_pallas_windowed`):
//   K1 with the source pixel coordinates (ix, iy) given per sample instead
//   of computed from the projection. K1 is "warp, then K7": both pick a
//   sample's cell with `coord_taps` and reduce it with `load_taps` and
//   `correlate_taps` (common.cuh), so K7 on K1's warp coordinates equals K1
//   to the bit.
//
// What bounds K1, K3 and K6 on an H100: not HBM. The source maps (at most
// 8 MB a view, 32 MB for K6's four at stage 1; K3's is the reference map)
// stay in the 50 MB L2, and a launch needs 28-84 MB of device-memory
// traffic. Each sample reads 4 corner rows of C channels (stage 3 bf16: 4
// x 128 B) wherever its cell lies, so the limits are the L1 requests those
// reads make and the instructions issued per sample: the cell (K1, K6: the
// warp's two IEEE divisions), and per channel a widening and 4 + 1
// multiply-adds, the same in every design.
//
// K1, K3 and K6: the tiled kernel, `group_corr_tile_kernel`, one body for
// three sources of a sample's cell (`Samples`): K1 warps depth hypotheses
// through one projection, K6 through V, each pixel's view weights applied,
// and K3 takes the eval grid's neighbours of the reference itself.
// - Lanes split across channels. A lane owns KC consecutive channels, whole
//   16-byte vectors and whole groups: one group of 8 at stage 3 (bf16: one
//   vector; f32: two), two groups of 4 in one bf16 vector at stages 2 and
//   1, one group of 4 in one f32 vector. L = C / KC neighbouring lanes hold
//   one sample, so one load instruction reads 32 / L whole corner rows
//   (stage 3 bf16: 4 rows of 128 B) in whole 32-byte sectors, where the
//   thread-per-sample design touched 32 rows at 16 B each. No group sum
//   crosses lanes, and each lane sums its groups with `correlate_taps` in
//   channel order, corners t = 0..3 in order, invalid corners skipped: the
//   arithmetic of the thread-per-sample kernel, to the bit.
// - Tile. A block of 256 threads owns TX = 256 / L consecutive reference
//   pixels (row-major over H x W, so a tile may cross a row) and a chunk
//   of samples per pixel: kHypChunk hypotheses (K1, K6) or kGridChunk
//   eval-grid neighbours (K3: all 9 of the model's). It reads the chunk's
//   depths or grid coordinates, each view's projection and (K6) each
//   pixel's view weights once, into shared memory; each lane reads its
//   reference channels once, into registers, for every sample of the
//   chunk.
// - One warp per sample. A pixel's samples s = j * V + v (hypothesis or
//   neighbour j, view v; K3 has V = 1) go L at a time: lane p computes the
//   cell of sample s0 + p, and the L lanes take each cell in turn by
//   shuffle (first pixel, fractions and, for K1 and K6, validity; the
//   weights are recomputed from the fractions by the same `set_weights`,
//   so they are the cell lane's to the bit). K1 and K6 warp with the unchanged `warp_taps` (K4
//   shares it, so forward and backward pick the same cells); K3 takes the
//   border cell of `border_taps` (K2 and K5 pick theirs with it). At 64
//   registers a thread 4 blocks fit an SM; issuing two samples' loads
//   together took more registers and was slower.
// - Staged stores. The output is [B, G, D, H, W], x fastest (K3: the
//   neighbours in the D slot), while a lane ends with its pixel's GL groups
//   of each sample. The block writes them to shared memory and then stores
//   each (g, d) row of TX consecutive pixels with consecutive threads, 16
//   bytes each where H x W is a multiple of 4 and the tile lies inside it,
//   masking ragged ends (H x W not a multiple of TX, D not a multiple of
//   the chunk) otherwise. K6's weights and projections take V * (TX + 12)
//   floats of dynamic shared memory, within the 48 KB a block gets without
//   opting in for V <= 50 at every stage; a launch with more views fails,
//   and the wrapper raises.
// The TPU kernel's source window (and its escape counter) does not exist:
// every sample reads the source directly, so none is lost.
//
// K7 keeps the thread-per-sample design (`group_corr_kernel`): one thread
// per (b, d, pixel), x fastest, each reading its sample's 4 corners x C
// channels in 16-byte vectors. K7 has no model path and is the measured
// baseline of that design beside K1.

#include "common.cuh"

namespace pmn {

// K7: one thread per (b, d, pixel) at source pixel coordinates (ix, iy).
template <typename T, int C, int G>
__global__ void __launch_bounds__(kThreads) group_corr_kernel(
    const T* __restrict__ src, const T* __restrict__ ref, const float* __restrict__ ix,
    const float* __restrict__ iy, float* __restrict__ out, int B, int D, int H, int W, int Hs,
    int Ws) {
  constexpr int CG = C / G;

  const long long hw = (long long)H * W;
  const long long total = (long long)B * D * hw;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long pix = idx % hw;
  const long long bd = idx / hw;
  const int d = (int)(bd % D);
  const int b = (int)(bd / D);

  const Taps taps = coord_taps(ix[idx], iy[idx], Hs, Ws);
  float res[G];
  group_sums<T, C, G>(src + (long long)b * Hs * Ws * C, Ws, taps,
                      ref + ((long long)b * hw + pix) * C, res);
  float* o = out + ((long long)b * G * D + d) * hw + pix;
#pragma unroll
  for (int g = 0; g < G; ++g) o[(long long)g * D * hw] = res[g] * (1.0f / CG);
}

// Where the tiled kernel's samples come from.
enum class Samples {
  kWarp,   // K1: depth hypotheses warped through one projection
  kViews,  // K6: the same through V projections, weighted per view
  kGrid,   // K3: eval-grid neighbours (gx, gy) of the reference itself
};

// Samples one block of the tiled kernel computes for each of its pixels:
// hypotheses (K1, K6), or eval-grid neighbours (K3, common.cuh `kGridChunk`).
constexpr int kHypChunk = 8;

template <Samples kMode>
constexpr int kChunkOf = kMode == Samples::kGrid ? kGridChunk : kHypChunk;

// K1 (kWarp: V = 1, no weights), K6 (kViews) and K3 (kGrid: src = ref, V =
// 1). s0 and s1 are the per-sample inputs [B, D, H, W]: the depths (s1
// unused), or the grid gx and gy.
template <typename T, int C, int G, Samples kMode>
__global__ void __launch_bounds__(kThreads, 4) group_corr_tile_kernel(
    const T* __restrict__ src, const T* __restrict__ ref, const float* __restrict__ mats,
    const float* __restrict__ s0_in, const float* __restrict__ s1_in,
    const float* __restrict__ vw, float* __restrict__ out, int V, int D, int H, int W, int Hs,
    int Ws) {
  using Layout = TileLayout<T, C, G>;
  constexpr int N = Layout::N, CG = Layout::CG, KC = Layout::KC, L = Layout::L;
  constexpr int GL = Layout::GL, TX = Layout::TX;
  constexpr bool kViews = kMode == Samples::kViews;
  constexpr int kChunk = kChunkOf<kMode>;
  constexpr int kInputs = kMode == Samples::kGrid ? 2 : 1;  // depth, or (gx, gy)
  // + 1: the L lanes of a slot write L rows at once; the padding spreads
  // them over the banks
  __shared__ float staged[G][kChunk][TX + 1];
  __shared__ float smp_s[kInputs][kChunk][TX];
  extern __shared__ float views_s[];  // projections [V][12], then K6's weights [V][TX]
  float* mats_s = views_s;
  float* vw_s = views_s + V * 12;

  const long long hw = (long long)H * W;
  const int b = blockIdx.z;
  const int d0 = blockIdx.y * kChunk;
  const int nd = min(kChunk, D - d0);
  const long long pix0 = (long long)blockIdx.x * TX;
  const int slot = threadIdx.x / L;
  const int part = threadIdx.x % L;

  // The block's inputs other than the maps, read once: the chunk's depths
  // or grid coordinates, each view's projection and (K6) each pixel's view
  // weights.
#pragma unroll
  for (int a = 0; a < kInputs; ++a) {
    const float* in = a == 0 ? s0_in : s1_in;
    for (int i = threadIdx.x; i < kChunk * TX; i += kThreads) {
      const int j = i / TX;
      const long long p = pix0 + i % TX;
      smp_s[a][j][i % TX] = j < nd && p < hw ? in[((long long)b * D + d0 + j) * hw + p] : 0.0f;
    }
  }
  if constexpr (kMode != Samples::kGrid) {
    for (int i = threadIdx.x; i < V * 12; i += kThreads)
      mats_s[i] = mats[(long long)b * V * 12 + i];
  }
  if constexpr (kViews) {
    for (int i = threadIdx.x; i < V * TX; i += kThreads) {
      const long long p = pix0 + i % TX;
      vw_s[i] = p < hw ? vw[((long long)b * V + i / TX) * hw + p] : 0.0f;
    }
  }
  __syncthreads();

  // Lanes of a slot past the end of H x W compute on the last pixel (the
  // shuffles below need every lane) and their results are not stored.
  const long long pix = min(pix0 + slot, hw - 1);
  const float x = (float)(int)(pix % W), y = (float)(int)(pix / W);
  float rv[KC];
  const T* r = ref + ((long long)b * hw + pix) * C + part * KC;
#pragma unroll
  for (int k = 0; k < KC; k += N) VecLoad<T>::load(r + k, rv + k);
  const T* base0 = src + (long long)b * V * Hs * Ws * C + part * KC;
  const long long view_stride = (long long)Hs * Ws * C;
  float m1[12];  // K1's one projection, in registers
  if constexpr (kMode == Samples::kWarp) {
#pragma unroll
    for (int i = 0; i < 12; ++i) m1[i] = mats_s[i];
  }

  // The slot's samples s = j * V + v (sample j of the chunk, view v), L at
  // a time: lane `part` computes the cell of sample s0 + part, and the
  // slot's L lanes then reduce the L samples one after another with its
  // cell, shuffled.
  const int S = nd * V;
  float res[GL];
#pragma unroll
  for (int k = 0; k < GL; ++k) res[k] = 0.0f;
  int j = 0, v = 0;
  for (int s0 = 0; s0 < S; s0 += L) {
    int cell = 0, valid = 0;
    float fx = 0.0f, fy = 0.0f;
    const int s = s0 + part;
    if (s < S) {
      const int sj = s / V;
      Taps t;
      if constexpr (kMode == Samples::kGrid) {
        t = border_taps(unnormalize_border(smp_s[0][sj][slot], Ws),
                        unnormalize_border(smp_s[1][sj][slot], Hs), Hs, Ws);
      } else {
        const float* m = kViews ? mats_s + (s - sj * V) * 12 : m1;
        t = warp_taps(m, x, y, smp_s[0][sj][slot], Hs, Ws);
      }
      cell = t.y0 * Ws + t.x0;
      fx = t.fx;
      fy = t.fy;
      valid = t.valid[0] | t.valid[1] << 1 | t.valid[2] << 2 | t.valid[3] << 3;
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (s0 + i >= S) break;
      Taps taps;
      taps.fx = __shfl_sync(0xffffffffu, fx, i, L);
      taps.fy = __shfl_sync(0xffffffffu, fy, i, L);
      // every corner of an eval-grid cell is valid (border clamping); a
      // constant here also drops K3's per-corner validity tests
      const int bits = kMode == Samples::kGrid ? 0xF : __shfl_sync(0xffffffffu, valid, i, L);
#pragma unroll
      for (int t = 0; t < 4; ++t) taps.valid[t] = (bits >> t) & 1;
      set_weights(taps);  // the cell lane's weights, to the bit
      const Corners<T, C> corner(base0 + v * view_stride, __shfl_sync(0xffffffffu, cell, i, L),
                                 Ws);
      uint4 raw[KC / N][4];  // every load of the sample before its arithmetic
#pragma unroll
      for (int k = 0; k < KC / N; ++k) load_taps<T, C>(corner, k * N, taps, raw[k]);
      float acc[GL];
#pragma unroll
      for (int k = 0; k < GL; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < KC / N; ++k)
        correlate_taps<T, CG>(raw[k], taps, rv + k * N, acc + k * N / CG);
#pragma unroll
      for (int k = 0; k < GL; ++k) {
        if constexpr (kViews) {
          const float weight = vw_s[v * TX + slot];
          res[k] = __fadd_rn(res[k], __fmul_rn(__fmul_rn(acc[k], 1.0f / CG), weight));
        } else {
          res[k] = acc[k] * (1.0f / CG);
        }
      }
      if (++v == V) {  // sample j is summed over every view
#pragma unroll
        for (int k = 0; k < GL; ++k) {
          staged[part * GL + k][j][slot] = res[k];
          res[k] = 0.0f;
        }
        v = 0;
        ++j;
      }
    }
  }

  // Stores: each (g, j) row of the tile's consecutive pixels, 4 at a time
  // where the rows are 16-byte aligned and the tile lies inside H x W.
  __syncthreads();
  float* o = out + (long long)b * G * D * hw + (long long)d0 * hw + pix0;
  if (hw % 4 == 0 && pix0 + TX <= hw) {
    for (int i = threadIdx.x; i < G * kChunk * (TX / 4); i += kThreads) {
      const int px = 4 * (i % (TX / 4)), row = i / (TX / 4);
      const int jj = row % kChunk, g = row / kChunk;
      if (jj < nd) {
        const float* st = &staged[g][jj][px];
        *reinterpret_cast<float4*>(o + ((long long)g * D + jj) * hw + px) =
            make_float4(st[0], st[1], st[2], st[3]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < G * kChunk * TX; i += kThreads) {
      const int px = i % TX, row = i / TX;
      const int jj = row % kChunk, g = row / kChunk;
      if (jj < nd && pix0 + px < hw) o[((long long)g * D + jj) * hw + px] = staged[g][jj][px];
    }
  }
}

template <typename T, int C, int G>
cudaError_t launch_per_sample(const void* src, const void* ref, const void* ix, const void* iy,
                              void* out, int B, int D, int H, int W, int Hs, int Ws,
                              cudaStream_t stream) {
  const long long total = (long long)B * D * H * W;
  if (total == 0) return cudaSuccess;
  group_corr_kernel<T, C, G><<<num_blocks(total), kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref), static_cast<const float*>(ix),
      static_cast<const float*>(iy), static_cast<float*>(out), B, D, H, W, Hs, Ws);
  return cudaGetLastError();
}

template <typename T, int C, int G, Samples kMode>
cudaError_t launch_tiled(const void* src, const void* ref, const void* mats, const void* s0_in,
                         const void* s1_in, const void* vw, void* out, int B, int V, int D,
                         int H, int W, int Hs, int Ws, cudaStream_t stream) {
  constexpr int TX = TileLayout<T, C, G>::TX;
  constexpr int kChunk = kChunkOf<kMode>;
  const long long hw = (long long)H * W;
  if (B == 0 || D == 0 || hw == 0) return cudaSuccess;
  const dim3 grid((unsigned int)((hw + TX - 1) / TX), (D + kChunk - 1) / kChunk, B);
  const size_t views_bytes = kMode == Samples::kGrid   ? 0
                             : kMode == Samples::kViews ? sizeof(float) * V * (12 + TX)
                                                        : sizeof(float) * V * 12;
  group_corr_tile_kernel<T, C, G, kMode><<<grid, kThreads, views_bytes, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(ref), static_cast<const float*>(mats),
      static_cast<const float*>(s0_in), static_cast<const float*>(s1_in),
      static_cast<const float*>(vw), static_cast<float*>(out), V, D, H, W, Hs, Ws);
  return cudaGetLastError();
}

// A (payload, C, G) instantiation, passed to the launch lambdas of `dispatch`.
template <typename T_, int C_, int G_>
struct Inst {
  using T = T_;
  static constexpr int C = C_, G = G_;
};

// Calls launch(Inst<T, C, G>{}) for the instantiated (C, G) pairs (stages 1,
// 2, 3) and payloads; anything else is cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch(int C, int G, int bf16, F launch) {
#define PMN_CASE(CC, GG)                                                          \
  if (C == CC && G == GG) {                                                       \
    return bf16 ? launch(Inst<__nv_bfloat16, CC, GG>{}) : launch(Inst<float, CC, GG>{}); \
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
  return (int)pmn::dispatch(C, G, bf16, [&](auto inst) {
    using I = decltype(inst);
    return pmn::launch_tiled<typename I::T, I::C, I::G, pmn::Samples::kWarp>(
        src, ref, mat12, depth, nullptr, nullptr, out, B, 1, D, H, W, Hs, Ws,
        static_cast<cudaStream_t>(stream));
  });
}

// ref [B,H,W,C] (f32 or bf16), gx/gy [B,K,H,W] f32 -> out [B,G,K,H,W] f32.
extern "C" int pmn_neighbor_group_corr(const void* ref, const void* gx, const void* gy,
                                       void* out, int B, int K, int H, int W, int C, int G,
                                       int bf16, void* stream) {
  return (int)pmn::dispatch(C, G, bf16, [&](auto inst) {
    using I = decltype(inst);
    return pmn::launch_tiled<typename I::T, I::C, I::G, pmn::Samples::kGrid>(
        ref, ref, nullptr, gx, gy, nullptr, out, B, 1, K, H, W, H, W,
        static_cast<cudaStream_t>(stream));
  });
}

// src [B,Hs,Ws,C], ref [B,H,W,C] (f32 or bf16), ix/iy [B,D,H,W] f32 source
// pixel coordinates (align_corners=True, may be off the image)
// -> out [B,G,D,H,W] f32.
extern "C" int pmn_coord_group_corr(const void* src, const void* ref, const void* ix,
                                    const void* iy, void* out, int B, int D, int H, int W,
                                    int Hs, int Ws, int C, int G, int bf16, void* stream) {
  return (int)pmn::dispatch(C, G, bf16, [&](auto inst) {
    using I = decltype(inst);
    return pmn::launch_per_sample<typename I::T, I::C, I::G>(
        src, ref, ix, iy, out, B, D, H, W, Hs, Ws, static_cast<cudaStream_t>(stream));
  });
}

// src [B,V,Hs,Ws,C], ref [B,H,W,C] (f32 or bf16), mats [B,V,12] f32,
// depth [B,D,H,W] f32, vw [B,V,H,W] f32 -> out [B,G,D,H,W] f32.
extern "C" int pmn_warp_group_corr_views(const void* src, const void* ref, const void* mats,
                                         const void* depth, const void* vw, void* out, int B,
                                         int V, int D, int H, int W, int Hs, int Ws, int C, int G,
                                         int bf16, void* stream) {
  return (int)pmn::dispatch(C, G, bf16, [&](auto inst) {
    using I = decltype(inst);
    return pmn::launch_tiled<typename I::T, I::C, I::G, pmn::Samples::kViews>(
        src, ref, mats, depth, nullptr, vw, out, B, V, D, H, W, Hs, Ws,
        static_cast<cudaStream_t>(stream));
  });
}

extern "C" const char* pmn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
