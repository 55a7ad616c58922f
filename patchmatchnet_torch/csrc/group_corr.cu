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
//   is multiplied by its weight with __fmul_rn and added to a running sum
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
//   `correlate_taps` (common.cuh) in the same lane layout, so K7 on K1's
//   warp coordinates equals K1 to the bit.
//
// What bounds them on an H100: not HBM. The source maps (at most 8 MB a
// view, 32 MB for K6's four at stage 1; K3's is the reference map) stay in
// the 50 MB L2, and a launch needs 28-84 MB of device-memory traffic. Each
// sample reads 4 corner rows of C channels (stage 3 bf16: 4 x 128 B)
// wherever its cell lies, so the limits are the L1 requests those reads
// make and the instructions issued per sample: the cell (K1, K6: the warp's
// two IEEE divisions), and per channel a widening and 4 + 1 multiply-adds.
//
// One kernel, `group_corr_tile_kernel`, for four sources of a sample's cell
// (`Samples`): K1 warps depth hypotheses through one projection, K6 through
// V, each pixel's view weights applied, K3 takes the eval grid's neighbours
// of the reference itself, and K7 reads the given coordinates.
// - Lanes split across channels. A lane owns KC consecutive channels, whole
//   16-byte vectors and whole groups: one group of 8 at stage 3 (bf16: one
//   vector; f32: two), two groups of 4 in one bf16 vector at stages 2 and
//   1, one group of 4 in one f32 vector. L = C / KC neighbouring lanes hold
//   one sample, so one load instruction reads 32 / L whole corner rows
//   (stage 3 bf16: 4 rows of 128 B) in whole 32-byte sectors, where a
//   thread per sample touched 32 rows at 16 B each. No group sum crosses
//   lanes, and each lane sums its groups with `correlate_taps` in channel
//   order, corners t = 0..3 in order, invalid corners skipped: a thread per
//   sample walking all C channels computes the same bits.
// - Tile. A block of 256 threads owns TX = 256 / L consecutive reference
//   pixels (row-major over H x W, so a tile may cross a row) and a chunk
//   of samples per pixel: kHypChunk hypotheses (K1, K6, K7) or kGridChunk
//   eval-grid neighbours (K3: all 9 where Ke = 9; 9 and 8 where 17). It
//   reads the chunk's depths, coordinates (K7: ix, iy) or grid coordinates
//   (K3: gx, gy), each view's projection and (K6) each pixel's view
//   weights once, into shared memory; each lane reads its reference
//   channels once, into registers, for every sample of the chunk.
// - One warp per sample. A pixel's samples s = j * V + v (hypothesis or
//   neighbour j, view v; K1, K3 and K7 have V = 1) go L at a time: lane p
//   computes the cell of sample s0 + p, and the L lanes take each cell in
//   turn by shuffle (first pixel, fractions and, for K1, K6 and K7,
//   validity; the weights are recomputed from the fractions by the same
//   `set_weights`, so they are the cell lane's to the bit). K1 and K6 warp
//   with the unchanged `warp_taps` (K4 shares it, so forward and backward
//   pick the same cells), K7 calls `coord_taps` (the cell `warp_taps` ends
//   with), K3 takes the border cell of `border_taps` (K2 and K5 pick theirs
//   with it). At 64 registers a thread 4 blocks fit an SM; issuing two
//   samples' loads together took more registers and was slower.
// - K6's views, in chunks. A block stages the projections and weights of
//   all V views at once where V <= kViewChunk (the main path's V = 4), and
//   otherwise of kViewChunk views at a time (kViewChunks: kViewChunk * (TX
//   + 12) floats of dynamic shared memory, within the 48 KB a block gets
//   without opting in at every TX), runs every sample of its chunk against
//   them and then stages the next views. A lane's sum of sample j over the
//   views of one chunk stays in registers; between chunks it waits,
//   unrounded, in its slot of the staged output. So the sum runs over views
//   0..V-1 in order for any V. The launch picks the variant by V: on an
//   H100 the chunks' bookkeeping in the sample loop cost the one-chunk case
//   5% of its device time.
// - Staged stores. The output is [B, G, D, H, W], x fastest (K3: the
//   neighbours in the D slot), while a lane ends with its pixel's GL groups
//   of each sample. The block writes them to shared memory and then stores
//   each (g, d) row of TX consecutive pixels with consecutive threads, 16
//   bytes each where H x W is a multiple of 4 and the tile lies inside it,
//   masking ragged ends (H x W not a multiple of TX, D not a multiple of
//   the chunk) otherwise.
// The TPU kernels' source window (and its escape counter) does not exist:
// every sample reads the source directly, so none is lost.

#include "common.cuh"

namespace pmn {

// Where the tiled kernel's samples come from.
enum class Samples {
  kWarp,    // K1: depth hypotheses warped through one projection
  kViews,   // K6: the same through V projections, weighted per view
  kGrid,    // K3: eval-grid neighbours (gx, gy) of the reference itself
  kCoords,  // K7: source pixel coordinates (ix, iy) given per sample
};

// Samples one block of the tiled kernel computes for each of its pixels:
// hypotheses (K1, K6, K7), or eval-grid neighbours (K3, common.cuh
// `kGridChunk`).
constexpr int kHypChunk = 8;

// K6: views whose projections and weights a block stages at a time.
constexpr int kViewChunk = 16;

template <Samples kMode>
constexpr int kChunkOf = kMode == Samples::kGrid ? kGridChunk : kHypChunk;

// K1 (kWarp: V = 1, no weights), K6 (kViews), K3 (kGrid: src = ref, V = 1)
// and K7 (kCoords: V = 1, no projection). s0 and s1 are the per-sample
// inputs [B, D, H, W]: the depths (s1 unused), the grid gx and gy, or the
// source pixel coordinates ix and iy. kViewChunks (K6 with V > kViewChunk)
// stages the views in chunks; without it the block stages all V at once and
// its loop carries no chunk bookkeeping.
template <typename T, int C, int G, Samples kMode, bool kViewChunks = false>
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
  // depth, or (gx, gy), or (ix, iy)
  constexpr int kInputs = kMode == Samples::kGrid || kMode == Samples::kCoords ? 2 : 1;
  // + 1: the L lanes of a slot write L rows at once; the padding spreads
  // them over the banks
  __shared__ float staged[G][kChunk][TX + 1];
  __shared__ float smp_s[kInputs][kChunk][TX];
  // projections [VC][12], then K6's weights [VC][TX]: VC views at a time.
  // K1, K3 and K7 have one view, known here, so the sample loop below
  // divides by no runtime view count.
  extern __shared__ float views_s[];
  const int VC = !kViews ? 1 : kViewChunks ? kViewChunk : V;
  float* mats_s = views_s;
  float* vw_s = views_s + VC * 12;

  const long long hw = (long long)H * W;
  const int b = blockIdx.z;
  const int d0 = blockIdx.y * kChunk;
  const int nd = min(kChunk, D - d0);
  const long long pix0 = (long long)blockIdx.x * TX;
  const int slot = threadIdx.x / L;
  const int part = threadIdx.x % L;

  // The block's inputs other than the maps, read once: the chunk's depths
  // or coordinates, the projection (K1) or the first chunk's projections
  // and each pixel's view weights (K6).
#pragma unroll
  for (int a = 0; a < kInputs; ++a) {
    const float* in = a == 0 ? s0_in : s1_in;
    for (int i = threadIdx.x; i < kChunk * TX; i += kThreads) {
      const int j = i / TX;
      const long long p = pix0 + i % TX;
      smp_s[a][j][i % TX] = j < nd && p < hw ? in[((long long)b * D + d0 + j) * hw + p] : 0.0f;
    }
  }
  // views [vc0, vc0 + nv) into shared memory: projections (K1, K6) and
  // weights (K6)
  auto stage_views = [&](int vc0, int nv) {
    for (int i = threadIdx.x; i < nv * 12; i += kThreads)
      mats_s[i] = mats[((long long)b * V + vc0) * 12 + i];
    if constexpr (kViews) {
      for (int i = threadIdx.x; i < nv * TX; i += kThreads) {
        const long long p = pix0 + i % TX;
        vw_s[i] = p < hw ? vw[((long long)b * V + vc0 + i / TX) * hw + p] : 0.0f;
      }
    }
  };
  if constexpr (kMode == Samples::kWarp || kViews) stage_views(0, VC);
  __syncthreads();

  // Lanes of a slot past the end of H x W compute on the last pixel (the
  // shuffles below need every lane) and their results are not stored.
  const long long pix = min(pix0 + slot, hw - 1);
  const float x = (float)(int)(pix % W), y = (float)(int)(pix / W);
  float rv[KC];
  const T* r = ref + ((long long)b * hw + pix) * C + part * KC;
#pragma unroll
  for (int k = 0; k < KC; k += N) VecLoad<T>::load(r + k, rv + k);
  const T* base0 = src + (long long)b * (kViews ? V : 1) * Hs * Ws * C + part * KC;
  const long long view_stride = (long long)Hs * Ws * C;
  float m1[12];  // K1's one projection, in registers
  if constexpr (kMode == Samples::kWarp) {
#pragma unroll
    for (int i = 0; i < 12; ++i) m1[i] = mats_s[i];
  }

  // The views in chunks of VC (one chunk but for kViewChunks). In a chunk
  // of nv views, the slot's samples s = j * nv + v (sample j of the block's
  // chunk, view vc0 + v) go L at a time: lane `part` computes the cell of
  // sample s0 + part, and the slot's L lanes then reduce the L samples one
  // after another with its cell, shuffled.
  float res[GL];
#pragma unroll
  for (int k = 0; k < GL; ++k) res[k] = 0.0f;
  for (int vc0 = 0;;) {
    const int nv = kViewChunks ? min(VC, V - vc0) : VC;
    const int S = nd * nv;
    int j = 0, v = 0;
    for (int s0 = 0; s0 < S; s0 += L) {
      int cell = 0, valid = 0;
      float fx = 0.0f, fy = 0.0f;
      const int s = s0 + part;
      if (s < S) {
        const int sj = s / nv;
        Taps t;
        if constexpr (kMode == Samples::kGrid) {
          t = border_taps(unnormalize_border(smp_s[0][sj][slot], Ws),
                          unnormalize_border(smp_s[1][sj][slot], Hs), Hs, Ws);
        } else if constexpr (kMode == Samples::kCoords) {
          t = coord_taps(smp_s[0][sj][slot], smp_s[1][sj][slot], Hs, Ws);
        } else {
          const float* m = kViews ? mats_s + (s - sj * nv) * 12 : m1;
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
        const Corners<T, C> corner(base0 + (vc0 + v) * view_stride,
                                   __shfl_sync(0xffffffffu, cell, i, L), Ws);
        uint4 raw[KC / N][4];  // every load of the sample before its arithmetic
#pragma unroll
        for (int k = 0; k < KC / N; ++k) load_taps<T, C>(corner, k * N, taps, raw[k]);
        float acc[GL];
#pragma unroll
        for (int k = 0; k < GL; ++k) acc[k] = 0.0f;
#pragma unroll
        for (int k = 0; k < KC / N; ++k)
          correlate_taps<T, CG>(raw[k], taps, rv + k * N, acc + k * N / CG);
        if constexpr (kViews) {
          if (kViewChunks && v == 0 && vc0 > 0) {  // sample j's sum over earlier views
#pragma unroll
            for (int k = 0; k < GL; ++k) res[k] = staged[part * GL + k][j][slot];
          }
          const float weight = vw_s[v * TX + slot];
#pragma unroll
          for (int k = 0; k < GL; ++k)
            res[k] = __fadd_rn(res[k], __fmul_rn(__fmul_rn(acc[k], 1.0f / CG), weight));
        } else {
#pragma unroll
          for (int k = 0; k < GL; ++k) res[k] = acc[k] * (1.0f / CG);
        }
        if (++v == nv) {  // sample j is summed over the chunk's views
#pragma unroll
          for (int k = 0; k < GL; ++k) {
            staged[part * GL + k][j][slot] = res[k];
            if constexpr (kViews) res[k] = 0.0f;
          }
          v = 0;
          ++j;
        }
      }
    }
    vc0 += nv;
    if (!kViewChunks || vc0 >= V) break;
    __syncthreads();  // every lane is done with the chunk's views
    stage_views(vc0, min(VC, V - vc0));
    __syncthreads();
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

template <typename T, int C, int G, Samples kMode, bool kViewChunks = false>
cudaError_t launch_tiled(const void* src, const void* ref, const void* mats, const void* s0_in,
                         const void* s1_in, const void* vw, void* out, int B, int V, int D,
                         int H, int W, int Hs, int Ws, cudaStream_t stream) {
  constexpr int TX = TileLayout<T, C, G>::TX;
  constexpr int kChunk = kChunkOf<kMode>;
  const long long hw = (long long)H * W;
  if (B == 0 || D == 0 || hw == 0) return cudaSuccess;
  if (V < 1) return cudaErrorInvalidValue;
  const dim3 grid((unsigned int)((hw + TX - 1) / TX), (D + kChunk - 1) / kChunk, B);
  const int VC = kViewChunks ? kViewChunk : V;
  const size_t views_bytes = kMode == Samples::kViews  ? sizeof(float) * VC * (12 + TX)
                             : kMode == Samples::kWarp ? sizeof(float) * 12
                                                       : 0;
  group_corr_tile_kernel<T, C, G, kMode, kViewChunks><<<grid, kThreads, views_bytes, stream>>>(
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
    return pmn::launch_tiled<typename I::T, I::C, I::G, pmn::Samples::kCoords>(
        src, ref, nullptr, ix, iy, nullptr, out, B, 1, D, H, W, Hs, Ws,
        static_cast<cudaStream_t>(stream));
  });
}

// src [B,V,Hs,Ws,C], ref [B,H,W,C] (f32 or bf16), mats [B,V,12] f32,
// depth [B,D,H,W] f32, vw [B,V,H,W] f32 -> out [B,G,D,H,W] f32; any V >= 1.
extern "C" int pmn_warp_group_corr_views(const void* src, const void* ref, const void* mats,
                                         const void* depth, const void* vw, void* out, int B,
                                         int V, int D, int H, int W, int Hs, int Ws, int C, int G,
                                         int bf16, void* stream) {
  return (int)pmn::dispatch(C, G, bf16, [&](auto inst) {
    using I = decltype(inst);
    constexpr auto kViews = pmn::Samples::kViews;
    const auto s = static_cast<cudaStream_t>(stream);
    return V > pmn::kViewChunk
               ? pmn::launch_tiled<typename I::T, I::C, I::G, kViews, true>(
                     src, ref, mats, depth, nullptr, vw, out, B, V, D, H, W, Hs, Ws, s)
               : pmn::launch_tiled<typename I::T, I::C, I::G, kViews>(
                     src, ref, mats, depth, nullptr, vw, out, B, V, D, H, W, Hs, Ws, s);
  });
}

extern "C" const char* pmn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
