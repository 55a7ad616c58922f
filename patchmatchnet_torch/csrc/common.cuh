// Shared device helpers for the PatchmatchNet kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pmn {

constexpr int kThreads = 256;

// VecLoad<T>: N consecutive elements of T in one 16-byte vector. `raw`
// reads one from a 16-byte aligned address, `widen` converts it to f32, and
// `load` does both.
template <typename T>
struct VecLoad;

template <>
struct VecLoad<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 raw(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void load(const float* p, float* out) { widen(raw(p), out); }
};

template <>
struct VecLoad<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const uint4& v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static uint4 raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    widen(raw(p), out);
  }
};

// The lane layout of the tiled kernels (K1, K3, K6, K7 in group_corr.cu; K5 in
// group_corr_bwd.cu) for a (payload, C, G) instantiation: a lane owns
// KC consecutive channels (whole 16-byte vectors and whole groups), L lanes
// hold one sample, and a block of kThreads holds TX reference pixels.
template <typename T, int C, int G>
struct TileLayout {
  static constexpr int N = VecLoad<T>::N;     // channels in a 16-byte vector
  static constexpr int CG = C / G;            // channels in a group
  static constexpr int KC = N > CG ? N : CG;  // channels a lane owns
  static constexpr int L = C / KC;            // lanes of one sample
  static constexpr int GL = KC / CG;          // groups a lane owns
  static constexpr int TX = kThreads / L;     // reference pixels of a block
  static_assert(C % KC == 0 && KC % N == 0 && KC % CG == 0 && 32 % L == 0, "lane layout");
};

// Eval-grid neighbours a block of K3 or K5 takes for each of its pixels
// (the model has 9).
constexpr int kGridChunk = 9;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// align_corners=False unnormalization of a grid coordinate:
// ((g + 1) * size - 1) / 2. Rounded op by op (no FMA contraction) so it
// matches the PyTorch/JAX element-wise formulas.
__device__ __forceinline__ float unnormalize(float g, int size) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)size), 1.0f), 0.5f);
}

// `unnormalize` clamped to the border, [0, size - 1].
__device__ __forceinline__ float unnormalize_border(float g, int size) {
  return fminf(fmaxf(unnormalize(g, size), 0.0f), (float)(size - 1));
}

// The four bilinear taps of one sample: corner (x0, y0) of the 2x2 cell,
// weights w[t] and validity valid[t] for t = (x0,y0), (x0+1,y0), (x0,y0+1),
// (x0+1,y0+1). Forward and backward kernels share these helpers, so a
// sample reads the same cell in both.
struct Taps {
  float w[4];
  bool valid[4];
  int x0, y0;
  float fx, fy;
};

__device__ __forceinline__ void set_weights(Taps& t) {
  t.w[0] = (1.0f - t.fx) * (1.0f - t.fy);
  t.w[1] = t.fx * (1.0f - t.fy);
  t.w[2] = (1.0f - t.fx) * t.fy;
  t.w[3] = t.fx * t.fy;
}

// Cell of a sample at source pixel coordinates (ix, iy): zeros padding,
// align_corners=True. A corner outside the Hs x Ws map is invalid (reads
// zero); so is every corner of a sample far off the image.
__device__ __forceinline__ Taps coord_taps(float ix, float iy, int Hs, int Ws) {
  const float x0f = floorf(ix), y0f = floorf(iy);
  Taps t;
  t.fx = ix - x0f;
  t.fy = iy - y0f;
  const bool x0v = x0f >= 0.0f && x0f <= (float)(Ws - 1);
  const bool x1v = x0f >= -1.0f && x0f <= (float)(Ws - 2);
  const bool y0v = y0f >= 0.0f && y0f <= (float)(Hs - 1);
  const bool y1v = y0f >= -1.0f && y0f <= (float)(Hs - 2);
  t.valid[0] = x0v && y0v;
  t.valid[1] = x1v && y0v;
  t.valid[2] = x0v && y1v;
  t.valid[3] = x1v && y1v;
  set_weights(t);
  // clamp before the int conversion; out-of-range corners are not read
  t.x0 = (int)fminf(fmaxf(x0f, -1.0f), (float)(Ws - 1));
  t.y0 = (int)fminf(fmaxf(y0f, -1.0f), (float)(Hs - 1));
  return t;
}

// Homography warp of reference pixel (u, v) at depth `dep` through
// m = [R | t] (12 floats, row-major): p = R [u, v, 1]^T * dep + t,
// (ix, iy) = (px, py) / pz, rounded op by op like the reference; then the
// cell of `coord_taps`. pz <= 1e-3 (behind the source camera) pushes the
// sample to (Ws, Hs), where no corner is valid.
__device__ __forceinline__ Taps warp_taps(const float* m, float u, float v, float dep,
                                          int Hs, int Ws) {
  const float rx = __fadd_rn(__fadd_rn(__fmul_rn(m[0], u), __fmul_rn(m[1], v)), m[2]);
  const float ry = __fadd_rn(__fadd_rn(__fmul_rn(m[4], u), __fmul_rn(m[5], v)), m[6]);
  const float rz = __fadd_rn(__fadd_rn(__fmul_rn(m[8], u), __fmul_rn(m[9], v)), m[10]);
  const float px = __fadd_rn(__fmul_rn(rx, dep), m[3]);
  const float py = __fadd_rn(__fmul_rn(ry, dep), m[7]);
  const float pz = __fadd_rn(__fmul_rn(rz, dep), m[11]);
  const bool behind = pz <= 1e-3f;
  const float ix = behind ? (float)Ws : __fdiv_rn(px, pz);
  const float iy = behind ? (float)Hs : __fdiv_rn(py, pz);
  return coord_taps(ix, iy, Hs, Ws);
}

// Eval-grid sample at normalized (gx, gy): align_corners=False, border
// clamping; the cell's x0 is clamped to [0, W-2], so fx may be 1 at the
// last column. All four corners are valid.
__device__ __forceinline__ Taps border_taps(float sx, float sy, int Hs, int Ws) {
  const float x0f = fminf(fmaxf(floorf(sx), 0.0f), (float)(Ws - 2));
  const float y0f = fminf(fmaxf(floorf(sy), 0.0f), (float)(Hs - 2));
  Taps t;
  t.fx = sx - x0f;
  t.fy = sy - y0f;
  t.valid[0] = t.valid[1] = t.valid[2] = t.valid[3] = true;
  set_weights(t);
  t.x0 = (int)x0f;
  t.y0 = (int)y0f;
  return t;
}

// Pointers to the four corners of a sample's cell in the [Hs, Ws, C] map
// `base` (in the order of Taps::w), from the cell's first pixel
// y0 * Ws + x0. A corner off the map gets a pointer that is never read.
template <typename T, int C>
struct Corners {
  const T* p[4];
  Corners() = default;
  __device__ __forceinline__ Corners(const T* base, long long cell, int Ws) {
    p[0] = base + cell * C;
    p[1] = base + (cell + 1) * C;
    p[2] = base + (cell + Ws) * C;
    p[3] = base + (cell + Ws + 1) * C;
  }
};

// One 16-byte vector of a sample, in two steps. `load_taps` reads channels
// [c, c + N) of the sample's valid corners (invalid ones are not read);
// `correlate_taps` weights them bilinearly (valid corners only, t = 0..3 in
// order), multiplies by the reference channels rv[0..N) and adds each
// channel i into its group sum acc[i / CG], in channel order; acc points at
// the sum of the group that holds channel c. Every sample of K1, K3, K6 and
// K7 is reduced through these two steps, with explicit roundings, so the
// four compute the same bits for the same cell.
template <typename T, int C>
__device__ __forceinline__ void load_taps(const Corners<T, C>& corner, int c, const Taps& taps,
                                          uint4 (&raw)[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    raw[t] = taps.valid[t] ? VecLoad<T>::raw(corner.p[t] + c) : make_uint4(0u, 0u, 0u, 0u);
}

template <typename T, int CG>
__device__ __forceinline__ void correlate_taps(const uint4 (&raw)[4], const Taps& taps,
                                               const float* rv, float* acc) {
  constexpr int N = VecLoad<T>::N;
  float warped[N], tap[N];
#pragma unroll
  for (int i = 0; i < N; ++i) warped[i] = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (!taps.valid[t]) continue;
    VecLoad<T>::widen(raw[t], tap);
#pragma unroll
    for (int i = 0; i < N; ++i) warped[i] = __fmaf_rn(tap[i], taps.w[t], warped[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i / CG] = __fmaf_rn(warped[i], rv[i], acc[i / CG]);
}

inline unsigned int num_blocks(long long total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace pmn
