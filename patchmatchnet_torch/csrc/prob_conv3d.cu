// K9 prob_conv3d: CasMVSNet's probability head, the 3x3x3 convolution from
// the last U-Net block's 8 channels to one logit a voxel.
//
// Replaces no TPU kernel: the JAX package has no cost-volume network. It
// was added because cuDNN has no tensor-core engine for a 3D convolution
// with one output channel and runs this one on its generic CUDA-core
// kernel (`implicit_convolveNd_sgemm`), 150 times off its bound.
//
//   out[b, d, y, x] = sum_{kd, ky, kx, c} x[b, d+kd-1, y+ky-1, x+kx-1, c] w[c, kd, ky, kx]
//
// over 8 channels and 27 taps, zero padding on every side, accumulated in
// f32. The input is [B, D, H, W, 8] in memory (a channels_last_3d [B, 8,
// D, H, W] tensor), bf16 or f32; the weights are the head's f32 [1, 8, 3,
// 3, 3] as stored; the output is f32 [B, D, H, W].
//
// What bounds it on an H100: a stencil, bound by memory and the CUDA cores
// alike. Per voxel it reads one 16-byte vector (bf16), writes 4 bytes and
// does 216 multiply-adds: DTU's stage 2 (32 x 432 x 576) reads and writes
// 159 MB (48 us at 3.35 TB/s) and does 3.4 GFLOP (51 us at 67 TFLOP/s).
// Design: a block owns a tile of TH x 32 outputs in (y, x) and a chunk of
// kDepthChunk planes, and walks its input planes along D. Each plane, tile
// plus a one-voxel halo, comes from device memory once into shared memory
// by cp.async (zero-filled off the volume), double-buffered so the next
// plane's copy runs under this plane's arithmetic. A plane adds to three
// outputs along D (kd = 0, 1, 2), so each thread keeps three accumulators
// for each of its RY outputs in (y) and writes the one that is complete
// after each plane. A thread reads the (RY + 2) x 3 voxels it needs of a
// plane from shared memory once, widens them to f32 in registers, and
// takes each of the 216 weights (in shared memory, the same address for
// every thread) once a plane for its RY outputs. A warp's lanes take 32
// neighbouring x, so its shared-memory reads and its f32 stores are
// contiguous.

#include "common.cuh"

namespace pmn {

constexpr int kProbChannels = 8;
constexpr int kProbTaps = 27;
constexpr int kTileW = 32;       // outputs in x of a block: one warp's lanes
constexpr int kTileRows = 8;     // warps of a block, each a band of RY rows
constexpr int kDepthChunk = 8;   // output planes of a block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: no read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int RY>
__global__ void __launch_bounds__(kTileW * kTileRows, 2)
    prob_conv3d_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                       float* __restrict__ out, int D, int H, int W, int chunks) {
  constexpr int N = VecLoad<T>::N;
  constexpr int NCH = kProbChannels / N;  // 16-byte vectors of a voxel
  constexpr int TH = kTileRows * RY;      // outputs in y of a block
  constexpr int SH = TH + 2, SW = kTileW + 2;
  constexpr int PLANE = NCH * SH * SW;    // 16-byte vectors of a staged plane
  __shared__ uint4 planes[2][NCH][SH][SW];
  __shared__ __align__(16) float wts[kProbTaps * kProbChannels];  // [tap][c]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * TH;
  const int b = blockIdx.z / chunks;
  const int d0 = (blockIdx.z % chunks) * kDepthChunk;
  const int dend = min(d0 + kDepthChunk, D);
  const int zs = max(d0 - 1, 0), ze = min(d0 + kDepthChunk, D - 1);  // planes read
  const long long plane_voxels = (long long)H * W;

  for (int i = tid; i < kProbTaps * kProbChannels; i += kTileW * kTileRows) {
    const int c = i % kProbChannels, tap = i / kProbChannels;
    wts[i] = __ldg(weight + c * kProbTaps + tap);
  }

  auto stage = [&](int z, int buf) {
    const T* base = x + ((long long)b * D + z) * plane_voxels * kProbChannels;
    for (int i = tid; i < PLANE; i += kTileW * kTileRows) {
      const int ch = i % NCH, rest = i / NCH;
      const int sx = rest % SW, sy = rest / SW;
      const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
      const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const T* src = valid ? base + ((long long)gy * W + gx) * kProbChannels + ch * N : x;
      cp_async16(&planes[buf][ch][sy][sx], src, valid);
    }
    cp_async_commit();
  };

  // acc[k][r]: row r's output at plane z + 1 - k while plane z is added
  float acc[3][RY];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int r = 0; r < RY; ++r) acc[k][r] = 0.0f;

  auto store = [&](int d, int r, float v) {
    const int y = y0 + ty * RY + r, xx = x0 + tx;
    if (y < H && xx < W) out[(((long long)b * D + d) * H + y) * W + xx] = v;
  };

  stage(zs, 0);
  for (int z = zs, it = 0; z <= ze; ++z, ++it) {
    const int buf = it & 1;
    if (z < ze) {
      stage(z + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float in[RY + 2][3][kProbChannels];
#pragma unroll
    for (int r = 0; r < RY + 2; ++r)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
          VecLoad<T>::widen(planes[buf][ch][ty * RY + r][tx + kx], &in[r][kx][ch * N]);

#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      const int d = z + 1 - kd;  // the output plane this tap depth adds to
      if (d < d0 || d >= dend) continue;  // the same in the whole block
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wv = reinterpret_cast<const float4*>(wts) + ((kd * 3 + ky) * 3 + kx) * 2;
          const float4 lo = wv[0], hi = wv[1];
          const float wc[kProbChannels] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int c = 0; c < kProbChannels; ++c)
#pragma unroll
            for (int r = 0; r < RY; ++r)
              acc[kd][r] = __fmaf_rn(in[r + ky][kx][c], wc[c], acc[kd][r]);
        }
    }
    __syncthreads();  // the next iteration stages into this buffer

#pragma unroll
    for (int r = 0; r < RY; ++r) {
      if (z - 1 >= d0) store(z - 1, r, acc[2][r]);  // plane z was its last
      acc[2][r] = acc[1][r];
      acc[1][r] = acc[0][r];
      acc[0][r] = 0.0f;
    }
  }
  if (ze < dend) {  // the last plane of the volume: zeros beyond it
#pragma unroll
    for (int r = 0; r < RY; ++r) store(ze, r, acc[2][r]);
  }
}

template <typename T>
cudaError_t launch_prob_conv3d(const void* x, const void* weight, void* out, int B, int D,
                               int H, int W, cudaStream_t stream) {
  constexpr int RY = 2;
  if ((long long)B * D * H * W == 0) return cudaSuccess;
  const int chunks = (D + kDepthChunk - 1) / kDepthChunk;
  const dim3 block(kTileW, kTileRows);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileRows * RY - 1) / (kTileRows * RY),
                  B * chunks);
  prob_conv3d_kernel<T, RY><<<grid, block, 0, stream>>>(static_cast<const T*>(x),
                                                       static_cast<const float*>(weight),
                                                       static_cast<float*>(out), D, H, W,
                                                       chunks);
  return cudaGetLastError();
}

}  // namespace pmn

// x [B,D,H,W,8] (bf16 or f32), weight [1,8,3,3,3] f32 -> out [B,D,H,W] f32
extern "C" int pmn_prob_conv3d(const void* x, const void* weight, void* out, int B, int D,
                               int H, int W, int bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? pmn::launch_prob_conv3d<__nv_bfloat16>(x, weight, out, B, D, H, W, s)
                    : pmn::launch_prob_conv3d<float>(x, weight, out, B, D, H, W, s));
}
