// K10 conv3d_block: one block of CasMVSNet's 3D U-Nets (cascade-stereo's
// module.py `Conv3d` and `Deconv3d`) in one pass:
//
//   y = relu(conv3x3x3(x) * scale + shift) [+ skip]
//
// the eval-mode BatchNorm folded to scale = gamma * rsqrt(var + 1e-5) and
// shift = beta - mean * scale, the skip added after the ReLU (the decoder
// blocks, `conv4 + conv7(x)` in the published code). Three kinds of
// convolution, each 3x3x3 with padding 1 and no bias:
//   mode 0, stride 1:   out[o] = sum_k x[o + k - 1] w[k]
//   mode 1, stride 2:   out[o] = sum_k x[2 o + k - 1] w[k]
//   mode 2, transposed, stride 2, output padding 1 (each of D, H, W doubles),
//     written as a gather: out[o] = sum_k x[(o + 1 - k) / 2] w[k] over the
//     k where (o + 1 - k) / 2 is an integer in range,
// per axis; w[k] is Conv3d's [Cout, Cin, 3, 3, 3] or ConvTranspose3d's
// [Cin, Cout, 3, 3, 3] f32 weight as stored. The input is [B, D, H, W, Cin]
// in memory (a channels_last_3d tensor), the output and the skip [B, Do, Ho,
// Wo, Cout], all bf16 or all f32. bf16 payloads (the served model) take the
// tensor cores, f32 sums and epilogue and one rounding to bf16 at the store;
// f32 payloads (a model served in f32, which turns TF32 off) take the CUDA
// cores, f32 products and sums throughout.
//
// Replaces no TPU kernel: the JAX package has no cost-volume network. It
// was added because cuDNN runs these blocks at 8-64 channels on thin
// implicit-GEMM kernels (sm80_xmma_fprop, sm90_xmma_dgrad for the
// transposed ones) followed by three or four element-wise passes (the
// BatchNorm's multiply and add, the ReLU, the skip add), each a full read
// and write of the block's output.
//
// What bounds it on an H100: bytes. At 8-16 input channels a voxel's
// 27 x Cin x Cout multiply-adds are 108-216 operations a byte moved, under
// the card's ~295 bf16 tensor-core operations a byte. DTU's 1152x864 moves
// ~0.49 GB (stage 1), 1.05 GB (stage 2) and 0.92 GB (stage 3) a map when each
// block reads its input and skip once and writes its output once: 0.74 ms at
// 3.35 TB/s, against 246 GFLOP (0.25 ms on the tensor cores).
// Design: a block owns a tile of outputs in (y, x) (64 wide) and a chunk of
// up to kPlaneChunk output planes, for 8 or 16 output channels, and walks its
// input planes along D. Each input plane, its tile and halo, comes from
// device memory once into shared memory by cp.async (zero-filled off the
// volume), double-buffered so the next plane's copy runs under this plane's
// products; a stride-2 block stages its columns split by parity, so that
// neighbouring outputs read neighbouring voxels, and every voxel's 16-byte
// vectors sit XOR-swizzled, so that the eight rows of an ldmatrix fall in
// eight different bank groups. The weights sit in shared memory as bf16 in
// the order of the tensor cores' B fragments, converted from f32 once by
// each block. The products run on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 sums): M is 16 outputs in x, N is 8 output channels, K is Cin x
// the in-plane taps (two taps in one K step at Cin = 8). One input plane
// adds to up to three output planes (kd = 0, 1, 2), so each A fragment,
// loaded once by ldmatrix, feeds up to three products, and each warp keeps
// the sums of the output planes in flight in registers, storing each one,
// BatchNorm, ReLU and skip applied, when its last input plane is in. A
// transposed block's warp owns a 2 x 32 patch of outputs: one m-tile per
// output parity class in (y, x), each with only its own taps (1, 2, 2 or 4
// of the 9). Nothing but the output reaches device memory.
// f32 payloads (conv3d_block_f32_kernel) run on the CUDA cores at 8 output
// channels a block, each warp a row of 32 or 64 outputs. Two or four lanes
// share an output voxel, each summing a slice of its input channels, so that
// a warp's 16-byte loads read runs of neighbouring voxels whole through L1;
// the slices meet by shuffles before the store. A transposed block's warp
// takes the outputs of one x parity at a time, so that a tap is live in a
// whole warp or in none, and each output runs only its own taps. Each block
// walks its chunk of output planes with the 27 x Cin x 8 weights staged in
// shared memory once, in the order the lanes read them.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace pmn {

enum BlockMode : int { kConvStride1 = 0, kConvStride2 = 1, kDeconvStride2 = 2 };

constexpr int kBlockWarps = 8;
constexpr int kBlockThreads = 32 * kBlockWarps;
constexpr int kPlaneChunk = 16;  // output planes of a block at most (even: transposed pairs)
constexpr int kTileX = 64;      // outputs in x of a block
constexpr int kMTiles = 4;      // m-tiles (16 outputs each) of a warp

// The shapes of a block for one instantiation. NB output channels a block
// (8 or 16), one warp per 8 of them (WN) and WM warps along the outputs:
// stride 1 and 2, a warp owns one row of 64 outputs; transposed, a 2 x 32
// patch, two across. SH x SW voxels of CV 16-byte vectors are staged a plane.
template <int MODE, int CIN, int NB>
struct BlockTile {
  static constexpr int CV = CIN / 8;
  static constexpr int WN = NB / 8;
  static constexpr int WM = kBlockWarps / WN;
  static constexpr int BX = kTileX;
  static constexpr int BY = WM;
  static constexpr int SH = MODE == kConvStride1 ? BY + 2
                            : MODE == kConvStride2 ? 2 * BY + 1 : BY / 2 + 1;
  static constexpr int SW = MODE == kConvStride1 ? BX + 2
                            : MODE == kConvStride2 ? 2 * BX + 1 : BX / 2 + 1;
  static constexpr int PLANE = SH * SW * CV;      // 16-byte vectors of a staged plane
  static constexpr int WWORDS = 27 * CV * WN * 32;  // 32-bit words of the staged weights
  static constexpr int SMEM = 2 * PLANE * 16 + WWORDS * 4;
  static_assert(CIN % 8 == 0 && CIN <= 64 && NB % 8 == 0 && kBlockWarps % WN == 0, "shape");
  static_assert(MODE != kDeconvStride2 || WM % 2 == 0, "transposed patches come in pairs");
};

// Vector c of staged voxel v, in column col of its staged row: XOR-swizzled
// within the voxel by the column's low 3 bits, so that vector c of eight
// neighbouring voxels of a row lies in eight different 16-byte bank groups.
// Columns 8 apart share the swizzle: an m-tile's is that of its row r.
template <int CV>
__device__ __forceinline__ int vec_index(int v, int col, int c) {
  constexpr int kShift = CV == 1 ? 3 : CV == 2 ? 2 : CV == 4 ? 1 : 0;  // log2(8 / CV)
  return v * CV + (c ^ (((col & 7) >> kShift) & (CV - 1)));
}

__device__ __forceinline__ void conv_cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: no read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void conv_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}

template <int N>
__device__ __forceinline__ void conv_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A transposed block's taps along one axis for output parity p: k = 1 for
// an even output, k = 0 and 2 for an odd one.
__device__ __forceinline__ constexpr int parity_taps(int p) { return p ? 2 : 1; }
__device__ __forceinline__ constexpr int parity_tap(int p, int i) { return p ? 2 * i : 1; }

template <int MODE, int CIN, int COUT, int NB>
__global__ void __launch_bounds__(kBlockThreads, 2)
    conv3d_block_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ weight,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        const float* __restrict__ mean, const float* __restrict__ var,
                        const __nv_bfloat16* __restrict__ skip, __nv_bfloat16* __restrict__ out,
                        int D, int H, int W, int Do, int Ho, int Wo, int planes_per_chunk,
                        int chunks) {
  using Tile = BlockTile<MODE, CIN, NB>;
  constexpr int CV = Tile::CV, WN = Tile::WN, BX = Tile::BX, BY = Tile::BY;
  constexpr int SW = Tile::SW, PLANE = Tile::PLANE;
  constexpr int SPLITS = COUT / NB;
  constexpr int HALF = BX + 1;  // a stride-2 plane's even columns, then its odd ones
  extern __shared__ uint4 smem[];
  uint4* planes = smem;
  uint32_t* wts = reinterpret_cast<uint32_t*>(smem + 2 * PLANE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % WN, wm = warp / WN;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const int split = blockIdx.z % SPLITS;
  const int chunk = (blockIdx.z / SPLITS) % chunks;
  const int b = blockIdx.z / (SPLITS * chunks);
  const int n0 = split * NB;
  const int d0 = chunk * planes_per_chunk, dend = min(d0 + planes_per_chunk, Do);
  int zs, ze;  // the input planes this chunk reads
  if constexpr (MODE == kConvStride1) {
    zs = max(d0 - 1, 0);
    ze = min(dend, D - 1);
  } else if constexpr (MODE == kConvStride2) {
    zs = max(2 * d0 - 1, 0);
    ze = min(2 * dend - 1, D - 1);
  } else {
    zs = d0 / 2;
    ze = min(dend / 2, D - 1);
  }

  auto stage = [&](int z, int buf) {
    uint4* dst = planes + buf * PLANE;
    const __nv_bfloat16* base = x + ((long long)b * D + z) * H * W * CIN;
    for (int i = tid; i < PLANE; i += kBlockThreads) {
      const int c = i % CV, rest = i / CV;
      const int sx = rest % SW, sy = rest / SW;
      int gy, gx, col = sx;
      if constexpr (MODE == kConvStride1) {
        gy = y0 - 1 + sy;
        gx = x0 - 1 + sx;
      } else if constexpr (MODE == kConvStride2) {
        gy = 2 * y0 - 1 + sy;
        gx = 2 * x0 - 1 + sx;
        col = (sx & 1) ? HALF + (sx >> 1) : (sx >> 1);
      } else {
        gy = y0 / 2 + sy;
        gx = x0 / 2 + sx;
      }
      const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const __nv_bfloat16* src = valid ? base + ((long long)gy * W + gx) * CIN + c * 8 : x;
      conv_cp_async16(dst + vec_index<CV>(sy * SW + col, col, c), src, valid);
    }
    conv_cp_async_commit();
  };

  stage(zs, 0);

  // weights: word (((kd * 9 + tap) * CV + c) * WN + nt) * 32 + lane holds
  // the B-fragment pair {w[k = 2q], w[k = 2q + 1]} of input channels c * 8 +
  // 2q, + 1 (q = lane % 4) for output channel n0 + nt * 8 + lane / 4. A
  // thread takes kWeightBatch words at a time, their loads all in flight
  // before the first conversion (the first plane's copy runs meanwhile).
  constexpr int kWeightBatch = 8;
  for (int i0 = tid; i0 < Tile::WWORDS; i0 += kBlockThreads * kWeightBatch) {
    float lo[kWeightBatch], hi[kWeightBatch];
#pragma unroll
    for (int j = 0; j < kWeightBatch; ++j) {
      const int i = i0 + j * kBlockThreads;
      if (i >= Tile::WWORDS) break;
      const int l = i & 31, nt = (i >> 5) % WN, rest = (i >> 5) / WN;
      const int c = rest % CV, tap = rest / CV;  // tap = kd * 9 + ky * 3 + kx
      const int n = n0 + nt * 8 + (l >> 2), cin = c * 8 + (l & 3) * 2;
      const long long at = MODE == kDeconvStride2 ? ((long long)cin * COUT + n) * 27 + tap
                                                  : ((long long)n * CIN + cin) * 27 + tap;
      lo[j] = __ldg(weight + at);
      hi[j] = __ldg(weight + at + (MODE == kDeconvStride2 ? COUT * 27 : 27));
    }
#pragma unroll
    for (int j = 0; j < kWeightBatch; ++j) {
      const int i = i0 + j * kBlockThreads;
      if (i >= Tile::WWORDS) break;
      const __nv_bfloat162 pair = __floats2bfloat162_rn(lo[j], hi[j]);
      wts[i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
  }

  // this lane's folded BatchNorm for its two output channels
  const int q = lane & 3, g = lane >> 2;
  const int nc = n0 + wn * 8 + 2 * q;
  float scale[2], shift[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__ldg(var + nc + j), 1e-5f)));
    scale[j] = __fmul_rn(__ldg(gamma + nc + j), inv);
    shift[j] = __fsub_rn(__ldg(beta + nc + j), __fmul_rn(__ldg(mean + nc + j), scale[j]));
  }

  // ldmatrix rows: output row r = lane % 16 of each m-tile reads K half h =
  // lane / 16; vbase[mt] is the staged voxel of its tap (0, 0) (transposed:
  // of its class's taps k = 1 and 2)
  const int r = lane & 15, h = lane >> 4;
  int vbase[kMTiles];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
    if constexpr (MODE == kConvStride1) {
      vbase[mt] = wm * SW + mt * 16 + r;
    } else if constexpr (MODE == kConvStride2) {
      vbase[mt] = 2 * wm * SW + mt * 16 + r;
    } else {
      vbase[mt] = (wm >> 1) * SW + (wm & 1) * 16 + r;
    }
  }

  float acc[3][kMTiles][4];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][mt][e] = 0.0f;

  // output plane o of the sums acc[s]: BatchNorm, ReLU, skip, bf16
  auto store = [&](int o, float (&sums)[kMTiles][4]) {
    if (o < d0 || o >= dend) return;  // the same in the whole block
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half;
        int oy, ox;
        if constexpr (MODE == kDeconvStride2) {
          oy = y0 + 2 * (wm >> 1) + (mt >> 1);
          ox = x0 + 32 * (wm & 1) + 2 * row + (mt & 1);
        } else {
          oy = y0 + wm;
          ox = x0 + mt * 16 + row;
        }
        if (oy >= Ho || ox >= Wo) continue;
        const long long idx = ((((long long)b * Do + o) * Ho + oy) * Wo + ox) * COUT + nc;
        float v0 = fmaxf(fmaf(sums[mt][2 * half], scale[0], shift[0]), 0.0f);
        float v1 = fmaxf(fmaf(sums[mt][2 * half + 1], scale[1], shift[1]), 0.0f);
        if (skip != nullptr) {
          const __nv_bfloat162 s = *reinterpret_cast<const __nv_bfloat162*>(skip + idx);
          v0 += __bfloat162float(s.x);
          v1 += __bfloat162float(s.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + idx) = __floats2bfloat162_rn(v0, v1);
      }
  };

  // B fragment words of tap (kd, ky, kx), input-channel vector c
  auto wword = [&](int kd, int ky, int kx, int c) {
    return wts[((((kd * 3 + ky) * 3 + kx) * CV + c) * WN + wn) * 32 + lane];
  };

  for (int z = zs, it = 0; z <= ze; ++z, ++it) {
    const int buf = it & 1;
    if (z < ze) {
      stage(z + 1, buf ^ 1);
      conv_cp_async_wait<1>();
    } else {
      conv_cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* plane = planes + buf * PLANE;

    // live[kd]: plane z adds with tap depth kd to an output plane of this
    // chunk (the same in the whole block); slot: the sums it adds to
    bool live[3];
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      int o;
      if constexpr (MODE == kConvStride1) {
        o = z + 1 - kd;
      } else if constexpr (MODE == kConvStride2) {
        o = ((z + 1 - kd) & 1) ? -1 : (z + 1 - kd) / 2;
      } else {
        o = 2 * z - 1 + kd;
      }
      live[kd] = o >= d0 && o < dend;
    }

    if constexpr (MODE != kDeconvStride2) {
      // every m-tile of the warp takes the same 9 taps: a K step's B
      // fragments once, then its A fragment for each m-tile
      constexpr int KS = CV == 1 ? 5 : 9 * CV / 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int t0 = CV == 1 ? 2 * ks : ks / (CV / 2);
        const bool pad = CV == 1 && 2 * ks + 1 >= 9;  // the last K step's second tap
        const int t1 = CV == 1 ? (pad ? t0 : 2 * ks + 1) : t0;
        const int c0 = CV == 1 ? 0 : 2 * (ks % (CV / 2)), c1 = CV == 1 ? 0 : c0 + 1;
        uint32_t bw[3][2];
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          bw[kd][0] = live[kd] ? wword(kd, t0 / 3, t0 % 3, c0) : 0u;
          bw[kd][1] = live[kd] && !pad ? wword(kd, t1 / 3, t1 % 3, c1) : 0u;
        }
        const int tap = h ? t1 : t0, c = h ? c1 : c0;
        const int ky = tap / 3, kx = tap % 3;
        const int offx = MODE == kConvStride1 ? kx : (kx == 1 ? HALF : kx >> 1);
        const int off = ky * SW + offx;
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          uint32_t a[4];  // column mt * 16 + r + offx
          ldmatrix_x4(a, plane + vec_index<CV>(vbase[mt] + off, r + offx, c));
#pragma unroll
          for (int kd = 0; kd < 3; ++kd) {
            // stride 2: kd 0 adds to the next output plane, kd 1 and 2 to this one
            const int s = MODE == kConvStride1 ? kd : (kd == 0 ? 1 : 0);
            if (live[kd]) mma_16816(acc[s][mt], a, bw[kd][0], bw[kd][1]);
          }
        }
      }
    } else {
      // m-tile mt is the output parity class (py, px) = (mt / 2, mt % 2),
      // with its own 1, 2, 2 or 4 in-plane taps
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        const int py = mt >> 1, px = mt & 1;
        const int nx = parity_taps(px), ntaps = parity_taps(py) * nx;
        const int KS = CV == 1 ? (ntaps + 1) / 2 : ntaps * CV / 2;
        constexpr int kMaxKS = CV == 1 ? 2 : 2 * CV;  // class (1, 1): 4 taps
#pragma unroll
        for (int ks = 0; ks < kMaxKS; ++ks) {
          if (ks >= KS) break;
          const int i0 = CV == 1 ? 2 * ks : ks / (CV / 2);
          const bool pad = CV == 1 && 2 * ks + 1 >= ntaps;
          const int i1 = CV == 1 ? (pad ? i0 : 2 * ks + 1) : i0;
          const int c0 = CV == 1 ? 0 : 2 * (ks % (CV / 2)), c1 = CV == 1 ? 0 : c0 + 1;
          const int ky0 = parity_tap(py, i0 / nx), kx0 = parity_tap(px, i0 % nx);
          const int ky1 = parity_tap(py, i1 / nx), kx1 = parity_tap(px, i1 % nx);
          uint32_t bw[3][2];
#pragma unroll
          for (int kd = 0; kd < 3; ++kd) {
            bw[kd][0] = live[kd] ? wword(kd, ky0, kx0, c0) : 0u;
            bw[kd][1] = live[kd] && !pad ? wword(kd, ky1, kx1, c1) : 0u;
          }
          const int ky = h ? ky1 : ky0, kx = h ? kx1 : kx0, c = h ? c1 : c0;
          const int offx = kx == 0 ? 1 : 0;
          const int off = (ky == 0 ? SW : 0) + offx;
          uint32_t a[4];  // column (wm & 1) * 16 + r + offx
          ldmatrix_x4(a, plane + vec_index<CV>(vbase[mt] + off, r + offx, c));
#pragma unroll
          for (int kd = 0; kd < 3; ++kd)
            if (live[kd]) mma_16816(acc[kd][mt], a, bw[kd][0], bw[kd][1]);
        }
      }
    }
    __syncthreads();  // the next iteration stages into this buffer

    // store the output planes whose last input plane was z, then move the sums
    if constexpr (MODE == kConvStride1) {
      store(z - 1, acc[2]);
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2][mt][e] = acc[1][mt][e];
          acc[1][mt][e] = acc[0][mt][e];
          acc[0][mt][e] = 0.0f;
        }
    } else if constexpr (MODE == kConvStride2) {
      if (z & 1) {
        store((z - 1) / 2, acc[0]);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[0][mt][e] = acc[1][mt][e];
            acc[1][mt][e] = 0.0f;
          }
      }
    } else {
      store(2 * z - 1, acc[0]);
      store(2 * z, acc[1]);
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][mt][e] = acc[2][mt][e];
          acc[1][mt][e] = 0.0f;
          acc[2][mt][e] = 0.0f;
        }
    }
  }
  // the output plane still in flight after the volume's last input plane
  if constexpr (MODE == kConvStride1) {
    store(ze, acc[2]);
  } else if constexpr (MODE == kConvStride2) {
    if (!(ze & 1)) store(ze / 2, acc[0]);
  } else {
    store(2 * ze + 1, acc[0]);
  }
}

// The input index along one axis that output o reads with tap k, or -1
// where that tap adds nothing (zero padding; transposed: a half-integer).
template <int MODE>
__device__ __forceinline__ int tap_source(int o, int k, int n) {
  int i;
  if constexpr (MODE == kConvStride1) {
    i = o + k - 1;
  } else if constexpr (MODE == kConvStride2) {
    i = 2 * o + k - 1;
  } else {
    const int t = o + 1 - k;
    i = (t & 1) ? -1 : t / 2;
  }
  return i >= 0 && i < n ? i : -1;
}

constexpr int kF32Channels = 8;  // output channels of an f32 block

// An f32 block's lanes: L lanes share an output voxel, each summing a slice
// of its input channels (16-byte vectors c = cv + L k), so that a warp's
// loads read whole runs of neighbouring voxels; G voxels a warp at a time,
// RX times over the warp's BX outputs (a lane's 4 x 8 sums in registers, two
// blocks an SM).
template <int CIN>
struct F32Lanes {
  static constexpr int CV = CIN / 4;
  static constexpr int L = CV < 4 ? CV : 4;
  static constexpr int KV = CV / L;  // vectors of a lane's slice
  static constexpr int G = 32 / L;
  static constexpr int RX = 4;
  static constexpr int BX = G * RX;
  static constexpr int SMEM = 27 * CIN * kF32Channels * 4;
  static_assert(CIN % 8 == 0 && (kF32Channels / L) % 2 == 0, "shape");
};

template <int MODE, int CIN, int COUT>
__global__ void __launch_bounds__(kBlockThreads, 2)
    conv3d_block_f32_kernel(const float* __restrict__ x, const float* __restrict__ weight,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            const float* __restrict__ mean, const float* __restrict__ var,
                            const float* __restrict__ skip, float* __restrict__ out, int D,
                            int H, int W, int Do, int Ho, int Wo, int planes_per_chunk,
                            int chunks) {
  using Lanes = F32Lanes<CIN>;
  constexpr int NB = kF32Channels, SPLITS = COUT / NB, CV = Lanes::CV, L = Lanes::L;
  constexpr int KV = Lanes::KV, G = Lanes::G, RX = Lanes::RX, BX = Lanes::BX, NL = NB / L;
  // weights: float4 pair ((((tap * KV + k) * 4 + e) * L + cv) * 2 + half) holds
  // output channels half * 4 .. + 3 of input channel 4 (cv + L k) + e, so that
  // the L lanes of a voxel read neighbouring pairs
  extern __shared__ float4 wts4[];
  float* wts = reinterpret_cast<float*>(wts4);
  __shared__ float fold[2][NB];  // the folded BatchNorm: scale, shift

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cv = lane % L, g = lane / L;
  const int split = blockIdx.z % SPLITS;
  const int chunk = (blockIdx.z / SPLITS) % chunks;
  const int b = blockIdx.z / (SPLITS * chunks);
  const int n0 = split * NB;
  const int d0 = chunk * planes_per_chunk, dend = min(d0 + planes_per_chunk, Do);
  for (int i = tid; i < 27 * CIN * NB; i += kBlockThreads) {
    int rest = i / NB;
    const int n = n0 + i % NB, lc = rest % L;
    rest /= L;
    const int e = rest % 4;
    rest /= 4;
    const int cin = 4 * (lc + L * (rest % KV)) + e, tap = rest / KV;
    wts[i] = __ldg(weight + (MODE == kDeconvStride2 ? ((long long)cin * COUT + n) * 27 + tap
                                                    : ((long long)n * CIN + cin) * 27 + tap));
  }
  if (tid < NB) {
    const int n = n0 + tid;
    const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__ldg(var + n), 1e-5f)));
    fold[0][tid] = __fmul_rn(__ldg(gamma + n), inv);
    fold[1][tid] = __fsub_rn(__ldg(beta + n), __fmul_rn(__ldg(mean + n), fold[0][tid]));
  }
  __syncthreads();
  const int oy = blockIdx.y * kBlockWarps + warp;
  if (oy >= Ho) return;
  // output r of the lane: transposed, all of one x parity (r % 2) in a warp
  int ox[RX];
#pragma unroll
  for (int r = 0; r < RX; ++r)
    ox[r] = blockIdx.x * BX + (MODE == kDeconvStride2 ? 2 * (g + G * (r >> 1)) + (r & 1)
                                                       : g + G * r);

  for (int o = d0; o < dend; ++o) {
    float acc[RX][NB];
#pragma unroll
    for (int r = 0; r < RX; ++r)
#pragma unroll
      for (int n = 0; n < NB; ++n) acc[r][n] = 0.0f;
    for (int kd = 0; kd < 3; ++kd) {
      const int z = tap_source<MODE>(o, kd, D);
      if (z < 0) continue;
      for (int ky = 0; ky < 3; ++ky) {
        const int y = tap_source<MODE>(oy, ky, H);
        if (y < 0) continue;
        const float4* row =
            reinterpret_cast<const float4*>(x + (((long long)b * D + z) * H + y) * W * CIN);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          int xi[RX];
#pragma unroll
          for (int r = 0; r < RX; ++r) xi[r] = ox[r] < Wo ? tap_source<MODE>(ox[r], kx, W) : -1;
          const float4* w = wts4 + ((kd * 3 + ky) * 3 + kx) * KV * 4 * L * 2 + cv * 2;
#pragma unroll
          for (int k = 0; k < KV; ++k) {
            float4 v[RX];
#pragma unroll
            for (int r = 0; r < RX; ++r)
              v[r] = xi[r] >= 0 ? __ldg(row + (long long)xi[r] * CV + cv + L * k)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            // transposed: an even output takes tap kx = 1 alone, an odd one 0 and 2
            auto live = [&](int r) { return MODE != kDeconvStride2 || ((r & 1) != (kx == 1)); };
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 lo = w[(k * 4 + e) * L * 2], hi = w[(k * 4 + e) * L * 2 + 1];
              const float wn[NB] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
              for (int r = 0; r < RX; ++r) {
                if (!live(r)) continue;
                const float a = e == 0 ? v[r].x : e == 1 ? v[r].y : e == 2 ? v[r].z : v[r].w;
#pragma unroll
                for (int n = 0; n < NB; ++n) acc[r][n] = fmaf(a, wn[n], acc[r][n]);
              }
            }
          }
        }
      }
    }
    // the L lanes of a voxel add their slices; lane cv stores channels cv NL .. + NL - 1
#pragma unroll
    for (int r = 0; r < RX; ++r) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int m = 1; m < L; m <<= 1) acc[r][n] += __shfl_xor_sync(0xffffffffu, acc[r][n], m);
      if (ox[r] >= Wo) continue;
      const long long idx =
          ((((long long)b * Do + o) * Ho + oy) * Wo + ox[r]) * COUT + n0 + cv * NL;
      float v[4];  // NL of them
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const int n = cv * NL + j;
        float sum = 0.0f;  // acc[r][n], without indexing registers by a lane's number
#pragma unroll
        for (int m = 0; m < NB; ++m) sum = m == n ? acc[r][m] : sum;
        v[j] = fmaxf(fmaf(sum, fold[0][n], fold[1][n]), 0.0f);
      }
      if constexpr (NL == 4) {
        if (skip != nullptr) {
          const float4 s = *reinterpret_cast<const float4*>(skip + idx);
          v[0] += s.x, v[1] += s.y, v[2] += s.z, v[3] += s.w;
        }
        *reinterpret_cast<float4*>(out + idx) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        if (skip != nullptr) {
          const float2 s = *reinterpret_cast<const float2*>(skip + idx);
          v[0] += s.x, v[1] += s.y;
        }
        *reinterpret_cast<float2*>(out + idx) = make_float2(v[0], v[1]);
      }
    }
  }
}

template <int MODE, int CIN, int COUT, typename T>
cudaError_t launch_conv3d_block(const void* x, const void* weight, const void* gamma,
                                const void* beta, const void* mean, const void* var,
                                const void* skip, void* out, int B, int D, int H, int W,
                                int Do, int Ho, int Wo, cudaStream_t stream) {
  constexpr bool kTensor = std::is_same<T, __nv_bfloat16>::value;  // f32: the CUDA cores
  constexpr int NB = kTensor ? (COUT < 16 ? COUT : 16) : kF32Channels;
  using Tile = BlockTile<MODE, CIN, NB>;
  constexpr int SMEM = kTensor ? Tile::SMEM : F32Lanes<CIN>::SMEM;
  constexpr int BX = kTensor ? kTileX : F32Lanes<CIN>::BX;
  constexpr int BY = kTensor ? Tile::BY : kBlockWarps;
  void (*kernel)(const T*, const float*, const float*, const float*, const float*, const float*,
                 const T*, T*, int, int, int, int, int, int, int, int);
  if constexpr (kTensor) {
    kernel = conv3d_block_kernel<MODE, CIN, COUT, NB>;
  } else {
    kernel = conv3d_block_f32_kernel<MODE, CIN, COUT>;
  }
  static bool attributes_set[64] = {};  // per device: shared memory above 48 KB
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!attributes_set[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    attributes_set[device] = true;
  }
  static int sms[64] = {};  // per device: streaming multiprocessors
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  if ((long long)B * Do * Ho * Wo == 0) return cudaSuccess;
  // chunks of at most kPlaneChunk output planes (half that at stride 2, whose
  // chunks read twice their planes), of equal size, more of them where the
  // volume gives fewer blocks than the card has SMs (the U-Nets' lowest
  // levels); a transposed block's chunk is a whole number of plane pairs
  const long long tiles =
      (long long)((Wo + BX - 1) / BX) * ((Ho + BY - 1) / BY) * B * (COUT / NB);
  const int most = MODE == kConvStride2 ? kPlaneChunk / 2 : kPlaneChunk;
  int chunks = (Do + most - 1) / most;
  while (chunks < Do && tiles * chunks < sms[device]) chunks = min(2 * chunks, Do);
  int planes_per_chunk = (Do + chunks - 1) / chunks;
  if (MODE == kDeconvStride2) planes_per_chunk += planes_per_chunk & 1;
  chunks = (Do + planes_per_chunk - 1) / planes_per_chunk;
  const dim3 grid((Wo + BX - 1) / BX, (Ho + BY - 1) / BY, B * chunks * (COUT / NB));
  kernel<<<grid, kBlockThreads, SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(weight),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<const T*>(skip), static_cast<T*>(out), D, H, W, Do, Ho, Wo, planes_per_chunk,
      chunks);
  return cudaGetLastError();
}

}  // namespace pmn

// x [B,D,H,W,cin] bf16 or f32 (bf16 != 0: bf16); weight f32 Conv3d
// [cout,cin,3,3,3] (modes 0, 1) or ConvTranspose3d [cin,cout,3,3,3] (mode 2);
// gamma, beta, mean, var f32 [cout]; skip [B,Do,Ho,Wo,cout] or null -> out
// [B,Do,Ho,Wo,cout], skip and out in x's dtype. The (mode, cin, cout) of
// CasMVSNet's CostRegNets; any other is refused (cudaErrorInvalidValue).
extern "C" int pmn_conv3d_block(const void* x, const void* weight, const void* gamma,
                                const void* beta, const void* mean, const void* var,
                                const void* skip, void* out, int B, int D, int H, int W,
                                int Do, int Ho, int Wo, int cin, int cout, int mode, int bf16,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define PMN_CONV3D_BLOCK(M, CI, CO)                                                         \
  if (mode == M && cin == CI && cout == CO)                                                 \
    return (int)(bf16 ? pmn::launch_conv3d_block<M, CI, CO, __nv_bfloat16>(                 \
                            x, weight, gamma, beta, mean, var, skip, out, B, D, H, W, Do, Ho, \
                            Wo, s)                                                          \
                      : pmn::launch_conv3d_block<M, CI, CO, float>(                         \
                            x, weight, gamma, beta, mean, var, skip, out, B, D, H, W, Do, Ho, \
                            Wo, s));
  PMN_CONV3D_BLOCK(0, 32, 8)
  PMN_CONV3D_BLOCK(0, 16, 8)
  PMN_CONV3D_BLOCK(0, 8, 8)
  PMN_CONV3D_BLOCK(0, 16, 16)
  PMN_CONV3D_BLOCK(0, 32, 32)
  PMN_CONV3D_BLOCK(0, 64, 64)
  PMN_CONV3D_BLOCK(1, 8, 16)
  PMN_CONV3D_BLOCK(1, 16, 32)
  PMN_CONV3D_BLOCK(1, 32, 64)
  PMN_CONV3D_BLOCK(2, 64, 32)
  PMN_CONV3D_BLOCK(2, 32, 16)
  PMN_CONV3D_BLOCK(2, 16, 8)
#undef PMN_CONV3D_BLOCK
  return (int)cudaErrorInvalidValue;
}
