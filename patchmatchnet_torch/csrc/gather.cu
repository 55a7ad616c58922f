// Gathers of the gather microbenchmarks (patchmatchnet_torch/dev/bench_gather.py):
//
//   gather_lanes     out[n,a,l] = win[n, a, idx[n,a,l]]         (f32)
//   gather_sublanes  out[n,s,l] = win[n, idx[n,s,l], l]         (f32)
//   gather_rows      out[n,p,:] = win[n, idx[n,p], :]           (f32 or bf16)
//
// They replace the Pallas kernels of tools/dev/bench_gather.py:
// `_pallas_lane_kernel` (take_along_axis along the lanes of [C, 128] blocks)
// as launched at :96 (D1, 8 blocks per grid step), :112 (D2, 1 block) and
// :145 (D3, [256, 128] blocks); the sublane kernel launched at :180 (D4,
// take_along_axis along axis 0 of [8, 128] blocks); and the one-hot kernel
// launched at :219 (D5), which computes the row gather as a one-hot
// [P, KW] x [KW, C4] product on the TPU's matrix unit. The block shapes are
// the TPU's tiling and mean nothing here, so D1, D2 and D3 are one function;
// the one-hot product is the TPU's way to gather and is not carried over.
//
// What bounds them on an H100: bytes. Each reads its index and writes its
// output once and does no arithmetic; the gathered reads land in rows or
// blocks that stay in L1/L2 (a 512-byte lane row, a 4 KiB sublane block, a
// table row read by nearby points), so the table is read from device memory
// about once. Design: consecutive threads own consecutive 8- or 16-byte
// pieces of the index and the output, so both move in full sectors; the index and the
// output are streamed past the caches (__ldcs / __stcs) to leave L2 to the
// table, which is read through the read-only path (__ldg).
// gather_lanes gives each thread 4 consecutive outputs (one int4 of the
// index, one float4 of the output) and reads their 4 values from the row in
// L1. gather_sublanes gives each thread a 2-column strip of one [S, L]
// block: it loads the strip's S rows as float2 (coalesced across the warp,
// the block read once) and picks each output from registers, so no read is
// gathered; it takes S <= 8. (With 4-column strips it needed 45 registers,
// ran its blocks in 1.4 waves and was slower on the card.) gather_rows
// copies rows in 16-byte pieces (4 f32 or 8 bf16), 4 pieces a thread with
// all their index loads issued before their row loads; a warp copies a
// whole row of 32 pieces or more, or several whole rows (C = 64 f32 is 16
// pieces).
// Index arithmetic is 32-bit (a 64-bit division costs tens of instructions
// per output), so every tensor holds fewer than 2^31 elements (the wrappers
// check). PERF.md has the variants tried on the card and not kept.
//
// Indices are int32 and must lie in range: the kernels do not check them
// (the plain versions in ops/gather.py raise on one that does not).

#include "common.cuh"

namespace pmn {

constexpr unsigned kPiecesPerThread = 4;
constexpr int kMaxSublanes = 8;  // D4's block height, the TPU's sublane count
constexpr long long kMaxElements = (1LL << 31) - 1;

// out[e] = row(e)[idx[e]], row(e) the L-element row of output e.
__global__ void __launch_bounds__(kThreads) gather_lanes_kernel(
    const float* __restrict__ win, const int4* __restrict__ idx, float4* __restrict__ out,
    unsigned quads, unsigned L) {
  const unsigned q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= quads) return;
  const float* row = win + q * 4 / L * L;  // L % 4 == 0: the 4 outputs share a row
  const int4 i = __ldcs(idx + q);
  __stcs(out + q, make_float4(__ldg(row + i.x), __ldg(row + i.y), __ldg(row + i.z),
                              __ldg(row + i.w)));
}

// v[k] for k in [0, kMaxSublanes), by selects (a dynamic index into a
// register array would go through local memory).
__device__ __forceinline__ float pick(const float (&v)[kMaxSublanes], int k) {
  float r = v[0];
#pragma unroll
  for (int s = 1; s < kMaxSublanes; ++s) r = k == s ? v[s] : r;
  return r;
}

// A thread owns a 2-column strip of one [S, L] block (S <= kMaxSublanes):
// it loads the strip's S rows, then picks each output from registers.
__global__ void __launch_bounds__(kThreads) gather_sublanes_kernel(
    const float2* __restrict__ win, const int2* __restrict__ idx, float2* __restrict__ out,
    unsigned strips, int S, unsigned L2) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;  // (n, strip)
  if (t >= strips) return;
  const unsigned n = t / L2;
  const unsigned base = n * S * L2 + (t - n * L2);  // (n, row 0, strip), in float2
  float x[kMaxSublanes], y[kMaxSublanes];
#pragma unroll
  for (int s = 0; s < kMaxSublanes; ++s) {
    const float2 v = s < S ? __ldg(win + base + s * L2) : make_float2(0.f, 0.f);
    x[s] = v.x;
    y[s] = v.y;
  }
#pragma unroll
  for (int s = 0; s < kMaxSublanes; ++s) {
    if (s < S) {
      const int2 i = __ldcs(idx + base + s * L2);
      __stcs(out + base + s * L2, make_float2(pick(x, i.x), pick(y, i.y)));
    }
  }
}

// `vpr` 16-byte pieces per row; the payload type does not matter to a copy.
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const uint4* __restrict__ win, const int* __restrict__ idx, uint4* __restrict__ out,
    unsigned pieces, unsigned vpr, unsigned R, unsigned P) {
  const unsigned v0 = blockIdx.x * (kThreads * kPiecesPerThread) + threadIdx.x;
  int r[kPiecesPerThread];
  uint4 val[kPiecesPerThread];
#pragma unroll
  for (unsigned k = 0; k < kPiecesPerThread; ++k) {
    const unsigned v = v0 + k * kThreads;
    r[k] = v < pieces ? __ldg(idx + v / vpr) : 0;  // one address for a row's threads
  }
#pragma unroll
  for (unsigned k = 0; k < kPiecesPerThread; ++k) {
    const unsigned v = v0 + k * kThreads;
    if (v < pieces) {
      const unsigned row = v / vpr;  // (n, p)
      val[k] = __ldg(win + ((row / P * R + (unsigned)r[k]) * vpr + (v - row * vpr)));
    }
  }
#pragma unroll
  for (unsigned k = 0; k < kPiecesPerThread; ++k) {
    const unsigned v = v0 + k * kThreads;
    if (v < pieces) __stcs(out + v, val[k]);
  }
}

}  // namespace pmn

// win, idx, out [N, A, L]: win f32, idx int32 in [0, L), out f32;
// L % 4 == 0 and N * A * L < 2^31.
extern "C" int pmn_gather_lanes(const void* win, const void* idx, void* out, int N, int A, int L,
                                void* stream) {
  const long long total = (long long)N * A * L;
  if (L % 4 || total > pmn::kMaxElements) return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaSuccess;
  pmn::gather_lanes_kernel<<<pmn::num_blocks(total / 4), pmn::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(win), static_cast<const int4*>(idx), static_cast<float4*>(out),
      (unsigned)(total / 4), (unsigned)L);
  return (int)cudaGetLastError();
}

// win, idx, out [N, S, L]: win f32, idx int32 in [0, S), out f32;
// S <= 8, L % 4 == 0 and N * S * L < 2^31.
extern "C" int pmn_gather_sublanes(const void* win, const void* idx, void* out, int N, int S,
                                   int L, void* stream) {
  const long long total = (long long)N * S * L;
  if (S > pmn::kMaxSublanes || L % 4 || total > pmn::kMaxElements)
    return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaSuccess;
  const long long strips = (long long)N * (L / 2);
  pmn::gather_sublanes_kernel<<<pmn::num_blocks(strips), pmn::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(win), static_cast<const int2*>(idx), static_cast<float2*>(out),
      (unsigned)strips, S, (unsigned)(L / 2));
  return (int)cudaGetLastError();
}

// win [N, R, C] (f32, or bf16 when bf16 != 0), idx [N, P] int32 in [0, R)
// -> out [N, P, C] of win's type; C * element size % 16 == 0, and the table
// and the output hold fewer than 2^31 elements.
extern "C" int pmn_gather_rows(const void* win, const void* idx, void* out, int N, int R, int P,
                               int C, int bf16, void* stream) {
  const int per_piece = bf16 ? 8 : 4;
  if (C % per_piece || (long long)N * R * C > pmn::kMaxElements ||
      (long long)N * P * C > pmn::kMaxElements)
    return (int)cudaErrorInvalidValue;
  const unsigned pieces = (unsigned)((long long)N * P * (C / per_piece));
  if (pieces == 0) return (int)cudaSuccess;
  const unsigned tile = pmn::kThreads * pmn::kPiecesPerThread;
  pmn::gather_rows_kernel<<<(pieces + tile - 1) / tile, pmn::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(win), static_cast<const int*>(idx), static_cast<uint4*>(out),
      pieces, (unsigned)(C / per_piece), (unsigned)R, (unsigned)P);
  return (int)cudaGetLastError();
}

