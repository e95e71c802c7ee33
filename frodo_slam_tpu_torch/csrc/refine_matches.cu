// Coarse-to-fine dilated descriptor refine over 2-D query tiles.
//
// Spec: the reference refine_matches_kernel (matching_kernels.cu:25-125), as
// transcribed by refine_matches_gather in frodo_slam_tpu/ops/matching.py and
// by refine_matches_plain in frodo_slam_tpu_torch/ops/refine_kernel.py. For
// each query: levels d = dilation_max .. 1, each a (2r+1)^2 window at stride
// d around the running best; probes go u-major; off-image probes never win;
// a probe must be strictly greater to win; each level recentres at the best.
//
// Numerics: descriptors arrive as bf16; every product of two bf16 values is
// exact in f32, and the dot is a sequential f32 fmaf over f = 0..23, so the
// result equals the plain version's sequential f32 sum bit for bit.
//
// Design: one CTA of 384 threads takes a 2-D tile of queries, 32 x 12 of the
// query grid (the frame-2 raster when n = h * w), or 384 consecutive queries
// otherwise. One thread per query holds its descriptor in 24 f32 registers.
// Neighbouring queries of a tile probe overlapping windows, so the SM's L1
// serves most of a tile's row reads once one query has fetched them (a
// shared-memory box staged per level served most probes of coherent seeds
// and made nothing faster: its copy and barrier cost what the L1 hits
// saved; see PERF.md). The radius is a template parameter and a window
// column's 2R+1 dots are interleaved, so their loads and FMA chains are in
// flight together.
//
// What bounds it: at 384x512 a cold refine does 5 levels x 49 probes x 24
// FMAs per query, ~2.3 GFLOP in f32 (the dot must stay a sequential f32 fmaf
// for bitwise equality, so not the tensor cores): 0.035 ms at 67 TFLOP/s;
// its inputs and outputs are ~38 MB (0.012 ms at 3.35 TB/s). The probes
// read 2.3 GB of 48-byte rows, most of them from L1.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDesc = 24;           // descriptor width (bf16): 48 bytes a row
constexpr int kRowVec = kDesc / 8;  // 16-byte loads per row
constexpr int kThreads = 384;  // queries per CTA: 168 registers a thread, no spills

__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// One level's (2R+1)^2 probes around (u0, v0) at stride d, u-major. A window
// column's 2R+1 dots run interleaved, channel by channel, so 2R+1
// independent FMA chains (each in channel order, as the plain version sums)
// and their loads are in flight together. Branch-free: an off-image probe
// reads a clamped in-range row and cannot win.
template <int R>
__device__ __forceinline__ void probe_level(const uint4* __restrict__ img, const float (&q)[kDesc],
                                            int d, int h, int w, int u0, int v0, float& best,
                                            int& ub, int& vb) {
  constexpr int kSide = 2 * R + 1;
  const int rd = R * d;
#pragma unroll
  for (int i = 0; i < kSide; ++i) {
    const int u = u0 - rd + i * d;
    const bool u_in = u >= 0 && u < w;
    const int uc = min(max(u, 0), w - 1);
    int rows[kSide];  // 16-byte offsets from img (an image holds < 2^31 of them)
#pragma unroll
    for (int j = 0; j < kSide; ++j) {
      const int vc = min(max(v0 - rd + j * d, 0), h - 1);
      rows[j] = (vc * w + uc) * kRowVec;
    }
    float acc[kSide];
#pragma unroll
    for (int j = 0; j < kSide; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < kRowVec; ++k) {
      uint4 x[kSide];
#pragma unroll
      for (int j = 0; j < kSide; ++j) x[j] = __ldg(img + rows[j] + k);
#pragma unroll
      for (int j = 0; j < kSide; ++j) {
        acc[j] = fmaf(q[8 * k + 0], bf16_lo(x[j].x), acc[j]);
        acc[j] = fmaf(q[8 * k + 1], bf16_hi(x[j].x), acc[j]);
        acc[j] = fmaf(q[8 * k + 2], bf16_lo(x[j].y), acc[j]);
        acc[j] = fmaf(q[8 * k + 3], bf16_hi(x[j].y), acc[j]);
        acc[j] = fmaf(q[8 * k + 4], bf16_lo(x[j].z), acc[j]);
        acc[j] = fmaf(q[8 * k + 5], bf16_hi(x[j].z), acc[j]);
        acc[j] = fmaf(q[8 * k + 6], bf16_lo(x[j].w), acc[j]);
        acc[j] = fmaf(q[8 * k + 7], bf16_hi(x[j].w), acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSide; ++j) {  // in probe order: strictly greater wins
      const int v = v0 - rd + j * d;
      const bool win = u_in && v >= 0 && v < h && acc[j] > best;  // off-image: never
      best = win ? acc[j] : best;
      ub = win ? u : ub;
      vb = win ? v : vb;
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
refine_tiles_kernel(const uint4* __restrict__ d11,   // (b, h*w, 3) x 16B
                    const uint4* __restrict__ d21,   // (b*n, 3) x 16B
                    const int2* __restrict__ p1,     // (b*n) [u, v]
                    int2* __restrict__ p1_out,       // (b*n) [u, v]
                    float* __restrict__ scores,      // (b*n)
                    int h, int w, int n, int gw, int tile_w, int dilation_max) {
  const int tid = threadIdx.x;
  const int tile_h = kThreads / tile_w;
  const int x = blockIdx.x * tile_w + tid % tile_w;
  const int y = blockIdx.y * tile_h + tid / tile_w;
  const int k = y * gw + x;
  if (x >= gw || k >= n) return;
  const long long t = (long long)blockIdx.z * n + k;

  float q[kDesc];
  const uint4* qrow = d21 + t * kRowVec;
#pragma unroll
  for (int c = 0; c < kRowVec; ++c) {
    const uint4 v = qrow[c];
    q[8 * c + 0] = bf16_lo(v.x); q[8 * c + 1] = bf16_hi(v.x);
    q[8 * c + 2] = bf16_lo(v.y); q[8 * c + 3] = bf16_hi(v.y);
    q[8 * c + 4] = bf16_lo(v.z); q[8 * c + 5] = bf16_hi(v.z);
    q[8 * c + 6] = bf16_lo(v.w); q[8 * c + 7] = bf16_hi(v.w);
  }
  const uint4* img = d11 + (long long)blockIdx.z * h * w * kRowVec;
  const int2 c = p1[t];
  int ub = c.x, vb = c.y;
  float best = __uint_as_float(0xff800000u);  // -inf
  for (int d = dilation_max; d >= 1; --d) probe_level<R>(img, q, d, h, w, ub, vb, best, ub, vb);
  p1_out[t] = make_int2(ub, vb);
  scores[t] = best;
}

template <int R>
int launch(const void* d11, const void* d21, const void* p1, void* p1_out, void* scores, int b,
           int h, int w, int n, int gw, int tile_w, int dilation_max, cudaStream_t stream) {
  const int tile_h = kThreads / tile_w;
  const int gh = (n + gw - 1) / gw;
  const dim3 grid((gw + tile_w - 1) / tile_w, (gh + tile_h - 1) / tile_h, b);
  refine_tiles_kernel<R><<<grid, kThreads, 0, stream>>>(
      (const uint4*)d11, (const uint4*)d21, (const int2*)p1, (int2*)p1_out, (float*)scores, h, w,
      n, gw, tile_w, dilation_max);
  return (int)cudaGetLastError();
}

}  // namespace

// gw: the query grid's width (w when n = h * w, else n); tile_w: the tile's
// width in queries (32, or 384 for a 1-D tile). Returns the launch's
// cudaError_t (0 on success), 1 for a radius outside 0..3 or a tile width
// that does not divide the CTA's 384 threads.
extern "C" int refine_matches_launch(const void* d11, const void* d21, const void* p1,
                                     void* p1_out, void* scores, int b, int h, int w, int n,
                                     int gw, int tile_w, int radius, int dilation_max,
                                     void* stream) {
  if ((long long)b * n == 0) return 0;
  if (tile_w < 1 || kThreads % tile_w != 0 || gw < 1) return 1;
  cudaStream_t st = (cudaStream_t)stream;
  switch (radius) {
    case 0: return launch<0>(d11, d21, p1, p1_out, scores, b, h, w, n, gw, tile_w, dilation_max, st);
    case 1: return launch<1>(d11, d21, p1, p1_out, scores, b, h, w, n, gw, tile_w, dilation_max, st);
    case 2: return launch<2>(d11, d21, p1, p1_out, scores, b, h, w, n, gw, tile_w, dilation_max, st);
    case 3: return launch<3>(d11, d21, p1, p1_out, scores, b, h, w, n, gw, tile_w, dilation_max, st);
    default: return 1;
  }
}
