// A camera frame's resize (PIL's Lanczos or bicubic resampler), centre crop
// and ImgNorm, to the network input.
//
// Spec: resize_normalize_plain in frodo_slam_tpu_torch/ops/resample_kernel.py,
// which is data/image.py's resize_img (the reference's
// mast3r_utils.py:369-460) done as PIL's ImagingResample does it
// (libImaging/Resample.c, 8 bits a channel):
//   u    = uint8(trunc(f32(x * 255)))                     (np.uint8(img * 255))
//   tmp  = clip((2^21 + sum_t u[y][xmin(x') + t] * kx[x'][t]) >> 22, 0, 255)
//   v    = clip((2^21 + sum_t tmp[ymin(y') + t][x'] * ky[y'][t]) >> 22, 0, 255)
//   out  = (f32(v) / 255 - 0.5) / 0.5                      (IEEE division)
// The tables (bounds: first tap and tap count; kk: 22-bit fixed-point
// weights) are PIL's, built in double on the host once a shape. An axis
// that keeps its size has the identity table (one tap of 2^22), which gives
// the bytes of PIL's skipped pass. Sums run over the taps in order in int32,
// as PIL's do.
//
// Replaces no TPU kernel: both packages resized with PIL on the host.
//
// Two launches: resample_h quantises the f32 frame and runs the horizontal
// pass over the rows the crop's vertical taps read and the crop's columns,
// into a uint8 image; resample_v runs the vertical pass over the crop's rows,
// normalises, and writes the f32 output at the strides it is given (the
// portrait transpose swaps them). A thread makes one pixel's three channels.
//
// What bounds it: the f32 frame read once and the f32 output written once:
// 6.05 MB at 480x640 -> 384x512, 1.8 us at 3.35 TB/s. A pixel's taps are
// re-read by its neighbours from L1.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (no --use_fast_math; the normalisation uses
//             __fdiv_rn and __fsub_rn explicitly).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPrecisionBits = 22;

__device__ __forceinline__ int quantise(float x) {
  // an f32 product, then C's float -> int -> uint8 conversion, as numpy's
  // astype(uint8) does on values in [0, 256)
  return (int)(unsigned char)(int)__fmul_rn(x, 255.0f);
}
__device__ __forceinline__ int quantise(unsigned char x) { return x; }

__device__ __forceinline__ unsigned char clip8(int ss) {
  const int v = ss >> kPrecisionBits;
  return (unsigned char)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__device__ __forceinline__ float normalise(unsigned char v) {
  return __fdiv_rn(__fsub_rn(__fdiv_rn((float)v, 255.0f), 0.5f), 0.5f);
}

// tmp[r][c] of the rows [r0, r0 + rows) and the columns [c0, c0 + cols) of
// the horizontally resized frame; src is (H, W, 3) contiguous
template <typename T>
__global__ void __launch_bounds__(kThreads)
resample_h(const T* __restrict__ src, int W, unsigned char* __restrict__ tmp, int r0, int rows, int c0,
           int cols, const int* __restrict__ bounds, const int* __restrict__ kk, int ksize) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  const int c = (int)(i % cols);
  const int r = (int)(i / cols);
  const int xo = c0 + c;
  const int xmin = __ldg(bounds + 2 * xo);
  const int n = __ldg(bounds + 2 * xo + 1);
  const int* k = kk + (long long)xo * ksize;
  const T* p = src + ((long long)(r0 + r) * W + xmin) * 3;
  int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
  for (int t = 0; t < n; ++t, p += 3) {
    const int w = __ldg(k + t);
    s0 += quantise(p[0]) * w;
    s1 += quantise(p[1]) * w;
    s2 += quantise(p[2]) * w;
  }
  unsigned char* o = tmp + i * 3;
  o[0] = clip8(s0);
  o[1] = clip8(s1);
  o[2] = clip8(s2);
}

// out at (r, c) of the crop's h rows and cols columns, element strides so_r
// and so_c (channels unit stride); tmp's row 0 is the frame's row r0
__global__ void __launch_bounds__(kThreads)
resample_v(const unsigned char* __restrict__ tmp, int cols, int r0, int y0, int h,
           const int* __restrict__ bounds, const int* __restrict__ kk, int ksize, float* __restrict__ out,
           long long so_r, long long so_c) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)h * cols) return;
  const int c = (int)(i % cols);
  const int r = (int)(i / cols);
  const int yo = y0 + r;
  const int ymin = __ldg(bounds + 2 * yo) - r0;
  const int n = __ldg(bounds + 2 * yo + 1);
  const int* k = kk + (long long)yo * ksize;
  const unsigned char* p = tmp + ((long long)ymin * cols + c) * 3;
  const long long step = 3LL * cols;
  int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
  for (int t = 0; t < n; ++t, p += step) {
    const int w = __ldg(k + t);
    s0 += p[0] * w;
    s1 += p[1] * w;
    s2 += p[2] * w;
  }
  float* o = out + r * so_r + c * so_c;
  o[0] = normalise(clip8(s0));
  o[1] = normalise(clip8(s1));
  o[2] = normalise(clip8(s2));
}

unsigned blocks(long long work) { return (unsigned)((work + kThreads - 1) / kThreads); }

}  // namespace

// src (H, W, 3) contiguous, f32 in [0, 1] (src_u8 = 0) or uint8 already
// quantised (1); tmp (rows, cols, 3) uint8 scratch for the frame's rows
// [r0, r0 + rows) and the crop's columns [c0, c0 + cols); bx/kx (Wout, 2)
// and (Wout, kxs), by/ky (Hout, 2) and (Hout, kys) int32 tables; the crop's
// rows [y0, y0 + h); out f32 at element strides so_r, so_c of the crop's rows
// and columns. Returns the launches' cudaError_t (0 on success), or 1 for
// arguments the kernel does not take.
extern "C" int resample_launch(const void* src, int src_u8, int H, int W, void* tmp, int r0, int rows,
                               int c0, int cols, const void* bx, const void* kx, int kxs, const void* by,
                               const void* ky, int kys, int y0, int h, void* out, long long so_r,
                               long long so_c, void* stream) {
  if (H <= 0 || W <= 0 || kxs <= 0 || kys <= 0 || r0 < 0 || rows < 0 || r0 + rows > H) return 1;
  if ((long long)rows * cols == 0 || (long long)h * cols == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned char* t8 = (unsigned char*)tmp;
  const long long hwork = (long long)rows * cols, vwork = (long long)h * cols;
  if (hwork / kThreads >= 0x7fffffffLL || vwork / kThreads >= 0x7fffffffLL) return 1;
  if (src_u8)
    resample_h<unsigned char><<<blocks(hwork), kThreads, 0, st>>>(
        (const unsigned char*)src, W, t8, r0, rows, c0, cols, (const int*)bx, (const int*)kx, kxs);
  else
    resample_h<float><<<blocks(hwork), kThreads, 0, st>>>(
        (const float*)src, W, t8, r0, rows, c0, cols, (const int*)bx, (const int*)kx, kxs);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  resample_v<<<blocks(vwork), kThreads, 0, st>>>(t8, cols, r0, y0, h, (const int*)by, (const int*)ky, kys,
                                                 (float*)out, so_r, so_c);
  return (int)cudaGetLastError();
}
