// Backend BA ray-edge normal equations: per directed edge, the 7x7
// relative-pose Gram B = sum_p J^T W J and g = sum_p J^T W e over its points.
//
// Spec: _ray_reduce_kernel in frodo_slam_tpu/ops/ba_reduce_pallas.py (the
// reference's ray_align_kernel, gn_kernels.cu:576-907, reduced to the
// relative pose), as transcribed by ray_edge_systems_plain in
// frodo_slam_tpu_torch/ops/ba_reduce_kernel.py. Per point, with the edge's
// relative Sim(3) [sR | t]:
//   P = sR Xj + t, n = |P|, rj = P / n, ri = Xi / |Xi|  (both norms guarded
//   by max(., 1e-12));
//   residuals e = [rj - ri (3), n - |Xi| (1)], whitened by w0 / sigma_ray and
//   w0 / sigma_dist, Huber weight where(|x| <= k, 1, k / max(|x|, 1e-12));
//   Jacobian rows  ray k:  [ (I - rj rj^T)_k / n | -skew(rj)_k | 0 ]
//                  dist:   [ rj^T              | 0 0 0       | n ]
// with literal zeros skipped. Outputs B (E, 7, 7) (both triangles written
// from the 28 upper-triangle sums) and g (E, 7).
//
// Design: pass 1 gives each (point chunk, edge) one CTA of 256 threads; each
// thread streams its points with coalesced loads from the channel-major
// XiT/XjT/w0 and keeps the 35 sums in registers; the CTA reduces them with
// warp shuffles and shared memory into one partial row. Pass 2 sums each
// edge's partial rows in chunk order. No atomics: a result is the same from
// run to run. Templated on the scalar type (float, double).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOut = 35;  // 28 upper-triangle B entries (row-major, a <= b) + 7 g

__device__ __forceinline__ float xsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double xsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float xabs(float x) { return fabsf(x); }
__device__ __forceinline__ double xabs(double x) { return fabs(x); }
__device__ __forceinline__ float xmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double xmax(double a, double b) { return fmax(a, b); }

// Is entry a of Jacobian row k structurally nonzero? Rows 0-2 are the ray
// rows (no scale column; rotation column 3 + k vanishes), row 3 the distance
// row (no rotation block). Constant-folded once the loops are unrolled.
__device__ __forceinline__ constexpr bool nz(int k, int a) {
  return k == 3 ? (a < 3 || a == 6) : (a < 3 || (a < 6 && a - 3 != k));
}

// Row-major upper-triangle index of B[a][b], a <= b: every index into the
// per-thread arrays is a compile-time constant once the loops are unrolled,
// so the arrays stay in registers.
__device__ __forceinline__ constexpr int triu(int a, int b) {
  return a * 7 - a * (a - 1) / 2 + (b - a);
}

template <typename T>
__device__ __forceinline__ T huber_w(T sw, T e, T k, T eps) {
  const T x = xabs(sw * e);
  return x <= k ? T(1) : k / xmax(x, eps);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ray_partial_kernel(const T* __restrict__ scal,  // (E, 12) [sR row-major | t]
                   const T* __restrict__ xiT,   // (E, 3, N)
                   const T* __restrict__ xjT,   // (E, 3, N)
                   const T* __restrict__ w0,    // (E, N)
                   T* __restrict__ partial,     // (E, chunks, kOut)
                   int n_pts, int chunk, T inv_sr, T inv_sd, T huber_k) {
  const int c = blockIdx.x;
  const int e = blockIdx.y;
  const int chunks = gridDim.x;
  const T eps = T(1e-12);

  T s[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) s[k] = scal[e * 12 + k];

  const T* xi = xiT + (size_t)e * 3 * n_pts;
  const T* xj = xjT + (size_t)e * 3 * n_pts;
  const T* ww = w0 + (size_t)e * n_pts;

  T acc[kOut];
#pragma unroll
  for (int t = 0; t < kOut; ++t) acc[t] = T(0);

  const int start = c * chunk;
  const int end = min(start + chunk, n_pts);
  for (int p = start + threadIdx.x; p < end; p += kThreads) {
    const T xi0 = __ldg(xi + p), xi1 = __ldg(xi + n_pts + p), xi2 = __ldg(xi + 2 * n_pts + p);
    const T xj0 = __ldg(xj + p), xj1 = __ldg(xj + n_pts + p), xj2 = __ldg(xj + 2 * n_pts + p);
    const T w = __ldg(ww + p);

    const T p0 = s[0] * xj0 + s[1] * xj1 + s[2] * xj2 + s[9];
    const T p1 = s[3] * xj0 + s[4] * xj1 + s[5] * xj2 + s[10];
    const T p2 = s[6] * xj0 + s[7] * xj1 + s[8] * xj2 + s[11];

    const T ni = xsqrt(xi0 * xi0 + xi1 * xi1 + xi2 * xi2);
    const T ni_inv = T(1) / xmax(ni, eps);
    const T n = xsqrt(p0 * p0 + p1 * p1 + p2 * p2);
    const T n_inv = T(1) / xmax(n, eps);
    const T a0 = p0 * n_inv, a1 = p1 * n_inv, a2 = p2 * n_inv;

    const T err[4] = {a0 - xi0 * ni_inv, a1 - xi1 * ni_inv, a2 - xi2 * ni_inv, n - ni};
    const T sr = w * inv_sr;
    const T sd = w * inv_sd;
    const T wk[4] = {huber_w(sr, err[0], huber_k, eps) * sr * sr,
                     huber_w(sr, err[1], huber_k, eps) * sr * sr,
                     huber_w(sr, err[2], huber_k, eps) * sr * sr,
                     huber_w(sd, err[3], huber_k, eps) * sd * sd};

    // Dray = (I - rj rj^T) / n
    const T d00 = (T(1) - a0 * a0) * n_inv, d01 = (-a0 * a1) * n_inv, d02 = (-a0 * a2) * n_inv;
    const T d11 = (T(1) - a1 * a1) * n_inv, d12 = (-a1 * a2) * n_inv;
    const T d22 = (T(1) - a2 * a2) * n_inv;
    const T z = T(0);  // never read: nz() masks it
    const T J[4][7] = {{d00, d01, d02, z, a2, -a1, z},
                       {d01, d11, d12, -a2, z, a0, z},
                       {d02, d12, d22, a1, -a0, z, z},
                       {a0, a1, a2, z, z, z, n}};

#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T we = wk[k] * err[k];
#pragma unroll
      for (int a = 0; a < 7; ++a) {
        if (!nz(k, a)) continue;
        const T q = wk[k] * J[k][a];
#pragma unroll
        for (int b = a; b < 7; ++b) {
          if (nz(k, b)) acc[triu(a, b)] += q * J[k][b];
        }
        acc[28 + a] += we * J[k][a];
      }
    }
  }

  __shared__ T red[kWarps][kOut];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < kOut; ++t) {
    const T v = warp_sum(acc[t]);
    if (lane == 0) red[warp][t] = v;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    T v = T(0);
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += red[k][threadIdx.x];
    partial[((size_t)e * chunks + c) * kOut + threadIdx.x] = v;
  }
}

// One CTA per edge: sum the partial rows in chunk order, write B (both
// triangles) and g.
template <typename T>
__global__ void ray_finish_kernel(const T* __restrict__ partial, T* __restrict__ B,
                                  T* __restrict__ g, int chunks) {
  const int e = blockIdx.x;
  const int t = threadIdx.x;
  if (t >= kOut) return;
  T v = T(0);
  for (int c = 0; c < chunks; ++c) v += partial[((size_t)e * chunks + c) * kOut + t];
  if (t >= 28) {
    g[e * 7 + (t - 28)] = v;
    return;
  }
  int a = 0, r = t;  // upper-triangle index t -> (a, b), row-major
  while (r >= 7 - a) {
    r -= 7 - a;
    ++a;
  }
  const int b = a + r;
  B[e * 49 + a * 7 + b] = v;
  B[e * 49 + b * 7 + a] = v;
}

template <typename T>
int launch(const void* scal, const void* xiT, const void* xjT, const void* w0, void* partial,
           void* B, void* g, int n_edges, int n_pts, int chunk, T inv_sr, T inv_sd, T huber_k,
           void* stream) {
  if (n_edges == 0 || n_pts == 0) return 0;
  const int chunks = (n_pts + chunk - 1) / chunk;
  const cudaStream_t st = (cudaStream_t)stream;
  ray_partial_kernel<T><<<dim3(chunks, n_edges), kThreads, 0, st>>>(
      (const T*)scal, (const T*)xiT, (const T*)xjT, (const T*)w0, (T*)partial, n_pts, chunk,
      inv_sr, inv_sd, huber_k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ray_finish_kernel<T><<<n_edges, 64, 0, st>>>((const T*)partial, (T*)B, (T*)g, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ray_edge_systems_f32(const void* scal, const void* xiT, const void* xjT,
                                    const void* w0, void* partial, void* B, void* g,
                                    int n_edges, int n_pts, int chunk, float inv_sr,
                                    float inv_sd, float huber_k, void* stream) {
  return launch<float>(scal, xiT, xjT, w0, partial, B, g, n_edges, n_pts, chunk, inv_sr, inv_sd,
                       huber_k, stream);
}

extern "C" int ray_edge_systems_f64(const void* scal, const void* xiT, const void* xjT,
                                    const void* w0, void* partial, void* B, void* g,
                                    int n_edges, int n_pts, int chunk, double inv_sr,
                                    double inv_sd, double huber_k, void* stream) {
  return launch<double>(scal, xiT, xjT, w0, partial, B, g, n_edges, n_pts, chunk, inv_sr,
                        inv_sd, huber_k, stream);
}
