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
// Inputs: scal (E, 12), XiT (E, 3, N) channel-major, w0 (E, N), the
// window's pointmaps X (P, N, 3) in the store's own layout, jj (E,) int32
// and active (E,) bool. Xj of row e is X[jj[e]], read here: no (E, 3, N)
// copy is made. An inactive row reads no points (nor its jj) and gets
// B = g = 0 exactly.
//
// What bounds it: each live row reads Xi and w0 once (16 bytes a point in
// f32) and each distinct frame's slab once from HBM (12 bytes a point; rows
// with the same jj meet it in the 50 MB L2), against ~260 operations a
// point: bytes, at 3.35 TB/s. The earlier two-pass design made each thread load 7
// scalars and then run its ~260 dependent operations before the next load,
// so the bytes in flight depended on occupancy alone (~57% of HBM at large
// E), streamed dead rows, and was two launches.
//
// Design: ONE launch, grid (chunks, E). In each CTA one producer warp
// streams the chunk's tiles (XiT's three channel rows, w0 and the X[jj]
// slab, 2 KB of each a tile) through a 4-stage shared-memory ring with 1-D
// cp.async.bulk copies completed on full/empty mbarriers, so 56 KB a CTA
// stay in flight whatever the arithmetic does. Eight consumer warps compute
// from shared memory and keep the 35 sums in registers; the CTA reduces them
// (warp shuffles, then warps in order) into one partial row. The last CTA
// of an edge to finish (a per-edge ticket: __threadfence, then atomicAdd)
// sums the edge's partial rows in chunk order, writes B and g and resets
// the ticket, so the ticket buffer is zero again for the next call on the
// stream. No atomics on the sums: two calls are bitwise equal. The host
// sizes the chunks from the number of live rows so that one wave of live
// CTAs fills the card. A row whose arrays are not 16-byte aligned (N not a
// multiple of 16 bytes) takes the same ring, filled by the producer warp's
// own loads instead of bulk copies. Templated on the scalar type.
//
// f32 takes the SFU's approximate rsqrt and reciprocal (the kernel is bound
// by instruction issue once its loads stream); the residuals are formed from
// d = P - Xi, so near the optimum, where unit(P) - unit(Xi) cancels, they
// carry the rounding of d and not that of the unit vectors. f64 divides
// exactly.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kConsumers = 256;              // 8 consumer warps
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;    // + one producer warp
constexpr int kStages = 4;
constexpr int kSliceBytes = 2048;            // one channel row of a tile
constexpr int kStageBytes = 7 * kSliceBytes; // XiT (3) + w0 (1) + X[jj] slab (3)
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kRedOffset = kBarOffset + 16 * kStages;
constexpr int kSmemBytes = kRedOffset + kWarps * 35 * 8 + 16;
constexpr int kOut = 35;  // 28 upper-triangle B entries (row-major, a <= b) + 7 g

template <typename T>
struct Tile {
  static constexpr int kPts = kSliceBytes / sizeof(T);  // 512 f32, 256 f64
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 2 : 1;
};

// f32: the SFU's approximate reciprocal square root and reciprocal (2 ulp).
// The IEEE sequences cost ~10 instructions each and the kernel is bound by
// its instruction issue once the loads stream; the residuals are formed
// without cancellation (accumulate), so a 2-ulp factor only scales small
// terms. f64: exact.
__device__ __forceinline__ float xrsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double xrsqrt(double x) { return 1.0 / sqrt(x); }
__device__ __forceinline__ float xrcp(float x) { return __fdividef(1.0f, x); }
__device__ __forceinline__ double xrcp(double x) { return 1.0 / x; }
__device__ __forceinline__ float xfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double xfma(double a, double b, double c) { return fma(a, b, c); }
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
  return x <= k ? T(1) : k * xrcp(xmax(x, eps));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// PTX wrappers: mbarrier, 1-D bulk copy, named barrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// One point's terms added to the 35 sums.
template <typename T>
__device__ __forceinline__ void accumulate(T (&acc)[kOut], const T (&s)[12], T xi0, T xi1, T xi2,
                                           T xj0, T xj1, T xj2, T w, T inv_sr, T inv_sd,
                                           T huber_k) {
  const T eps = T(1e-12), eps2 = T(1e-24);
  // d = P - Xi = sR Xj + t - Xi, each row's diagonal product first so that
  // one rounding leaves a small value (sR ~ I and Xj ~ Xi near the optimum)
  // and every later rounding is relative to small terms; then P = Xi + d.
  const T d0 = xfma(s[2], xj2, xfma(s[1], xj1, xfma(s[0], xj0, -xi0))) + s[9];
  const T d1 = xfma(s[5], xj2, xfma(s[3], xj0, xfma(s[4], xj1, -xi1))) + s[10];
  const T d2 = xfma(s[7], xj1, xfma(s[6], xj0, xfma(s[8], xj2, -xi2))) + s[11];
  const T p0 = xi0 + d0, p1 = xi1 + d1, p2 = xi2 + d2;

  // 1 / max(|v|, eps) = rsqrt(max(|v|^2, eps^2)); |v| = |v|^2 times that
  const T ni2 = xi0 * xi0 + xi1 * xi1 + xi2 * xi2;
  const T ni_inv = xrsqrt(xmax(ni2, eps2));
  const T ni = ni2 * ni_inv;
  const T n2 = p0 * p0 + p1 * p1 + p2 * p2;
  const T n_inv = xrsqrt(xmax(n2, eps2));
  const T n = n2 * n_inv;
  const T a0 = p0 * n_inv, a1 = p1 * n_inv, a2 = p2 * n_inv;

  // Residuals without cancellation: near the optimum P ~ Xi, and
  // unit(P) - unit(Xi) or |P| - |Xi| formed directly is rounding noise of
  // the unit vectors. From d: |P| - |Xi| = (2 Xi.d + d.d) / (|P| + |Xi|) and
  // unit(P) - unit(Xi) = (d - Xi (|P| - |Xi|) / |Xi|) / |P| (the same values
  // wherever both norms exceed eps).
  const T dn = (T(2) * (xi0 * d0 + xi1 * d1 + xi2 * d2) + (d0 * d0 + d1 * d1 + d2 * d2)) *
               xrcp(xmax(n + ni, eps));
  const T c = dn * ni_inv;
  const T err[4] = {(d0 - xi0 * c) * n_inv, (d1 - xi1 * c) * n_inv, (d2 - xi2 * c) * n_inv, dn};
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

// kBulk: the producer fills the ring with cp.async.bulk (every array 16-byte
// aligned, N * sizeof(T) a multiple of 16); else with its lanes' own loads.
template <typename T, bool kBulk>
__global__ void __launch_bounds__(kThreads, Tile<T>::kMinBlocks)
ray_edge_kernel(const T* __restrict__ scal,    // (E, 12) [sR row-major | t]
                const T* __restrict__ xiT,     // (E, 3, N)
                const T* __restrict__ w0,      // (E, N)
                const T* __restrict__ X,       // (P, N, 3)
                const int* __restrict__ jj,    // (E,)
                const uint8_t* __restrict__ active,  // (E,) bool
                T* __restrict__ B,             // (E, 7, 7)
                T* __restrict__ g,             // (E, 7)
                T* __restrict__ partial,       // (E, chunks, kOut)
                unsigned* __restrict__ tickets,  // (>= E,), zero between calls
                int n_pts, int n_frames, int tiles_per_chunk, T inv_sr, T inv_sd, T huber_k) {
  constexpr int kPts = Tile<T>::kPts;
  extern __shared__ __align__(128) uint8_t smem[];
  const int c = blockIdx.x;
  const int e = blockIdx.y;
  const int chunks = gridDim.x;
  const int tid = threadIdx.x;

  if (!active[e]) {  // reads no points; one CTA writes the zeros
    if (c == 0 && tid < 56) {
      if (tid < 49) B[(size_t)e * 49 + tid] = T(0);
      else g[(size_t)e * 7 + tid - 49] = T(0);
    }
    return;
  }
  const int j = jj[e];
  if (j < 0 || j >= n_frames) __trap();  // jj must index X

  const int n_tiles = (n_pts + kPts - 1) / kPts;
  const int tile0 = c * tiles_per_chunk;
  const int count = max(0, min(tile0 + tiles_per_chunk, n_tiles) - tile0);
  const uint32_t base = smem_u32(smem);
  auto full = [&](int s) { return base + kBarOffset + 8 * s; };
  auto empty = [&](int s) { return base + kBarOffset + 8 * kStages + 8 * s; };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), kBulk ? 1 : 32);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const T* xi = xiT + (size_t)e * 3 * n_pts;
  const T* ww = w0 + (size_t)e * n_pts;
  const T* xj = X + (size_t)j * 3 * n_pts;

  if (tid >= kConsumers) {  // producer warp
    const int lane = tid - kConsumers;
    for (int t = 0; t < count; ++t) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait(empty(s), ((t / kStages) - 1) & 1);
      const int p0 = (tile0 + t) * kPts;
      const int len = min(kPts, n_pts - p0);
      if constexpr (kBulk) {
        if (lane == 0) {
          const uint32_t row = len * sizeof(T);
          const uint32_t dst = base + s * kStageBytes;
          mbar_expect_tx(full(s), 7 * row);
#pragma unroll
          for (int k = 0; k < 3; ++k)
            bulk_load(dst + k * kSliceBytes, xi + (size_t)k * n_pts + p0, row, full(s));
          bulk_load(dst + 3 * kSliceBytes, ww + p0, row, full(s));
          bulk_load(dst + 4 * kSliceBytes, xj + (size_t)3 * p0, 3 * row, full(s));
        }
      } else {
        T* st = reinterpret_cast<T*>(smem + s * kStageBytes);
        for (int i = lane; i < len; i += 32) {
#pragma unroll
          for (int k = 0; k < 3; ++k) st[k * kPts + i] = xi[(size_t)k * n_pts + p0 + i];
          st[3 * kPts + i] = ww[p0 + i];
        }
        for (int i = lane; i < 3 * len; i += 32) st[4 * kPts + i] = xj[(size_t)3 * p0 + i];
        mbar_arrive(full(s));  // release: this lane's stores
      }
    }
    return;
  }

  // consumers
  T s[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) s[k] = scal[(size_t)e * 12 + k];
  T acc[kOut];
#pragma unroll
  for (int t = 0; t < kOut; ++t) acc[t] = T(0);

  for (int t = 0; t < count; ++t) {
    const int st_i = t % kStages;
    mbar_wait(full(st_i), (t / kStages) & 1);
    const int len = min(kPts, n_pts - (tile0 + t) * kPts);
    const T* st = reinterpret_cast<const T*>(smem + st_i * kStageBytes);
    auto point = [&](int i) {
      accumulate(acc, s, st[i], st[kPts + i], st[2 * kPts + i], st[4 * kPts + 3 * i],
                 st[4 * kPts + 3 * i + 1], st[4 * kPts + 3 * i + 2], st[3 * kPts + i], inv_sr,
                 inv_sd, huber_k);
    };
    if (len == kPts) {  // a full tile: no guard, so a thread's points interleave
#pragma unroll
      for (int q = 0; q < kPts / kConsumers; ++q) point(tid + q * kConsumers);
    } else {
      for (int i = tid; i < len; i += kConsumers) point(i);
    }
    mbar_arrive(empty(st_i));
  }

  // CTA reduction in a fixed order: lanes by shuffles, then warps in order
  T* red = reinterpret_cast<T*>(smem + kRedOffset);
  int* last = reinterpret_cast<int*>(smem + kRedOffset + kWarps * kOut * 8);
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int t = 0; t < kOut; ++t) {
    const T v = warp_sum(acc[t]);
    if (lane == 0) red[warp * kOut + t] = v;
  }
  consumers_sync();
  if (tid < kOut) {
    T v = T(0);
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += red[k * kOut + tid];
    partial[((size_t)e * chunks + c) * kOut + tid] = v;
    __threadfence();  // the partial row is visible before the ticket counts it
  }
  consumers_sync();
  if (tid == 0) *last = atomicAdd(&tickets[e], 1u) == (unsigned)(chunks - 1);
  consumers_sync();
  if (!*last) return;

  // the edge's last CTA: its partial rows in chunk order, B (both triangles), g
  __threadfence();
  if (tid == 0) tickets[e] = 0u;
  if (tid >= kOut) return;
  T v = T(0);
  const T* pe = partial + (size_t)e * chunks * kOut + tid;
#pragma unroll 8
  for (int k = 0; k < chunks; ++k) v += __ldcg(pe + (size_t)k * kOut);
  if (tid >= 28) {
    g[(size_t)e * 7 + (tid - 28)] = v;
    return;
  }
  int a = 0, r = tid;  // upper-triangle index -> (a, b), row-major
  while (r >= 7 - a) {
    r -= 7 - a;
    ++a;
  }
  const int b = a + r;
  B[(size_t)e * 49 + a * 7 + b] = v;
  B[(size_t)e * 49 + b * 7 + a] = v;
}

template <typename T, bool kBulk>
cudaError_t prepare() {
  // dynamic shared memory above 48 KB: set once per device (one bit each;
  // two threads may launch on two cards at once)
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(ray_edge_kernel<T, kBulk>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int launch(const void* scal, const void* xiT, const void* w0, const void* X, const void* jj,
           const void* active, void* B, void* g, void* partial, void* tickets, int n_edges,
           int n_pts, int n_frames, int chunks, int tiles_per_chunk, T inv_sr, T inv_sd,
           T huber_k, void* stream) {
  if (n_edges == 0) return 0;
  const bool bulk = ((size_t)n_pts * sizeof(T)) % 16 == 0 && aligned16(xiT) && aligned16(w0) &&
                    aligned16(X);
  const dim3 grid(chunks, n_edges);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (bulk) {
    if ((err = prepare<T, true>()) != cudaSuccess) return (int)err;
    ray_edge_kernel<T, true><<<grid, kThreads, kSmemBytes, st>>>(
        (const T*)scal, (const T*)xiT, (const T*)w0, (const T*)X, (const int*)jj,
        (const uint8_t*)active, (T*)B, (T*)g, (T*)partial, (unsigned*)tickets, n_pts, n_frames,
        tiles_per_chunk, inv_sr, inv_sd, huber_k);
  } else {
    if ((err = prepare<T, false>()) != cudaSuccess) return (int)err;
    ray_edge_kernel<T, false><<<grid, kThreads, kSmemBytes, st>>>(
        (const T*)scal, (const T*)xiT, (const T*)w0, (const T*)X, (const int*)jj,
        (const uint8_t*)active, (T*)B, (T*)g, (T*)partial, (unsigned*)tickets, n_pts, n_frames,
        tiles_per_chunk, inv_sr, inv_sd, huber_k);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int slots(int* out) {
  cudaError_t err = prepare<T, true>();
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ray_edge_kernel<T, true>, kThreads,
                                                      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  *out = sms * per_sm;
  return 0;
}

}  // namespace

// CTAs of the kernel that are resident on the current device at once
// (SMs x blocks per SM): the host sizes the chunks from it.
extern "C" int ray_edge_systems_slots(int f64, int* out) {
  return f64 ? slots<double>(out) : slots<float>(out);
}

extern "C" int ray_edge_systems_f32(const void* scal, const void* xiT, const void* w0,
                                    const void* X, const void* jj, const void* active, void* B,
                                    void* g, void* partial, void* tickets, int n_edges, int n_pts,
                                    int n_frames, int chunks, int tiles_per_chunk, float inv_sr,
                                    float inv_sd, float huber_k, void* stream) {
  return launch<float>(scal, xiT, w0, X, jj, active, B, g, partial, tickets, n_edges, n_pts,
                       n_frames, chunks, tiles_per_chunk, inv_sr, inv_sd, huber_k, stream);
}

extern "C" int ray_edge_systems_f64(const void* scal, const void* xiT, const void* w0,
                                    const void* X, const void* jj, const void* active, void* B,
                                    void* g, void* partial, void* tickets, int n_edges, int n_pts,
                                    int n_frames, int chunks, int tiles_per_chunk, double inv_sr,
                                    double inv_sd, double huber_k, void* stream) {
  return launch<double>(scal, xiT, w0, X, jj, active, B, g, partial, tickets, n_edges, n_pts,
                        n_frames, chunks, tiles_per_chunk, inv_sr, inv_sd, huber_k, stream);
}
