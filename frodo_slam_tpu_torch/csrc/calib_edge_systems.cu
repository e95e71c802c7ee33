// Backend BA calibrated edge normal equations: per directed edge, the 7x7
// relative-pose Gram B = sum_p J^T W J and g = sum_p J^T W e of the pixel +
// log-depth residual over its points.
//
// Spec: the reference's calib_proj_kernel (gn_kernels.cu:2295-2608), which
// the JAX package's global_opt._calib_edge_system reduces with XLA, as
// transcribed by calib_edge_systems_plain in
// frodo_slam_tpu_torch/ops/calib_edge_kernel.py. Per edge e, its relative
// Sim(3) T_ij = T_i^-1 T_j of the window poses T[ii[e]], T[jj[e]] ([t | q
// | s], scalar-last quaternions), formed as lie.sim3_rel forms it (the
// conjugate as inverse, Hamilton products), and sR = s quat_to_R(q), which
// for a quaternion off unit norm is not a rotation, as in the plain code.
// Per point k, with the intrinsics (fx, fy, cx, cy):
//   P = sR Xj + t (Xj = X[jj[e], k], in frame i's coordinates);
//   valid_z = P_z > depth_eps and z_i > depth_eps (z_i = XiT[e, 2, k]);
//   z_inv = valid_z ? 1 / P_z : 0; u = fx P_x z_inv + cx, v = fy P_y z_inv + cy;
//   the point counts where valid_z and u, v lie inside the pixel border;
//   residual e = [u - u_t, v - v_t, log P_z - log z_i] ((u_t, v_t) the
//   matched pixel idx[e, k] of frame i; the log terms 0 where not valid_z);
//   sqrt-weights w0 / sigma_pixel (u, v) and w0 / sigma_depth (log z), 0
//   where the point does not count; W_r = huber(sw_r e_r) sw_r^2 with
//   huber(x) = |x| < k ? 1 : k / |x|;
//   D = d[u, v, log z]/dP = [[fx z_inv, 0, -fx x z_inv^2],
//                            [0, fy z_inv, -fy y z_inv^2], [0, 0, z_inv]];
//   Jacobian row r = [D_r | P x D_r | D_r . P], literal zeros skipped.
// Outputs B (E, 7, 7) (both triangles written from the 28 upper-triangle
// sums) and g (E, 7), in frame i's coordinates: the caller pushes them
// through AdjInv(T_i) (global_opt._calib_edge_systems). A point whose
// weight is 0 adds nothing, so it is not accumulated.
//
// Inputs: the window poses T (P, 8), intr (4,) [fx, fy, cx, cy], XiT (E, 3,
// N) of which only row 2 (z_i) is read, w0 (E, N), the window's pointmaps X
// (P, N, 3) in the store's own layout, ii and jj (E,) int32, idx (E, N)
// int32 and active (E,) bool. Xj of row e is X[jj[e]], read here: no (E, 3,
// N) copy is made. An inactive row reads no points (nor its ii and jj) and
// gets B = g = 0 exactly.
//
// What bounds it: each live row reads z_i, w0 and idx once (12 bytes a point
// in f32) and each distinct frame's slab (12 bytes a point; rows with the
// same jj may meet it in the 50 MB L2), against ~230 operations a point
// (FLOPS_PER_POINT in the wrapper): bytes, at 3.35 TB/s, with the arithmetic
// close behind (two logs, an exact reciprocal and an integer division a
// point).
//
// Design (the ray kernel's, csrc/ray_edge_systems.cu, without its ring: four
// independent points a thread, two in f64, have their loads issued before
// any of their arithmetic, which keeps the loads in flight): ONE launch,
// grid (chunks, E), 256 threads a CTA, each CTA a contiguous chunk of one
// row's points.
// The 35 sums stay in registers; the CTA reduces them (warp shuffles, then
// warps in order) into one partial row. The last CTA of an edge to finish (a
// per-edge ticket: __threadfence, then atomicAdd) sums the edge's partial
// rows in chunk order, writes B and g and resets the ticket, so the ticket
// buffer is zero again for the next call on the stream. No atomics on the
// sums: two calls are bitwise equal. The host sizes the chunks from the
// number of live rows so that one wave of live CTAs fills the card.
// Templated on the scalar type; exact division and logarithm in both.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kOut = 35;       // 28 upper-triangle B entries (row-major, a <= b) + 7 g

// kUnroll: points a thread loads before it computes (f64 takes two registers
// a scalar, so it loads fewer and runs one CTA an SM at least)
template <typename T>
struct Occupancy {
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 2 : 1;
  static constexpr int kUnroll = sizeof(T) == 4 ? 4 : 2;
};

__device__ __forceinline__ float xlog(float x) { return logf(x); }
__device__ __forceinline__ double xlog(double x) { return log(x); }
__device__ __forceinline__ float xabs(float x) { return fabsf(x); }
__device__ __forceinline__ double xabs(double x) { return fabs(x); }
__device__ __forceinline__ float xmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double xmax(double a, double b) { return fmax(a, b); }

// Is entry a of Jacobian row r structurally nonzero? Row 0 (u) has no y
// column, row 1 (v) no x column, row 2 (log z) only z, the two rotation
// columns it reaches and the scale. Constant-folded once the loops unroll.
__device__ __forceinline__ constexpr bool nz(int r, int a) {
  return r == 0 ? a != 1 : (r == 1 ? a != 0 : (a == 2 || a == 3 || a == 4 || a == 6));
}

// Row-major upper-triangle index of B[a][b], a <= b: compile-time constants
// once the loops unroll, so the sums stay in registers.
__device__ __forceinline__ constexpr int triu(int a, int b) {
  return a * 7 - a * (a - 1) / 2 + (b - a);
}

template <typename T>
__device__ __forceinline__ T huber_w(T x, T k) {
  const T a = xabs(x);
  return a < k ? T(1) : k / a;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The edge's scalars and the cell's constants, the same for every point.
template <typename T>
struct Edge {
  T s[12];                   // [sR row-major | t]
  T fx, fy, cx, cy;
  T inv_sp, inv_sd, border, u_hi, v_hi, eps, huber_k;
  int width;
};

// s = [sR row-major | t] of T_ij = T_i^-1 T_j, T_* = [t (3) | q (4) | s],
// in the operations of lie.sim3_rel (quat_inv the conjugate, quat_mul,
// quat_act) and quat_to_R.
template <typename T>
__device__ __forceinline__ void relative_sim3(const T* __restrict__ Ti, const T* __restrict__ Tj,
                                              T (&s)[12]) {
  const T si_inv = T(1) / Ti[7];
  const T sc = si_inv * Tj[7];
  const T ax = -Ti[3], ay = -Ti[4], az = -Ti[5], aw = Ti[6];  // conj(q_i)
  const T bx = Tj[3], by = Tj[4], bz = Tj[5], bw = Tj[6];
  const T x = aw * bx + ax * bw + ay * bz - az * by;
  const T y = aw * by - ax * bz + ay * bw + az * bx;
  const T z = aw * bz + ax * by - ay * bx + az * bw;
  const T w = aw * bw - ax * bx - ay * by - az * bz;
  // t = si_inv * quat_act(conj(q_i), t_j - t_i): d + w uv + q x uv, uv = 2 q x d
  const T d0 = Tj[0] - Ti[0], d1 = Tj[1] - Ti[1], d2 = Tj[2] - Ti[2];
  const T u0 = T(2) * (ay * d2 - az * d1), u1 = T(2) * (az * d0 - ax * d2),
          u2 = T(2) * (ax * d1 - ay * d0);
  s[9] = si_inv * (d0 + aw * u0 + (ay * u2 - az * u1));
  s[10] = si_inv * (d1 + aw * u1 + (az * u0 - ax * u2));
  s[11] = si_inv * (d2 + aw * u2 + (ax * u1 - ay * u0));
  s[0] = sc * (T(1) - T(2) * (y * y + z * z));
  s[1] = sc * (T(2) * (x * y - z * w));
  s[2] = sc * (T(2) * (x * z + y * w));
  s[3] = sc * (T(2) * (x * y + z * w));
  s[4] = sc * (T(1) - T(2) * (x * x + z * z));
  s[5] = sc * (T(2) * (y * z - x * w));
  s[6] = sc * (T(2) * (x * z - y * w));
  s[7] = sc * (T(2) * (y * z + x * w));
  s[8] = sc * (T(1) - T(2) * (x * x + y * y));
}

// One point's terms added to the 35 sums.
template <typename T>
__device__ __forceinline__ void accumulate(T (&acc)[kOut], const Edge<T>& E, T xj0, T xj1, T xj2,
                                           T zi, T w, int id) {
  const T p0 = E.s[0] * xj0 + E.s[1] * xj1 + E.s[2] * xj2 + E.s[9];
  const T p1 = E.s[3] * xj0 + E.s[4] * xj1 + E.s[5] * xj2 + E.s[10];
  const T p2 = E.s[6] * xj0 + E.s[7] * xj1 + E.s[8] * xj2 + E.s[11];
  const bool valid_z = p2 > E.eps && zi > E.eps;
  const T z_inv = valid_z ? T(1) / p2 : T(0);
  const T x_div_z = p0 * z_inv, y_div_z = p1 * z_inv;
  const T u = E.fx * x_div_z + E.cx, v = E.fy * y_div_z + E.cy;
  const bool ok = valid_z && u > E.border && u < E.u_hi && v > E.border && v < E.v_hi;
  const T okf = ok ? w : T(0);
  if (okf == T(0)) return;  // adds nothing
  const int vt = id / E.width;
  const T err[3] = {u - T(id - vt * E.width), v - T(vt), xlog(p2) - xlog(xmax(zi, E.eps))};
  const T sp = okf * E.inv_sp, sd = okf * E.inv_sd;
  const T wk[3] = {huber_w(sp * err[0], E.huber_k) * sp * sp,
                   huber_w(sp * err[1], E.huber_k) * sp * sp,
                   huber_w(sd * err[2], E.huber_k) * sd * sd};

  const T d00 = E.fx * z_inv, d02 = -E.fx * x_div_z * z_inv;
  const T d11 = E.fy * z_inv, d12 = -E.fy * y_div_z * z_inv;
  const T d22 = z_inv;
  const T z = T(0);  // never read: nz() masks it
  // [D_r | P x D_r | D_r . P]
  const T J[3][7] = {{d00, z, d02, p1 * d02, p2 * d00 - p0 * d02, -p1 * d00, d00 * p0 + d02 * p2},
                     {z, d11, d12, p1 * d12 - p2 * d11, -p0 * d12, p0 * d11, d11 * p1 + d12 * p2},
                     {z, z, d22, p1 * d22, -p0 * d22, z, d22 * p2}};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T we = wk[r] * err[r];
#pragma unroll
    for (int a = 0; a < 7; ++a) {
      if (!nz(r, a)) continue;
      const T q = wk[r] * J[r][a];
#pragma unroll
      for (int b = a; b < 7; ++b) {
        if (nz(r, b)) acc[triu(a, b)] += q * J[r][b];
      }
      acc[28 + a] += we * J[r][a];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Occupancy<T>::kMinBlocks)
calib_edge_kernel(const T* __restrict__ poses,   // (P, 8) [t | q | s]
                  const T* __restrict__ intr,    // (4,) fx, fy, cx, cy
                  const T* __restrict__ xiT,     // (E, 3, N): row 2 read
                  const T* __restrict__ w0,      // (E, N)
                  const T* __restrict__ X,       // (P, N, 3)
                  const int* __restrict__ ii,    // (E,)
                  const int* __restrict__ jj,    // (E,)
                  const int* __restrict__ idx,   // (E, N)
                  const uint8_t* __restrict__ active,  // (E,) bool
                  T* __restrict__ B,             // (E, 7, 7)
                  T* __restrict__ g,             // (E, 7)
                  T* __restrict__ partial,       // (E, chunks, kOut)
                  unsigned* __restrict__ tickets,  // (>= E,), zero between calls
                  int n_pts, int n_frames, int pts_per_chunk, int width, T inv_sp, T inv_sd,
                  T border, T u_hi, T v_hi, T eps, T huber_k) {
  __shared__ T red[kWarps * kOut];
  __shared__ int last;
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
  const int i = ii[e], j = jj[e];
  if (i < 0 || i >= n_frames || j < 0 || j >= n_frames) __trap();  // they must index T and X

  Edge<T> E;
  relative_sim3(poses + (size_t)i * 8, poses + (size_t)j * 8, E.s);
  E.fx = intr[0];
  E.fy = intr[1];
  E.cx = intr[2];
  E.cy = intr[3];
  E.inv_sp = inv_sp;
  E.inv_sd = inv_sd;
  E.border = border;
  E.u_hi = u_hi;
  E.v_hi = v_hi;
  E.eps = eps;
  E.huber_k = huber_k;
  E.width = width;

  const T* zi_row = xiT + ((size_t)e * 3 + 2) * n_pts;
  const T* w_row = w0 + (size_t)e * n_pts;
  const int* id_row = idx + (size_t)e * n_pts;
  const T* xj = X + (size_t)j * 3 * n_pts;
  const int k0 = c * pts_per_chunk;
  const int k1 = min(n_pts, k0 + pts_per_chunk);

  T acc[kOut];
#pragma unroll
  for (int t = 0; t < kOut; ++t) acc[t] = T(0);

  constexpr int kUnroll = Occupancy<T>::kUnroll;
  for (int base = k0 + tid; base < k1; base += kThreads * kUnroll) {
    T x0[kUnroll], x1[kUnroll], x2[kUnroll], zi[kUnroll], w[kUnroll];
    int id[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {  // every load first
      const int k = base + q * kThreads;
      const bool in = k < k1;
      const int ks = in ? k : k0;
      x0[q] = __ldg(xj + (size_t)3 * ks);
      x1[q] = __ldg(xj + (size_t)3 * ks + 1);
      x2[q] = __ldg(xj + (size_t)3 * ks + 2);
      zi[q] = __ldg(zi_row + ks);
      w[q] = in ? __ldg(w_row + ks) : T(0);  // a point past the chunk adds nothing
      id[q] = __ldg(id_row + ks);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) accumulate(acc, E, x0[q], x1[q], x2[q], zi[q], w[q], id[q]);
  }

  // CTA reduction in a fixed order: lanes by shuffles, then warps in order
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int t = 0; t < kOut; ++t) {
    const T v = warp_sum(acc[t]);
    if (lane == 0) red[warp * kOut + t] = v;
  }
  __syncthreads();
  if (tid < kOut) {
    T v = T(0);
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += red[k * kOut + tid];
    partial[((size_t)e * chunks + c) * kOut + tid] = v;
    __threadfence();  // the partial row is visible before the ticket counts it
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[e], 1u) == (unsigned)(chunks - 1);
  __syncthreads();
  if (!last) return;

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

template <typename T>
int launch(const void* poses, const void* intr, const void* xiT, const void* w0, const void* X,
           const void* ii, const void* jj, const void* idx, const void* active, void* B, void* g,
           void* partial, void* tickets, int n_edges, int n_pts, int n_frames, int chunks,
           int pts_per_chunk,
           int width, T inv_sp, T inv_sd, T border, T u_hi, T v_hi, T eps, T huber_k,
           void* stream) {
  if (n_edges == 0) return 0;
  calib_edge_kernel<T><<<dim3(chunks, n_edges), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)poses, (const T*)intr, (const T*)xiT, (const T*)w0, (const T*)X, (const int*)ii,
      (const int*)jj, (const int*)idx, (const uint8_t*)active, (T*)B, (T*)g, (T*)partial,
      (unsigned*)tickets, n_pts, n_frames, pts_per_chunk, width, inv_sp, inv_sd, border, u_hi, v_hi, eps, huber_k);
  return (int)cudaGetLastError();
}

template <typename T>
int slots(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, calib_edge_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *out = sms * per_sm;
  return 0;
}

}  // namespace

// CTAs of the kernel that are resident on the current device at once
// (SMs x blocks per SM): the host sizes the chunks from it.
extern "C" int calib_edge_systems_slots(int f64, int* out) {
  return f64 ? slots<double>(out) : slots<float>(out);
}

extern "C" int calib_edge_systems_f32(const void* poses, const void* intr, const void* xiT,
                                      const void* w0, const void* X, const void* ii, const void* jj,
                                      const void* idx, const void* active, void* B, void* g,
                                      void* partial, void* tickets, int n_edges, int n_pts,
                                      int n_frames, int chunks, int pts_per_chunk, int width,
                                      float inv_sp, float inv_sd, float border, float u_hi,
                                      float v_hi, float eps, float huber_k, void* stream) {
  return launch<float>(poses, intr, xiT, w0, X, ii, jj, idx, active, B, g, partial, tickets, n_edges,
                       n_pts, n_frames, chunks, pts_per_chunk, width, inv_sp, inv_sd, border,
                       u_hi, v_hi, eps, huber_k, stream);
}

extern "C" int calib_edge_systems_f64(const void* poses, const void* intr, const void* xiT,
                                      const void* w0, const void* X, const void* ii, const void* jj,
                                      const void* idx, const void* active, void* B, void* g,
                                      void* partial, void* tickets, int n_edges, int n_pts,
                                      int n_frames, int chunks, int pts_per_chunk, int width,
                                      double inv_sp, double inv_sd, double border, double u_hi,
                                      double v_hi, double eps, double huber_k, void* stream) {
  return launch<double>(poses, intr, xiT, w0, X, ii, jj, idx, active, B, g, partial, tickets, n_edges,
                        n_pts, n_frames, chunks, pts_per_chunk, width, inv_sp, inv_sd, border,
                        u_hi, v_hi, eps, huber_k, stream);
}
