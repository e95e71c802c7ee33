// RoPE2D in place on the q and k of one attention, from cos/sin tables.
//
// Spec: rope2d_plain in frodo_slam_tpu_torch/ops/rope_kernel.py, which is the
// JAX package's apply_rope2d (frodo_slam_tpu/models/layers.py:106) on tables
// that the forward builds once (layers.rope_tables). A (B, H, N, D) operand's
// head dim is split in halves: the first is rotated by the token's y
// position, the second by its x position. Within a half of width 2P the
// rotate-half partner of element j < P is j + P:
//   out[j]     = t[j] * cos[j]         + (-t[j + P]) * sin[j]
//   out[j + P] = t[j + P] * cos[j + P] + t[j] * sin[j + P]
// The table is (B, N, 4, D/2): cos_y, sin_y, cos_x, sin_x.
//
// Replaces no TPU kernel: XLA fused the rotation into the attention's
// producers there, while eager PyTorch issued some 35 launches for each of
// q and k of each attention. One launch here rotates both.
//
// Numerics, bitwise equal to PyTorch's pointwise ops: in bf16 each product
// is formed in f32 (exact: two 8-bit significands) and rounded to bf16, as
// the two multiplications round, then their f32 sum is rounded to bf16, as
// the addition rounds. In f32 the products and the sum are __fmul_rn and
// __fadd_rn, so that nvcc cannot contract them into an FMA.
//
// In place: each thread reads both elements of each rotate-half pair it
// owns (V consecutive j of both halves) before it writes any of them, and
// no two threads own the same element, so q and k may be views into one
// buffer (the qkv projection's output) as long as they do not overlap.
//
// What bounds it: q and k read and written once, plus the tables: at
// (1, 16, 768, 64) bf16 6.3 MB, 1.9 us at 3.35 TB/s; a few operations an
// element. A thread moves V elements of each quarter of a row as one
// vector (16 bytes for bf16 at D = 64), threads of a warp take the heads of
// one token in turn, so a token's table rows are read from L1.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Operand {
  void* t;          // (B, H, N, D), unit stride along D
  const void* tab;  // (B, N, 4, D/2), unit stride along the last dim
  long long sb, sh, sn;  // element strides of t
  long long tb, tn, t4;  // element strides of the table
  int n;                 // tokens
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ __nv_bfloat16 neg(__nv_bfloat16 x) { return __hneg(x); }
__device__ __forceinline__ float neg(float x) { return -x; }

// x * c + r * s, rounded as PyTorch's mul, mul and add round
__device__ __forceinline__ __nv_bfloat16 rot(__nv_bfloat16 x, __nv_bfloat16 c, __nv_bfloat16 r,
                                             __nv_bfloat16 s) {
  const float a = __bfloat162float(__float2bfloat16_rn(__fmul_rn(to_f32(x), to_f32(c))));
  const float b = __bfloat162float(__float2bfloat16_rn(__fmul_rn(to_f32(r), to_f32(s))));
  return __float2bfloat16_rn(__fadd_rn(a, b));
}

__device__ __forceinline__ float rot(float x, float c, float r, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(r, s));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// grid.y = 0 rotates q, 1 rotates k; a thread owns V consecutive j < P of
// both halves of one (b, n, h) row, heads fastest
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rope2d_kernel(Operand q, Operand k, int B, int H, int D) {
  const Operand o = blockIdx.y == 0 ? q : k;
  const int P = D / 4;
  const int per_row = P / V;
  const long long work = (long long)B * o.n * H * per_row;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= work) return;
  const int j = (int)(i % per_row) * V;
  long long r = i / per_row;
  const int h = (int)(r % H);
  r /= H;
  const int n = (int)(r % o.n);
  const int b = (int)(r / o.n);

  T* t = (T*)o.t + b * o.sb + h * o.sh + n * o.sn + j;
  const T* tab = (const T*)o.tab + b * o.tb + n * o.tn + j;
  // the four quarters of the row: y lo, y hi, x lo, x hi
  Vec<T, V> e[4];
#pragma unroll
  for (int qd = 0; qd < 4; ++qd) e[qd] = load<T, V>(t + qd * P);
  Vec<T, V> out[4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const T* cs = tab + (2 * half) * o.t4;   // cos of this half
    const T* sn = cs + o.t4;                 // sin of this half
    const Vec<T, V> c_lo = load<T, V>(cs), c_hi = load<T, V>(cs + P);
    const Vec<T, V> s_lo = load<T, V>(sn), s_hi = load<T, V>(sn + P);
    const Vec<T, V>& lo = e[2 * half];
    const Vec<T, V>& hi = e[2 * half + 1];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      out[2 * half].v[v] = rot(lo.v[v], c_lo.v[v], neg(hi.v[v]), s_lo.v[v]);
      out[2 * half + 1].v[v] = rot(hi.v[v], c_hi.v[v], lo.v[v], s_hi.v[v]);
    }
  }
#pragma unroll
  for (int qd = 0; qd < 4; ++qd) *reinterpret_cast<Vec<T, V>*>(t + qd * P) = out[qd];
}

template <typename T>
int launch(Operand q, Operand k, int B, int H, int D, int vec, cudaStream_t stream) {
  const long long rows = (long long)B * H * (q.n > k.n ? q.n : k.n);
  const long long work = rows * (D / 4 / vec);
  const long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return 1;
  const dim3 grid((unsigned)blocks, 2);
  switch (vec) {
    case 1: rope2d_kernel<T, 1><<<grid, kThreads, 0, stream>>>(q, k, B, H, D); break;
    case 2: rope2d_kernel<T, 2><<<grid, kThreads, 0, stream>>>(q, k, B, H, D); break;
    case 4: rope2d_kernel<T, 4><<<grid, kThreads, 0, stream>>>(q, k, B, H, D); break;
    case 8: rope2d_kernel<T, 8><<<grid, kThreads, 0, stream>>>(q, k, B, H, D); break;
    default: return 1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Nq, D) and k (B, H, Nk, D) rotated in place by their tables tq
// (B, Nq, 4, D/2) and tk (B, Nk, 4, D/2); dtype 0 = bf16, 1 = f32 (operands
// and tables alike); strides in elements; vec elements a thread moves as one
// vector (1, 2, 4 or 8: it divides D/4, every stride, and every pointer is
// aligned to it, which rope_kernel.rope_vec checks). Returns the launch's
// cudaError_t (0 on success), or 1 for arguments the kernel does not take.
extern "C" int rope2d_launch(void* q, const void* tq, void* k, const void* tk, int dtype, int B,
                             int H, int Nq, int Nk, int D, long long q_sb, long long q_sh,
                             long long q_sn, long long k_sb, long long k_sh, long long k_sn,
                             long long tq_sb, long long tq_sn, long long tq_s4, long long tk_sb,
                             long long tk_sn, long long tk_s4, int vec, void* stream) {
  if (D < 4 || D % 4 != 0 || vec < 1 || (D / 4) % vec != 0) return 1;
  if ((long long)B * H * Nq == 0 && (long long)B * H * Nk == 0) return 0;
  const Operand oq{q, tq, q_sb, q_sh, q_sn, tq_sb, tq_sn, tq_s4, Nq};
  const Operand ok{k, tk, k_sb, k_sh, k_sn, tk_sb, tk_sn, tk_s4, Nk};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<__nv_bfloat16>(oq, ok, B, H, D, vec, st);
    case 1: return launch<float>(oq, ok, B, H, D, vec, st);
    default: return 1;
  }
}
