// Flash attention forward, non-causal, no bias: o = softmax(q k^T * scale) v.
//
// Spec: the library kernel the JAX package calls at
// frodo_slam_tpu/models/layers.py:151-161
// (jax.experimental.pallas.ops.tpu.flash_attention,
// _flash_attention_kernel_single_batch): s = q.k^T in f32, an online
// softmax in f32, the UNNORMALISED p rounded to v's type before p.v with
// f32 accumulation, the output in q's type. The plain version is
// flash_attention_plain in frodo_slam_tpu_torch/ops/attention_kernel.py.
//
// Layout: q, k, v are (B, H, N, D) with any batch/head/token strides and
// unit stride along D; o is written (B, Nq, H, D) contiguous, which is the
// (B, N, H*D) layout the attention projection reads next.
//
// bf16 (the ViT-L path): one CTA of 4 warps per (batch x head, 64-query
// tile); each warp owns 16 query rows. The Q fragments live in registers
// for the whole CTA. Per tile of 64 keys, K is staged in shared memory row
// major and V transposed (so both B operands are 32-bit loads), S = Q K^T
// runs on mma.sync m16n8k16 (bf16 in, f32 accumulate), the running max and
// sum stay in f32 registers (a row is shared by the 4 lanes of a quad), P is
// rounded to bf16 and re-used from the S accumulators as the A operand of
// P V without a shuffle, and the output is normalised once at the end.
// Keys past Nk score -inf; queries past Nq are computed on zeros and not
// stored. The head dim is zero-padded to 32, 64 or 128.
//
// f32 (the tiny configurations): the same tiling on FMA, 4 threads per
// query (each owns every 4th channel), 32 keys per shared-memory tile; p
// stays f32, which is what rounding p to v's type means there.
//
// What bounds it: at (1, 16, 768, 64) the work is 2.4 GFLOP of bf16 dots
// against 6.3 MB of inputs and output: bound by the tensor cores (2.4 us at
// 989 TFLOP/s). This design uses mma.sync, not wgmma, and no TMA or
// pipelining of the K/V loads, so it reaches a fraction of that; the plain
// loads, the synchronous tiles and 4 warps per CTA are what a later change
// replaces (wgmma from shared memory, a TMA ring, a producer warp).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per CTA
constexpr int kBK = 64;        // keys per shared-memory tile (bf16)
constexpr int kBKF = 32;       // keys per shared-memory tile (f32)
constexpr int kPad = 8;        // bf16 row padding: conflict-free fragment loads
constexpr float kNegInf = -INFINITY;

struct Strides {
  long long b, h, n;  // element strides of one operand; D has stride 1
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One bf16 element of an operand, 0 outside [0, n) x [0, d).
__device__ __forceinline__ __nv_bfloat16 ld_or_zero(const __nv_bfloat16* base, long long sn,
                                                    int row, int col, int n, int d) {
  return (row < n && col < d) ? base[row * sn + col] : __float2bfloat16(0.0f);
}

template <int DP>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
               int Nq, int Nk, int D, Strides sq, Strides sk, Strides sv, float scale_log2,
               int vec) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK][DP + kPad];
  __shared__ __align__(16) __nv_bfloat16 Vt[DP][kBK + kPad];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kBQ + warp * 16;

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  // Q fragments of this warp's 16 rows, all DP/16 k-steps, in registers
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + g + ((r & 1) ? 8 : 0);
      const int col = kk * 16 + tig * 2 + ((r & 2) ? 8 : 0);
      __nv_bfloat162 pr;
      pr.x = ld_or_zero(qb, sq.n, row, col, Nq, D);
      pr.y = ld_or_zero(qb, sq.n, row, col + 1, Nq, D);
      qa[kk][r] = *reinterpret_cast<uint32_t*>(&pr);
    }
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};  // rows g and g+8, in log2 units
  float l_run[2] = {0.0f, 0.0f};         // this lane's partial row sums

  const int n_tiles = (Nk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    if (vec) {        // 16-byte loads: D % 8 == 0, 16-byte aligned rows
      constexpr int kChunks = kBK * DP / 8;
      for (int idx = tid; idx < kChunks; idx += 128) {
        const int j = idx / (DP / 8), d0 = (idx % (DP / 8)) * 8;
        const int key = key0 + j;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (key < Nk && d0 < D) {
          kv = *reinterpret_cast<const uint4*>(kb + key * sk.n + d0);
          vv = *reinterpret_cast<const uint4*>(vb + key * sv.n + d0);
        }
        *reinterpret_cast<uint4*>(&Ks[j][d0]) = kv;
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
        for (int i = 0; i < 8; ++i) Vt[d0 + i][j] = ve[i];
      }
    } else {
      for (int idx = tid; idx < kBK * DP; idx += 128) {
        const int j = idx / DP, d = idx % DP;
        Ks[j][d] = ld_or_zero(kb, sk.n, key0 + j, d, Nk, D);
        Vt[d][j] = ld_or_zero(vb, sv.n, key0 + j, d, Nk, D);
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const __nv_bfloat16* kr = &Ks[nt * 8 + g][kk * 16 + tig * 2];
        mma_bf16(s[nt], qa[kk], lds32(kr), lds32(kr + 8));
      }
    }

    // scale into log2 units, mask the ragged tail, running max per row
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + tig * 2 + (e & 1);
        const float val = key < Nk ? s[nt][e] * scale_log2 : kNegInf;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m_run[hf], mx[hf]);
      m_use[hf] = m_new == kNegInf ? 0.0f : m_new;  // an all -inf row: exp2(-inf) = 0, no NaN
      alpha[hf] = exp2f(m_run[hf] - m_use[hf]);
      m_run[hf] = m_new;
      l_run[hf] *= alpha[hf];
    }
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_use[e >> 1]);
        s[nt][e] = p;
        l_run[e >> 1] += p;  // the unrounded p, as the row sum of the JAX kernel
      }
    }

    // O += bf16(P) V: the S accumulators of n-tiles 2kk, 2kk+1 are the A
    // fragment of the k-step over keys 16kk .. 16kk+15
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < DP / 8; ++nd) {
        const __nv_bfloat16* vr = &Vt[nd * 8 + g][kk * 16 + tig * 2];
        mma_bf16(acc[nd], pa, lds32(vr), lds32(vr + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hf] = l == 0.0f ? 1.0f : 1.0f / l;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + g + hf * 8;
    if (row >= Nq) continue;
    __nv_bfloat16* orow = o + (((long long)b * Nq + row) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      const int col = nd * 8 + tig * 2;
      if (col < D) orow[col] = __float2bfloat16(acc[nd][2 * hf] * inv[hf]);
      if (col + 1 < D) orow[col + 1] = __float2bfloat16(acc[nd][2 * hf + 1] * inv[hf]);
    }
  }
}

// f32 on FMA: 4 lanes per query, lane c4 owns channels c4, c4 + 4, ...
template <int DP>
__global__ void __launch_bounds__(256)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H, int Nq, int Nk, int D,
              Strides sq, Strides sk, Strides sv, float scale) {
  constexpr int C = DP / 4;  // channels per lane
  __shared__ float Ks[kBKF][DP];
  __shared__ float Vs[kBKF][DP];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, c4 = tid & 3;
  const int row = blockIdx.x * kBQ + (tid >> 2);

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float qr[C], acc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int d = c4 + 4 * i;
    qr[i] = (row < Nq && d < D) ? qb[row * sq.n + d] : 0.0f;
    acc[i] = 0.0f;
  }
  float m_run = kNegInf, l_run = 0.0f;

  const int n_tiles = (Nk + kBKF - 1) / kBKF;
  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * kBKF;
    __syncthreads();
    for (int idx = tid; idx < kBKF * DP; idx += 256) {
      const int j = idx / DP, d = idx % DP, key = key0 + j;
      const bool in = key < Nk && d < D;
      Ks[j][d] = in ? kb[key * sk.n + d] : 0.0f;
      Vs[j][d] = in ? vb[key * sv.n + d] : 0.0f;
    }
    __syncthreads();

    float s[kBKF];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBKF; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < C; ++i) part = fmaf(qr[i], Ks[j][c4 + 4 * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = key0 + j < Nk ? part * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m_run, mx);
    const float m_use = m_new == kNegInf ? 0.0f : m_new;
    const float alpha = expf(m_run - m_use);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < C; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBKF; ++j) {
      const float p = expf(s[j] - m_use);
      l_run += p;
#pragma unroll
      for (int i = 0; i < C; ++i) acc[i] = fmaf(p, Vs[j][c4 + 4 * i], acc[i]);
    }
  }
  if (row >= Nq) return;
  const float inv = l_run == 0.0f ? 1.0f : 1.0f / l_run;
  float* orow = o + (((long long)b * Nq + row) * H + h) * D;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int d = c4 + 4 * i;
    if (d < D) orow[d] = acc[i] * inv;
  }
}

template <int DP>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, int B, int H,
           int Nq, int Nk, int D, Strides sq, Strides sk, Strides sv, float scale, int vec,
           cudaStream_t stream) {
  const dim3 grid((Nq + kBQ - 1) / kBQ, B * H);
  if (dtype == 0) {
    flash_fwd_bf16<DP><<<grid, 128, 0, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (__nv_bfloat16*)o, H, Nq, Nk, D, sq, sk, sv, scale * 1.4426950408889634f, vec);
  } else {
    flash_fwd_f32<DP><<<grid, 256, 0, stream>>>((const float*)q, (const float*)k,
                                                (const float*)v, (float*)o, H, Nq, Nk, D, sq,
                                                sk, sv, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: bf16 (tensor cores), 1: f32 (FMA). Strides in elements.
// Returns the launch's cudaError_t (0 on success); 1 for a head dim above 128.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int H, int Nq, int Nk, int D,
                                   long long qsb, long long qsh, long long qsn, long long ksb,
                                   long long ksh, long long ksn, long long vsb, long long vsh,
                                   long long vsn, float scale, int vec, void* stream) {
  if ((long long)B * H * Nq == 0) return 0;
  const Strides sq{qsb, qsh, qsn}, sk{ksb, ksh, ksn}, sv{vsb, vsh, vsn};
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 32) return launch<32>(dtype, q, k, v, o, B, H, Nq, Nk, D, sq, sk, sv, scale, vec, st);
  if (D <= 64) return launch<64>(dtype, q, k, v, o, B, H, Nq, Nk, D, sq, sk, sv, scale, vec, st);
  if (D <= 128) return launch<128>(dtype, q, k, v, o, B, H, Nq, Nk, D, sq, sk, sv, scale, vec, st);
  return 1;
}
