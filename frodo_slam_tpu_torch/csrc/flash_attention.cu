// Flash attention forward, non-causal, no bias: o = softmax(q k^T * scale) v.
//
// Spec: the library kernel the JAX package calls at
// frodo_slam_tpu/models/layers.py:151-161
// (jax.experimental.pallas.ops.tpu.flash_attention,
// _flash_attention_kernel_single_batch): s = q.k^T in f32, an online
// softmax in f32, the UNNORMALISED p rounded to v's type before p.v with
// f32 accumulation, the row sum from the unrounded p, the output normalised
// once at the end and written in q's type. The plain version is
// flash_attention_plain in frodo_slam_tpu_torch/ops/attention_kernel.py.
//
// Layout: q, k, v are (B, H, N, D) with any batch/head/token strides and
// unit stride along D; o is written (B, Nq, H, D) contiguous, which is the
// (B, N, H*D) layout the attention projection reads next.
//
// bf16 (the ViT-L path), warp-specialised TMA + wgmma. One CTA per
// (batch x head, 64-query tile): one consumer warpgroup (threads 0-127) and
// one producer warp (threads 128-159).
//  - The producer's lane 0 loads the Q tile once and streams 64-key K and V
//    tiles through a ring of S stages (3 for D <= 64, 2 above) with cp.async.bulk.tensor (TMA),
//    full/empty mbarriers per stage. The tensor maps are 4-D (D, N, H, B)
//    over the caller's strides with 64 x 64 boxes and the 128-byte swizzle
//    (a 64-wide bf16 row is 128 bytes); TMA zero-fills head dims past D,
//    rows past N and the ragged tail. A head dim above 64 takes two 64-wide
//    halves per tile.
//  - The consumers run S = Q K^T as wgmma m64n64k16 with both operands in
//    shared memory (K-major: K's rows are already its reduction dim), the
//    online softmax in registers (a row lives in the 4 lanes of a quad), and
//    O += bf16(P) V as wgmma with A from registers: the S accumulators of
//    two adjacent 8-key column blocks are exactly the A fragment of a 16-key
//    k-step, packed to bf16 without a shuffle. V stays as TMA wrote it and
//    is read as an MN-major B operand through the transpose bit.
//  - The epilogue normalises O, stages it in the (free) Q buffer with the
//    same swizzle and writes each output row with 16-byte stores.
// Keys past Nk score -inf; a row that saw only -inf gives 0, not NaN.
//
// f32 (the tiny configurations): an FMA variant, 4 threads per query (each
// owns every 4th channel), 32 keys per shared-memory tile; p stays f32,
// which is what rounding p to v's type means there.
//
// What bounds it: at (1, 16, 768, 64) the work is 2.4 GFLOP of bf16 dots
// against 6.3 MB of inputs and output: the tensor cores (2.4 us at 989
// TFLOP/s). The design keeps the tensor cores fed from shared memory (TMA,
// no register staging of K/V, no transposes), overlaps the next tiles'
// loads with this tile's math, and issues tile t's S = Q K^T together with
// tile t-1's P V, so the softmax of tile t overlaps the tensor cores' P V.
//
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda)
// and passed to the kernel as __grid_constant__ parameters.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (no --use_fast_math).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBQ = 64;             // queries per CTA
constexpr int kBK = 64;             // keys per tile
constexpr int kBKF = 32;            // keys per shared-memory tile (f32)
constexpr int kHalfBytes = 64 * 64 * 2;  // one 64 x 64 bf16 box: 8 KB
constexpr int kConsumers = 128;     // one warpgroup
constexpr int kThreads = kConsumers + 32;
constexpr float kNegInf = -INFINITY;

struct Strides {
  long long b, h, n;  // element strides of one operand; D has stride 1
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarrier, TMA, wgmma
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. For the K-major
// operands (Q, K) the stride between 8-row groups is SBO = 1024 bytes and
// LBO is unused; for the MN-major V the stride between 8-key groups along
// the reduction dim is SBO = 1024 bytes and LBO (between 64-wide MN atoms)
// is unused at N = 64. Both are set to 1024.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {  // ex2.approx: exp2(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keeps the compiler from moving register traffic across an async wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define WG_D32                                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),            \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_D32_LIST                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of element (row r, col c) of a 64 x 64 bf16 box with the
// 128-byte swizzle (16-byte chunk index XOR row mod 8)
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

// NH: 64-wide halves of the padded head dim (1: D <= 64, 2: D <= 128)
template <int NH, int S>
struct Layout {
  static constexpr int kQ = 0;
  static constexpr int kK = NH * kHalfBytes;
  static constexpr int kV = kK + S * NH * kHalfBytes;
  static constexpr int kBar = kV + S * NH * kHalfBytes;  // full_q, full[S], empty[S]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * S) + 1024;  // + alignment slack
};

template <int NH, int S>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int H,
                int Nq, int Nk, int D, float scale_log2) {
  using L = Layout<NH, S>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // swizzled boxes need 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t full_q = base + L::kBar;
  auto full = [&](int s) { return base + L::kBar + 8 + 8 * s; };
  auto empty = [&](int s) { return base + L::kBar + 8 + 8 * S + 8 * s; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int n_tiles = (Nk + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp: lane 0 issues every TMA load
    if (tid == kConsumers) {
      mbar_expect_tx(full_q, NH * kHalfBytes);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        tma_load_4d(base + L::kQ + hh * kHalfBytes, &tq, full_q, hh * 64, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty(s), ((t / S) - 1) & 1);
        mbar_expect_tx(full(s), 2 * NH * kHalfBytes);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) {
          tma_load_4d(base + L::kK + (s * NH + hh) * kHalfBytes, &tk, full(s), hh * 64, t * kBK, h, b);
          tma_load_4d(base + L::kV + (s * NH + hh) * kHalfBytes, &tv, full(s), hh * 64, t * kBK, h, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: warp w owns query rows 16w .. 16w+15 of the tile;
  // lane (g, tg) holds rows 16w+g and 16w+g+8, columns 8j+2tg, 8j+2tg+1.
  // Tile t's S = Q K^T is issued together with tile t-1's O += P V, so the
  // softmax of tile t runs while the tensor cores finish P V of tile t-1.
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;

  float acc[NH][32];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hh][i] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};  // rows g and g+8, raw score units
  float l_run[2] = {0.0f, 0.0f};         // this lane's partial row sums
  float sc[32];
  uint32_t pa[4][4];  // bf16(P) of the previous tile: the A operand of P V

  auto issue_s = [&](int t) {
    const int s = t % S;
    mbar_wait(full(s), (t / S) & 1);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NH; ++kk) {
      const int hh = kk >> 2, off = (kk & 3) * 32;
      wgmma_ss(sc, sw128_desc(base + L::kQ + hh * kHalfBytes + off),
               sw128_desc(base + L::kK + (s * NH + hh) * kHalfBytes + off), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int t) {  // V's k-step is 16 key rows = 2048 bytes
    const int s = t % S;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(acc[hh]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        wgmma_rs_mn(acc[hh], pa[kk], sw128_desc(base + L::kV + (s * NH + hh) * kHalfBytes + kk * 2048));
    wgmma_commit();
  };
  auto pv_done = [&](int t) {  // P V of tile t has finished: its stage is free
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(acc[hh]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    mbar_arrive(empty(t % S));
  };
  // online softmax of tile t's scores in sc (in place: sc becomes p);
  // returns the factor that rescales the running O and row sums
  auto softmax = [&](int t, float (&alpha)[2]) {
    const int key0 = t * kBK;
    if (key0 + kBK > Nk) {  // the ragged tail scores -inf
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (key0 + 8 * (i >> 2) + 2 * tg + (i & 1) >= Nk) sc[i] = kNegInf;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float m_use[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m_run[hf], mx[hf]);
      // an all -inf row subtracts 0: exp2(-inf) = 0, no NaN
      m_use[hf] = m_new == kNegInf ? 0.0f : m_new * scale_log2;
      alpha[hf] = fast_exp2(fmaf(m_run[hf], scale_log2, -m_use[hf]));
      m_run[hf] = m_new;
      l_run[hf] *= alpha[hf];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = fast_exp2(fmaf(sc[i], scale_log2, -m_use[(i >> 1) & 1]));
      sc[i] = p;
      l_run[(i >> 1) & 1] += p;  // the unrounded p, as the row sum of the JAX kernel
    }
  };
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hh][i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  mbar_wait(full_q, 0);
  float alpha[2];
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0, alpha);
  rescale_and_pack(alpha);
  for (int t = 1; t < n_tiles; ++t) {
    issue_s(t);
    issue_pv(t - 1);
    wgmma_wait<1>();  // S of tile t is in; P V of tile t-1 may still run
    fence_regs(sc);
    softmax(t, alpha);
    wgmma_wait<0>();
    pv_done(t - 1);
    rescale_and_pack(alpha);
  }
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  pv_done(n_tiles - 1);

  // epilogue: normalise, stage bf16 O in the Q buffer (same swizzle), then
  // write each row of the tile with 16-byte stores
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hf] = l == 0.0f ? 1.0f : 1.0f / l;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");  // every S product is done
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * warp + g + 8 * hf;
        const int c = 8 * j + 2 * tg;
        *reinterpret_cast<uint32_t*>(gbase + L::kQ + hh * kHalfBytes + sw128_offset(r, c)) =
            pack_bf16(acc[hh][4 * j + 2 * hf] * inv[hf], acc[hh][4 * j + 2 * hf + 1] * inv[hf]);
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  constexpr int kChunks = NH * 8;  // 16-byte chunks per padded row
  const bool vec = (D & 7) == 0;
  for (int idx = tid; idx < kBQ * kChunks; idx += kConsumers) {
    const int r = idx / kChunks, c8 = idx % kChunks;
    const int row = q0 + r, col = c8 * 8;
    if (row >= Nq || col >= D) continue;
    const uint8_t* src = gbase + L::kQ + (c8 >> 3) * kHalfBytes + sw128_offset(r, col & 63);
    __nv_bfloat16* dst = o + (((long long)b * Nq + row) * H + h) * D + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(src);
      for (int i = 0; i < 8 && col + i < D; ++i) dst[i] = e[i];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 on FMA: 4 lanes per query, lane c4 owns channels c4, c4 + 4, ...
// ---------------------------------------------------------------------------

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
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk,
               int D, Strides sq, Strides sk, Strides sv, float scale, cudaStream_t stream) {
  const dim3 grid((Nq + kBQ - 1) / kBQ, B * H);
  flash_fwd_f32<DP><<<grid, 256, 0, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                              (float*)o, H, Nq, Nk, D, sq, sk, sv, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// host: tensor maps and the bf16 launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn lookup_encode_tiled() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
  cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
  return status == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
}

// the driver's entry point is one per process; looked up once, by whichever
// thread comes first (a function-local static is initialised thread-safely)
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = lookup_encode_tiled();
  return fn;
}

// A 4-D map (D, N, H, B) of one operand, 64 x 64 boxes, 128-byte swizzle,
// zero fill out of bounds. Strides in elements (bf16); the caller has made
// them TMA-legal (16-byte multiples, 16-byte aligned base).
int encode_map(CUtensorMap* map, const void* ptr, int D, int N, int H, int B, Strides st) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.n * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

template <int NH, int S>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk,
                int D, Strides sq, Strides sk, Strides sv, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = encode_map(&mq, q, D, Nq, H, B, sq);
  if (!err) err = encode_map(&mk, k, D, Nk, H, B, sk);
  if (!err) err = encode_map(&mv, v, D, Nk, H, B, sv);
  if (err) return err;
  constexpr int smem = Layout<NH, S>::kBytes;
  // above the 48 KB default: the attribute belongs to the current device, so
  // it is set once per device (one bit each), not once per process; the
  // tracker's and the backend's threads may launch on two cards at once
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = 1ull << (dev & 63);
  if (!(attr_set.load() & bit)) {
    e = cudaFuncSetAttribute(flash_fwd_wgmma<NH, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set.fetch_or(bit);
  }
  const dim3 grid((Nq + kBQ - 1) / kBQ, B * H);
  flash_fwd_wgmma<NH, S><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, H, Nq, Nk, D, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: bf16 (TMA + wgmma; strides and base TMA-legal), 1: f32 (FMA).
// Strides in elements. Returns 0 on success, the launch's cudaError_t, 1 for
// a head dim outside 1..128, 2 when the driver has no cuTensorMapEncodeTiled,
// or 1000 + the CUresult of a refused tensor map.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int H, int Nq, int Nk, int D,
                                   long long qsb, long long qsh, long long qsn, long long ksb,
                                   long long ksh, long long ksn, long long vsb, long long vsh,
                                   long long vsn, float scale, void* stream) {
  if ((long long)B * H * Nq == 0) return 0;
  if (D < 1 || D > 128) return 1;
  const Strides sq{qsb, qsh, qsn}, sk{ksb, ksh, ksn}, sv{vsb, vsh, vsn};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    if (D <= 64) return launch_bf16<1, 3>(q, k, v, o, B, H, Nq, Nk, D, sq, sk, sv, scale, st);
    return launch_bf16<2, 2>(q, k, v, o, B, H, Nq, Nk, D, sq, sk, sv, scale, st);
  }
  if (D <= 32) return launch_f32<32>(q, k, v, o, B, H, Nq, Nk, D, sq, sk, sv, scale, st);
  if (D <= 64) return launch_f32<64>(q, k, v, o, B, H, Nq, Nk, D, sq, sk, sv, scale, st);
  return launch_f32<128>(q, k, v, o, B, H, Nq, Nk, D, sq, sk, sv, scale, st);
}
