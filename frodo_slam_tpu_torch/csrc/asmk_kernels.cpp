// Host kernels of the ASMK retrieval scoring path.
//
// The port's own copy of the JAX package's native popcount kernels, which
// replace the reference's Cython hamming module (asmk/cython/hamming.pyx):
// popcount hamming distance over packed uint32 descriptors, the binarize +
// pack step, and the fused per-word IVF scoring. They run on the host at
// keyframe rate while the card decodes; the C form avoids numpy's
// materialized (Q, N, words * 4) byte intermediates.
//
// Plain C ABI, built by g++ at first use into build/kernels/ and loaded with
// ctypes (frodo_slam_tpu_torch/utils/native.py). The numpy forms in
// retrieval/asmk.py (*_plain) are their plain versions.

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(__GNUC__) || defined(__clang__)
#define POPCOUNT(x) __builtin_popcount(x)
#else
static inline int POPCOUNT(uint32_t x) {
  x = x - ((x >> 1) & 0x55555555u);
  x = (x & 0x33333333u) + ((x >> 2) & 0x33333333u);
  x = (x + (x >> 4)) & 0x0F0F0F0Fu;
  return (int)((x * 0x01010101u) >> 24);
}
#endif

extern "C" {

// Normalized hamming distance between two sets of packed bit rows.
// a: (na, words), b: (nb, words), out: (na, nb) float32, each entry
// popcount(a_i ^ b_j) / dim_bits.   (hamming.pyx:128-...)
void hamming_cdist_packed(const uint32_t* a, const uint32_t* b, float* out,
                          int64_t na, int64_t nb, int64_t words,
                          float dim_bits) {
  const float inv = 1.0f / dim_bits;
  for (int64_t i = 0; i < na; ++i) {
    const uint32_t* ai = a + i * words;
    float* oi = out + i * nb;
    for (int64_t j = 0; j < nb; ++j) {
      const uint32_t* bj = b + j * words;
      int acc = 0;
      for (int64_t w = 0; w < words; ++w) acc += POPCOUNT(ai[w] ^ bj[w]);
      oi[j] = (float)acc * inv;
    }
  }
}

// Binarize (v > 0) and pack MSB-first into uint32 words.
// vecs: (n, d) float32 -> out: (n, ceil(d/32)) uint32  (hamming.pyx:79-105)
void binarize_and_pack_2d(const float* vecs, uint32_t* out, int64_t n,
                          int64_t d) {
  const int64_t words = (d + 31) / 32;
  for (int64_t i = 0; i < n; ++i) {
    const float* vi = vecs + i * d;
    uint32_t* oi = out + i * words;
    std::memset(oi, 0, (size_t)words * sizeof(uint32_t));
    for (int64_t k = 0; k < d; ++k) {
      if (vi[k] > 0.0f) oi[k >> 5] |= (uint32_t)1u << (31 - (k & 31));
    }
  }
}

// Fused IVF word scoring: for one query word's packed residual `q` against
// the word's database residuals `vecs` (n, words) with image ids `imids`,
// apply the monomial ASMK kernel (kernel.py:55-68, functional.py:11-15) and
// accumulate directly into the per-image score array:
//   sim = 1 - 2*hamming/dim;  if sim >= thr: scores[imid] += sign(sim)*|sim|^3
//                                              / sqrt(norm_factor[imid])
// alpha is fixed at 3 (the system's parameter of record,
// retrieval/processor.py:95).
void asmk_accumulate_word(const uint32_t* q, const uint32_t* vecs,
                          const int64_t* imids, int64_t n, int64_t words,
                          float dim_bits, float sim_threshold,
                          const double* norm_factor, double* scores) {
  const float inv = 1.0f / dim_bits;
  for (int64_t j = 0; j < n; ++j) {
    const uint32_t* vj = vecs + j * words;
    int acc = 0;
    for (int64_t w = 0; w < words; ++w) acc += POPCOUNT(q[w] ^ vj[w]);
    float sim = 1.0f - 2.0f * (float)acc * inv;
    if (sim >= sim_threshold) {
      double s = (double)sim;
      double contrib = s * s * s;  // alpha = 3 (sign-preserving)
      int64_t id = imids[j];
      scores[id] += contrib / std::sqrt(norm_factor[id]);
    }
  }
}

}  // extern "C"
