"""ASMK: aggregated selective match kernel for image retrieval.

The port's copy of the JAX package's ``retrieval/asmk.py``. Behavioral spec
(the vendored asmk package):
- codebook quantization: L2 top-k against the centroids as one matmul on the
  device (``retrieval_database.py:101-110``); the trained codebook of record
  has 65,536 words of 1,024 dims (256 MiB in f32);
- aggregation: per visual word, the sum of residuals to the centroid, then
  binarize (sign) and pack to uint32 (``asmk/kernel.py:26-50``,
  ``asmk/cython/hamming.pyx:79-...``);
- similarity: normalized packed hamming -> [-1, 1], threshold + monomial
  alpha kernel (``asmk/kernel.py:55-68``, ``asmk/functional.py:11-15``);
- inverted file: per-word store of packed residuals + image ids, IDF-less
  (``use_idf: False`` in the SLAM params, ``retrieval/processor.py:91-96``),
  norm factor = per-image word count (``asmk/inverted_file.py:56-105``).

The inverted file is host numpy: pointer-chasing bookkeeping at keyframe
rate, as the reference keeps it on the CPU. Packing, hamming distances and
the alpha = 3 scoring run in the host kernels of ``csrc/asmk_kernels.cpp``
(:mod:`..utils.native`, built at first use); the ``*_plain`` functions are
their numpy plain versions, which only the tests call.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import native
from ..utils.device import resolve_device

_POPCNT_TABLE = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint16)


def binarize_and_pack_plain(vecs: np.ndarray) -> np.ndarray:
    """(N, D) float -> (N, ceil(D/32)) uint32, bit = (v > 0)
    (hamming.pyx:79-105). Bit order: bit k of word w is element 32w+k,
    MSB-first to match the Cython packer (result |= 1 << (31 - k))."""
    n, d = vecs.shape
    dpad = (-d) % 32
    bits = (vecs > 0).astype(np.uint8)
    if dpad:
        bits = np.concatenate([bits, np.zeros((n, dpad), np.uint8)], axis=1)
    bits = bits.reshape(n, -1, 32)
    weights = (1 << (31 - np.arange(32, dtype=np.uint64))).astype(np.uint64)
    packed = (bits.astype(np.uint64) * weights).sum(axis=2)
    return packed.astype(np.uint32)


def hamming_cdist_packed_plain(a: np.ndarray, b: np.ndarray, dim_bits: int) -> np.ndarray:
    """Normalized hamming distance between packed uint32 rows
    (hamming.pyx:128-...): popcount(xor) / dim_bits, f32."""
    x = a[:, None, :] ^ b[None, :, :]
    counts = _POPCNT_TABLE[x.view(np.uint8).reshape(*x.shape[:2], -1)].sum(axis=-1)
    # times the f32 inverse, as the host kernel does (the JAX package
    # divides: equal when dim_bits is a power of two)
    return counts.astype(np.float32) * (np.float32(1.0) / np.float32(dim_bits))


def asmk_accumulate_word_plain(q, vecs, imids, dim_bits, sim_threshold, norm_factor, scores):
    """numpy form of the host kernel ``asmk_accumulate_word``, with its
    arithmetic: sim in f32, its cube and the normalization in f64."""
    nd = hamming_cdist_packed_plain(q[None], vecs, dim_bits)[0]
    sim = np.float32(1.0) - np.float32(2.0) * nd
    mask = sim >= np.float32(sim_threshold)
    s = sim[mask].astype(np.float64)
    np.add.at(scores, imids[mask], s * s * s / np.sqrt(norm_factor[imids[mask]]))


def binarize_and_pack(vecs: np.ndarray) -> np.ndarray:
    """(N, D) float -> (N, ceil(D/32)) uint32, MSB-first (the host kernel)."""
    return native.binarize_and_pack_2d(vecs)


def hamming_cdist_packed(a: np.ndarray, b: np.ndarray, dim_bits: int) -> np.ndarray:
    """popcount(a_i ^ b_j) / dim_bits (the host kernel)."""
    return native.hamming_cdist_packed(a, b, dim_bits)


class Codebook:
    """Visual-word codebook: host centroids for the aggregation, device
    centroids and squared norms for the quantization."""

    def __init__(self, centroids, device=None):
        self.centroids = np.asarray(centroids, np.float32)  # (K, D)
        self.device = resolve_device(device)
        self._dev_centroids = torch.from_numpy(self.centroids).to(self.device)
        self._dev_norms = torch.sum(self._dev_centroids ** 2, dim=1)

    @property
    def size(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @torch.no_grad()
    def quantize(self, qvecs, multiple_assignment: int) -> np.ndarray:
        """Top-k nearest centroids by L2, via the expanded-norm matmul
        (retrieval_database.py:101-110). ``qvecs``: (N, D) numpy or tensor.
        Returns (N, k) int32, nearest first."""
        q = torch.as_tensor(qvecs, dtype=torch.float32).to(self.device)
        qn = torch.sum(q ** 2, dim=1)[:, None]
        d2 = qn + self._dev_norms[None, :] - 2.0 * (q @ self._dev_centroids.T)
        _, idx = torch.topk(-d2, multiple_assignment, dim=1)
        return idx.to(torch.int32).cpu().numpy()

    @staticmethod
    def random(rng: np.random.Generator, size: int, dim: int, device=None) -> "Codebook":
        """Placeholder codebook when the trained pickle is unavailable."""
        return Codebook(rng.normal(size=(size, dim)).astype(np.float32), device=device)


def aggregate_image(codebook: Codebook, des: np.ndarray, word_ids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Sum residuals per unique visual word, binarize + pack
    (kernel.py:26-40). ``word_ids``: (N, MA). Returns the packed residuals
    and the unique words, ascending."""
    unique_ids = np.unique(word_ids)
    ades = np.empty((unique_ids.shape[0], des.shape[1]), np.float32)
    for i, word in enumerate(unique_ids):
        sel = (word_ids == word).any(axis=1)
        ades[i] = (des[sel] - codebook.centroids[word]).sum(0)
    return binarize_and_pack(ades), unique_ids


class InvertedFile:
    """IDF-less inverted file over packed binary residuals
    (inverted_file.py:40-105 with use_idf=False)."""

    def __init__(self, n_words: int, dim_bits: int):
        self.n_words = n_words
        self.dim_bits = dim_bits
        self.ivf_vecs: List[Optional[np.ndarray]] = [None] * n_words
        self.ivf_image_ids: List[Optional[np.ndarray]] = [None] * n_words
        self.counts = np.zeros(n_words, np.int64)
        self.norm_factor = np.zeros(0)
        self.n_images = 0

    @staticmethod
    def _append(arr: Optional[np.ndarray], size: int, item: np.ndarray) -> np.ndarray:
        if arr is None:
            arr = np.zeros((10,) + item.shape, item.dtype)
        elif size >= arr.shape[0]:
            arr = np.resize(arr, (int(np.ceil(arr.shape[0] * 1.5)),) + arr.shape[1:])
        arr[size] = item
        return arr

    def add(self, des: np.ndarray, word_ids: np.ndarray, image_ids: np.ndarray):
        max_imid = int(image_ids.max())
        if int(image_ids.min()) < self.n_images:
            raise ValueError("image ids must be consecutive")
        self.norm_factor = np.concatenate(
            [self.norm_factor, np.zeros(max_imid + 1 - len(self.norm_factor))])
        self.n_images = max(self.n_images, max_imid + 1)
        for i, word in enumerate(word_ids):
            w = int(word)
            self.ivf_vecs[w] = self._append(self.ivf_vecs[w], self.counts[w], des[i])
            self.ivf_image_ids[w] = self._append(self.ivf_image_ids[w], self.counts[w], image_ids[i])
            self.counts[w] += 1
            self.norm_factor[image_ids[i]] += 1

    def search(self, des: np.ndarray, word_ids: np.ndarray, *, alpha: float,
               similarity_threshold: float, topk: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
        """Accumulate monomial-kernel similarities over the query's words
        (inverted_file.py:84-105 + kernel.similarity + asmk_kernel). Scores
        take the host kernel at ``alpha == 3`` (the system's value) and the
        numpy form otherwise."""
        scores = np.zeros(self.n_images)
        q_norm_factor = len(word_ids)  # idf == 1 per word when use_idf=False
        for qvec, word in zip(des, word_ids):
            w = int(word)
            if self.ivf_image_ids[w] is None:
                continue
            vecs = self.ivf_vecs[w][: self.counts[w]]
            imids = self.ivf_image_ids[w][: self.counts[w]].astype(np.int64)
            if alpha == 3.0:
                native.asmk_accumulate_word(qvec, vecs, imids, self.dim_bits, similarity_threshold,
                                            self.norm_factor, scores)
                continue
            nd = hamming_cdist_packed(qvec[None], vecs, self.dim_bits)[0]
            sim = -2.0 * nd + 1.0
            mask = sim >= similarity_threshold
            contrib = np.sign(sim[mask]) * np.abs(sim[mask]) ** alpha
            ids = imids[mask]
            scores[ids] += contrib / np.sqrt(self.norm_factor[ids])
        scores = scores / np.sqrt(max(q_norm_factor, 1))
        k = self.n_images if topk is None else min(topk, self.n_images)
        ranks = np.argsort(-scores)[:k]
        return ranks, scores[ranks]
