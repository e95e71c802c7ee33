"""Keyframe retrieval database for loop closure.

Behavioral spec: ``mast3r_slam/retrieval_database.py:9-171``; the port's copy
of the JAX package's ``retrieval/database.py``. Per keyframe: project the
encoder features through the retrieval head (whiten + attention top-k) on
the device, quantize against the codebook on the device, query the
incremental inverted file on the host for the top-k similar keyframes above
a threshold, then add the keyframe.

ASMK parameters of record (``mast3r/retrieval/processor.py:91-96``): binary
kernel, multiple assignment 1 to build and 5 to query, alpha 3, similarity
threshold 0, no IDF.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .asmk import Codebook, InvertedFile, aggregate_image
from .model import RetrievalHead

BUILD_MA = 1
QUERY_MA = 5
ALPHA = 3.0
SIM_THRESHOLD = 0.0


class RetrievalDatabase:
    def __init__(self, head: RetrievalHead, codebook: Codebook, degraded: bool = False):
        self.head = head
        self.codebook = codebook
        # True on the random head + codebook fallback (no trained retrieval
        # assets): loop closures are then meaningless, and runs record it
        # (loader.load_retriever sets it)
        self.degraded = degraded
        self.dim_bits = codebook.dim
        self.ivf = InvertedFile(codebook.size, self.dim_bits)
        self.kf_counter = 0
        self.kf_ids: List[int] = []

    def reset(self):
        self.ivf = InvertedFile(self.codebook.size, self.dim_bits)
        self.kf_counter = 0
        self.kf_ids = []

    @torch.no_grad()
    def update(self, backbone_feat, add_after_query: bool, k: int,
               min_thresh: float = 0.0, kf_id: Optional[int] = None) -> List[int]:
        """Query + (optionally) insert one keyframe
        (retrieval_database.py:48-77). ``backbone_feat``: (1, N, enc_dim)
        tensor (or array).

        ``kf_id``: the caller's keyframe index for this insertion. The
        inverted file is keyed by insertion order, but results are mapped
        back through ``kf_ids``, so callers whose insertion order can
        diverge from keyframe order (a preempting relocalization, a
        backlogged backend queue) still get true keyframe indices back.
        Defaults to the insertion counter.

        Returns keyframe ids of the top-k matching keyframes above
        ``min_thresh``, best first."""
        feat_dev = self.head.prep_features(torch.as_tensor(backbone_feat))[0]  # (nfeat, dim)
        feat = feat_dev.cpu().numpy()

        topk_image_inds: List[int] = []
        topk_codes: Optional[np.ndarray] = None
        if self.kf_counter > 0:
            word_ids_q = self.codebook.quantize(feat_dev, QUERY_MA)
            topk_codes = word_ids_q
            ades, words = aggregate_image(self.codebook, feat, word_ids_q)
            ranks, scores = self.ivf.search(
                ades, words, alpha=ALPHA, similarity_threshold=SIM_THRESHOLD, topk=None)
            # ranks are sorted by descending score (inverted_file.py:103-105)
            for r, s in zip(ranks[: min(k, self.ivf.n_images)], scores):
                if s > min_thresh:
                    topk_image_inds.append(int(self.kf_ids[int(r)]))

        if add_after_query:
            self._add(feat_dev, feat, topk_codes, kf_id)
        return topk_image_inds

    def state_arrays(self) -> dict:
        """Flat numpy dict of the database's map state (inverted file + id
        mapping), for checkpoint and resume. The codebook and head are model
        assets, not map state: they reload from their own files."""
        vecs, ids, words = [], [], []
        for w in range(self.ivf.n_words):
            c = int(self.ivf.counts[w])
            if c:
                vecs.append(self.ivf.ivf_vecs[w][:c])
                ids.append(self.ivf.ivf_image_ids[w][:c])
                words.append(np.full(c, w, np.int64))
        cat = lambda xs, dt: (np.concatenate(xs) if xs else np.zeros((0,), dt))  # noqa: E731
        return {
            "vecs": cat(vecs, np.uint64),
            "image_ids": cat(ids, np.int64),
            "word_ids": cat(words, np.int64),
            "norm_factor": self.ivf.norm_factor,
            "n_images": np.int64(self.ivf.n_images),
            "kf_ids": np.asarray(self.kf_ids, np.int64),
            "kf_counter": np.int64(self.kf_counter),
        }

    def load_state_arrays(self, d: dict) -> None:
        """Inverse of ``state_arrays`` (into a freshly reset database)."""
        self.reset()
        if len(d["vecs"]):
            self.ivf.add(np.asarray(d["vecs"]), np.asarray(d["word_ids"]),
                         np.asarray(d["image_ids"]))
        # add() recounts norm_factor and n_images from the entries; restore
        # the exact values (images whose features all hashed elsewhere too)
        self.ivf.norm_factor = np.asarray(d["norm_factor"], np.float64)
        self.ivf.n_images = int(d["n_images"])
        self.kf_ids = [int(k) for k in np.asarray(d["kf_ids"])]
        self.kf_counter = int(d["kf_counter"])

    def _add(self, feat_dev: torch.Tensor, feat: np.ndarray, topk_codes: Optional[np.ndarray],
             kf_id: Optional[int] = None):
        """Insert into the inverted file, reusing the query's quantization
        when there was one (retrieval_database.py:147-171)."""
        if topk_codes is None:
            word_ids = self.codebook.quantize(feat_dev, BUILD_MA)
        else:
            word_ids = topk_codes[:, :BUILD_MA]
        ades, words = aggregate_image(self.codebook, feat, word_ids)
        imids = np.full(words.shape[0], self.kf_counter, np.int64)
        self.ivf.add(ades, words, imids)
        self.kf_ids.append(self.kf_counter if kf_id is None else int(kf_id))
        self.kf_counter += 1
