"""Train an ASMK retrieval codebook from your own images, on the card.

    python -m frodo_slam_tpu_torch.tools.train_codebook --dataset <path> --out <pkl>
        [--centroids 65536] [--max-images 500] [--iters 20] [--ckpt <model>]
        [--retrieval-ckpt <head>] [--seed 0] [--device cuda]

The reference downloads a trained 65,536-word codebook
(``mast3r/retrieval/processor.py:65-99``); without one the loader falls back
to a random codebook and marks retrieval degraded
(:func:`~frodo_slam_tpu_torch.loader.load_retriever`). This tool makes one
without a download: it runs the encoder and the retrieval head over a
dataset (any path :func:`~frodo_slam_tpu_torch.data.datasets.load_dataset`
reads, a plain image folder included), k-means the per-image local features
with mini-batch Lloyd iterations on the device, and writes
``{"centroids": (K, D) f32, "head_fingerprint": ...}``, which
``load_retriever(codebook_path=...)`` loads as not degraded next to the same
head.

The port's counterpart of the JAX package's ``scripts/train_codebook.py``.
The features are the ones a running ``SLAM`` hands its retrieval database:
each image preprocessed as ``SLAM.preprocess`` does (the 512 long side,
ImgNorm), encoded, and passed through ``head.prep_features``; then
l2-normalized, as the JAX script does. ``minibatch_kmeans`` draws every
random index from the caller's numpy generator in the JAX script's order,
so both pick the same indices.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np
import torch

from ..models import mast3r
from ..slam.system import preprocess_image


@torch.no_grad()
def collect_features(model, head, dataset, max_images: int) -> torch.Tensor:
    """The l2-normalized retrieval features (n_images * nfeat, D) of up to
    ``max_images`` frames spread evenly over ``dataset``, on the head's
    device."""
    (h, w), _ = dataset.get_img_shape()
    portrait = h > w
    img_hw = (w, h) if portrait else (h, w)  # the landscape storage shape
    device = next(model.parameters()).device
    n = min(len(dataset), max_images)
    step = max(1, len(dataset) // max(n, 1))
    feats = []
    for i in range(0, len(dataset), step):
        if len(feats) == n:
            break
        _, img = dataset[i]
        x = np.ascontiguousarray(preprocess_image(img, img_hw, portrait), np.float32)
        feat, _ = mast3r.encode_image(model, torch.from_numpy(x).to(device), portrait=portrait)
        feats.append(head.prep_features(feat)[0])
    if not feats:
        raise ValueError("no images to collect features from")
    allf = torch.cat(feats)
    return allf / torch.clamp(torch.linalg.norm(allf, dim=1, keepdim=True), min=1e-12)


def _assign(xb: torch.Tensor, centroids: torch.Tensor, chunk: int) -> torch.Tensor:
    """Index of each row's most similar centroid (argmax of the dot product;
    argmin of the L2 distance for unit rows). The product is f32, in row
    chunks; a row whose two best f32 similarities lie within twice the
    bound of the f32 error of their difference (d x 2^-23 for unit rows and
    centroids of norm <= 1) is scored again in f64, so that its winner does
    not hang on the product's summation order: the card and the CPU then
    pick the same centroids."""
    d = xb.shape[1]
    tie = 2.0 * d * 2.0 ** -23
    c64 = None
    out = []
    for r0 in range(0, xb.shape[0], chunk):
        x = xb[r0:r0 + chunk]
        sims = x @ centroids.T
        best, assign = sims.max(dim=1)
        sims.scatter_(1, assign[:, None], -torch.inf)
        near = torch.nonzero(best - sims.max(dim=1).values < tie).squeeze(1)
        if near.numel():
            c64 = centroids.double() if c64 is None else c64
            assign[near] = torch.argmax(x[near].double() @ c64.T, dim=1)
        out.append(assign)
    return torch.cat(out)


@torch.no_grad()
def minibatch_kmeans(rng: np.random.Generator, feats: torch.Tensor, k: int, iters: int = 20,
                     batch: int = 65536, chunk: int = 8192) -> torch.Tensor:
    """Mini-batch Lloyd k-means (the reference trains its codebook with faiss
    k-means, asmk/asmk/codebook.py) on ``feats``' device. ``feats`` (N, D)
    f32, l2-normalized; returns (k, D) f32 unit centroids. With N <= k the
    features are tiled to k rows plus N(0, 1e-4) noise, as in the JAX script.

    Each iteration assigns a batch of rows drawn without replacement and
    moves every hit centroid toward its members' mean with the rate
    m / (count + m), count in f64. The JAX script loops over the clusters;
    here one scatter sums every cluster's members (in f64) and one blend
    updates them: each cluster reads only its own members and count, so it
    is the same update."""
    n, d = feats.shape
    dev = feats.device
    if n <= k:
        reps = int(np.ceil(k / max(n, 1)))
        base = feats.repeat(reps, 1)[:k]
        noise = rng.normal(scale=1e-4, size=tuple(base.shape)).astype(np.float32)
        return base + torch.from_numpy(noise).to(dev)
    centroids = feats[torch.from_numpy(rng.choice(n, size=k, replace=False)).to(dev)].clone()
    counts = torch.ones(k, dtype=torch.float64, device=dev)
    for _ in range(iters):
        xb = feats[torch.from_numpy(rng.choice(n, size=min(batch, n), replace=False)).to(dev)]
        assign = _assign(xb, centroids, chunk)
        m = torch.bincount(assign, minlength=k).double()
        sums = torch.zeros((k, d), dtype=torch.float64, device=dev).index_add_(0, assign, xb.double())
        lr = (m / (counts + m))[:, None]
        moved = ((1 - lr) * centroids + lr * (sums / torch.clamp(m, min=1)[:, None])).float()
        centroids = torch.where((m > 0)[:, None], moved, centroids)
        counts += m
    return centroids / torch.clamp(torch.linalg.norm(centroids, dim=1, keepdim=True), min=1e-12)


def train(args, device=None) -> dict:
    """Collect, cluster, write the pickle. Returns a summary."""
    from .. import loader
    from ..data.datasets import load_dataset

    model, model_cfg = loader.load_mast3r(args.ckpt, device=device)
    head = loader.load_retriever(model_cfg, args.retrieval_ckpt, device=device).head
    dataset = load_dataset(args.dataset)
    feats = collect_features(model, head, dataset, args.max_images)
    n_images = min(len(dataset), args.max_images)
    print(f"collected {feats.shape[0]} local features from {n_images} images", file=sys.stderr)
    centroids = minibatch_kmeans(np.random.default_rng(args.seed), feats, args.centroids,
                                 iters=args.iters).cpu().numpy()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        # the fingerprint binds the codebook to the head it was trained
        # against; load_retriever checks it (a mismatch loads degraded)
        pickle.dump({"centroids": centroids, "head_fingerprint": loader.head_fingerprint(head)}, f)
    return {"out": args.out, "images": n_images, "features": int(feats.shape[0]),
            "centroids": list(centroids.shape), "iters": args.iters, "seed": args.seed}


def build_parser():
    ap = argparse.ArgumentParser(description="train an ASMK retrieval codebook (PyTorch/CUDA port)")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--centroids", type=int, default=65536)
    ap.add_argument("--max-images", type=int, default=500)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--retrieval-ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cpu runs the plain PyTorch path")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    summary = train(args, device=args.device)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
