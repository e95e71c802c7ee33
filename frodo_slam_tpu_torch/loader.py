"""Model and retriever loading (the ``load_mast3r`` / ``load_retriever``
layer, ``mast3r_slam/mast3r_utils.py:14-52``).

The port's own copy of the JAX package's ``loader.py:26-170``. Checkpoint
resolution order of :func:`load_mast3r`:
1. ``<path>.npz``: converted JAX params (as written by the JAX package's
   ``loader convert``), crossed into the port by ``state_dict_from_jax``;
2. ``<path>.pth``: the reference torch checkpoint, read directly;
3. none found: random weights from a seeded generator, with a loud warning
   (geometry is meaningless; benchmarks and smoke tests only).

:func:`load_retriever` reads the reference retrieval checkpoint and its
codebook pickle, or falls back to a seeded random head and a random
4096-word codebook marked ``degraded``.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .models import convert, mast3r
from .utils.device import resolve_device

DEFAULT_CKPT = "checkpoints/MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth"
DEFAULT_RETRIEVAL = "checkpoints/MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric_retrieval_trainingfree.pth"


def _unflatten_npz(data) -> Dict[str, Any]:
    """The JAX package's ``save_npz`` keys ("enc_blocks/attn/qkv/w",
    "head1/dpt/layer_rn/0/w") back into nested dicts, numeric parts into
    lists."""
    tree: Dict[str, Any] = {}
    for key in data.files:
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def _from_state_dict(sd, cfg: mast3r.MASt3RConfig, device) -> mast3r.MASt3R:
    with torch.device(device):
        model = mast3r.MASt3R(cfg)
    model.load_state_dict(sd, strict=True)
    return model.cast_transformer_().eval()


def load_mast3r(path: Optional[str] = None, cfg: Optional[mast3r.MASt3RConfig] = None,
                device=None) -> Tuple[mast3r.MASt3R, mast3r.MASt3RConfig]:
    """Returns (model on ``device``, model config); ``device=None`` is the card."""
    cfg = cfg or mast3r.MASt3RConfig()
    path = path or DEFAULT_CKPT
    npz = pathlib.Path(path).with_suffix(".npz")
    if npz.exists():
        with np.load(npz) as data:
            params = _unflatten_npz(data)
        return _from_state_dict(convert.state_dict_from_jax(params, cfg), cfg, resolve_device(device)), cfg
    if pathlib.Path(path).exists():
        sd = convert.load_torch_checkpoint(path, cfg)
        return _from_state_dict(sd, cfg, resolve_device(device)), cfg
    warnings.warn(
        f"checkpoint not found at {path}; using RANDOM weights — pointmaps "
        "will be meaningless (benchmark/smoke-test mode only)"
    )
    if os.environ.get("FRODO_ENTRY_TINY"):
        # keep only the compute knobs the caller set explicitly (different
        # from the MASt3RConfig defaults): tiny_config() defaults to f32
        base = mast3r.MASt3RConfig()
        reps = {k: getattr(cfg, k) for k in ("dtype", "head_dtype", "attention_impl")
                if getattr(cfg, k) != getattr(base, k)}
        cfg = dataclasses.replace(mast3r.tiny_config(), **reps)
    model = mast3r.init_model(cfg, seed=0, device=device)
    if os.environ.get("FRODO_RANDOM_SHARE_DECODER"):
        # benchmark-mode random weights: decoder2/head2 := decoder/head1, so
        # identical frames decode consistently and the tracker's success
        # branches run (independent random heads never agree across views)
        model.downstream_head2.load_state_dict(model.downstream_head1.state_dict())
        model.dec_blocks2.load_state_dict(model.dec_blocks.state_dict())
    return model, cfg


def apply_model_knobs(model_cfg: mast3r.MASt3RConfig, cfg) -> mast3r.MASt3RConfig:
    """Apply the yaml ``tpu:`` model-compute knobs before loading, so the
    one-time weight cast uses the final compute type: ``tpu.dtype``
    (encoder/decoder), ``tpu.head_dtype`` (DPT and descriptor heads; f32 is
    the reference contract) and ``tpu.attention_impl`` ("xla" | "pallas",
    one function in the port). Missing keys leave the config as it is."""
    tpu = cfg.get("tpu", {}) or {}
    reps = {}
    for key in ("dtype", "head_dtype"):
        if tpu.get(key):
            dt = getattr(torch, str(tpu[key]), None)
            if not isinstance(dt, torch.dtype):
                raise ValueError(f"tpu.{key}: {tpu[key]!r} is not a torch dtype")
            reps[key] = dt
    if tpu.get("attention_impl"):
        reps["attention_impl"] = str(tpu["attention_impl"])
    return dataclasses.replace(model_cfg, **reps) if reps else model_cfg


def head_fingerprint(head) -> str:
    """Digest of the retrieval head's weights, stored in a codebook pickle
    by ``scripts/train_codebook.py`` so that a codebook can be checked
    against the head it was trained for. It hashes the leaves in the JAX
    package's ``tree_leaves`` order and layout (dict keys sorted, linear
    weights (in, out)), so a head and its converted copy give one digest."""
    import hashlib

    sd = {k: v.detach().float().cpu() for k, v in head.state_dict().items()}
    leaves = [sd[f"{w}.{x}"] for w in ("postwhiten", "prewhiten") for x in ("m", "p")]
    mods = list(head.projector)
    lin = [i for i, m in enumerate(mods) if isinstance(m, torch.nn.Linear)]
    if lin:  # "final" sorts before "layers"
        leaves += [sd[f"projector.{lin[-1]}.bias"], sd[f"projector.{lin[-1]}.weight"].T]
    for i in lin[:-1]:
        leaves += [sd[f"projector.{i}.bias"], sd[f"projector.{i}.weight"].T,
                   sd[f"projector.{i + 1}.bias"], sd[f"projector.{i + 1}.weight"]]
    md = hashlib.sha256()
    for leaf in leaves:
        md.update(np.ascontiguousarray(leaf.numpy(), np.float32).tobytes())
    return md.hexdigest()[:16]


def load_retriever(model_cfg: mast3r.MASt3RConfig, path: Optional[str] = None,
                   codebook_path: Optional[str] = None, device=None):
    """Returns a :class:`RetrievalDatabase` on ``device`` (the card unless
    the caller asks for the CPU). Without a trained head and codebook it is
    a seeded random head and a random 4096-word codebook, marked
    ``degraded``."""
    import pickle

    from .retrieval.asmk import Codebook
    from .retrieval.database import RetrievalDatabase
    from .retrieval.model import RetrievalHead, convert_retrieval_checkpoint

    device = resolve_device(device)
    path = path or DEFAULT_RETRIEVAL
    head = None
    if pathlib.Path(path).exists():
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = {k: v.float().numpy() for k, v in ckpt["model"].items() if torch.is_tensor(v)}
        head = RetrievalHead(backbone_dim=sd["prewhiten.p"].shape[0], hdims=[1024], nfeat=300)
        head.load_state_dict(convert_retrieval_checkpoint(sd))
        head = head.to(device).eval()

    # the codebook loads on its own: one trained by scripts/train_codebook.py
    # pairs with the seeded random head it was trained against
    cb_file = codebook_path or str(pathlib.Path(path).parent / (
        "_".join(pathlib.Path(path).name.split("_")[:-1]) + "_codebook.pkl"))
    centroids = None
    cb_data = None
    if pathlib.Path(cb_file).exists():
        with open(cb_file, "rb") as f:
            cb_data = pickle.load(f)
        centroids = np.asarray(cb_data["centroids"] if isinstance(cb_data, dict) else cb_data.centroids)

    head_is_random = head is None
    if head is None:
        if centroids is None:
            warnings.warn("retrieval checkpoint/codebook not found; using random "
                          "retrieval head + codebook (loop closures will be random)")
        gen = torch.Generator().manual_seed(1)
        head = RetrievalHead.init(gen, backbone_dim=model_cfg.enc_embed_dim,
                                  hdims=[min(1024, model_cfg.enc_embed_dim)], nfeat=300, device=device)
    if centroids is not None:
        # the codebook must have been trained against THIS head: pickles of
        # scripts/train_codebook.py carry the head's fingerprint; the
        # reference's do not, and are trusted only beside its real head
        fp = cb_data.get("head_fingerprint") if isinstance(cb_data, dict) else None
        matched = (fp == head_fingerprint(head)) if fp is not None else (None if head_is_random else True)
        if matched is not True:
            warnings.warn(
                f"codebook {cb_file} was not trained against the loaded retrieval head "
                f"({'fingerprint mismatch' if matched is False else 'no fingerprint; head is random-init'}); "
                "marking retrieval degraded")
        return RetrievalDatabase(head, Codebook(centroids, device=device), degraded=matched is not True)
    cb = Codebook.random(np.random.default_rng(0), 4096, head.dim, device=device)
    # degraded: runs record the random fallback, so that numbers with random
    # loop closures never look like real ones
    return RetrievalDatabase(head, cb, degraded=True)
