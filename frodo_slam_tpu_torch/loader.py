"""Model loading (the ``load_mast3r`` layer, ``mast3r_slam/mast3r_utils.py:14-52``).

The port's own copy of the JAX package's ``loader.py:26-92``. Checkpoint
resolution order:
1. ``<path>.npz``: converted JAX params (as written by the JAX package's
   ``loader convert``), crossed into the port by ``state_dict_from_jax``;
2. ``<path>.pth``: the reference torch checkpoint, read directly;
3. none found: random weights from a seeded generator, with a loud warning
   (geometry is meaningless; benchmarks and smoke tests only).

``load_retriever`` waits for retrieval (ROADMAP.md §1 item 10).
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
