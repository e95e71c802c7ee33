"""Retrieval feature head: whiten -> project -> attention top-k.

Behavioral spec: ``mast3r/retrieval/model.py`` — ``Whitener`` (:55-76),
``build_projector`` (:144-157), ``featweights='l2norm'`` attention
(:132-134), ``how_select_local`` (:88-104) — and the SLAM-side wrapper
``prep_features`` (``mast3r_slam/retrieval_database.py:30-46``). The port's
copy of the JAX package's ``retrieval/model.py``.

Module and buffer names follow the reference retrieval checkpoint
(``prewhiten.m``, ``projector.0.weight``, ...), so its state dict loads with
``load_state_dict``. Numerics follow the JAX package: the whiteners run in
the features' dtype (f32), the layernorm computes in f32 with eps 1e-6, the
GELU is exact. The head runs on the device of its parameters.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import LayerNorm, layernorm, linear, xavier_
from ..utils.device import resolve_device


class Whitener(nn.Module):
    """``(x - m) @ p`` with ``m`` (1, dim) and ``p`` (dim, dim) as buffers."""

    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer("m", torch.zeros(1, dim))
        self.register_buffer("p", torch.eye(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.m.to(x.dtype)) @ self.p.to(x.dtype)


def build_projector(d_in: int, hdims: Sequence[int]) -> nn.Sequential:
    """[Linear, LayerNorm, GELU] x (len - 1) + a final Linear
    (model.py:144-157); no layers at all for empty ``hdims``."""
    layers: List[nn.Module] = []
    d = d_in
    for h in hdims[:-1]:
        layers += [nn.Linear(d, h), LayerNorm(h), nn.GELU()]
        d = h
    if hdims:
        layers.append(nn.Linear(d, hdims[-1]))
    return nn.Sequential(*layers)


def projector(proj: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    for mod in proj:
        if isinstance(mod, nn.Linear):
            x = linear(mod, x)
        elif isinstance(mod, nn.LayerNorm):
            x = layernorm(mod, x)
        else:
            x = F.gelu(x)
    return x


def how_select_local(feat: torch.Tensor, attn: torch.Tensor, nfeat: int):
    """Top-nfeat features by attention (model.py:88-104).

    feat: (B, N, C); attn: (B, N). Returns (B, k, C), their attention and
    indices, in descending attention order."""
    k = min(int(nfeat), attn.shape[1])
    topk_attn, topk_idx = torch.topk(attn, k, dim=1)
    topk_feat = torch.gather(feat, 1, topk_idx[..., None].expand(-1, -1, feat.shape[-1]))
    return topk_feat, topk_attn, topk_idx


class RetrievalHead(nn.Module):
    def __init__(self, backbone_dim: int = 1024, hdims: Sequence[int] = (1024,), nfeat: int = 300):
        super().__init__()
        self.nfeat = nfeat
        self.prewhiten = Whitener(backbone_dim)
        self.projector = build_projector(backbone_dim, list(hdims))
        self.postwhiten = Whitener(hdims[-1] if hdims else backbone_dim)

    @property
    def dim(self) -> int:
        return self.postwhiten.p.shape[0]

    @staticmethod
    def init(gen: torch.Generator, backbone_dim: int = 1024, hdims: Sequence[int] = (1024,),
             nfeat: int = 300, device=None) -> "RetrievalHead":
        """Random init from ``gen`` with the JAX package's distributions:
        identity whiteners, xavier-uniform linears with zero biases, unit
        layernorms. ``device``: where the head lives, the card unless the
        caller asks for the CPU (``gen``'s device draws the weights)."""
        head = RetrievalHead(backbone_dim, hdims, nfeat)
        with torch.no_grad():
            for mod in head.projector:
                if isinstance(mod, nn.Linear):
                    w = torch.empty(mod.weight.shape, device=gen.device)
                    xavier_(w, mod.in_features, mod.out_features, gen)
                    mod.weight.copy_(w)
                    mod.bias.zero_()
        return head.to(resolve_device(device)).eval()

    @torch.no_grad()
    def prep_features(self, backbone_feat: torch.Tensor) -> torch.Tensor:
        """(B, N, enc_dim) encoder tokens -> (B, nfeat, dim) local features
        (retrieval_database.py:30-46), on the head's device."""
        proj = projector(self.projector, self.prewhiten(backbone_feat.to(self.prewhiten.p.device)))
        attn = torch.linalg.norm(proj, dim=-1)  # featweights='l2norm'
        topk, _, _ = how_select_local(self.postwhiten(proj), attn, self.nfeat)
        return topk


def convert_retrieval_checkpoint(sd: Dict[str, np.ndarray], hdims: Sequence[int] = (1024,)
                                 ) -> Dict[str, torch.Tensor]:
    """The reference retrieval checkpoint's state dict (numpy values) ->
    this head's f32 ``state_dict``: the same names, other entries dropped."""
    n = 3 * (len(hdims) - 1)
    keep = ["prewhiten.m", "prewhiten.p", "postwhiten.m", "postwhiten.p"]
    for i in range(len(hdims) - 1):
        keep += [f"projector.{3 * i}.{p}" for p in ("weight", "bias")]
        keep += [f"projector.{3 * i + 1}.{p}" for p in ("weight", "bias")]
    if hdims:
        keep += [f"projector.{n}.weight", f"projector.{n}.bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(sd[k], np.float32)) for k in keep}
