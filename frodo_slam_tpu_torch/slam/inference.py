"""MASt3R inference orchestration for the SLAM layer.

Behavioral spec: ``mast3r_slam/mast3r_utils.py`` — ``mast3r_inference_mono``
(:208-231), ``mast3r_asymmetric_inference`` (:295-320) and the backend's
symmetric pair decode + match (:115-174, :234-293). Outputs use the
SLAM layer's flattened layout: X (HW, 3), C (HW, 1), D (HW, 24), Q (HW, 1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import mast3r
from ..ops import matching


class AsymOut(NamedTuple):
    """One-direction decode of (frame, keyframe) + dense match."""

    idx_f2k: torch.Tensor  # (1, HW) int32: kf pixel -> frame linear index
    valid_match_k: torch.Tensor  # (1, HW, 1) bool
    Xff: torch.Tensor  # (HW, 3) frame pointmap (own frame)
    Cff: torch.Tensor  # (HW, 1)
    Qff: torch.Tensor  # (HW, 1)
    Xkf: torch.Tensor  # (HW, 3) keyframe pointmap in frame coords
    Ckf: torch.Tensor  # (HW, 1)
    Qkf: torch.Tensor  # (HW, 1)
    Dff: torch.Tensor  # (HW, desc) frame descriptors (for the fnn fallback)
    Dkf: torch.Tensor  # (HW, desc)


def decode_mono(model, feat, pos, img_hw):
    """Self-pair decode for map init (mast3r_utils.py:208-231).
    Returns (Xii (HW,3), Cii (HW,1))."""
    res11, _ = mast3r.decode_and_heads(model, feat, pos, feat, pos, img_hw)
    h, w = img_hw
    return res11["pts3d"].reshape(h * w, 3), res11["conf"].reshape(h * w, 1)


def decode_asymmetric(model, feat_f, pos_f, feat_k, pos_k, img_hw):
    """(frame, keyframe) one-way decode (mast3r_utils.py:295-320), frame as
    view 1."""
    return mast3r.decode_and_heads(model, feat_f, pos_f, feat_k, pos_k, img_hw)


def asym_out(res11, res21, idx_f2k, valid_match_k, img_hw) -> AsymOut:
    """Flatten one decode direction + its match into the SLAM layout."""
    hw = img_hw[0] * img_hw[1]
    flat = lambda x, c: x.reshape(hw, c)  # noqa: E731
    return AsymOut(
        idx_f2k=idx_f2k,
        valid_match_k=valid_match_k,
        Xff=flat(res11["pts3d"], 3),
        Cff=flat(res11["conf"], 1),
        Qff=flat(res11["desc_conf"], 1),
        Xkf=flat(res21["pts3d"], 3),
        Ckf=flat(res21["conf"], 1),
        Qkf=flat(res21["desc_conf"], 1),
        Dff=flat(res11["desc"], res11["desc"].shape[-1]),
        Dkf=flat(res21["desc"], res21["desc"].shape[-1]),
    )


def decode_symmetric_batch(model, feat_i, pos_i, feat_j, pos_j, img_hw):
    """Batched symmetric decode for the backend factor graph
    (mast3r_utils.py:115-174): both directions of N pairs packed into one
    decoder batch of 2N.

    feat_i/feat_j: (N, n_tok, D). Returns X (4, N, h, w, 3), C (4, N, h, w),
    D (4, N, h, w, 24), Q (4, N, h, w) ordered [ii, ji, jj, ij].
    """
    f1 = torch.cat([feat_i, feat_j], dim=0)
    p1 = torch.cat([pos_i, pos_j], dim=0)
    f2 = torch.cat([feat_j, feat_i], dim=0)
    p2 = torch.cat([pos_j, pos_i], dim=0)
    res1, res2 = mast3r.decode_and_heads(model, f1, p1, f2, p2, img_hw)
    n = feat_i.shape[0]

    def split4(r1, r2):
        return torch.stack([r1[:n], r2[:n], r1[n:], r2[n:]], dim=0)

    return tuple(split4(res1[k], res2[k]) for k in ("pts3d", "conf", "desc", "desc_conf"))


def match_symmetric(model, match_cfg, feat_i, pos_i, feat_j, pos_j, img_hw):
    """Symmetric matching for backend edges (mast3r_utils.py:234-293): one
    decoder batch of 2N and one cold match of 2N (the backend's pair match
    is never warm-started).

    Returns (idx_i2j, idx_j2i, valid_match_j, valid_match_i, Qii, Qjj, Qji,
    Qij) with Q* shaped (N, HW, 1).
    """
    mc = dict(match_cfg)
    mc.pop("symmetric_impl", None)  # retired knob: tolerate old configs
    cold_cfg, _ = matching.split_match_cfg(mc)
    n = feat_i.shape[0]
    hw = img_hw[0] * img_hw[1]
    rs = lambda a: a.reshape(n, hw, 1)  # noqa: E731

    X, C, D, Q = decode_symmetric_batch(model, feat_i, pos_i, feat_j, pos_j, img_hw)
    X11 = torch.cat([X[0], X[2]], dim=0)  # (2N, h, w, 3): ii, jj
    X21 = torch.cat([X[1], X[3]], dim=0)  # ji, ij
    D11 = torch.cat([D[0], D[2]], dim=0)
    D21 = torch.cat([D[1], D[3]], dim=0)
    idx_1_to_2, valid_match_2 = matching.match(X11, X21, D11, D21, None, **cold_cfg)
    return (
        idx_1_to_2[:n], idx_1_to_2[n:], valid_match_2[:n], valid_match_2[n:],
        rs(Q[0]), rs(Q[2]), rs(Q[1]), rs(Q[3]),
    )


def match_asymmetric(model, match_cfg, feat_f, pos_f, feat_k, pos_k, img_hw,
                     idx_f2k_init=None) -> AsymOut:
    """Decode + dense match (mast3r_utils.py:389-413 mast3r_match_asymmetric)."""
    res11, res21 = decode_asymmetric(model, feat_f, pos_f, feat_k, pos_k, img_hw)
    cold_cfg, warm_cfg = matching.split_match_cfg(match_cfg)
    idx_f2k, valid_match_k = matching.match(
        res11["pts3d"], res21["pts3d"], res11["desc"], res21["desc"], idx_f2k_init,
        **(warm_cfg if idx_f2k_init is not None else cold_cfg),
    )
    return asym_out(res11, res21, idx_f2k, valid_match_k, img_hw)
